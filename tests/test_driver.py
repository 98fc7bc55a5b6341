"""Gibbs-driver mechanics added in round 5: the long-call guard for
nthin > max_sweeps_per_call (VERDICT round-4 item 8), split-R-hat in the
results dict (item 7), the one-shot profiler capture (item 9), and the
float16 data-storage option (memory-bound optimization pass, item 3)."""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from functionalmf_tpu import (
    GaussianBayesianTensorFiltering,
    ConstrainedNonconjugateBayesianTensorFiltering,
)


def _gauss_model(seed=3, nchains=1):
    return GaussianBayesianTensorFiltering(
        4, 3, 6, nembeds=2, nu2_init=0.3, sigma2_init=0.5, lam2_init=0.5,
        seed=seed, nchains=nchains)


def _gauss_data(rng):
    return rng.normal(size=(4, 3, 6, 2))


def test_nthin_exceeding_chunk_limit_is_stream_identical(rng):
    """nthin > max_sweeps_per_call splits each thin interval into chunks;
    because draw streams key on the ABSOLUTE sweep offset, the collected
    draws must be bit-identical to the unchunked run (previously a single
    device call silently executed nthin sweeps, violating the long-call
    invariant — models/base.py:run_gibbs)."""
    Y = _gauss_data(rng)
    res = {}
    for tag, cap in (("big", None), ("small", 8)):
        m = _gauss_model()
        if cap is not None:
            m.max_sweeps_per_call = cap  # instance override
        res[tag] = m.run_gibbs(Y, nburn=8, nthin=20, nsamples=3,
                               verbose=False)
    for k in ("W", "V", "lam2", "sigma2"):
        np.testing.assert_array_equal(res["big"][k], res["small"][k])


def test_rhat_in_multichain_results(rng):
    Y = _gauss_data(rng)
    m = _gauss_model(nchains=3)
    res = m.run_gibbs(Y, nburn=30, nthin=1, nsamples=12, verbose=False)
    rhat = res["rhat"]
    assert set(rhat) >= {"W", "V", "lam2", "sigma2", "max"}
    assert np.isfinite(rhat["max"]) and rhat["max"] >= 1.0 - 1e-6
    assert rhat["max"] == max(v for k, v in rhat.items() if k != "max")
    # single-chain runs must NOT carry rhat
    res1 = _gauss_model().run_gibbs(Y, nburn=5, nthin=1, nsamples=6,
                                    verbose=False)
    assert "rhat" not in res1


def test_profile_dir_captures_trace(rng, tmp_path):
    Y = _gauss_data(rng)
    m = _gauss_model()
    pdir = str(tmp_path / "prof")
    m.run_gibbs(Y, nburn=4, nthin=1, nsamples=2, verbose=False,
                profile_dir=pdir)
    found = [f for _, _, fs in os.walk(pdir) for f in fs]
    assert found, "profiler trace directory is empty"


def test_data_dtype_f16(rng):
    """float16 data storage (halved likelihood HBM reads) must keep the
    sampler finite and feasible; counts <= 2048 are exact in f16."""
    W = rng.gamma(1, 1, (4, 2)); W[np.triu_indices(2, 1)] = 0
    V = np.abs(rng.normal(1, .3, (3, 8, 2)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W, V)).astype(float)
    C = np.concatenate([np.eye(8), np.zeros((8, 1))], axis=1)
    W0 = np.abs(rng.normal(1, .2, (4, 2))); W0[np.triu_indices(2, 1)] = 0
    V0 = np.abs(rng.normal(1, .2, (3, 8, 2)))

    def loglik(Yd, WV, Wm, Vm, row=None, col=None):
        if row is not None:
            Yd = Yd[row]
        if col is not None:
            Yd = Yd[:, col]
        rate = jnp.clip(WV, 1e-8, None)
        Y0 = jnp.where(jnp.isnan(Yd), 0.0, Yd)
        return jnp.sum(jnp.where(jnp.isnan(Yd), 0.0,
                                 Y0 * jnp.log(rate) - rate))

    m = ConstrainedNonconjugateBayesianTensorFiltering(
        4, 3, 8, loglik, C, nembeds=2, tf_order=0, sigma2_init=0.5,
        lam2_init=0.1, W_init=W0, V_init=V0, gass_ngrid=24,
        v_block_size=4, seed=5, data_dtype=jnp.float16)
    assert m.prepare_data(Y).dtype == jnp.float16
    res = m.run_gibbs(Y, nburn=30, nthin=1, nsamples=30, verbose=False)
    mu = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
    assert np.isfinite(mu).all()
    assert mu.min() >= -1e-5
