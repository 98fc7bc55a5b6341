"""Multi-chain + mesh sharding tests on the virtual 8-device CPU mesh."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from functionalmf_tpu.parallel.mesh import make_mesh, shard_state, state_shardings


def test_mesh_construction():
    assert len(jax.devices()) == 8
    mesh = make_mesh(n_dp=2, n_mp=4)
    assert mesh.axis_names == ("dp", "mp")
    assert mesh.devices.shape == (2, 4)


@pytest.mark.slow
def test_sharded_multichain_gaussian(rng):
    """Chains sharded over dp, rows/cols over mp: one jitted sweep must
    produce the same distribution family of results as unsharded."""
    from functionalmf_tpu import GaussianBayesianTensorFiltering
    nrows, ncols, ndepth, k, nchains = 8, 8, 6, 2, 4
    Y = rng.normal(size=(nrows, ncols, ndepth))

    mesh = make_mesh(n_dp=2, n_mp=4)
    model = GaussianBayesianTensorFiltering(
        nrows, ncols, ndepth, nembeds=k, nchains=nchains, mesh=mesh, seed=0)
    res = model.run_gibbs(Y, nburn=20, nthin=1, nsamples=10, verbose=False)
    assert res["W"].shape == (nchains * 10, nrows, k)
    assert np.isfinite(res["W"]).all() and np.isfinite(res["V"]).all()


@pytest.mark.slow
def test_shard_state_specs(rng):
    from functionalmf_tpu import GaussianBayesianTensorFiltering
    mesh = make_mesh(n_dp=2, n_mp=4)
    model = GaussianBayesianTensorFiltering(8, 8, 6, nembeds=2, nchains=2,
                                            seed=0, mesh=mesh)
    sharded = model._shard_state(model.state)
    specs = model.state_shardings()
    # W shards rows over mp, and the placed arrays actually carry the spec
    assert "mp" in str(specs["W"].spec)
    assert "mp" in str(specs["V"].spec)
    for k, v in sharded.items():
        assert v.shape == model.state[k].shape
    assert "mp" in str(sharded["W"].sharding.spec)


@pytest.mark.slow
def test_indivisible_dims_fall_back_to_replication():
    """GDELT-like odd sizes (19 rows) over mp=4 must not error."""
    from functionalmf_tpu import GaussianBayesianTensorFiltering
    mesh = make_mesh(n_dp=2, n_mp=4)
    model = GaussianBayesianTensorFiltering(19, 19, 6, nembeds=2, nchains=2,
                                            seed=0, mesh=mesh)
    sharded = model._shard_state(model.state)
    assert "mp" not in str(sharded["W"].sharding.spec)


@pytest.mark.slow
def test_sharded_equals_unsharded_gaussian(rng):
    """The (dp, mp)-sharded run must produce the same draws as the
    unsharded run for identical keys — GSPMD computes the same function,
    so only float reassociation noise is allowed."""
    from functionalmf_tpu import GaussianBayesianTensorFiltering
    nrows, ncols, ndepth, k, nchains = 8, 8, 6, 2, 2
    Y = rng.normal(size=(nrows, ncols, ndepth))

    kwargs = dict(nembeds=k, nchains=nchains, seed=3)
    ref = GaussianBayesianTensorFiltering(nrows, ncols, ndepth, **kwargs)
    res_ref = ref.run_gibbs(Y, nburn=10, nthin=1, nsamples=5, verbose=False)

    mesh = make_mesh(n_dp=2, n_mp=4)
    mod = GaussianBayesianTensorFiltering(nrows, ncols, ndepth, mesh=mesh,
                                          **kwargs)
    res_mesh = mod.run_gibbs(Y, nburn=10, nthin=1, nsamples=5, verbose=False)

    for key_ in ("W", "V", "lam2", "sigma2"):
        np.testing.assert_allclose(res_mesh[key_], res_ref[key_],
                                   rtol=2e-3, atol=2e-4, err_msg=key_)
    # the run's final carried state is still mp-sharded (not drifted to
    # replicated across chunk boundaries)
    assert "mp" in str(mod.state["W"].sharding.spec)


@pytest.mark.slow
def test_sharded_equals_unsharded_constrained(rng):
    """Same equivalence for the flagship constrained model (GASS path,
    all-of-V constraint assembly crossing the mp shards)."""
    from jax.scipy.special import gammaln
    from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering

    nrows, ncols, ndepth, k = 8, 8, 6, 2

    def poisson_loglik(Y, WV, W, V, row=None, col=None):
        if row is not None:
            Y = Y[row]
        if col is not None:
            Y = Y[:, col]
        rate = jnp.clip(WV, 1e-8, None)
        Y0 = jnp.where(jnp.isnan(Y), 0.0, Y)
        ll = Y0 * jnp.log(rate) - rate - gammaln(Y0 + 1.0)
        return jnp.sum(jnp.where(jnp.isnan(Y), 0.0, ll))

    W0 = np.abs(rng.normal(1, 0.2, size=(nrows, k)))
    W0[np.triu_indices(k, k=1)] = 0
    V0 = np.abs(rng.normal(1, 0.2, size=(ncols, ndepth, k)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W0, V0)).astype(float)
    Constraints = np.concatenate([np.eye(ndepth), np.zeros((ndepth, 1))], axis=1)

    kwargs = dict(nembeds=k, tf_order=1, sigma2_init=0.5, lam2_init=0.1,
                  W_init=W0, V_init=V0, gass_ngrid=12, seed=5, nchains=2)
    # Few-sweep window: GSPMD computes the same function, so over 1-2
    # sweeps the draws must agree to float-reassociation precision. (Over
    # many sweeps GASS's discrete arc picks chaotically amplify 1e-7
    # reassociation noise into fully decorrelated elements — seed
    # dependent — so a long-run comparison tests chaos, not partitioning.
    # A real partitioning bug, e.g. a missing all-gather in the
    # constraint assembly, corrupts the very first sweep, which this
    # catches at tight tolerance.)
    ref = ConstrainedNonconjugateBayesianTensorFiltering(
        nrows, ncols, ndepth, poisson_loglik, Constraints, **kwargs)
    res_ref = ref.run_gibbs(Y, nburn=1, nthin=1, nsamples=1, verbose=False)

    mesh = make_mesh(n_dp=2, n_mp=4)
    mod = ConstrainedNonconjugateBayesianTensorFiltering(
        nrows, ncols, ndepth, poisson_loglik, Constraints, mesh=mesh, **kwargs)
    res_mesh = mod.run_gibbs(Y, nburn=1, nthin=1, nsamples=1, verbose=False)

    for key_ in ("W", "V"):
        np.testing.assert_allclose(res_mesh[key_], res_ref[key_],
                                   rtol=1e-3, atol=1e-3, err_msg=key_)
        assert np.isfinite(res_mesh[key_]).all(), key_

    # And a longer sharded run stays finite with sharding retained.
    res_long = mod.run_gibbs(Y, nburn=5, nthin=1, nsamples=3, verbose=False)
    assert np.isfinite(res_long["W"]).all() and np.isfinite(res_long["V"]).all()
    assert "mp" in str(mod.state["W"].sharding.spec)


@pytest.mark.slow
def test_constrained_long_run_under_mesh(rng):
    """Flagship constrained model driven through run_gibbs for 60+ sweeps
    ON the (dp, mp) mesh (VERDICT round-2 item 5): every retained draw must
    be finite AND satisfy the positivity constraints at every cell — the
    collective plan (all-gather of the V-derived constraint matrix across
    mp shards) holds up over a long window, not just one step."""
    from jax.scipy.special import gammaln
    from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering

    nrows, ncols, ndepth, k = 8, 8, 6, 2

    def poisson_loglik(Y, WV, W, V, row=None, col=None):
        if row is not None:
            Y = Y[row]
        if col is not None:
            Y = Y[:, col]
        rate = jnp.clip(WV, 1e-8, None)
        Y0 = jnp.where(jnp.isnan(Y), 0.0, Y)
        ll = Y0 * jnp.log(rate) - rate - gammaln(Y0 + 1.0)
        return jnp.sum(jnp.where(jnp.isnan(Y), 0.0, ll))

    W0 = np.abs(rng.normal(1, 0.2, size=(nrows, k)))
    W0[np.triu_indices(k, k=1)] = 0
    V0 = np.abs(rng.normal(1, 0.2, size=(ncols, ndepth, k)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W0, V0)).astype(float)
    Constraints = np.concatenate([np.eye(ndepth), np.zeros((ndepth, 1))], axis=1)

    mesh = make_mesh(n_dp=2, n_mp=4)
    mod = ConstrainedNonconjugateBayesianTensorFiltering(
        nrows, ncols, ndepth, poisson_loglik, Constraints, mesh=mesh,
        nembeds=k, tf_order=1, sigma2_init=0.5, lam2_init=0.1,
        W_init=W0, V_init=V0, gass_ngrid=12, seed=7, nchains=2)
    res = mod.run_gibbs(Y, nburn=20, nthin=1, nsamples=40, verbose=False)

    Ws, Vs = res["W"], res["V"]  # (2*40, ...) chain-major
    assert Ws.shape[0] == 80
    assert np.isfinite(Ws).all() and np.isfinite(Vs).all()
    tau = np.einsum("znk,zmtk->znmt", Ws, Vs)
    assert tau.min() >= -1e-4, f"constraint violated under mesh: {tau.min()}"
    # chains actually moved
    assert not np.allclose(Vs[0], Vs[39])
    # the final carried state is still mp-sharded
    assert "mp" in str(mod.state["V"].sharding.spec)
    assert float(np.asarray(res["nan_fallbacks"]).sum()) == 0.0


@pytest.mark.slow
def test_graft_entry_hooks():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    for k, v in out.items():
        assert bool(jnp.all(jnp.isfinite(v))), k
    mod.dryrun_multichip(8)
