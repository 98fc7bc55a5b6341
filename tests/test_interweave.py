"""ASIS interweaving of global scales + the collapsed likelihood contract.

Round-5 additions (VERDICT round-4 items 2 and 4):
  * samplers/slice1d.shrink_slice_1d — exact 1-D shrinkage slice kernel;
  * ConstrainedNonconjugateBTF(interweave=True) — ancillary re-draws of
    lam2 (V-scale) and sigma2 (W-scale) after the conjugate updates,
    attacking the slowest-mixing parameter of every headline number
    (min ESS/sweep 0.003 on lam2, BENCH_r04; the reference's own TODO at
    functionalmf/factor.py:144-146);
  * loglikelihood_cells / loglikelihood_block derivation from a single
    loglikelihood_cellfn (one opt-in instead of three hand-synchronized
    likelihood variants).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.scipy.special import gammaln
from scipy import stats

from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering
from functionalmf_tpu.samplers.slice1d import shrink_slice_1d


# ---------------------------------------------------------------------------
# slice kernel
# ---------------------------------------------------------------------------
def test_shrink_slice_truncated_normal(key):
    """Chain of shrink_slice_1d updates targets the exact truncated normal:
    KS test of the chain's marginal against the analytic CDF."""
    lo, hi = -1.0, 2.0

    def logdens(x):
        return -0.5 * x * x

    @jax.jit
    def step(carry, k):
        x, _ = carry
        x, acc = shrink_slice_1d(k, x, logdens, lo, hi)
        return (x, acc), x

    keys = jax.random.split(key, 4000)
    (_, _), xs = jax.lax.scan(step, (jnp.asarray(0.3), jnp.zeros((), bool)),
                              keys)
    xs = np.asarray(xs)[500::5]  # burn + thin (slice chains mix fast)
    assert xs.min() >= lo and xs.max() <= hi
    cdf = stats.truncnorm(lo, hi).cdf
    ks = stats.kstest(xs, cdf)
    assert ks.pvalue > 0.01, (ks, xs.mean(), xs.std())


def test_shrink_slice_stays_put_on_cap(key):
    """With max_shrink=0 the move must degrade to stay-put."""
    x, acc = shrink_slice_1d(key, jnp.asarray(0.5),
                             lambda x: -x * x, 0.0, 1.0, max_shrink=0)
    assert float(x) == 0.5 and not bool(acc)


# ---------------------------------------------------------------------------
# shared toy problem
# ---------------------------------------------------------------------------
NE = 2
N_, M_, T_ = 6, 5, 11


def poisson_loglik(Y, WV, W, V, row=None, col=None):
    if row is not None:
        Y = Y[row]
    if col is not None:
        Y = Y[:, col]
    if Y.ndim > WV.ndim:
        WV = WV[..., None]
    rate = jnp.clip(WV, 1e-8, None)
    Y0 = jnp.where(jnp.isnan(Y), 0.0, Y)
    ll = Y0 * jnp.log(rate) - rate - gammaln(Y0 + 1.0)
    return jnp.sum(jnp.where(jnp.isnan(Y), 0.0, ll))


def poisson_cellfn(y, tau):
    # elementwise contract: 0 on NaN, y-only terms omitted
    rate = jnp.clip(tau, 1e-8, None)
    y0 = jnp.where(jnp.isnan(y), 0.0, y)
    return jnp.where(jnp.isnan(y), 0.0, y0 * jnp.log(rate) - rate)


def _toy(seed=5):
    rng = np.random.default_rng(seed)
    W = rng.gamma(1, 1, (N_, NE))
    W[np.triu_indices(NE, 1)] = 0
    V = np.abs(rng.normal(1, .3, (M_, T_, NE)))
    Mu = np.einsum("nk,mtk->nmt", W, V)
    Y = rng.poisson(Mu).astype(float)
    Y[0, 0] = np.nan
    C = np.concatenate([np.eye(T_), np.zeros((T_, 1))], axis=1)
    W0 = np.abs(rng.normal(1, .2, (N_, NE)))
    W0[np.triu_indices(NE, 1)] = 0
    V0 = np.abs(rng.normal(1, .2, (M_, T_, NE)))
    return W, V, Mu, Y, C, W0, V0


# ---------------------------------------------------------------------------
# interweaving
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_interweave_preserves_posterior_mean(rng):
    """interweave=True targets the same posterior. The identified
    quantity — the rate tensor Mu = W V^T — must agree between the two
    samplers to MC error, and every draw stays feasible. (The lam2 /
    sigma2 MARGINALS cannot be compared this way: the W<->V scale split
    is weakly identified, and WITHOUT the interweave moves the chain
    explores only a sliver of the wide scale marginals — measured sd of
    log lam2 0.9 vs the true ~2.2 — which is precisely the pathology the
    moves fix. Their exactness is established against a KNOWN target in
    test_interweave_exact_on_prior_target below.)"""
    W, V, Mu, Y, C, W0, V0 = _toy()
    res = {}
    for iw in (False, True):
        mod = ConstrainedNonconjugateBayesianTensorFiltering(
            N_, M_, T_, poisson_loglik, C, nembeds=NE, tf_order=0,
            sigma2_init=0.5, lam2_init=0.1, W_init=W0, V_init=V0,
            gass_ngrid=40, v_block_size=3, seed=7, interweave=iw)
        r = mod.run_gibbs(Y, nburn=600, nthin=1, nsamples=800, verbose=False)
        mu = np.einsum("znk,zmtk->znmt", r["W"], r["V"])
        assert mu.min() >= -1e-5, mu.min()  # feasibility of every draw
        assert mod.check_constraints()
        res[iw] = mu.mean(0)
    scale = np.sqrt((Mu ** 2).mean())
    rel = np.abs(res[False] - res[True]).mean() / scale
    assert rel < 0.12, rel


@pytest.mark.slow
def test_interweave_exact_on_prior_target(rng):
    """Exactness of the full move set (GASS + collapsed scale-split
    rebalance + AA scale moves) against a KNOWN target: with
    loglikelihood == 0 and a vacuous constraint the posterior IS the
    prior, whose scale marginals are directly samplable — lam2 is a
    clipped half-Cauchy^2 (horseshoe ladder), sigma2 an IG(3, 3). The
    chain's log-scale quantiles must match direct prior draws."""
    def zero_ll(Y, WV, W, V, row=None, col=None):
        return jnp.zeros(())

    C = np.concatenate([np.zeros((1, T_)), -np.ones((1, 1))], axis=1)
    mod = ConstrainedNonconjugateBayesianTensorFiltering(
        N_, M_, T_, zero_ll, C, nembeds=NE, tf_order=0,
        sigma2_a=3.0, sigma2_b=3.0, gass_ngrid=40, v_block_size=3,
        seed=31, interweave=True)
    r = mod.run_gibbs(None, nburn=500, nthin=3, nsamples=1200,
                      verbose=False)
    lam2 = np.log(r["lam2"].reshape(-1))
    sig2 = np.log(r["sigma2"].reshape(-1))

    # direct prior draws
    g = np.random.default_rng(0)
    n = 200_000
    hc2 = (np.abs(g.standard_cauchy(n)) ** 2)  # half-Cauchy^2 == IG ladder
    hc2 = np.maximum(hc2, 1e-5)  # the sampler's lam2_min clamp
    ig = 3.0 / g.gamma(3.0, size=n)            # IG(3, 3)
    for chain, direct, tol in ((lam2, np.log(hc2), 0.45),
                               (sig2, np.log(ig), 0.35)):
        for q in (0.25, 0.5, 0.75):
            a, b = np.quantile(chain, q), np.quantile(direct, q)
            assert abs(a - b) < tol, (q, a, b)


@pytest.mark.slow
def test_interweave_multiplies_lam2_ess(rng):
    """The point of the moves: lam2's ESS must improve by a large factor
    (the conjugate draw alone leaves lam2 random-walking the
    weakly-identified W<->V scale split; measured 6.9 -> ~108 here)."""
    from functionalmf_tpu.utils.diagnostics import effective_sample_size
    W, V, Mu, Y, C, W0, V0 = _toy(seed=3)
    ess = {}
    for iw in (False, True):
        mod = ConstrainedNonconjugateBayesianTensorFiltering(
            N_, M_, T_, poisson_loglik, C, nembeds=NE, tf_order=0,
            sigma2_init=0.5, lam2_init=0.1, W_init=W0, V_init=V0,
            gass_ngrid=40, v_block_size=3, seed=19, interweave=iw)
        r = mod.run_gibbs(Y, nburn=400, nthin=1, nsamples=600, verbose=False)
        ess[iw] = effective_sample_size(np.log(r["lam2"].reshape(-1)))
    assert ess[True] > 3.0 * ess[False], ess


def test_interweave_feasible_with_row_constraints(rng):
    """sigma2's AA move rescales W, which rescales the Row_constraints
    values too — the feasibility interval must account for them."""
    W, V, Mu, Y, C, W0, V0 = _toy(seed=11)
    RC = np.concatenate([np.eye(NE), np.zeros((NE, 1))], axis=1)  # w >= 0
    mod = ConstrainedNonconjugateBayesianTensorFiltering(
        N_, M_, T_, poisson_loglik, C, nembeds=NE, tf_order=0,
        sigma2_init=0.5, lam2_init=0.1, W_init=W0, V_init=V0,
        gass_ngrid=32, v_block_size=3, seed=23, interweave=True,
        Row_constraints=RC)
    r = mod.run_gibbs(Y, nburn=60, nthin=1, nsamples=60, verbose=False)
    mu = np.einsum("znk,zmtk->znmt", r["W"], r["V"])
    assert mu.min() >= -1e-5
    assert r["W"].min() >= -1e-5  # row constraints held at every draw
    assert mod.check_constraints()


def test_factor_rebalance_feasible_with_mixed_row_constraints(rng):
    """The per-factor rebalance scales ONE column of W; a row constraint
    mixing factors (here w0 - w1 >= -0.5) is affine in that scale, so the
    feasibility interval must be computed per factor."""
    W, V, Mu, Y, C, W0, V0 = _toy(seed=17)
    RC = np.array([[1.0, 0.0, 0.0],       # w0 >= 0
                   [0.0, 1.0, 0.0],       # w1 >= 0
                   [1.0, -1.0, -3.0]])    # w0 - w1 >= -3
    # start feasible for the mixed row
    assert (W0[:, 0] - W0[:, 1] >= -3).all()
    mod = ConstrainedNonconjugateBayesianTensorFiltering(
        N_, M_, T_, poisson_loglik, C, nembeds=NE, tf_order=0,
        sigma2_init=0.5, lam2_init=0.1, W_init=W0, V_init=V0,
        gass_ngrid=32, v_block_size=3, seed=41, interweave=True,
        Row_constraints=RC)
    r = mod.run_gibbs(Y, nburn=60, nthin=1, nsamples=60, verbose=False)
    Wd = r["W"].reshape(-1, NE)
    assert Wd.min() >= -1e-5
    assert (Wd[:, 0] - Wd[:, 1] >= -3 - 1e-4).all()
    assert mod.check_constraints()


@pytest.mark.slow
def test_factor_rebalance_multiplies_split_ess(rng):
    """The per-factor move's target direction: the RELATIVE scale of the
    rank-1 factors, log ||V[:,:,0]||^2 / ||V[:,:,1]||^2, is
    likelihood-invariant and random-walks without the move (measured ESS
    3.2 -> 10.2 here); the identified Mu must agree on/off."""
    from functionalmf_tpu.utils.diagnostics import effective_sample_size
    W, V, Mu, Y, C, W0, V0 = _toy(seed=5)
    out = {}
    for fr in (False, True):
        mod = ConstrainedNonconjugateBayesianTensorFiltering(
            N_, M_, T_, poisson_loglik, C, nembeds=NE, tf_order=0,
            sigma2_init=0.5, lam2_init=0.1, W_init=W0, V_init=V0,
            gass_ngrid=40, v_block_size=3, seed=7, factor_rebalance=fr)
        r = mod.run_gibbs(Y, nburn=600, nthin=1, nsamples=800,
                          verbose=False)
        mu = np.einsum("znk,zmtk->znmt", r["W"], r["V"])
        assert mu.min() >= -1e-5 and mod.check_constraints()
        split = np.log((r["V"][..., 0] ** 2).sum(axis=(1, 2))
                       / (r["V"][..., 1] ** 2).sum(axis=(1, 2)))
        out[fr] = (mu.mean(0), effective_sample_size(split))
    rel = (np.abs(out[False][0] - out[True][0]).mean()
           / np.sqrt((Mu ** 2).mean()))
    assert rel < 0.12, rel
    assert out[True][1] > 2.0 * out[False][1], (out[False][1], out[True][1])


def test_interweave_respects_fixed_scales(rng):
    """lam2_true / sigma2_true must stay exactly fixed (no AA move)."""
    W, V, Mu, Y, C, W0, V0 = _toy(seed=13)
    mod = ConstrainedNonconjugateBayesianTensorFiltering(
        N_, M_, T_, poisson_loglik, C, nembeds=NE, tf_order=0,
        sigma2_true=0.5, lam2_true=0.1, W_init=W0, V_init=V0,
        gass_ngrid=32, v_block_size=3, seed=29, interweave=True)
    r = mod.run_gibbs(Y, nburn=30, nthin=1, nsamples=20, verbose=False)
    assert np.all(r["lam2"] == np.float32(0.1))
    assert np.all(r["sigma2"] == np.float32(0.5))


# ---------------------------------------------------------------------------
# collapsed likelihood contract
# ---------------------------------------------------------------------------
def test_derived_cells_and_block_values(rng):
    """The derived loglikelihood_cells/_block equal a direct cell sum."""
    from functionalmf_tpu.models.constrained import (
        _cells_from_cellfn, _block_from_cells)
    Y = rng.poisson(2.0, size=(4, 3, 9)).astype(float)
    Y[1, 2, 4] = np.nan
    tau = np.abs(rng.normal(1, .3, (4, 4)))  # (nrows, size)
    cells = _cells_from_cellfn(poisson_cellfn)
    block = _block_from_cells(cells)
    got = float(cells(jnp.asarray(Y), jnp.asarray(tau), None, None,
                      col=1, t0=2, size=4))
    want = float(np.nansum(np.where(
        np.isnan(Y[:, 1, 2:6]), 0.0,
        np.nan_to_num(Y[:, 1, 2:6]) * np.log(np.clip(tau, 1e-8, None))
        - tau)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got_b = float(block(jnp.asarray(Y), jnp.asarray(tau), None, None,
                        col=1, tslice=(2, 6)))
    np.testing.assert_allclose(got_b, got, rtol=1e-6)

    # structured (multi-leaf) data must raise a clear error
    with pytest.raises(TypeError, match="single-tensor"):
        cells((jnp.asarray(Y), jnp.asarray(Y)), jnp.asarray(tau), None,
              None, col=1, t0=2, size=4)


@pytest.mark.slow
def test_cellfn_only_redblack_matches_sequential(rng):
    """A model constructed with ONLY (loglikelihood, cellfn) — no
    hand-written cells/block — runs both blocked schedules and targets the
    same posterior."""
    W, V, Mu, Y, C, W0, V0 = _toy(seed=21)
    means = {}
    for sched in ("seq", "redblack"):
        mod = ConstrainedNonconjugateBayesianTensorFiltering(
            N_, M_, T_, poisson_loglik, C, nembeds=NE, tf_order=0,
            sigma2_init=0.5, lam2_init=0.1, W_init=W0, V_init=V0,
            gass_ngrid=40, v_block_size=3, seed=7, v_schedule=sched,
            loglikelihood_cellfn=poisson_cellfn)
        assert mod.loglikelihood_cells is not None   # derived
        assert mod.loglikelihood_block is not None   # derived
        r = mod.run_gibbs(Y, nburn=600, nthin=1, nsamples=600,
                          verbose=False)
        mu = np.einsum("znk,zmtk->znmt", r["W"], r["V"])
        assert mu.min() >= -1e-5
        means[sched] = mu.mean(0)
    rel = (np.abs(means["seq"] - means["redblack"]).mean()
           / np.sqrt((Mu ** 2).mean()))
    assert rel < 0.12, rel

