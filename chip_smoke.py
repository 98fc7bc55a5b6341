"""Smoke test of functionalmf_tpu on one NVIDIA GPU.

Drives the constrained-Poisson Gibbs sampler's production recipe once
through the public API (`run_gibbs`) at the reference's GDELT politics
width, runs the numerical building blocks on the GPU and on the CPU
backend of the same process with the same inputs, and runs each other
likelihood family for a few hundred sweeps.

    python chip_smoke.py                      # device, kernels, main, large, families
    python chip_smoke.py --phase kernels      # selected phases only (repeatable)
    python chip_smoke.py --multi              # (dp=2, mp=2) mesh on 4 GPUs vs 1 GPU

Every phase prints one line of results. The last line of standard output
is one JSON object, {"ok": true, "device": {...}}. Without a GPU, or when
any check fails, the script exits non-zero and prints no such line.
Everything runs in this one process (a second JAX process could not get
the card's memory).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("kernels", "main", "large", "families")

# GDELT politics shape (apps/politics/benchmark.py, bench.py)
GDELT = dict(nrows=19, ncols=19, ndepth=228, nembeds=5, ngrid=100)
# memory-bound shape (bench/roofline.py)
LARGE = dict(nrows=128, ncols=128, ndepth=256, nembeds=16, ngrid=64)


class CheckFailed(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def emit(tag, **fields):
    print(f"[{tag}] " + json.dumps(fields, default=float), flush=True)


# ---------------------------------------------------------------------------
# shared model pieces
# ---------------------------------------------------------------------------
def poisson_loglik(Y, WV, W, V, row=None, col=None):
    import jax.numpy as jnp
    from jax.scipy.special import gammaln
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
    """Elementwise Poisson log-likelihood, 0 on NaN, y-only terms omitted."""
    import jax.numpy as jnp
    rate = jnp.clip(tau, 1e-8, None)
    y0 = jnp.where(jnp.isnan(y), 0.0, y)
    return jnp.where(jnp.isnan(y), 0.0, y0 * jnp.log(rate) - rate)


def run_on(device, fn, *args):
    """jit `fn` on `device` at float32 matmul precision; numpy results."""
    import jax
    with jax.default_device(device), jax.default_matmul_precision("float32"):
        args = jax.device_put(args, device)
        return jax.device_get(jax.jit(fn)(*args))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# kernels: numerical building blocks, device vs reference device
# ---------------------------------------------------------------------------
def horseshoe_dtld(rng, batch, T, tf_order):
    """(batch, T, T) trend-filtering Grams D^T diag(w) D with horseshoe-range
    weights w in 1e-6..1e6."""
    from functionalmf_tpu.ops.penalty import bayes_grid_penalty
    D = np.asarray(bayes_grid_penalty(T, tf_order), np.float64)
    w = 10.0 ** rng.uniform(-6, 6, size=(batch, D.shape[0]))
    return np.einsum("dt,bd,ds->bts", D, w, D).astype(np.float32)


def _lower_matvec(L, z):
    """(L z) for block-banded lower L (..., T, p+1, k, k), z (..., T, k)."""
    import jax.numpy as jnp
    T, p1 = L.shape[-4], L.shape[-3]
    y = jnp.einsum("...tij,...tj->...ti", L[..., :, 0, :, :], z)
    for d in range(1, min(p1 - 1, T - 1) + 1):
        lo = jnp.einsum("...tij,...tj->...ti", L[..., d:, d, :, :],
                        z[..., :T - d, :])
        pad = [(0, 0)] * (y.ndim - 2) + [(d, 0), (0, 0)]
        y = y + jnp.pad(lo, pad)
    return y


def check_banded(dev, ref, batch, T, k, tf_order, seed=0):
    """Block-banded factor, solve and sample on an equilibrated V
    precision with horseshoe-range prior weights. Returns the relative
    residuals ||Qx - b|| / ||b|| per backend (max over the batch)."""
    import jax
    import jax.numpy as jnp
    from functionalmf_tpu.ops.banded import (
        block_banded_cholesky, block_banded_matvec, block_banded_solve,
        build_v_bands, equilibrate_bands, sample_mvn_block_banded)
    from functionalmf_tpu.ops.penalty import penalty_half_bandwidth

    rng = np.random.default_rng(seed)
    p = penalty_half_bandwidth(tf_order)
    DtLD = horseshoe_dtld(rng, batch, T, tf_order)
    A = rng.normal(size=(batch, T, k, k))
    G = np.einsum("btij,btkj->btik", A, A).astype(np.float32)
    b = rng.normal(size=(batch, T, k)).astype(np.float32)

    def fn(DtLD, G, b, key):
        bands, s = equilibrate_bands(build_v_bands(DtLD, G, p))
        be = b * s
        L, repaired, gersh = block_banded_cholesky(
            bands, psd_attempts=0, return_repairs=True)
        y = block_banded_solve(L, be)
        r = block_banded_matvec(bands, y) - be
        xs = sample_mvn_block_banded(key, bands, mu_part=be, psd_attempts=0)
        z = jax.random.normal(key, be.shape, be.dtype)
        rhs = be + _lower_matvec(L, z)
        rs = block_banded_matvec(bands, xs) - rhs
        nrm = lambda v: jnp.sqrt(jnp.sum(v * v, axis=(-2, -1)))  # noqa: E731
        return (jnp.max(nrm(r) / nrm(be)), jnp.max(nrm(rs) / nrm(rhs)),
                jnp.sum(repaired), jnp.sum(gersh))

    key = jax.random.PRNGKey(seed)
    out = {}
    for name, d in (("dev", dev), ("ref", ref)):
        res, res_s, rep, gersh = run_on(d, fn, DtLD, G, b, key)
        out[name] = dict(solve=float(res), sample=float(res_s),
                         repairs=float(rep), gershgorin=float(gersh))
    return out


def check_dense(dev, ref, batch, D, seed=0):
    """Batched dense Cholesky, cho_solve and MVN sampling (ops/mvn.py) on
    Jacobi-equilibrated SPD precisions with a 1e-3..1e3 diagonal range."""
    import jax
    import jax.numpy as jnp
    from functionalmf_tpu.ops.mvn import (
        _cho_solve, cholesky_psd, sample_mvn_from_precision)

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(batch, D, D))
    Q = (np.einsum("bij,bkj->bik", A, A) / D
         + np.eye(D) * 10.0 ** rng.uniform(-3, 3, size=(batch, 1, D)))
    dinv = 1.0 / np.sqrt(np.einsum("bii->bi", Q))
    Qe = (Q * dinv[:, :, None] * dinv[:, None, :]).astype(np.float32)
    b = rng.normal(size=(batch, D)).astype(np.float32)

    def fn(Qe, b, key):
        L = cholesky_psd(Qe)
        x = _cho_solve(L, b)
        r = jnp.einsum("...ij,...j->...i", Qe, x) - b
        xs = sample_mvn_from_precision(key, Qe, mu_part=b)
        z = jax.random.normal(key, b.shape, b.dtype)
        rhs = b + jnp.einsum("...ij,...j->...i", L, z)
        rs = jnp.einsum("...ij,...j->...i", Qe, xs) - rhs
        nrm = lambda v: jnp.linalg.norm(v, axis=-1)  # noqa: E731
        return jnp.max(nrm(r) / nrm(b)), jnp.max(nrm(rs) / nrm(rhs))

    key = jax.random.PRNGKey(seed)
    out = {}
    for name, d in (("dev", dev), ("ref", ref)):
        res, res_s = run_on(d, fn, Qe, b, key)
        out[name] = dict(solve=float(res), sample=float(res_s))
    return out


def check_gass(dev, ref, nrows, bs, k, ngrid, seed=0):
    """One GASS call (grid method) at a V-block width: D = bs*k coordinates,
    positivity of tau = W V_blk^T on nrows*bs cells, Poisson candidates.
    Returns the candidate log-likelihood grid and the new point's worst
    constraint margin per backend."""
    import jax
    import jax.numpy as jnp
    from functionalmf_tpu.samplers.gass import gass

    rng = np.random.default_rng(seed)
    W = np.abs(rng.normal(1, 0.3, size=(nrows, k))).astype(np.float32)
    x = np.abs(rng.normal(1, 0.3, size=(bs, k))).astype(np.float32)
    Y = rng.poisson(W @ x.T).astype(np.float32)                 # (n, bs)
    mu = np.abs(rng.normal(1, 0.3, size=(bs * k,))).astype(np.float32)
    v = rng.normal(0, 0.5, size=(bs * k,)).astype(np.float32)
    hp = jax.lax.Precision.HIGHEST

    def fn(W, x, Y, mu, v, key):
        def A_op(y):
            return jnp.dot(W, y.reshape(bs, k).T, precision=hp).reshape(-1)

        grids = []

        def loglik(c):
            tau = jnp.einsum("gtk,nk->gnt", c.reshape(-1, bs, k), W)
            ll = jnp.sum(poisson_cellfn(Y[None], tau), axis=(1, 2))
            grids.append(ll)
            return ll

        c0 = jnp.zeros((nrows * bs,), jnp.float32)
        x_new, _ = gass(key, x.reshape(-1), None, loglik, A_op, c0, mu=mu,
                        ngrid=ngrid, v=v)
        return grids[-1], jnp.min(A_op(x_new))

    key = jax.random.PRNGKey(seed)
    out = {}
    for name, d in (("dev", dev), ("ref", ref)):
        grid, margin = run_on(d, fn, W, x, Y, mu, v, key)
        out[name] = dict(grid=np.asarray(grid), margin=float(margin))
    return out


def check_pg_gamma(dev, ndraws, seed=0, nexact=200_000):
    """Moments of `ndraws` polya_gamma and gamma_mt draws on `dev` against
    the closed forms and, for PG(1|3, c), against exact draws
    (tests/pg_exact.py). Returns rows of (name, stat, got, want, tol)."""
    import jax
    import jax.numpy as jnp
    from functionalmf_tpu.ops.gamma import gamma_mt
    from functionalmf_tpu.ops.polyagamma import pg_mean, pg_var, polya_gamma
    from tests.pg_exact import exact_pg

    rows = []
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    n = ndraws
    for i, (b, c) in enumerate([(1.0, 0.5), (1.0, 2.0), (3.0, 1.0),
                                (50.0, 0.1), (200.0, 3.0)]):
        d = run_on(dev, lambda kk: polya_gamma(
            kk, jnp.full((n,), b), jnp.full((n,), c)), jax.random.fold_in(key, i))
        d = np.asarray(d, np.float64)
        m, v = float(pg_mean(b, c)), float(pg_var(b, c))
        rows.append((f"pg({b:g},{c:g})", "mean", d.mean(), m,
                     5 * np.sqrt(v / n) + 1e-4))
        # the series truncation loses a tiny tail of the variance
        rows.append((f"pg({b:g},{c:g})", "var", d.var(), v,
                     0.03 * v + 6 * v * np.sqrt(2.0 / n)))
        if b <= 3:
            e = exact_pg(rng, b, c, nexact)
            rows.append((f"pg({b:g},{c:g})", "mean_vs_exact", d.mean(),
                         e.mean(), 5 * np.sqrt(v / n + e.var() / nexact)))
    for i, a in enumerate([0.3, 1.0, 2.5, 30.0]):
        d = run_on(dev, lambda kk: gamma_mt(kk, jnp.full((n,), a)),
                   jax.random.fold_in(key, 100 + i))
        d = np.asarray(d, np.float64)
        rows.append((f"gamma({a:g})", "mean", d.mean(), a,
                     6 * np.sqrt(a / n) + 1e-3))
        rows.append((f"gamma({a:g})", "var", d.var(), a,
                     0.05 * a + 6 * a * np.sqrt(3.0 / n)))
    return rows


def phase_kernels(dev, ref):
    for T in (228, 370):
        r = check_banded(dev, ref, batch=19, T=T, k=5, tf_order=2)
        # f32 factor/solve of an equilibrated system whose prior weights
        # span 12 decades: the residual is set by conditioning, so the
        # device must match the reference backend to within 10x, with an
        # absolute floor of 1e-4
        tol = {s: max(10 * r["ref"][s], 1e-4) for s in ("solve", "sample")}
        emit("kernels", check=f"banded batch=19 T={T} k=5 p=3",
             precision="float32", residual_dev=r["dev"], residual_ref=r["ref"],
             tol=tol)
        for s in ("solve", "sample"):
            check(r["dev"][s] <= tol[s], f"banded T={T} {s} residual")
    for batch, D in ((19, 5), (19 * 29, 40)):
        r = check_dense(dev, ref, batch=batch, D=D)
        tol = {s: max(10 * r["ref"][s], 1e-5) for s in ("solve", "sample")}
        emit("kernels", check=f"dense chol/mvn ({batch},{D},{D})",
             precision="float32", residual_dev=r["dev"], residual_ref=r["ref"],
             tol=tol)
        for s in ("solve", "sample"):
            check(r["dev"][s] <= tol[s], f"dense ({batch},{D}) {s} residual")
    g = check_gass(dev, ref, nrows=19, bs=8, k=5, ngrid=100)
    # candidate grids: sums of 152 f32 cell terms; both backends at
    # float32, so they agree to a few ulps of the largest |ll|
    grid_rel = float(np.max(np.abs(g["dev"]["grid"] - g["ref"]["grid"]))
                     / np.max(np.abs(g["ref"]["grid"])))
    emit("kernels", check="gass grid D=40 (n=19, bs=8, k=5) ngrid=100",
         precision="float32", grid_max_rel_diff=grid_rel, grid_tol=1e-5,
         margin_dev=g["dev"]["margin"], margin_ref=g["ref"]["margin"],
         margin_tol=-1e-6)
    check(grid_rel <= 1e-5, "gass candidate grids differ")
    for s in ("dev", "ref"):
        check(g[s]["margin"] >= -1e-6, f"gass result infeasible on {s}")
    rows = check_pg_gamma(dev, ndraws=1_000_000)
    bad = [r for r in rows if not abs(r[2] - r[3]) <= r[4]]
    emit("kernels", check="polya_gamma/gamma_mt moments, 1e6 draws",
         rows=[dict(dist=r[0], stat=r[1], got=r[2], want=r[3], tol=r[4])
               for r in rows])
    check(not bad, f"moment checks failed: {bad}")


# ---------------------------------------------------------------------------
# main / large: the production recipe through run_gibbs
# ---------------------------------------------------------------------------
def gdelt_data(nrows, ncols, ndepth, nembeds, seed=42, hold_frac=0.1):
    """Synthetic GDELT-shaped counts as in bench.py: truth W, V ~ |N(1,.3)|,
    Y ~ Poisson(W V^T), hold_frac of the (row, col) curves held out, and a
    feasible warm start W0, V0 ~ |N(1,.2)|."""
    rng = np.random.default_rng(seed)
    k = nembeds
    W = np.abs(rng.normal(1, 0.3, size=(nrows, k)))
    W[np.triu_indices(k, k=1)] = 0
    V = np.abs(rng.normal(1, 0.3, size=(ncols, ndepth, k)))
    Mu = np.einsum("nk,mtk->nmt", W, V)
    Y = rng.poisson(Mu).astype(np.float64)
    hold = rng.random((nrows, ncols)) < hold_frac
    Y[hold] = np.nan
    W0 = np.abs(rng.normal(1, 0.2, size=(nrows, k)))
    W0[np.triu_indices(k, k=1)] = 0
    V0 = np.abs(rng.normal(1, 0.2, size=(ncols, ndepth, k)))
    return dict(Y=Y, Mu=Mu, hold=hold, W0=W0, V0=V0)


def production_model(nrows, ncols, ndepth, nembeds, ngrid, W0, V0,
                     nchains=1, mesh=None):
    """The flagship recipe: red-black V schedule, a cellfn, interweave
    with per-factor rebalance, tf_order=2, positivity constraints."""
    from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering
    C = np.concatenate([np.eye(ndepth), np.zeros((ndepth, 1))], axis=1)
    return ConstrainedNonconjugateBayesianTensorFiltering(
        nrows, ncols, ndepth, poisson_loglik, C, nembeds=nembeds,
        tf_order=2, sigma2_init=0.5, lam2_init=0.1, W_init=W0, V_init=V0,
        gass_ngrid=ngrid, seed=0, nchains=nchains, mesh=mesh,
        v_schedule="redblack", loglikelihood_cellfn=poisson_cellfn)


def timed_runs(model, data, nburn, nsamples):
    """Two identical run_gibbs calls: the first compiles, the second runs
    the cached executables. Returns (results of the second, compile_s,
    sweeps_per_s)."""
    t0 = time.perf_counter()
    model.run_gibbs(data, nburn=nburn, nthin=1, nsamples=nsamples,
                    verbose=False)
    t1 = time.perf_counter()
    res = model.run_gibbs(data, nburn=nburn, nthin=1, nsamples=nsamples,
                          verbose=False)
    t2 = time.perf_counter()
    return res, (t1 - t0) - (t2 - t1), (nburn + nsamples) / (t2 - t1)


def mu_draw_stats(W, V, chunk=128):
    """(min over draws of Mu = W V^T, posterior mean of Mu) on the host."""
    lo = np.inf
    total = 0.0
    for s in range(0, W.shape[0], chunk):
        mu = np.einsum("znk,zmtk->znmt", W[s:s + chunk], V[s:s + chunk],
                       optimize=True)
        lo = min(lo, float(mu.min()))
        total = total + mu.sum(axis=0)
    return lo, total / W.shape[0]


def heldout_rmse(mu_hat, data):
    """RMSE on the held-out curves of the posterior-mean Mu, the warm start,
    and the observed-data global mean, all against the generating Mu."""
    hold = data["hold"]
    truth = data["Mu"][hold]
    mu0 = np.einsum("nk,mtk->nmt", data["W0"], data["V0"])[hold]
    naive = np.nanmean(data["Y"])
    rm = lambda a: float(np.sqrt(np.mean((a - truth) ** 2)))  # noqa: E731
    return rm(mu_hat[hold]), rm(mu0), rm(np.full_like(truth, naive))


# Held-out accuracy bound: the posterior mean must beat both the warm start
# it began from and the global-mean predictor by this factor (a chain that
# did not move, or learned no structure, scores ~1.0 on one of them).
RMSE_FACTOR = 0.8


def check_production(tag, res, data, nchains):
    for key in ("W", "V", "sigma2", "lam2", "Tau2"):
        check(np.isfinite(res[key]).all(), f"{tag}: non-finite {key} draws")
    fb = float(np.asarray(res["nan_fallbacks"]).sum())
    check(fb == 0, f"{tag}: nan_fallbacks={fb}")
    lo, mu_hat = mu_draw_stats(np.asarray(res["W"]), np.asarray(res["V"]))
    check(lo >= -1e-5, f"{tag}: a Mu draw violates positivity ({lo})")
    rmse, rmse0, rmse_naive = heldout_rmse(mu_hat, data)
    check(rmse <= RMSE_FACTOR * min(rmse0, rmse_naive),
          f"{tag}: held-out RMSE {rmse} vs warm start {rmse0} / "
          f"global mean {rmse_naive}")
    return dict(min_mu=lo, nan_fallbacks=fb, heldout_rmse=rmse,
                rmse_warm_start=rmse0, rmse_global_mean=rmse_naive,
                rmse_bound=RMSE_FACTOR * min(rmse0, rmse_naive),
                rhat_max=res.get("rhat", {}).get("max") if nchains > 1
                else None)


def peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_production(phase, dev, shape, nchains, nburn, nsamples):
    data = gdelt_data(shape["nrows"], shape["ncols"], shape["ndepth"],
                      shape["nembeds"])
    model = production_model(shape["nrows"], shape["ncols"], shape["ndepth"],
                             shape["nembeds"], shape["ngrid"], data["W0"],
                             data["V0"], nchains=nchains)
    res, compile_s, sps = timed_runs(model, data["Y"], nburn, nsamples)
    stats = check_production(f"{phase} nchains={nchains}", res, data,
                             nchains)
    emit(phase, shape="{nrows}x{ncols}x{ndepth} k={nembeds} "
         "ngrid={ngrid}".format(**shape), nchains=nchains, nburn=nburn,
         nsamples=nsamples, compile_s=compile_s, sweeps_per_s=sps,
         chain_sweeps_per_s=sps * nchains, peak_bytes_in_use=peak_bytes(dev),
         **stats)


def phase_main(dev):
    run_production("main", dev, GDELT, nchains=1, nburn=300, nsamples=200)
    run_production("main", dev, GDELT, nchains=32, nburn=200, nsamples=100)


def phase_large(dev):
    # sampling sweeps only: one chunk executable to compile, not two
    run_production("large", dev, LARGE, nchains=1, nburn=0, nsamples=40)


# ---------------------------------------------------------------------------
# families: the other likelihoods through run_gibbs
# ---------------------------------------------------------------------------
def family_models(seed=0, flu=(50, 1, 370), gdelt=GDELT):
    """(name, model, data) for the Gaussian (flu-trends shape) and the
    Binomial, NegBinom and ESS-nonconjugate models (GDELT shape)."""
    import functionalmf_tpu as fmf
    rng = np.random.default_rng(seed)
    out = []

    (n, m, T), k = flu, gdelt["nembeds"]
    t = np.linspace(0, 1, T)
    V = np.stack([np.sin(2 * np.pi * (a + 1) * t + a) for a in range(k)],
                 axis=-1)[None]                                  # (1, T, k)
    W = rng.normal(size=(n, k))
    Y = np.einsum("nk,mtk->nmt", W, V) + rng.normal(0, 0.3, size=(n, m, T))
    out.append((f"gaussian {n}x{m}x{T}", fmf.GaussianBayesianTensorFiltering(
        n, m, T, nembeds=k, tf_order=2, seed=seed), Y))

    n, m, T = gdelt["nrows"], gdelt["ncols"], gdelt["ndepth"]
    shape = f"{n}x{m}x{T}"
    W = rng.normal(0, 0.5, size=(n, k))
    V = rng.normal(0, 0.5, size=(m, T, k))
    psi = np.einsum("nk,mtk->nmt", W, V)
    N = rng.integers(1, 30, size=psi.shape).astype(np.float64)
    Yb = rng.binomial(N.astype(int), 1 / (1 + np.exp(-psi))).astype(float)
    out.append((f"binomial (Y,N) {shape}",
                fmf.BinomialBayesianTensorFiltering(
                    n, m, T, nembeds=k, tf_order=2, seed=seed), (Yb, N)))

    d = gdelt_data(n, m, T, k, seed=seed + 1)
    out.append((f"negbinom {shape}",
                fmf.NegativeBinomialBayesianTensorFiltering(
                    n, m, T, nembeds=k, tf_order=2, seed=seed), d["Y"]))

    def ess_loglik(W, V, Yd):
        import jax.numpy as jnp
        tau = jnp.einsum("nk,mtk->nmt", W, V)
        return jnp.sum(poisson_cellfn(Yd, jnp.abs(tau)))
    out.append((f"nonconjugate ess {shape}",
                fmf.NonconjugateBayesianTensorFiltering(
                    n, m, T, ess_loglik, nembeds=k, tf_order=2,
                    W_init=d["W0"], V_init=d["V0"], sigma2_init=0.5,
                    lam2_init=0.1, seed=seed), d["Y"]))
    return out


def phase_families(dev, nburn=0, nsamples=300, **shapes):
    for name, model, data in family_models(**shapes):
        res, compile_s, sps = timed_runs(model, data, nburn, nsamples)
        # nu2 = 1/omega is +inf by construction on missing cells
        for key in set(model._collect_keys) - {"nu2"}:
            check(np.isfinite(res[key]).all(), f"{name}: non-finite {key}")
        fb = float(np.asarray(res["nan_fallbacks"]).sum())
        check(fb == 0, f"{name}: nan_fallbacks={fb}")
        emit("families", model=name, nburn=nburn, nsamples=nsamples,
             compile_s=compile_s, sweeps_per_s=sps, nan_fallbacks=fb,
             pivot_repairs=float(np.asarray(res["pivot_repairs"]).sum()),
             peak_bytes_in_use=peak_bytes(dev))


# ---------------------------------------------------------------------------
# --multi: (dp=2, mp=2) mesh over 4 cards vs the same seed on one card
# ---------------------------------------------------------------------------
MULTI = dict(nrows=20, ncols=20, ndepth=228, nembeds=5, ngrid=100)


def phase_multi(devices, nsweeps=100, shape=MULTI):
    import jax
    from functionalmf_tpu.parallel.mesh import make_mesh
    data = gdelt_data(shape["nrows"], shape["ncols"], shape["ndepth"],
                      shape["nembeds"])
    runs = {}
    for tag in ("mesh", "single"):
        mesh = (make_mesh(n_dp=2, n_mp=2, devices=devices[:4])
                if tag == "mesh" else None)
        model = production_model(shape["nrows"], shape["ncols"],
                                 shape["ndepth"], shape["nembeds"],
                                 shape["ngrid"], data["W0"], data["V0"],
                                 nchains=4, mesh=mesh)
        with jax.default_device(devices[0]):
            t0 = time.perf_counter()
            res = model.run_gibbs(data["Y"], nburn=0, nthin=1,
                                  nsamples=nsweeps, verbose=False)
            dt = time.perf_counter() - t0
        check(np.isfinite(res["W"]).all() and np.isfinite(res["V"]).all(),
              f"multi {tag}: non-finite draws")
        fb = float(np.asarray(res["nan_fallbacks"]).sum())
        check(fb == 0, f"multi {tag}: nan_fallbacks={fb}")
        lo, mu_hat = mu_draw_stats(np.asarray(res["W"]), np.asarray(res["V"]))
        check(lo >= -1e-5, f"multi {tag}: positivity violated ({lo})")
        runs[tag] = dict(res=res, wall_s=dt, mu_hat=mu_hat,
                         sharding=str(model.state["V"].sharding))
    a, b = runs["mesh"]["res"], runs["single"]["res"]
    # draws arrive chain-major: (4 * nsweeps, ...) -> (4, nsweeps, ...)
    Wa = np.asarray(a["W"]).reshape(4, nsweeps, -1)
    Wb = np.asarray(b["W"]).reshape(4, nsweeps, -1)
    Va = np.asarray(a["V"]).reshape(4, nsweeps, -1)
    Vb = np.asarray(b["V"]).reshape(4, nsweeps, -1)
    equal = [bool(np.array_equal(Wa[:, s], Wb[:, s])
                  and np.array_equal(Va[:, s], Vb[:, s]))
             for s in range(nsweeps)]
    close = [bool(np.allclose(Wa[:, s], Wb[:, s], rtol=1e-3, atol=1e-3)
                  and np.allclose(Va[:, s], Vb[:, s], rtol=1e-3, atol=1e-3))
             for s in range(nsweeps)]
    first_far = next((s for s, c in enumerate(close) if not c), None)
    mean_rel = _rel(runs["mesh"]["mu_hat"], runs["single"]["mu_hat"])
    emit("multi", shape="{nrows}x{ncols}x{ndepth} k={nembeds} "
         "ngrid={ngrid}".format(**shape), mesh="dp=2 mp=2",
         nchains=4, nsweeps=nsweeps,
         bit_equal_draws=int(sum(equal)), close_draws_1e3=int(sum(close)),
         first_draw_beyond_1e3=first_far, posterior_mean_rel_diff=mean_rel,
         wall_s_mesh=runs["mesh"]["wall_s"],
         wall_s_single=runs["single"]["wall_s"],
         v_sharding_mesh=runs["mesh"]["sharding"])
    # over 1-2 sweeps the partitioned program computes the same function up
    # to float reassociation (tests/test_parallel.py uses the same 1e-3);
    # later draws may decorrelate chaotically, so they are reported only
    check(close[0], "multi: first draw differs between mesh and one card")
    check(mean_rel < 0.1, f"multi: posterior means differ ({mean_rel})")


# ---------------------------------------------------------------------------
def gpu_name_and_power():
    """`nvidia-smi` name and power limit, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU (dp=2, mp=2) mesh comparison")
    ap.add_argument("--phase", action="append", choices=PHASES,
                    help="run only this phase (repeatable)")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    from functionalmf_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (default backend: {dev.platform})",
              file=sys.stderr)
        return 1
    ngpu = 4 if args.multi else 1
    if len(devices) < ngpu:
        print(f"chip_smoke: needs {ngpu} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    emit("device", platform=dev.platform, kind=dev.device_kind,
         count=len(devices), nvidia_smi=gpu_name_and_power(),
         jax=jax.__version__)

    if args.multi:
        phase_multi(devices)
    else:
        ref = jax.devices("cpu")[0]
        phases = args.phase or PHASES
        t_all = time.perf_counter()
        for name in phases:
            t0 = time.perf_counter()
            if name == "kernels":
                phase_kernels(dev, ref)
            elif name == "main":
                phase_main(dev)
            elif name == "large":
                phase_large(dev)
            else:
                phase_families(dev)
            emit("time", phase=name, wall_s=time.perf_counter() - t0)
        emit("time", phase="all", wall_s=time.perf_counter() - t_all)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
