"""Decisive experiment for the chunk-loop slowdown (round-2 perf thread).

Observed: a Gibbs sweep dispatched back-to-back via jit(vsweep) runs ~10x
faster per sweep on the round-2 accelerator than the SAME sweep iterated inside one
compiled lax.fori_loop/scan chunk (the production run_gibbs path,
models/base.py:_get_compiled_chunks). This script pins down which
construct pays the penalty:

  dispatch   N separate device calls of jit(vsweep)    (host loop)
  fori       jit(fori_loop(N, sweep))                  (production burn chunk)
  scan       jit(scan(sweep, N))                       (production sample chunk)
  unroll     jit(python-for K sweeps) called N/K times (multi-sweep, no loop op)

All arms use the identical key schedule (fold_in on step index) and are
checksummed so XLA cannot elide the work; each arm is timed after a
warmup call of the same executable.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp


def _load_bench():
    """Load repo-root bench.py (the bench/ directory shadows it on sys.path)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_root", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "..", "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nsweeps", type=int, default=64)
    ap.add_argument("--unroll", type=int, default=8)
    ap.add_argument("--kernel", default="joint", choices=["joint", "blocked"])
    args = ap.parse_args()

    # model setup identical to bench.py
    bench = _load_bench()
    from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering

    rng = np.random.default_rng(42)
    NR, NC, ND, K = bench.NROWS, bench.NCOLS, bench.NDEPTH, bench.NEMBEDS
    W = np.abs(rng.normal(1, 0.3, size=(NR, K)))
    W[np.triu_indices(K, k=1)] = 0
    V = np.abs(rng.normal(1, 0.3, size=(NC, ND, K)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W, V)).astype(float)
    Constraints = np.concatenate([np.eye(ND), np.zeros((ND, 1))], axis=1)
    kw = dict(nembeds=K, tf_order=2, sigma2_init=0.5, lam2_init=0.1,
              gass_ngrid=100, seed=0)
    if args.kernel == "joint":
        kw["v_block_size"] = None
    else:
        kw["loglikelihood_cellfn"] = bench.poisson_cellfn
    model = ConstrainedNonconjugateBayesianTensorFiltering(
        NR, NC, ND, bench.poisson_loglik, Constraints, **kw)

    pdata = model.prepare_data(Y)
    vsweep = model._batched_sweep()
    base_key = jax.random.PRNGKey(7)
    nchains = model.nchains

    def step_keys(step):
        base = jax.random.fold_in(base_key, step)
        return jax.vmap(lambda c: jax.random.fold_in(base, c))(
            jnp.arange(nchains, dtype=jnp.uint32))

    state0 = model.state
    N = args.nsweeps
    results = {}

    def checksum(st):
        return float(sum(jnp.sum(v).item() for v in st.values()
                         if jnp.issubdtype(v.dtype, jnp.floating)))

    # --- arm 1: dispatch -------------------------------------------------
    jsweep = jax.jit(vsweep)

    def run_dispatch(st):
        for i in range(N):
            st = jsweep(st, pdata, step_keys(i))
        jax.block_until_ready(st["W"])
        return st

    t0 = time.time(); st = run_dispatch(state0); results["compile_dispatch_s"] = round(time.time() - t0, 1)
    t0 = time.time(); st = run_dispatch(state0)
    results["dispatch_ms_per_sweep"] = round((time.time() - t0) / N * 1e3, 3)
    results["checksum_dispatch"] = checksum(st)

    # --- arm 2: fori (production burn chunk, offset traced) -------------
    @jax.jit
    def fori_chunk(st, off):
        def one(i, s):
            return vsweep(s, pdata, step_keys(off + i))
        return jax.lax.fori_loop(0, N, one, st)

    t0 = time.time(); st = fori_chunk(state0, jnp.uint32(0)); jax.block_until_ready(st["W"])
    results["compile_fori_s"] = round(time.time() - t0, 1)
    t0 = time.time(); st = fori_chunk(state0, jnp.uint32(0)); jax.block_until_ready(st["W"])
    results["fori_ms_per_sweep"] = round((time.time() - t0) / N * 1e3, 3)
    results["checksum_fori"] = checksum(st)

    # --- arm 3: scan ------------------------------------------------------
    @jax.jit
    def scan_chunk(st, off):
        def body(s, i):
            return vsweep(s, pdata, step_keys(off + i)), None
        return jax.lax.scan(body, st, jnp.arange(N, dtype=jnp.uint32))[0]

    t0 = time.time(); st = scan_chunk(state0, jnp.uint32(0)); jax.block_until_ready(st["W"])
    results["compile_scan_s"] = round(time.time() - t0, 1)
    t0 = time.time(); st = scan_chunk(state0, jnp.uint32(0)); jax.block_until_ready(st["W"])
    results["scan_ms_per_sweep"] = round((time.time() - t0) / N * 1e3, 3)
    results["checksum_scan"] = checksum(st)

    # --- arm 4: unrolled multi-sweep jit ---------------------------------
    Kun = args.unroll

    @jax.jit
    def unroll_chunk(st, off):
        for i in range(Kun):
            st = vsweep(st, pdata, step_keys(off + i))
        return st

    def run_unroll(st):
        for c in range(N // Kun):
            st = unroll_chunk(st, jnp.uint32(c * Kun))
        jax.block_until_ready(st["W"])
        return st

    t0 = time.time(); st = run_unroll(state0)
    results["compile_unroll_s"] = round(time.time() - t0, 1)
    t0 = time.time(); st = run_unroll(state0)
    results["unroll_ms_per_sweep"] = round((time.time() - t0) / (N // Kun * Kun) * 1e3, 3)
    results["checksum_unroll"] = checksum(st)

    results["platform"] = jax.devices()[0].platform
    results["kernel"] = args.kernel
    results["nsweeps"] = N
    print(json.dumps(results))


if __name__ == "__main__":
    main()
