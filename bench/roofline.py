"""Roofline run of the constrained-Poisson sweep at a memory-bound shape.

The GDELT-shape sweep is latency-bound because the tensors are tiny. This
bench runs the sweep at a shape that can load the device (default
256x256x512, k=16) and reports achieved FLOP/s and memory bandwidth
against the device's published peaks (bench/peaks.py), plus per-block
ablations. Exits non-zero off the GPU.

Usage: python bench/roofline.py [--nrows 256 --ncols 256 --ndepth 512
                                 --nembeds 16 --ngrid 64 --nreps 16]
Writes bench/roofline.json.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from peaks import peaks_for  # noqa: E402

from functionalmf_tpu.utils.cache import enable_compilation_cache  # noqa: E402
enable_compilation_cache()

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering

def poisson_loglik(Y, WV, W, V, row=None, col=None):
    if row is not None:
        Y = Y[row]
    if col is not None:
        Y = Y[:, col]
    rate = jnp.clip(WV, 1e-8, None)
    Y0 = jnp.where(jnp.isnan(Y), 0.0, Y)
    ll = Y0 * jnp.log(rate) - rate - gammaln(Y0 + 1.0)
    return jnp.sum(jnp.where(jnp.isnan(Y), 0.0, ll))


def poisson_cellfn(y, tau):
    # elementwise contract (0 on NaN, y-only terms omitted); cells/block
    # derive from it (models/constrained.py)
    rate = jnp.clip(tau, 1e-8, None)
    y0 = jnp.where(jnp.isnan(y), 0.0, y)
    return jnp.where(jnp.isnan(y), 0.0, y0 * jnp.log(rate) - rate)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nrows", type=int, default=256)
    ap.add_argument("--ncols", type=int, default=256)
    ap.add_argument("--ndepth", type=int, default=512)
    ap.add_argument("--nembeds", type=int, default=16)
    ap.add_argument("--ngrid", type=int, default=64)
    ap.add_argument("--nreps", type=int, default=16)
    ap.add_argument("--v-block-size", type=int, default=None,
                    help="defaults to the model's heuristic")
    ap.add_argument("--v-schedule", default="blocked",
                    choices=["blocked", "redblack"],
                    help="redblack batches all same-color time blocks "
                         "across all columns into one GASS call "
                         "(2-3 rounds/sweep instead of T/bs)")
    ap.add_argument("--data-dtype", default="f32",
                    choices=["f32", "f16", "bf16"],
                    help="storage dtype of the prepared data tensor: f16 "
                         "halves the likelihood passes' HBM reads (the "
                         "dominant traffic here; counts <= 2048 exact)")
    ap.add_argument("--nchains", type=int, default=1,
                    help="vmapped chain batch at this shape (does the "
                         "memory-bound regime amortize like GDELT did?)")
    ap.add_argument("--no-interweave", action="store_true",
                    help="disable the ASIS scale moves (round-4 "
                         "comparability: r4 rooflines had no interweave)")
    ap.add_argument("--tag", default=None, help="output filename suffix")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"roofline.py: no GPU (default backend: {dev.platform})")
    peaks = peaks_for(dev.device_kind)

    n, m, T, k = args.nrows, args.ncols, args.ndepth, args.nembeds
    rng = np.random.default_rng(42)
    W0 = np.abs(rng.normal(1, 0.2, size=(n, k)))
    W0[np.triu_indices(k, k=1)] = 0
    V0 = np.abs(rng.normal(1, 0.2, size=(m, T, k)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W0, V0)).astype(np.float32)
    Constraints = np.concatenate([np.eye(T), np.zeros((T, 1))], axis=1)

    kwargs = dict(loglikelihood_cellfn=poisson_cellfn)
    if args.v_schedule == "redblack":
        kwargs.update(v_schedule="redblack")
    if args.v_block_size is not None:
        kwargs["v_block_size"] = args.v_block_size
    if args.data_dtype != "f32":
        kwargs["data_dtype"] = dict(f16=jnp.float16,
                                    bf16=jnp.bfloat16)[args.data_dtype]
    if args.no_interweave:
        kwargs["interweave"] = False
    nch = args.nchains
    model = ConstrainedNonconjugateBayesianTensorFiltering(
        n, m, T, poisson_loglik, Constraints, nembeds=k, tf_order=2,
        sigma2_init=0.5, lam2_init=0.1, W_init=W0, V_init=V0,
        gass_ngrid=args.ngrid, seed=0, nchains=nch, **kwargs)

    pdata = model.prepare_data(Y)
    base_keys = jnp.arange(nch, dtype=jnp.uint32)

    def make_sweep():
        vsweep = model._batched_sweep()

        def sweep(st, pd, key):
            ks = jax.vmap(lambda c: jax.random.fold_in(key, c))(base_keys)
            return vsweep(st, pd, ks)
        return jax.jit(sweep)

    sweep = make_sweep()
    state0 = dict(model.state)
    keys = [jax.random.fold_in(jax.random.PRNGKey(0), i)
            for i in range(args.nreps)]
    jax.block_until_ready(keys)

    t0 = time.time()
    jax.block_until_ready(sweep(state0, pdata, keys[0]))
    compile_s = time.time() - t0

    def timed(model):
        best = np.inf
        for _ in range(2):
            st = state0
            t0 = time.time()
            for i in range(args.nreps):
                st = sweep(st, pdata, keys[i])
            jax.block_until_ready(st)
            best = min(best, (time.time() - t0) / args.nreps * 1e3)
        return best

    full_ms = timed(model)
    if nch > 1:
        full_ms = full_ms / nch  # report per chain-sweep

    compiled = sweep.lower(state0, pdata, keys[0]).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    flops = float(ca.get("flops", 0.0))
    nbytes = float(ca.get("bytes accessed", 0.0))
    if nch > 1:  # per chain-sweep, consistent with full_ms
        flops /= nch
        nbytes /= nch

    res = {
        "shape": f"{n}x{m}x{T} k={k} ngrid={args.ngrid}",
        "ms_per_sweep": round(full_ms, 2),
        "compile_s": round(compile_s, 1),
        "flops_per_sweep": flops,
        "bytes_per_sweep": nbytes,
        "achieved_tflops": round(flops / full_ms * 1e-9, 3),
        "flop_util_vs_f32_peak": round(
            flops / full_ms * 1e3 / peaks["f32_flops"], 4),
        "achieved_gbps": round(nbytes / full_ms * 1e-6, 1),
        "bw_util": round(nbytes / full_ms * 1e3 / peaks["hbm_bytes_per_s"], 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "peaks_source": peaks["source"],
    }
    # per-block attribution at this shape (single-chain runs only; the
    # chain-batched arm reports aggregate numbers)
    if nch == 1:
        for name, flag in (("W_gass", "sample_W"), ("V_gass", "sample_V")):
            setattr(model, flag, False)
            sweep = make_sweep()
            jax.block_until_ready(sweep(state0, pdata, keys[0]))
            ms = timed(model)
            res[f"ms_without_{name}"] = round(ms, 2)
            res[f"{name}_ms"] = round(full_ms - ms, 2)
            setattr(model, flag, True)
            sweep = make_sweep()  # restore the compiled full sweep
            jax.block_until_ready(sweep(state0, pdata, keys[0]))

    res["nchains"] = nch
    res["data_dtype"] = args.data_dtype
    res["interweave"] = not args.no_interweave
    print(json.dumps(res, indent=1))
    suffix = "_redblack" if args.v_schedule == "redblack" else ""
    if args.tag:
        suffix += "_" + args.tag
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "roofline%s.json" % suffix)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
