"""Where does the constrained-Poisson sweep's time go? (VERDICT.md item 9)

Profiles the GDELT-shape constrained sweep (bench.py config) three ways:

1. **Component ablation**: wall-time of the full sweep vs sweeps with the
   W-GASS / V-GASS / prior blocks disabled — the difference attributes
   ms/sweep to each block (more robust than parsing a trace, and it runs
   through exactly the production code path).
2. **Compiled cost analysis**: XLA's flop / byte estimates for the full
   sweep executable -> achieved FLOP/s and memory bandwidth vs the
   device's published peaks (bench/peaks.py).
3. Optionally (--trace DIR) a jax.profiler trace for manual inspection.

Writes bench/profile.json and prints a summary table. Exits non-zero off
the GPU.
"""
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

NROWS, NCOLS, NDEPTH, NEMBEDS = 19, 19, 228, 5

def poisson_loglik(Y, WV, W, V, row=None, col=None):
    if row is not None:
        Y = Y[row]
    if col is not None:
        Y = Y[:, col]
    rate = jnp.clip(WV, 1e-8, None)
    Y0 = jnp.where(jnp.isnan(Y), 0.0, Y)
    ll = Y0 * jnp.log(rate) - rate - gammaln(Y0 + 1.0)
    return jnp.sum(jnp.where(jnp.isnan(Y), 0.0, ll))


def poisson_loglik_block(Y, WV, W, V, row=None, col=None, tslice=None):
    s0, e0 = tslice
    Yb = Y[:, col, s0:e0]
    if Yb.ndim > WV.ndim:
        WV = WV[..., None]
    rate = jnp.clip(WV, 1e-8, None)
    Y0 = jnp.where(jnp.isnan(Yb), 0.0, Yb)
    ll = Y0 * jnp.log(rate) - rate - gammaln(Y0 + 1.0)
    return jnp.sum(jnp.where(jnp.isnan(Yb), 0.0, ll))


def build(blocked: bool):
    rng = np.random.default_rng(42)
    W0 = np.abs(rng.normal(1, 0.2, size=(NROWS, NEMBEDS)))
    W0[np.triu_indices(NEMBEDS, k=1)] = 0
    V0 = np.abs(rng.normal(1, 0.2, size=(NCOLS, NDEPTH, NEMBEDS)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W0, V0)).astype(float)
    Constraints = np.concatenate([np.eye(NDEPTH), np.zeros((NDEPTH, 1))],
                                 axis=1)
    kwargs = {}
    if blocked:
        kwargs = dict(loglikelihood_block=poisson_loglik_block)
    else:
        kwargs = dict(v_block_size=None)
    model = ConstrainedNonconjugateBayesianTensorFiltering(
        NROWS, NCOLS, NDEPTH, poisson_loglik, Constraints,
        nembeds=NEMBEDS, tf_order=2, sigma2_init=0.5, lam2_init=0.1,
        W_init=W0, V_init=V0, gass_ngrid=100, seed=0, **kwargs)
    return model, Y


def time_sweep(model, Y, nreps=50):
    """ms per single sweep (jit of the model's chain-batched sweep, one
    chain); every timed pass ends in block_until_ready of the carried
    state."""
    pdata = model.prepare_data(Y)
    sweep = jax.jit(model._batched_sweep())
    state0 = dict(model.state)
    key = jax.random.PRNGKey(0)
    # precompute the key schedule: eager fold_in per step costs host time
    # that would otherwise be attributed to the sweep
    keys = [jax.random.fold_in(key, i)[None] for i in range(nreps)]
    jax.block_until_ready(keys)
    t0 = time.time()
    jax.block_until_ready(sweep(state0, pdata, keys[0]))
    compile_s = time.time() - t0
    best = np.inf
    for rep in range(2):
        state = state0
        t0 = time.time()
        for i in range(nreps):
            state = sweep(state, pdata, keys[i])
        jax.block_until_ready(state)
        best = min(best, (time.time() - t0) / nreps * 1e3)
    return best, compile_s, sweep, (state, pdata, keys[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a jax.profiler trace of 10 sweeps to DIR")
    ap.add_argument("--nreps", type=int, default=128,
                    help="sweeps per timing pass (two passes, min kept)")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"profile_sweep.py: no GPU (default backend: {dev.platform})")
    peaks = peaks_for(dev.device_kind)

    out = {"config": f"GDELT {NROWS}x{NCOLS}x{NDEPTH} k={NEMBEDS} ngrid=100",
           "device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "peaks_source": peaks["source"]}
    for variant in ("blocked", "joint"):
        model, Y = build(blocked=(variant == "blocked"))
        full_ms, compile_s, sweep, sargs = time_sweep(model, Y, args.nreps)

        # cost analysis of the compiled sweep
        state, pdata, key = sargs
        compiled = sweep.lower(state, pdata, key).compile()
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        flops = float(ca.get("flops", 0.0))
        nbytes = float(ca.get("bytes accessed", 0.0))
        res = {
            "full_ms_per_sweep": round(full_ms, 3),
            "compile_s": round(compile_s, 1),
            "flops_per_sweep": flops,
            "bytes_per_sweep": nbytes,
            "achieved_gflops": round(flops / full_ms * 1e-6, 1),
            "flop_util_vs_f32_peak": round(
                flops / full_ms * 1e3 / peaks["f32_flops"], 5),
            "achieved_gbps": round(nbytes / full_ms * 1e-6, 1),
            "bw_util": round(
                nbytes / full_ms * 1e3 / peaks["hbm_bytes_per_s"], 5),
        }

        # ablations: turn each block off and re-time
        for name, flag in (("W_gass", "sample_W"), ("V_gass", "sample_V")):
            setattr(model, flag, False)
            ms, _, _, _ = time_sweep(model, Y, args.nreps)
            res[f"ms_without_{name}"] = round(ms, 3)
            res[f"{name}_ms"] = round(full_ms - ms, 3)
            setattr(model, flag, True)
        model.sample_W = model.sample_V = False
        ms, _, _, _ = time_sweep(model, Y, args.nreps)
        res["priors_only_ms"] = round(ms, 3)
        model.sample_W = model.sample_V = True
        out[variant] = res
        print(variant, json.dumps(res, indent=1))

    if args.trace:
        model, Y = build(blocked=True)
        _, _, sweep, (state, pdata, key) = time_sweep(model, Y, 3)
        with jax.profiler.trace(args.trace):
            s = state
            for i in range(10):
                s = sweep(s, pdata, jax.random.fold_in(key[0], i)[None])
            jax.block_until_ready(s)
        out["trace_dir"] = args.trace

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "profile.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
