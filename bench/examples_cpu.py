"""Head-to-head quality anchors for the three simple examples
(VERDICT round-3 item 8): gaussian / binomial / negbinom example
protocols run both through this library AND through the CPU
reference-algorithm engines (bench/quality_cpu.py), same data, same
configs (reference examples/{gaussian,binomial,negbinom}_tensor_filtering.py).

Usage:
  python bench/examples_cpu.py --example gaussian binomial negbinom \
      --arm cpu library [--seeds 1 2 3] [--fast]

Merges per-(example, arm, seed) rows into bench/examples_cpu.json.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# honor a CPU request through the config as well as the env var
if os.environ.get("JAX_PLATFORMS") == "cpu":
    import jax
    jax.config.update("jax_platforms", "cpu")

from functionalmf_tpu.utils import ilogit, mae, mse, coverage_at  # noqa: E402

import examples.gaussian_tensor_filtering as gex  # noqa: E402
import examples.binomial_tensor_filtering as bex  # noqa: E402
import examples.negbinom_tensor_filtering as nex  # noqa: E402


def run_gaussian(arm, seed, cfg):
    rng = np.random.default_rng(seed)
    W_true, V_true = gex.create_wiggly_with_jumps(rng)
    Mu = np.einsum("nk,mtk->nmt", W_true, V_true)
    Y = rng.normal(Mu[..., None], np.sqrt(gex.nu2_truth),
                   size=(gex.nrows, gex.ncols, gex.ndepth, 1))
    Ym = Y.copy()
    Ym[:3, :3] = np.nan
    nburn, nthin, nsamples = cfg.get("gaussian", (1000, 1, 1000))
    if arm == "library":
        model = gex.init_model(seed=seed)
        res = model.run_gibbs(Ym, nburn=nburn, nthin=nthin,
                              nsamples=nsamples, verbose=False)
    else:
        from quality_cpu import GaussianCPU
        model = GaussianCPU(Ym, nembeds=gex.nembeds, tf_order=2,
                            sigma2_init=0.5, lam2_init=0.1, nu2_init=1.0,
                            seed=seed)
        res = model.run_gibbs(nburn, nthin, nsamples)
    Mu_hat = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
    m = Mu_hat.mean(axis=0)
    return {
        "mae_held": float(mae(Mu[:3, :3], m[:3, :3])),
        "rmse_held": float(np.sqrt(mse(Mu[:3, :3], m[:3, :3]))),
        "cov90": float(coverage_at(Mu, Mu_hat, 90)),
        "nu2_mean": float(np.mean(res["nu2"])),
    }


def run_binomial(arm, seed, cfg):
    rng = np.random.default_rng(seed)
    W_true, V_true = bex.create_wiggly_with_jumps(rng)
    Mu = np.einsum("nk,mtk->nmt", W_true, V_true)
    N = np.full((bex.nrows, bex.ncols, bex.ndepth), 10.0)
    Y = rng.binomial(10, ilogit(Mu)).astype(float)
    Ym = Y.copy()
    Ym[:3, :3] = np.nan
    Nm = N.copy()
    Nm[np.isnan(Ym)] = np.nan
    nburn, nthin, nsamples = cfg.get("binomial", (10000, 10, 1000))
    if arm == "library":
        model = bex.init_model(seed=seed)
        res = model.run_gibbs((Ym, Nm), nburn=nburn, nthin=nthin,
                              nsamples=nsamples, verbose=False)
    else:
        from quality_cpu import BinomialCPU
        model = BinomialCPU(Ym, Nm, nembeds=bex.nembeds, tf_order=2,
                            sigma2_init=0.5, lam2_init=0.1, seed=seed)
        res = model.run_gibbs(nburn, nthin, nsamples)
    P_hat = ilogit(np.clip(
        np.einsum("znk,zmtk->znmt", res["W"], res["V"]), -10, 10))
    P_true = ilogit(Mu)
    m = P_hat.mean(axis=0)
    return {
        "mae_held_P": float(mae(P_true[:3, :3], m[:3, :3])),
        "rmse_held_P": float(np.sqrt(mse(P_true[:3, :3], m[:3, :3]))),
        "cov90_P": float(coverage_at(P_true, P_hat, 90)),
    }


def run_negbinom(arm, seed, cfg):
    rng = np.random.default_rng(seed)
    R_true, P_true, Mu_true, _ = nex.create_piecewise_constant(rng)
    Mu = R_true * P_true / (1 - P_true)
    Y = rng.poisson(rng.gamma(np.maximum(R_true[..., None], 1e-6),
                              (P_true / (1 - P_true))[..., None],
                              size=(nex.nrows, nex.ncols, nex.ndepth, 1))
                    ).astype(float)
    Ym = Y.copy()
    Ym[:3, :3] = np.nan
    nburn, nthin, nsamples = cfg.get("negbinom", (10000, 1, 2000))
    if arm == "library":
        model = nex.init_model(seed=seed)
        res = model.run_gibbs(Ym, nburn=nburn, nthin=nthin,
                              nsamples=nsamples, verbose=False)
        Rs = res["R"]
    else:
        from quality_cpu import NegBinomCPU
        model = NegBinomCPU(Ym, nembeds=nex.nembeds, tf_order=2,
                            sigma2_init=0.5, lam2_init=0.1, nu2_init=1.0,
                            rdims=(1, 2), seed=seed)
        res = model.run_gibbs(nburn, nthin, nsamples)
        Rs = res["R"]
    Ps = ilogit(np.clip(
        np.einsum("znk,zmtk->znmt", res["W"], res["V"]), -10, 10))
    if Rs.ndim == 2:  # (S, nrows) flattened per-row dispersion
        Rs = Rs.reshape(Rs.shape[0], -1, 1, 1)
    Mu_hat = Rs * Ps / (1 - Ps)
    m = Mu_hat.mean(axis=0)
    return {
        "mae_held": float(mae(Mu[:3, :3], m[:3, :3])),
        "rmse_held": float(np.sqrt(mse(Mu[:3, :3], m[:3, :3]))),
        "cov90": float(coverage_at(Mu, Mu_hat, 90)),
    }


RUNNERS = {"gaussian": run_gaussian, "binomial": run_binomial,
           "negbinom": run_negbinom}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--example", nargs="+", default=list(RUNNERS),
                    choices=list(RUNNERS))
    ap.add_argument("--arm", nargs="+", default=["cpu", "library"],
                    choices=["cpu", "library"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--fast", action="store_true",
                    help="short chains for smoke-testing the harness")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "examples_cpu.json"))
    args = ap.parse_args()

    cfg = {}
    if args.fast:
        cfg = {"gaussian": (100, 1, 100), "binomial": (200, 1, 100),
               "negbinom": (200, 1, 100)}

    rows = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            rows = json.load(f)["rows"]

    for ex in args.example:
        for arm in args.arm:
            for seed in args.seeds:
                t0 = time.time()
                metrics = RUNNERS[ex](arm, seed, cfg)
                row = {"example": ex, "arm": arm, "seed": seed,
                       "fast": bool(args.fast),
                       "wall_min": round((time.time() - t0) / 60, 1),
                       **{k: round(v, 4) for k, v in metrics.items()}}
                rows = [r for r in rows
                        if not (r["example"] == ex and r["arm"] == arm
                                and r["seed"] == seed)] + [row]
                print(json.dumps(row), flush=True)
                with open(args.out, "w") as f:
                    json.dump({"rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
