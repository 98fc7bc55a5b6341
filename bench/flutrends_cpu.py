"""Flu-trends anchor: the reference Gaussian-BTF algorithm on CPU, run on
the REAL Google-Flu state split (VERDICT round-2 item 2).

The library's benchmark (apps/flutrends/benchmark.py) reports 79/77% posterior
predictive coverage against a nominal 95%, attributed to the shared-nu2
model family. This run executes the same protocol with the *reference*
algorithm (reference flutrends/benchmark.py:16-77: Gaussian BTF, tf_order=2,
nburn=100/nthin=100/nsamples=100, predictive bands from
N(Mu_draw, nu2_draw)) in plain numpy — if it lands at the same coverage,
the shortfall is the model family's, not the library implementation's.

Usage: python bench/flutrends_cpu.py
Writes bench/flutrends_cpu.json.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from quality_cpu import GaussianCPU  # noqa: E402


def predictive_bands(Mu_hat, nu2s, nsim=100, seed=0):
    """reference flutrends/benchmark.py:66-77: per-cell 2.5/97.5 percentiles
    of N(Mu_draw, nu2_draw) over draws x nsim simulations."""
    rng = np.random.default_rng(seed)
    Z, n, _, T = Mu_hat.shape
    Y_lower = np.zeros((n, 1, T))
    Y_upper = np.zeros((n, 1, T))
    sd = np.sqrt(nu2s)
    for i in range(n):
        eps = rng.normal(size=(nsim, Z, T)) * sd[None, :, None]
        samp = Mu_hat[None, :, i, 0, :] + eps          # (nsim, Z, T)
        Y_lower[i, 0] = np.percentile(samp, 2.5, axis=(0, 1))
        Y_upper[i, 0] = np.percentile(samp, 97.5, axis=(0, 1))
    return Y_lower, Y_upper


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nembeds", type=int, nargs="+", default=[5])
    ap.add_argument("--nburn", type=int, default=100)
    ap.add_argument("--nthin", type=int, default=100)
    ap.add_argument("--nsamples", type=int, default=100)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__),
                                                  "flutrends_cpu.json"))
    args = ap.parse_args()

    # identical split to the library benchmark (create() is seed-deterministic)
    from functionalmf_tpu.apps.flutrends.create_datasets import create
    tmp = tempfile.mkdtemp()
    data, train, _ = create("/root/reference/flutrends/flu_US.mat", tmp)
    Y = np.log(data.T[:, None])
    Y_train = np.log(train.T[:, None])

    is_missing = np.isnan(Y)
    is_held_out = (~is_missing) & np.isnan(Y_train)
    is_in_sample = (~is_missing) & (~is_held_out)
    table = {}
    for k in args.nembeds:
        model = GaussianCPU(Y_train, k, tf_order=2, sigma2_init=1.0,
                            lam2_init=0.1, nu2_init=1.0, seed=args.seed)
        t0 = time.time()
        res = model.run_gibbs(args.nburn, args.nthin, args.nsamples,
                              print_freq=500)
        wall = time.time() - t0
        Mu_hat = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
        Mu_mean = Mu_hat.mean(axis=0)
        Y_lower, Y_upper = predictive_bands(Mu_hat, res["nu2"])
        rec = {"wall_min": round(wall / 60, 1)}
        for name, sel in (("in", is_in_sample), ("out", is_held_out)):
            rec[f"rmse_{name}"] = float(np.sqrt(np.mean(
                (Y[sel] - Mu_mean[sel]) ** 2)))
            rec[f"mae_{name}"] = float(np.mean(np.abs(Y[sel] - Mu_mean[sel])))
            rec[f"coverage_{name}"] = float(100 - (
                (Y[sel] < Y_lower[sel]) | (Y[sel] > Y_upper[sel])).mean() * 100)
        table[f"k={k}"] = rec
        print(json.dumps({f"k={k}": rec}), flush=True)
        with open(args.out, "w") as f:
            json.dump({"config": "real flu split, reference Gaussian-BTF "
                                 "algorithm on CPU, reference config "
                                 f"{args.nburn}/{args.nthin}/{args.nsamples}",
                       "table": table}, f, indent=2)


if __name__ == "__main__":
    main()
