"""Flagship-calibration CPU cells: the reference algorithm through the
flagship example's exact protocol (VERDICT round-2 item 8, closing Weak
#1/#3).

Runs the same (seed, nembeds) cells as bench/calibration.py — identical
data generator (examples/poisson_tensor_filtering.create_piecewise_constant
with the same rng), identical warm start (tensor_nmf + horseshoe hyperparam
re-draws), identical config (5000 burn / thin 5 / 1000 draws, tf_order=0,
positivity constraints) — but with the CPU reference-pattern sampler
(quality_cpu.ConstrainedPoissonCPU, the joint per-column GASS kernel of
reference factor.py:894-1017). Records true-rate coverage at 50/75/90/95 +
RMSE next to the library's calibration cells (bench/calibration.py):

  * k=3 cell — does the reference algorithm reach the same coverage as the
    library's blocked sampler?
  * k=2 cell — does the reference algorithm undercover identically under
    rank-3-truth misspecification (the round-2 claim)?

Usage: python bench/calibration_cpu.py --cells 3:1 2:1 [--nburn 5000 ...]
Writes bench/calibration_cpu.json incrementally.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from quality_cpu import ConstrainedPoissonCPU, sample_horseshoe_np, \
    sample_horseshoe_plus_np  # noqa: E402
from examples.poisson_tensor_filtering import (  # noqa: E402
    create_piecewise_constant, nrows, ncols, ndepth, nreplicates)
from functionalmf_tpu.utils import tensor_nmf, coverage_at, mse  # noqa: E402


def run_cell(nembeds, seed, nburn, nthin, nsamples):
    rng = np.random.default_rng(seed)
    W_true, V_true = create_piecewise_constant(rng)
    Mu = np.einsum("nk,mtk->nmt", W_true, V_true)
    Y = rng.poisson(Mu[..., None],
                    size=(nrows, ncols, ndepth, nreplicates)).astype(float)
    Y_missing = Y.copy()
    Y_missing[:3, :3] = np.nan

    W0, V0 = tensor_nmf(Y_missing, nembeds, rng=rng)
    model = ConstrainedPoissonCPU(
        Y_missing, nembeds, np.eye(ndepth), np.zeros(ndepth), tf_order=0,
        sigma2_init=0.5, lam2_init=0.1, seed=seed, W_init=W0, V_init=V0)
    # hyperparam re-init after the NMF warm start (poisson example:58-81)
    t2, c, b, a = sample_horseshoe_plus_np(model.rng, (ncols, model.nD))
    model.Tau2, model.Tau2_c, model.Tau2_b, model.Tau2_a = t2.clip(0, 9), c, b, a
    lam2, lam2_a = sample_horseshoe_np(model.rng)
    model.lam2, model.lam2_a = float(np.clip(lam2, 0, 4)), float(lam2_a)
    model.sigma2 = 1.0 / model.rng.gamma(0.1, 1 / 0.1)

    t0 = time.time()
    res = model.run_gibbs(nburn, nthin, nsamples, print_freq=1000)
    wall = time.time() - t0
    Mu_hat = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
    cell = {
        "seed": seed, "nembeds": nembeds, "wall_min": round(wall / 60, 1),
        "rmse_true": float(np.sqrt(mse(Mu, Mu_hat.mean(0)))),
    }
    for lvl in (50, 75, 90, 95):
        cell[f"cov{lvl}"] = float(coverage_at(Mu, Mu_hat, lvl))
    return cell


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", default=["3:1", "2:1"],
                    help="nembeds:seed pairs")
    ap.add_argument("--nburn", type=int, default=5000)
    ap.add_argument("--nthin", type=int, default=5)
    ap.add_argument("--nsamples", type=int, default=1000)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__),
                                                  "calibration_cpu.json"))
    args = ap.parse_args()

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f).get("cells", [])
    for spec in args.cells:
        k, seed = (int(x) for x in spec.split(":"))
        if any(r["nembeds"] == k and r["seed"] == seed for r in results):
            print(f"cell k={k} seed={seed} already done, skipping")
            continue
        print(f"running CPU cell k={k} seed={seed}", flush=True)
        cell = run_cell(k, seed, args.nburn, args.nthin, args.nsamples)
        results.append(cell)
        print(json.dumps(cell), flush=True)
        with open(args.out, "w") as f:
            json.dump({"config": "reference algorithm on CPU, flagship "
                                 "example protocol "
                                 f"{args.nburn}/{args.nthin}/{args.nsamples}",
                       "cells": results}, f, indent=2)


if __name__ == "__main__":
    main()
