"""Throughput vs tensor size (beyond-parity: the batched design's headroom).

The headline GDELT shape (19x19x228) leaves the device latency-bound: the
per-sweep cost is per-op overhead, not compute, so batched work should be
nearly free until the device fills. This
bench measures single-chain sweeps/s of the constrained-Poisson model
(k=5, ngrid=100, positivity constraints) at 1x/2x/4x rows+cols on the
bench chip, for both kernels, plus — as a *generous lower bound* for the
reference's cost — the vectorized CPU quality engine (bench/quality_cpu.py,
which is substantially faster than the reference's per-candidate work
pattern measured in bench/baseline_cpu.json).

Usage: python bench/scale_sweep.py [--cpu] [--nsweeps 100]
Writes bench/scale_sweep.json (merging arms across invocations).
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

SHAPES = [(19, 19, 228), (38, 38, 228), (76, 76, 228)]
K = 5
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "scale_sweep.json")


def make_data(nrows, ncols, ndepth, seed=42):
    rng = np.random.default_rng(seed)
    W = np.abs(rng.normal(1, 0.3, size=(nrows, K)))
    W[np.triu_indices(K, k=1)] = 0
    V = np.abs(rng.normal(1, 0.3, size=(ncols, ndepth, K)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W, V)).astype(float)
    Y[rng.random((nrows, ncols)) < 0.1] = np.nan
    W0 = np.abs(rng.normal(1, 0.2, size=(nrows, K)))
    W0[np.triu_indices(K, k=1)] = 0
    V0 = np.abs(rng.normal(1, 0.2, size=(ncols, ndepth, K)))
    return Y, W0, V0


def run_device(nsweeps):
    import bench as headline  # repo-root bench.py: likelihoods
    from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering
    rows = {}
    for (n, m, T) in SHAPES:
        Y, W0, V0 = make_data(n, m, T)
        C = np.concatenate([np.eye(T), np.zeros((T, 1))], axis=1)
        rec = {}
        for kernel in ("joint", "blocked"):
            kw = dict(v_block_size=None) if kernel == "joint" else \
                dict(loglikelihood_cellfn=headline.poisson_cellfn)
            model = ConstrainedNonconjugateBayesianTensorFiltering(
                n, m, T, headline.poisson_loglik, C, nembeds=K, tf_order=2,
                sigma2_init=0.5, lam2_init=0.1, W_init=W0, V_init=V0,
                gass_ngrid=100, seed=0, **kw)
            model.run_gibbs(Y, nburn=nsweeps - 1, nthin=1, nsamples=1,
                            verbose=False)  # compile + warm
            t0 = time.time()
            model.run_gibbs(Y, nburn=nsweeps - 1, nthin=1, nsamples=1,
                            verbose=False)
            rec[kernel] = round(nsweeps / (time.time() - t0), 2)
        rows[f"{n}x{m}x{T}"] = rec
        print(json.dumps({f"{n}x{m}x{T}": rec}), flush=True)
    return {"device_sweeps_per_sec": rows}


def run_cpu(nsweeps):
    from quality_cpu import ConstrainedPoissonCPU
    rows = {}
    for (n, m, T) in SHAPES:
        Y, W0, V0 = make_data(n, m, T)
        model = ConstrainedPoissonCPU(Y, K, np.eye(T), np.zeros(T),
                                      tf_order=2, seed=0, W_init=W0,
                                      V_init=V0)
        model.sweep()
        t0 = time.time()
        for _ in range(nsweeps):
            model.sweep()
        rows[f"{n}x{m}x{T}"] = round(nsweeps / (time.time() - t0), 4)
        print(json.dumps({f"{n}x{m}x{T}": rows[f'{n}x{m}x{T}']}), flush=True)
    return {"cpu_vectorized_sweeps_per_sec": rows,
            "cpu_note": "vectorized quality engine — a generous LOWER bound "
                        "for the reference's per-sweep cost (its measured "
                        "work-pattern throughput at 19x19x228 is 0.274 "
                        "sweeps/s incl. 3x thread credit, "
                        "bench/baseline_cpu.json)"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="measure the CPU arm instead of the device arm")
    ap.add_argument("--nsweeps", type=int, default=None)
    args = ap.parse_args()
    cur = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            cur = json.load(f)
    if args.cpu:
        cur.update(run_cpu(args.nsweeps or 6))
    else:
        cur.update(run_device(args.nsweeps or 100))
    with open(OUT, "w") as f:
        json.dump(cur, f, indent=2)
    print(json.dumps(cur))


if __name__ == "__main__":
    main()
