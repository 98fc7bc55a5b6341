"""Politics (GDELT) head-to-head: the reference algorithm on CPU, run to
convergence on the REAL pair-holdout split (VERDICT round-2 item 1).

Reproduces the protocol of /root/reference/politics/benchmark.py:60-204 with
the same warm start the library benchmark uses (apps/politics/benchmark.py —
tensor_nmf of the training tensor; the PGDS->NMF chain needs the optional
`apf` package, absent in this image, on BOTH sides), the same EP centering
(ep_from_nmf), the same config (10000 burn / thin 10 / 1000 draws), and the
same in/out-of-sample RMSE / MAE / Poisson-LL table — so the only variable
between bench/politics_cpu.json and the library run's metrics is the sampler
implementation.

Usage: python bench/politics_cpu.py [--nburn 10000 --nthin 10 --nsamples 1000]
Writes bench/politics_cpu.json (incrementally: partial draws are
checkpointed so an interrupted run still yields a usable posterior).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")  # tensor_nmf import only

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from quality_cpu import ConstrainedPoissonCPU  # noqa: E402


def metrics_table(Y, Y_train, Mu_draws):
    """politics/benchmark.py:163-204: per-draw errors averaged over draws."""
    from scipy.stats import poisson
    is_missing = np.isnan(Y)
    is_held_out = (~is_missing) & np.isnan(Y_train)
    is_in_sample = (~is_missing) & (~is_held_out)
    out = {}
    for name, sel in (("in", is_in_sample), ("out", is_held_out)):
        y = Y[None, sel]
        mu = Mu_draws[:, sel]
        out[f"rmse_{name}"] = float(np.sqrt(np.mean((y - mu) ** 2, axis=-1)).mean())
        out[f"mae_{name}"] = float(np.mean(np.abs(y - mu), axis=-1).mean())
        with np.errstate(all="ignore"):
            out[f"ll_{name}"] = float(poisson.logpmf(
                y, np.clip(mu, 1e-8, None)).mean(axis=-1).mean())
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nburn", type=int, default=10000)
    ap.add_argument("--nthin", type=int, default=10)
    ap.add_argument("--nsamples", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--data-dir", default="/root/reference/politics")
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__),
                                                  "politics_cpu.json"))
    args = ap.parse_args()

    Y = np.load(os.path.join(args.data_dir, "cooperate.npy")).astype(float)
    Y_train = np.load(os.path.join(args.data_dir, "cooperate_train.npy")).astype(float)
    nrows, ncols, ndepth = Y.shape
    nembeds = 5

    # identical warm start to the library benchmark (apps/politics/benchmark.py)
    rng = np.random.default_rng(args.seed)
    from functionalmf_tpu.utils import tensor_nmf
    from functionalmf_tpu.apps.politics.benchmark import ep_from_nmf
    W0, V0 = tensor_nmf(Y_train, nembeds, rng=rng)
    Mu_ep, Sigma_ep = ep_from_nmf(Y_train, W0, V0)

    model = ConstrainedPoissonCPU(
        Y_train, nembeds, np.eye(ndepth), np.zeros(ndepth), tf_order=2,
        sigma2_init=0.5, lam2_init=0.1, seed=args.seed,
        ep=(Mu_ep, Sigma_ep), W_init=W0, V_init=V0)

    total = args.nburn + args.nthin * args.nsamples
    t0 = time.time()
    state = {"done": 0}
    store = {"W": [], "V": []}

    def on_step(step):
        state["done"] = step + 1
        if (step + 1) % 200 == 0:
            el = time.time() - t0
            eta = el / (step + 1) * (total - step - 1)
            print(f"step {step+1}/{total} ({el/60:.1f} min, ETA {eta/60:.0f} min)",
                  flush=True)
        if (step + 1) % 1000 == 0 and store["W"]:
            _write(partial=True)

    def _write(partial=False):
        Ws = np.asarray(store["W"])
        Vs = np.asarray(store["V"])
        Mu_draws = np.einsum("znk,zmtk->znmt", Ws, Vs)
        half = len(Ws) // 2
        rec = {
            "config": f"real GDELT pair-holdout, reference algorithm on CPU, "
                      f"nburn={args.nburn} nthin={args.nthin} "
                      f"nsamples={args.nsamples}",
            "partial": partial, "draws_used": int(len(Ws)),
            "sweeps_done": int(state["done"]),
            "wall_min": round((time.time() - t0) / 60, 1),
            "metrics": metrics_table(Y, Y_train, Mu_draws),
        }
        if half >= 10:
            # split-half stability = convergence evidence for the table
            rec["metrics_first_half"] = metrics_table(Y, Y_train, Mu_draws[:half])
            rec["metrics_second_half"] = metrics_table(Y, Y_train, Mu_draws[half:])
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
        np.savez(os.path.splitext(args.out)[0] + "_draws.npz", W=Ws, V=Vs)

    # run with draw collection into `store`
    for step in range(total):
        model.sweep()
        if step >= args.nburn and (step - args.nburn) % args.nthin == args.nthin - 1:
            store["W"].append(model.W.copy())
            store["V"].append(model.V.copy())
        on_step(step)
    _write(partial=False)
    print(json.dumps(json.load(open(args.out))["metrics"], indent=2))


if __name__ == "__main__":
    main()
