"""Multi-chain throughput on ONE chip: chain-sweeps/sec vs nchains.

The Gibbs sweep at GDELT shape is latency-bound (sub-1% FLOP utilization,
bench/profile_sweep.py), so vmapping chains should cost far less than Nx —
batching tiny ops amortizes per-op overhead. Since post-warm ESS scales
linearly in independent chains, chain throughput here multiplies the
quality-adjusted (min-ESS/sec) headline directly.

Measures the production path (run_gibbs, which synchronizes via
device_get of the collected draws).

Usage: python bench/chains.py [--nchains 1 2 4 8] [--nsweeps 400]
Writes bench/chains.json.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from functionalmf_tpu.utils.cache import enable_compilation_cache  # noqa: E402
enable_compilation_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nchains", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--nsweeps", type=int, default=400)
    ap.add_argument("--kernel", nargs="+", default=["blocked"],
                    choices=["blocked", "joint", "redblack"])
    args = ap.parse_args()

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_root", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "..", "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering

    rng = np.random.default_rng(42)
    NR, NC, ND, K = bench.NROWS, bench.NCOLS, bench.NDEPTH, bench.NEMBEDS
    W0 = np.abs(rng.normal(1, 0.2, size=(NR, K)))
    W0[np.triu_indices(K, k=1)] = 0
    V0 = np.abs(rng.normal(1, 0.2, size=(NC, ND, K)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W0, V0)).astype(float)
    Constraints = np.concatenate([np.eye(ND), np.zeros((ND, 1))], axis=1)

    kernels = {}
    for kernel in args.kernel:
        kw = dict(nembeds=K, tf_order=2, sigma2_init=0.5, lam2_init=0.1,
                  W_init=W0, V_init=V0, gass_ngrid=100, seed=0)
        if kernel == "joint":
            kw["v_block_size"] = None
        elif kernel == "redblack":
            kw["v_schedule"] = "redblack"
            kw["loglikelihood_cellfn"] = bench.poisson_cellfn
        else:
            kw["loglikelihood_cellfn"] = bench.poisson_cellfn

        rows = []
        for c in args.nchains:
            model = ConstrainedNonconjugateBayesianTensorFiltering(
                NR, NC, ND, bench.poisson_loglik, Constraints, nchains=c,
                **kw)
            # compile + warm with the same static signature as the timed call
            model.run_gibbs(Y, nburn=args.nsweeps - 1, nthin=1, nsamples=1,
                            verbose=False)
            t0 = time.time()
            model.run_gibbs(Y, nburn=args.nsweeps - 1, nthin=1, nsamples=1,
                            verbose=False)
            dt = time.time() - t0
            row = {
                "nchains": c,
                "sweeps_per_sec": round(args.nsweeps / dt, 1),
                "chain_sweeps_per_sec": round(c * args.nsweeps / dt, 1),
                "ms_per_sweep": round(dt / args.nsweeps * 1e3, 3),
                # per-row window length: merged rows can come from runs
                # with different --nsweeps, and the window changes the
                # measured rate (ADVICE round-4)
                "nsweeps": args.nsweeps,
            }
            rows.append(row)
            print(json.dumps({"kernel": kernel, **row}), flush=True)
        kernels[kernel] = rows

        # write incrementally so partial sweeps survive a timeout, and
        # MERGE with any existing file so partial re-runs (a single
        # kernel or chain count) don't clobber the full table
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "chains.json")
        merged = {"kernels": {}}
        if os.path.exists(path):
            with open(path) as f:
                merged = json.load(f)
            merged.pop("nsweeps", None)  # legacy file-level field
        for k, rws in kernels.items():
            cur = merged["kernels"].setdefault(k, [])
            fresh = {r["nchains"] for r in rws}
            cur[:] = sorted([r for r in cur if r["nchains"] not in fresh]
                            + rws, key=lambda r: r["nchains"])
        # efficiency vs the MERGED table's 1-chain row at a matching
        # window (ADVICE round-4: computing vs rows[0] of a partial
        # re-run silently mislabeled the field)
        for k, rws in merged["kernels"].items():
            one = [r for r in rws if r["nchains"] == 1]
            for r in rws:
                base = [b for b in one
                        if b.get("nsweeps") == r.get("nsweeps")] or one
                if base:
                    r["efficiency_vs_1chain"] = round(
                        r["chain_sweeps_per_sec"]
                        / (base[0]["sweeps_per_sec"] * r["nchains"]), 3)
                else:
                    r.pop("efficiency_vs_1chain", None)
        out = merged
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
