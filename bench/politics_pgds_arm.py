"""Politics benchmark: the PGDS arm (Schein et al 2016) on the real split.

Reproduces the reference's PGDS baseline fit (politics/benchmark.py:74-81)
with the native sampler (functionalmf_tpu/models/pgds.py) on CPU, on the
same seed-42 pair-holdout split as apps/politics/benchmark.py, and
reports the reference's in/out RMSE/MAE/LL row (benchmark.py:163-204).

Writes bench/politics_pgds.json and the posterior-mean rate tensor
bench/politics_pgds_mu_mean.npy (the reference's BTF warm-start target,
benchmark.py:96).
"""
import argparse
import json
import os
import time

import numpy as np

import jax
jax.config.update("jax_platforms", "cpu")

from functionalmf_tpu.apps.politics.benchmark import load_data
from functionalmf_tpu.pgds import fit_pgds


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nburn", type=int, default=10000)
    p.add_argument("--nthin", type=int, default=10)
    p.add_argument("--nsamples", type=int, default=1000)
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "politics_pgds.json"))
    args = p.parse_args()

    rng = np.random.default_rng(42)
    Y, Y_train, _ = load_data("/root/reference/politics", rng)

    t0 = time.time()
    Mu, _ = fit_pgds(Y_train, 5, binary=False, nthreads=1, time_mode=2,
                     nburn=args.nburn, nthin=args.nthin,
                     nsamples=args.nsamples, verbose=1)
    wall = time.time() - t0
    Mu = np.asarray(Mu)

    is_missing = np.isnan(Y)
    is_held_out = (~is_missing) & np.isnan(Y_train)
    is_in_sample = (~is_missing) & (~is_held_out)

    from scipy.stats import poisson
    with np.errstate(all="ignore"):
        row = dict(
            rmse_in=float(np.sqrt(np.mean(
                (Y[None, is_in_sample] - Mu[:, is_in_sample]) ** 2,
                axis=-1)).mean()),
            rmse_out=float(np.sqrt(np.mean(
                (Y[None, is_held_out] - Mu[:, is_held_out]) ** 2,
                axis=-1)).mean()),
            mae_in=float(np.mean(np.abs(
                Y[None, is_in_sample] - Mu[:, is_in_sample]),
                axis=-1).mean()),
            mae_out=float(np.mean(np.abs(
                Y[None, is_held_out] - Mu[:, is_held_out]),
                axis=-1).mean()),
            ll_in=float(poisson.logpmf(
                Y[None, is_in_sample],
                np.clip(Mu[:, is_in_sample], 1e-8, None)
                ).mean(axis=-1).mean()),
            ll_out=float(poisson.logpmf(
                Y[None, is_held_out],
                np.clip(Mu[:, is_held_out], 1e-8, None)
                ).mean(axis=-1).mean()),
            wall_s=wall,
            config=dict(nburn=args.nburn, nthin=args.nthin,
                        nsamples=args.nsamples))
    np.save(os.path.join(os.path.dirname(__file__),
                         "politics_pgds_mu_mean.npy"), Mu.mean(axis=0))
    with open(args.out, "w") as f:
        json.dump({"Schein et al (2016), native PGDS": row}, f, indent=2)
    print(json.dumps(row, indent=2))


if __name__ == "__main__":
    main()
