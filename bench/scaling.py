"""Multi-device scaling of the sharded Gibbs sweep (VERDICT.md item 2).

Measures constrained-Poisson BTF sweeps/sec on a virtual CPU mesh at
1/2/4/8 devices, sharding chains over dp and rows/columns over mp via the
models' explicit partition specs (models/base.py:state_partition_specs).
Each device count runs in a fresh subprocess (the device count is fixed at
backend init), writing one JSON line; the parent collects a table into
bench/scaling.json.

Virtual CPU devices share the same host cores, so this validates that the
sharded program compiles, executes, and does not regress with mesh size —
interconnect speedups can only be observed on real multi-device hardware.
Replaces the role of the reference's nthreads fan-out benchmark
(factor.py:956-1000).
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def child(n_devices: int) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    sys.path.insert(0, REPO)
    from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering
    from functionalmf_tpu.parallel.mesh import make_mesh
    import jax.numpy as jnp
    from jax.scipy.special import gammaln
    import time

    # shapes divisible by every mp size tested (1, 2, 4, 8)
    NROWS, NCOLS, NDEPTH, NEMBEDS = 16, 16, 64, 4
    NCHAINS = 2 if n_devices > 1 else 1

    def poisson_loglik(Y, WV, W, V, row=None, col=None):
        if row is not None:
            Y = Y[row]
        if col is not None:
            Y = Y[:, col]
        rate = jnp.clip(WV, 1e-8, None)
        Y0 = jnp.where(jnp.isnan(Y), 0.0, Y)
        ll = Y0 * jnp.log(rate) - rate - gammaln(Y0 + 1.0)
        return jnp.sum(jnp.where(jnp.isnan(Y), 0.0, ll))

    rng = np.random.default_rng(0)
    W0 = np.abs(rng.normal(1, 0.2, size=(NROWS, NEMBEDS)))
    W0[np.triu_indices(NEMBEDS, k=1)] = 0
    V0 = np.abs(rng.normal(1, 0.2, size=(NCOLS, NDEPTH, NEMBEDS)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W0, V0)).astype(float)
    Constraints = np.concatenate([np.eye(NDEPTH), np.zeros((NDEPTH, 1))],
                                 axis=1)

    n_dp = min(NCHAINS, 2) if n_devices > 1 else 1
    mesh = make_mesh(n_dp=n_dp, n_mp=n_devices // n_dp)
    model = ConstrainedNonconjugateBayesianTensorFiltering(
        NROWS, NCOLS, NDEPTH, poisson_loglik, Constraints,
        nembeds=NEMBEDS, tf_order=1, sigma2_init=0.5, lam2_init=0.1,
        W_init=W0, V_init=V0, gass_ngrid=32, seed=0, nchains=NCHAINS,
        mesh=mesh)

    nsweeps = int(os.environ.get("SCALE_SWEEPS", "50"))
    model.run_gibbs(Y, nburn=nsweeps - 1, nthin=1, nsamples=1, verbose=False)
    t0 = time.time()
    model.run_gibbs(Y, nburn=nsweeps - 1, nthin=1, nsamples=1, verbose=False)
    dt = time.time() - t0
    print(json.dumps({"n_devices": n_devices, "nchains": NCHAINS,
                      "sweeps_per_sec": round(nsweeps / dt, 3)}))


def main() -> None:
    rows = []
    for n in (1, 2, 4, 8):
        env = dict(os.environ)
        flags = " ".join(f for f in env.get("XLA_FLAGS", "").split()
                         if "host_platform_device_count" not in f)
        env["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}").strip()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", str(n)],
            env=env, capture_output=True, text=True, timeout=1800, cwd=REPO)
        if proc.returncode != 0:
            raise RuntimeError(f"n={n} failed:\n{proc.stderr[-2000:]}")
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(rows[-1])
    with open(os.path.join(HERE, "scaling.json"), "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        child(int(sys.argv[2]))
    else:
        main()
