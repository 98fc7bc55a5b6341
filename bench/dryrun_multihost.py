"""Multi-host dryrun: 2 processes x 4 virtual CPU devices each
(VERDICT round-2 item 4).

Proves the mesh/sharding code does not assume a single process: two
jax.distributed-initialized controllers (coordinator on localhost) build ONE global
(dp=2, mp=4) mesh whose dp axis spans the process boundary — chains ride
the inter-process link, rows/columns the devices within a process — and run several jitted
Gibbs sweeps of the flagship constrained model with globally sharded state.
This is the mesh analog of the reference's multiprocessing fan-out
(reference functionalmf/factor.py:929-1000) at the multi-HOST scale the
reference never had.

Usage:
  python bench/dryrun_multihost.py            # parent: spawns 2 workers
  python bench/dryrun_multihost.py --worker i # (internal)
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS = 2
LOCAL_DEVICES = 4
NSWEEPS = 3


def _worker(process_id: int, port: int) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")  # before any backend touch
    sys.path.insert(0, REPO)
    from functionalmf_tpu.parallel.mesh import (
        init_distributed, make_mesh, make_global_array)
    init_distributed(f"localhost:{port}", N_PROCS, process_id)

    import jax.numpy as jnp
    import numpy as np
    devices = jax.devices()
    assert len(devices) == N_PROCS * LOCAL_DEVICES, len(devices)
    assert jax.process_count() == N_PROCS

    # dp spans the process boundary (first mesh axis = slowest-varying =
    # process-major for the default device order), mp stays intra-process
    mesh = make_mesh(n_dp=N_PROCS, n_mp=LOCAL_DEVICES, devices=devices)

    sys.path.insert(0, os.path.join(REPO))
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)

    nchains = 2 * N_PROCS
    n_mp = LOCAL_DEVICES
    model, Y = ge._build_model(nrows=2 * n_mp, ncols=2 * n_mp, ndepth=8,
                               nembeds=2, gass_ngrid=16, nchains=nchains)
    model.mesh = mesh
    pdata = model.prepare_data(np.asarray(Y))
    vsweep = model._batched_sweep()

    shardings = model.state_shardings()
    # every process holds the same host state (same seed); materialize it
    # as global arrays spanning both processes
    state = {k: make_global_array(np.asarray(v), shardings[k])
             for k, v in model.state.items()}
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(0), jnp.arange(nchains, dtype=jnp.uint32))

    step = jax.jit(vsweep, out_shardings=shardings)
    with mesh:
        for _ in range(NSWEEPS):
            state = step(state, pdata, keys)
        jax.block_until_ready(state)

    for k, v in state.items():
        for shard in v.addressable_shards:
            assert np.isfinite(np.asarray(shard.data)).all(), \
                f"non-finite {k} on process {process_id}"
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices("dryrun_multihost_done")
    print(f"worker {process_id}: OK ({NSWEEPS} sweeps, "
          f"{len(devices)} global devices, {jax.process_count()} processes)",
          flush=True)


def main() -> int:
    with socket.socket() as s:  # pick a free coordinator port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    flags = " ".join(f for f in env.get("XLA_FLAGS", "").split()
                     if "xla_force_host_platform_device_count" not in f)
    env["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"
    ).strip()
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_PLATFORM_NAME", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(i),
         str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(N_PROCS)]
    rc = 0
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        print(f"--- worker {i} (rc={p.returncode}) ---\n{out[-2000:]}")
        rc |= p.returncode
    print("dryrun_multihost:", "OK" if rc == 0 else "FAILED")
    return rc


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]))
    else:
        sys.exit(main())
