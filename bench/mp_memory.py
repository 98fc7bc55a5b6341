"""Per-device memory accounting across mp shard counts (VERDICT round-2
item 7: demonstrate, not assert, that the mp axis buys memory capacity).

Compiles ONE jitted flagship sweep at an enlarged GDELT-like shape
(4x rows/cols) over (dp=1, mp in {1, 2, 4, 8}) virtual CPU meshes and
records XLA's own per-device memory analysis (argument + output + temp
bytes) plus the sharded state-dict bytes per device. The claim backed:
state and scratch shrink ~1/mp per device, so a tensor that exceeds one
chip's HBM fits on an mp group.

Runs itself in a subprocess with 8 virtual CPU devices (same pattern as
__graft_entry__.dryrun_multichip). Writes bench/mp_memory.json.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "mp_memory.json")


def _body():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, REPO)
    from functionalmf_tpu.parallel.mesh import make_mesh

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)

    # 4x GDELT rows/cols; modest ngrid so CPU compile stays tractable
    nrows, ncols, ndepth, k = 80, 80, 228, 5
    rows = {}
    for n_mp in (1, 2, 4, 8):
        model, Y = ge._build_model(nrows=nrows, ncols=ncols, ndepth=ndepth,
                                   nembeds=k, gass_ngrid=32, nchains=1)
        mesh = make_mesh(n_dp=1, n_mp=n_mp, devices=jax.devices()[:n_mp])
        model.mesh = mesh
        pdata = model.prepare_data(Y)
        vsweep = model._batched_sweep()
        state = model._shard_state(model.state)
        shardings = model.state_shardings()
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.PRNGKey(0), jnp.arange(1, dtype=jnp.uint32))

        with mesh:
            compiled = jax.jit(vsweep, out_shardings=shardings).lower(
                state, pdata, keys).compile()
        ma = compiled.memory_analysis()
        # per-device live state bytes: sum of this device's shards
        dev0 = mesh.devices.reshape(-1)[0]
        state_dev = sum(
            s.data.nbytes for v in state.values()
            for s in v.addressable_shards if s.device == dev0)
        data_bytes = sum(np.asarray(v).nbytes
                         for v in jax.tree_util.tree_leaves(pdata))
        row = {
            "mp": n_mp,
            "state_bytes_per_device": int(state_dev),
            "data_bytes_total": int(data_bytes),
        }
        if ma is not None:
            for attr in ("argument_size_in_bytes", "output_size_in_bytes",
                         "temp_size_in_bytes", "generated_code_size_in_bytes"):
                v = getattr(ma, attr, None)
                if v is not None:
                    row[attr] = int(v)
        rows[str(n_mp)] = row
        print(json.dumps(row), flush=True)

    with open(OUT, "w") as f:
        json.dump({"shape": [nrows, ncols, ndepth, k],
                   "note": "XLA memory analysis of one compiled sweep per "
                           "mp; argument/temp sizes are per-device under "
                           "GSPMD",
                   "rows": rows}, f, indent=2)


def main() -> int:
    env = dict(os.environ)
    flags = " ".join(f for f in env.get("XLA_FLAGS", "").split()
                     if "xla_force_host_platform_device_count" not in f)
    env["XLA_FLAGS"] = (flags +
                        " --xla_force_host_platform_device_count=8").strip()
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--body"],
        env=env, timeout=3000)
    return proc.returncode


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--body":
        _body()
    else:
        sys.exit(main())
