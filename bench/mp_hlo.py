"""Measured per-sweep collective volume of the mp-sharded flagship sweep
(VERDICT round-3 item 2: collective bytes must be measured from the
compiled HLO, not asserted).

Compiles ONE jitted flagship sweep at GDELT shape over (dp=1, mp) virtual
CPU meshes, walks the optimized HLO, and records every collective op
(all-gather / all-reduce / reduce-scatter / collective-permute / all-to-all)
with its output bytes. Writes bench/mp_hlo.json with per-op tallies so the
comm-avoiding variants can be compared before/after.

Runs itself in a subprocess with 8 virtual CPU devices.
Usage: python bench/mp_hlo.py [--mp 2 4] [--nrows 19 --ncols 19 ...]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "mp_hlo.json")

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8,
                "s32": 4, "u64": 8, "u32": 4, "s16": 2, "u16": 2,
                "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str):
    """Total bytes of an HLO shape string like 'f32[19,100]' or a tuple
    '(f32[4], f32[4])'."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                "collective-permute", "all-to-all")


def collect_collectives(hlo_text):
    """Parse optimized HLO text; tally collective ops and bytes."""
    ops = []
    for line in hlo_text.splitlines():
        line = line.strip()
        m = re.match(r"%?[\w.-]+ = (\([^)]*\)|\S+) (all-gather|all-reduce|"
                     r"reduce-scatter|collective-permute|all-to-all)", line)
        if not m:
            continue
        shape_str, kind = m.group(1), m.group(2)
        ops.append({"kind": kind, "shape": shape_str,
                    "bytes": _shape_bytes(shape_str)})
    return ops


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

    args = json.loads(os.environ["MP_HLO_ARGS"])
    rows = {}
    for n_mp in args["mp"]:
        model, Y = ge._build_model(nrows=args["nrows"], ncols=args["ncols"],
                                   ndepth=args["ndepth"],
                                   nembeds=args["nembeds"],
                                   gass_ngrid=args["ngrid"], nchains=1)
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
        hlo = compiled.as_text()
        ops = collect_collectives(hlo)
        total = sum(o["bytes"] for o in ops)
        by_kind = {}
        for o in ops:
            by_kind.setdefault(o["kind"], {"count": 0, "bytes": 0})
            by_kind[o["kind"]]["count"] += 1
            by_kind[o["kind"]]["bytes"] += o["bytes"]
        big = sorted(ops, key=lambda o: -o["bytes"])[:8]
        rows[str(n_mp)] = {"total_collective_bytes": total,
                           "by_kind": by_kind, "largest_ops": big}
        print(json.dumps({"mp": n_mp, "total_bytes": total,
                          "by_kind": by_kind}), flush=True)
    with open(OUT, "w") as f:
        json.dump({"shape": args, "rows": rows}, f, indent=1)
    print("wrote", OUT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mp", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--nrows", type=int, default=20)
    ap.add_argument("--ncols", type=int, default=20)
    ap.add_argument("--ndepth", type=int, default=228)
    ap.add_argument("--nembeds", type=int, default=5)
    ap.add_argument("--ngrid", type=int, default=100)
    args = ap.parse_args()
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["MP_HLO_ARGS"] = json.dumps(vars(args))
    bench_dir = os.path.dirname(os.path.abspath(__file__))
    subprocess.run([sys.executable, "-c",
                    f"import sys; sys.path.insert(0, {bench_dir!r}); "
                    "from mp_hlo import _body; _body()"],
                   env=env, check=True, cwd=REPO)


if __name__ == "__main__":
    main()
