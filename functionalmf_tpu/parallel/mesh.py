"""Device-mesh sharding for BTF Gibbs state.

The reference's "distributed backend" is a POSIX shared-memory segment plus
a process pool (factor.py:929-1000). The JAX equivalent is a
`jax.sharding.Mesh` with two axes:

  * ``dp``  — chains (pure data parallelism; the genlasso.py:38 TODO)
  * ``mp``  — rows/columns of the tensor (the reference's intra-sweep
    fan-out, factor.py:984-1000): W-row GASS/ridge updates shard over rows,
    V-column updates shard over columns. Cross-shard terms (the lam2 rate
    reduction, the opposite-embedding constraint assembly) lower to XLA
    collectives (NCCL on GPUs) automatically under jit.

Partition specs are **explicit per model**: every model enumerates its own
state keys in ``state_partition_specs()`` (models/base.py and subclasses) —
no name/shape heuristics. This module only turns those specs into
``NamedSharding``s, guarding the divisibility constraint (a mesh axis is
dropped from a spec when the array dimension is not divisible by it, since
jax device_put requires even partitioning).

Collective plan for the constrained model (MEASURED from the compiled
HLO, bench/mp_hlo.json; see models/constrained.py:_update_W_gass /
_update_V_gass): the GASS fan-outs run inside explicit `jax.shard_map`
regions over mp — round 4 finding: left to GSPMD, the traced-index data
gather inside the vmapped likelihoods made the partitioner replicate the
whole (m, ngrid, T, k) candidate chain, 274 MB/sweep of all-gathers at
GDELT shape. Under shard_map the V update (columns mutually independent
given W) needs NO collectives; the W update all-gathers only V itself
(~91 KB) for the reduced constraint matrix
``A[(col,j),a] = sum_t CA[j,t] V[col,t,a]``; one small all-to-all
reshards the data tensor between the row-sharded and column-sharded
phases. Total: 0.27 MB/sweep at mp=4.
"""
from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "state_shardings", "shard_state", "specs_to_shardings",
           "init_distributed", "make_global_array", "DP_AXIS", "MP_AXIS"]

DP_AXIS = "dp"
MP_AXIS = "mp"


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, cpu_collectives: str = "gloo") -> None:
    """Initialize the multi-host (DCN) runtime (SURVEY.md §5: the
    multi-host analog of the reference's process fan-out,
    factor.py:984-1000, rides jax.distributed over DCN — no custom
    transport, XLA collectives handle the dense regular updates).

    Call before any backend touch, once per process, with an explicit
    coordinator address, process count and process id; on CPU test
    fixtures (bench/dryrun_multihost.py) it is localhost:port and the
    cross-process collectives use the gloo backend.
    """
    # NOTE: must not touch the backend here (jax.default_backend() would
    # initialize it and initialize() then refuses); consult config only
    platforms = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    if "cpu" in str(platforms):
        try:
            jax.config.update("jax_cpu_collectives_implementation",
                              cpu_collectives)
        except Exception:
            pass  # older/newer flag name; gloo is the default where absent
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_global_array(value, sharding):
    """Materialize a process-local numpy value (identical on every process)
    as a globally sharded jax.Array. The multi-process replacement for
    jax.device_put, which cannot place cross-process shardings."""
    value = np.asarray(value)
    return jax.make_array_from_callback(value.shape, sharding,
                                        lambda idx: value[idx])


def make_mesh(n_dp: int = 1, n_mp: int | None = None, devices=None) -> Mesh:
    """Build a (dp, mp) mesh over the available devices."""
    devices = jax.devices() if devices is None else devices
    if n_mp is None:
        n_mp = len(devices) // n_dp
    devs = np.array(devices[: n_dp * n_mp]).reshape(n_dp, n_mp)
    return Mesh(devs, (DP_AXIS, MP_AXIS))


def _feasible_spec(mesh: Mesh, spec: P, shape) -> P:
    """Drop mesh axes a dimension cannot be evenly partitioned over.

    jax.device_put requires dim % axis_size == 0; an indivisible dimension
    (e.g. GDELT's 19 rows over mp=4) falls back to replication on that
    mesh axis rather than erroring.
    """
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for d, name in enumerate(tuple(spec)[: len(shape)]):
        if name is None or name not in sizes:
            out.append(None)
        elif d < len(shape) and shape[d] % sizes[name] == 0:
            out.append(name)
        else:
            out.append(None)
    return P(*out)


def specs_to_shardings(mesh: Mesh, specs: dict, state: dict) -> dict:
    """Model-provided {key: PartitionSpec} -> {key: NamedSharding}."""
    return {k: NamedSharding(mesh, _feasible_spec(mesh, specs[k], v.shape))
            for k, v in state.items()}


def state_shardings(mesh: Mesh, state: dict, specs: dict | None = None) -> dict:
    """NamedShardings for a BTF state dict (leading axis = chains).

    Pass the model's explicit ``state_partition_specs()`` as ``specs``.
    Without specs, falls back to sharding only the chain axis over dp —
    there is deliberately no shape-guessing here.
    """
    if specs is not None:
        return specs_to_shardings(mesh, specs, state)
    return {k: NamedSharding(mesh, _feasible_spec(mesh, P(DP_AXIS), v.shape))
            for k, v in state.items()}


def shard_state(state: dict, mesh: Mesh, specs: dict | None = None) -> dict:
    shardings = state_shardings(mesh, state, specs)
    return {k: jax.device_put(v, shardings[k]) for k, v in state.items()}
