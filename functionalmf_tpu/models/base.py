"""Base Bayesian Tensor Filtering model: state pytree + jitted Gibbs driver.

JAX re-design of the reference's model layer
(functionalmf/factor.py:23-284 and functionalmf/genlasso.py:5-136).

Architecture deltas from the reference (deliberate; see SURVEY.md §7):

* **State is a pytree, the sweep is a pure function.** The reference holds
  mutable numpy arrays on a model object and mutates them in-place each
  Gibbs step. Here all latent state lives in a dict of jnp arrays with a
  leading *chain* axis, and each model builds ``sweep(state, data, key) ->
  state`` which `run_gibbs` drives with `lax.fori_loop`/`lax.scan` inside a
  single jit compilation.
* **Batch, don't fan out.** Per-row / per-column updates are vmapped into
  batched dense linear algebra instead of Python loops or worker processes
  (factor.py:313-409, 984-1000).
* **Counter-based RNG.** Every stochastic site derives its key from
  ``jax.random.fold_in`` of a per-sweep key, replacing global numpy RNG.
* **Chains are a first-class axis** (the genlasso.py:38 TODO): all state
  carries a leading ``nchains`` axis, vmapped and (optionally) sharded over
  a device mesh.

API parity preserved: constructor kwargs (the ``X_true`` fix-vs-``X_init``
initialize pattern, factor.py:26-36), ``run_gibbs(data, nburn, nthin,
nsamples, callback)`` returning a dict of posterior draws keyed
'W'/'V'/'Tau2'/'lam2'/'sigma2' (+model extras), and
``select_hyperparams_DIC`` (genlasso.py:69-136).
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from functionalmf_tpu.ops.banded import _mm_f32
from functionalmf_tpu.ops.penalty import bayes_grid_penalty
from functionalmf_tpu.samplers.horseshoe import (
    sample_horseshoe,
    sample_horseshoe_plus,
    resample_tau2_ladder,
    resample_lam2,
)
from functionalmf_tpu.samplers.conjugate import ConjugateInverseGammaPrior

__all__ = ["BayesianTensorFiltering", "tril_mask", "packed_w_len"]


def tril_mask(nrows: int, nembeds: int, dtype=np.float32):
    """Structural mask of the lower-triangular-identified W (factor.py:155-174).

    mask[i, a] = 1 iff embedding a is active for row i, i.e. a <= i. Rows
    i >= nembeds are fully dense. Replaces the reference's ragged
    pack/unpack with fixed-shape masking. Returned as host numpy: it is a
    trace-time constant of the compiled sweep.
    """
    i = np.arange(nrows)[:, None]
    a = np.arange(nembeds)[None, :]
    return (a <= i).astype(np.float32)


def packed_w_len(nrows: int, nembeds: int) -> int:
    """Length of the packed W vector (factor.py:155-163)."""
    if nrows >= nembeds:
        return (nembeds * nembeds - nembeds) // 2 + nembeds + (nrows - nembeds) * nembeds
    return (nrows * nrows - nrows) // 2 + nrows


def _fold(key, *ints):
    for i in ints:
        key = jax.random.fold_in(key, i)
    return key


class BayesianTensorFiltering:
    """Abstract BTF base (reference factor.py:23-284).

    Subclasses implement ``_make_sweep()`` returning a pure per-chain sweep
    function, ``prepare_data(data)``, and ``_collect_keys``.
    """

    _collect_keys = ("W", "V", "sigma2", "lam2", "Tau2")

    def __init__(self, nrows, ncols, ndepth,
                 nembeds=5, tf_order=2,
                 sigma2_init=None, sigma2_true=None,
                 sigma2_a=0.1, sigma2_b=0.1,
                 lam2_init=None, lam2_true=None,
                 Tau2_init=None, Tau2_true=None,
                 W_init=None, V_init=None,
                 W_true=None, V_true=None,
                 stability=1e-6,
                 force_psd=True,
                 force_psd_eps=1e-6,
                 force_psd_attempts=4,
                 dtype=jnp.float32,
                 data_dtype=None,   # storage dtype for the prepared data
                                    # tensor (e.g. jnp.float16 to halve the
                                    # HBM read volume of the likelihood
                                    # passes — the dominant traffic in the
                                    # memory-bound regime, bench/roofline).
                                    # float16 keeps integer counts <= 2048
                                    # exact; compute promotes back to f32.
                 seed=0,
                 nchains=1,
                 mesh=None,
                 nthreads=None,  # accepted for API parity; parallelism is on-device
                 **kwargs):
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.ndepth = int(ndepth)
        self.nembeds = int(nembeds)
        self.tf_order = int(tf_order)
        self.stability = float(stability)
        self.dtype = dtype
        self.data_dtype = data_dtype
        self.nchains = int(nchains)
        self.mesh = mesh
        self.linalg_opts = dict(
            force_psd=force_psd,
            force_psd_eps=force_psd_eps,
            force_psd_attempts=force_psd_attempts,
        )

        # Trend filtering prior (factor.py:50), dense: nD x ndepth.
        # Host numpy: embedded as a jaxpr constant where traced code uses it.
        self.Delta_np = bayes_grid_penalty(ndepth, tf_order)
        self.Delta = np.asarray(self.Delta_np, dtype=np.float32)
        self.nD = self.Delta_np.shape[0]

        self.sigma2_a = sigma2_a
        self.sigma2_b = sigma2_b
        self.sigma2_model = ConjugateInverseGammaPrior(1, sigma2_a, sigma2_b)

        self._base_key = jax.random.PRNGKey(seed)
        self._init_counter = 0  # distinct keys for repeated re-inits
        self._wmask = tril_mask(self.nrows, self.nembeds, dtype)
        self._w_len = packed_w_len(self.nrows, self.nembeds)

        state = {}
        ck = self._next_init_keys()

        # sigma2 (factor.py:53-64)
        if sigma2_true is not None:
            state["sigma2"] = self._chain_full((), sigma2_true)
            self.sample_sigma2 = False
        else:
            self.sample_sigma2 = True
            if sigma2_init is not None:
                state["sigma2"] = self._chain_full((), sigma2_init)
            else:
                state["sigma2"] = self._init_sigma2_val(ck)

        # lam2 (factor.py:66-74): note the reference *always* initializes the
        # auxiliary lam2_a even when lam2_init overrides lam2.
        lam2, lam2_a = self._init_lam2_val(ck)
        if lam2_true is not None:
            state["lam2"] = self._chain_full((), lam2_true)
            state["lam2_a"] = lam2_a
            self.sample_lam2 = False
        else:
            self.sample_lam2 = True
            state["lam2"] = self._chain_full((), lam2_init) if lam2_init is not None else lam2
            state["lam2_a"] = lam2_a

        # Tau2 horseshoe+ ladder (factor.py:76-86)
        t2, t2c, t2b, t2a = self._init_tau2_val(ck)
        if Tau2_true is not None:
            state["Tau2"] = self._chain_broadcast(Tau2_true, (self.ncols, self.nD))
            self.sample_Tau2 = False
        else:
            self.sample_Tau2 = True
            state["Tau2"] = (self._chain_broadcast(Tau2_init, (self.ncols, self.nD))
                             if Tau2_init is not None else t2)
        state["Tau2_c"], state["Tau2_b"], state["Tau2_a"] = t2c, t2b, t2a

        # W (factor.py:88-98)
        if W_true is not None:
            state["W"] = self._chain_broadcast(W_true, (self.nrows, self.nembeds))
            self.sample_W = False
        else:
            self.sample_W = True
            if W_init is not None:
                state["W"] = self._chain_broadcast(W_init, (self.nrows, self.nembeds))
            else:
                state["W"] = self._init_W_val(ck, state["sigma2"])

        # V (factor.py:100-110)
        if V_true is not None:
            state["V"] = self._chain_broadcast(V_true, (self.ncols, self.ndepth, self.nembeds))
            self.sample_V = False
        else:
            self.sample_V = True
            if V_init is not None:
                state["V"] = self._chain_broadcast(V_init, (self.ncols, self.ndepth, self.nembeds))
            else:
                state["V"] = self._init_V_val(ck, state["lam2"], state["Tau2"])

        # numerical-failsafe event counters: nan_fallbacks counts whole-array
        # non-finite skips (_nan_guard) plus Gershgorin-shift pivot repairs;
        # pivot_repairs counts every jittered-pivot repair in the banded
        # factor scans (ops/banded.py:_chol_pivot_guarded)
        state["nan_fallbacks"] = self._chain_full((), 0.0)
        state["pivot_repairs"] = self._chain_full((), 0.0)
        self._state = state

    # ------------------------------------------------------------------
    # init helpers (match reference init distributions)
    # ------------------------------------------------------------------
    def _next_init_keys(self):
        self._init_counter += 1
        k = _fold(self._base_key, 0xC0FFEE, self._init_counter)
        return jax.vmap(lambda c: _fold(k, c))(jnp.arange(self.nchains, dtype=jnp.uint32))

    def _chain_full(self, shape, value):
        return jnp.broadcast_to(jnp.asarray(value, self.dtype), (self.nchains,) + shape).copy()

    def _chain_broadcast(self, value, shape):
        v = jnp.asarray(value, self.dtype)
        if v.shape == (self.nchains,) + shape:
            return v
        assert v.shape == shape, f"expected {shape} or {(self.nchains,) + shape}, got {v.shape}"
        return jnp.broadcast_to(v, (self.nchains,) + shape).copy()

    def _init_sigma2_val(self, chain_keys):
        # factor.py:252-253: sigma2 = 1 / IG-prior draw
        def f(k):
            return 1.0 / self.sigma2_model.draw_from_prior(_fold(k, 1))
        return jax.vmap(f)(chain_keys).astype(self.dtype)

    def _init_lam2_val(self, chain_keys):
        # factor.py:248-250
        def f(k):
            lam2, lam2_a = sample_horseshoe(_fold(k, 2))
            return jnp.clip(lam2, 0, 4), lam2_a
        lam2, lam2_a = jax.vmap(f)(chain_keys)
        return lam2.astype(self.dtype), lam2_a.astype(self.dtype)

    def _init_tau2_val(self, chain_keys):
        # factor.py:244-246
        def f(k):
            d, c, b, a = sample_horseshoe_plus(_fold(k, 3), size=(self.ncols, self.nD))
            return jnp.clip(d, 0, 9), c, b, a
        t = jax.vmap(f)(chain_keys)
        return tuple(x.astype(self.dtype) for x in t)

    def _init_W_val(self, chain_keys, sigma2):
        # factor.py:230-233
        def f(k, s2):
            W = jax.random.normal(_fold(k, 4), (self.nrows, self.nembeds)) * jnp.sqrt(s2)
            return W * self._wmask if self.nrows > 1 else W
        return jax.vmap(f)(chain_keys, sigma2).astype(self.dtype)

    def _init_V_val(self, chain_keys, lam2, Tau2):
        # factor.py:235-242: V_j ~ N(0, Q_j^-1), Q_j = kron(I_k, D^T Lam_j D)
        def f(k, l2, T2):
            x = self._sample_v_prior(_fold(k, 5), l2, T2)  # (ncols, kT)
            V = x.reshape(self.ncols, self.nembeds, self.ndepth).transpose(0, 2, 1)
            return jnp.clip(V, -10, 10)
        return jax.vmap(f)(chain_keys, lam2, Tau2).astype(self.dtype)

    # Re-init entry points used by example/app code (poisson example:58-81).
    def _init_sigma2(self):
        self._state["sigma2"] = self._init_sigma2_val(self._next_init_keys())

    def _init_lam2(self):
        lam2, lam2_a = self._init_lam2_val(self._next_init_keys())
        self._state["lam2"], self._state["lam2_a"] = lam2, lam2_a

    def _init_Tau2(self):
        t2, c, b, a = self._init_tau2_val(self._next_init_keys())
        self._state["Tau2"], self._state["Tau2_c"] = t2, c
        self._state["Tau2_b"], self._state["Tau2_a"] = b, a

    def _init_W(self):
        self._state["W"] = self._init_W_val(self._next_init_keys(), self._state["sigma2"])

    def _init_V(self):
        self._state["V"] = self._init_V_val(
            self._next_init_keys(), self._state["lam2"], self._state["Tau2"])

    # ------------------------------------------------------------------
    # state access (reference exposes mutable attributes; we expose
    # properties with assignment — `model.W = value`)
    # ------------------------------------------------------------------
    @property
    def state(self):
        return self._state

    def _get_var(self, name):
        v = self._state[name]
        if self.nchains == 1:
            v = v[0]
        return np.asarray(v)

    def _set_var(self, name, value):
        shape = self._state[name].shape[1:]
        self._state[name] = self._chain_broadcast(np.asarray(value, dtype=np.float32), shape)

    W = property(lambda s: s._get_var("W"), lambda s, v: s._set_var("W", v))
    V = property(lambda s: s._get_var("V"), lambda s, v: s._set_var("V", v))
    Tau2 = property(lambda s: s._get_var("Tau2"), lambda s, v: s._set_var("Tau2", v))
    lam2 = property(lambda s: s._get_var("lam2"), lambda s, v: s._set_var("lam2", v))
    sigma2 = property(lambda s: s._get_var("sigma2"), lambda s, v: s._set_var("sigma2", v))

    # ------------------------------------------------------------------
    # shared prior-block updates (factor.py:112-153)
    # ------------------------------------------------------------------
    def _v_prior_weights(self, lam2, Tau2):
        """diag weights 1/(lam2 * Tau2_j), clipped (factor.py:186, 767)."""
        lo, hi = self.stability, 1.0 / self.stability
        return jnp.clip(1.0 / jnp.clip(lam2 * Tau2, lo, hi), lo, hi)

    @_mm_f32
    def _v_prior_dtld(self, lam2, Tau2):
        """D^T Lam_j D per column: (ncols, T, T). Full-f32 matmuls: the
        horseshoe weights span ~1e-6..1e6, and this Gram is the prior block
        of every V conditional — a reduced-precision pass here perturbs
        Cholesky pivots downstream (ops/banded.py:_mm_f32)."""
        w = self._v_prior_weights(lam2, Tau2)  # (ncols, nD)
        return jnp.einsum("dt,jd,ds->jts", self.Delta, w, self.Delta)

    def _v_prior_precision(self, lam2, Tau2):
        """kron(I_k, D^T Lam_j D) dense: (ncols, kT, kT) (factor.py:176-194)."""
        DtLD = self._v_prior_dtld(lam2, Tau2)
        I_k = np.eye(self.nembeds, dtype=np.float32)
        kT = self.nembeds * self.ndepth
        Q = jnp.einsum("ab,jts->jatbs", I_k, DtLD)
        return Q.reshape(self.ncols, kT, kT)

    def _sample_v_prior(self, key, lam2, Tau2):
        """Draw (ncols, k*T) ~ N(0, kron(I_k, DtLD)^-1) via the *block*
        structure: the kron prior is block-diagonal over embeddings, so one
        (ncols, T, T) Cholesky with k right-hand sides replaces the
        (ncols, kT, kT) factorization — O(k) less FLOPs and ~k x fewer
        sequential Cholesky panel steps. Jacobi equilibration keeps
        the horseshoe's 1e-6..1e6 dynamic range factorizable in f32.
        Returns embed-major packing (matching _pack_V, factor.py:176-194).
        """
        m, T, k = self.ncols, self.ndepth, self.nembeds
        DtLD = self._v_prior_dtld(lam2, Tau2)  # (m, T, T)
        d = jnp.diagonal(DtLD, axis1=-2, axis2=-1)
        dinv = jax.lax.rsqrt(jnp.where(d > 0, d, 1.0))
        Qe = DtLD * dinv[:, :, None] * dinv[:, None, :]
        from functionalmf_tpu.ops.mvn import cholesky_psd
        L = cholesky_psd(Qe, eps=self.linalg_opts["force_psd_eps"],
                         attempts=self.linalg_opts["force_psd_attempts"]
                         if self.linalg_opts["force_psd"] else 0)
        z = jax.random.normal(key, (m, T, k), dtype=self.dtype)
        x = jax.lax.linalg.triangular_solve(L, z, left_side=True, lower=True,
                                            transpose_a=True)  # (m, T, k)
        x = x * dinv[:, :, None]
        return x.transpose(0, 2, 1).reshape(m, k * T)

    def _update_sigma2(self, state, key):
        """IG update on packed W (factor.py:130-132)."""
        W = state["W"]
        mask = self._wmask
        sq = jnp.sum((W * mask) ** 2)
        prec = jax.random.gamma(key, self.sigma2_a + self._w_len / 2.0) / (
            self.sigma2_b + sq / 2.0)
        return dict(state, sigma2=(1.0 / prec).astype(self.dtype))

    @_mm_f32
    def _update_tau2(self, state, key):
        deltas = jnp.einsum("dt,jtk->jdk", self.Delta, state["V"])
        deltas_sq = jnp.sum(deltas * deltas, axis=-1)
        t2, c, b, a = resample_tau2_ladder(
            key, deltas_sq, state["lam2"], state["Tau2"], state["Tau2_c"],
            state["Tau2_b"], state["Tau2_a"], self.nembeds, self.stability)
        return dict(state, Tau2=t2.astype(self.dtype), Tau2_c=c.astype(self.dtype),
                    Tau2_b=b.astype(self.dtype), Tau2_a=a.astype(self.dtype))

    @_mm_f32
    def _update_lam2(self, state, key):
        deltas = jnp.einsum("dt,jtk->jdk", self.Delta, state["V"])
        s = jnp.sum(deltas * deltas / jnp.clip(state["Tau2"], self.stability,
                                               1 / self.stability)[..., None])
        lam2, lam2_a = resample_lam2(key, s, state["lam2_a"], self.nD,
                                     self.ncols, self.nembeds)
        return dict(state, lam2=lam2.astype(self.dtype), lam2_a=lam2_a.astype(self.dtype))

    @staticmethod
    def _nan_guard(old_state, new_state, names=("W", "V")):
        """Last-resort numerical failsafe: if an update produced non-finite
        values (a Cholesky beyond the jitter ladder in an extreme horseshoe
        regime), keep the previous draw for that array and count the event
        in state['nan_fallbacks']. The reference instead raises after a
        diagnostic dump (factor.py:696-708, fast_mvn.py:70-72); a counted
        skip is the production-grade equivalent for long unattended runs.
        """
        state = dict(new_state)
        fallbacks = state.get("nan_fallbacks", jnp.zeros((), jnp.float32))
        for k in names:
            ok = jnp.all(jnp.isfinite(new_state[k]))
            state[k] = jnp.where(ok, new_state[k], old_state[k])
            fallbacks = fallbacks + (1.0 - ok.astype(jnp.float32))
        state["nan_fallbacks"] = fallbacks
        return state

    def _prior_sweep(self, state, data, key, update_W, update_V):
        """Shared resample dispatch, order per factor.py:112-128."""
        if self.sample_sigma2:
            state = self._update_sigma2(state, _fold(key, 11))
        if self.sample_Tau2:
            state = self._update_tau2(state, _fold(key, 12))
        if self.sample_lam2:
            state = self._update_lam2(state, _fold(key, 13))
        if self.sample_W:
            state = self._nan_guard(state, update_W(state, data, _fold(key, 14)),
                                    names=("W",))
        if self.sample_V:
            state = self._nan_guard(state, update_V(state, data, _fold(key, 15)),
                                    names=("V",))
        return state

    # ------------------------------------------------------------------
    # checkpoint / resume (SURVEY.md §5: the reference has none; device
    # runs are long, so run_gibbs(checkpoint_path=..., resume=True) persists the
    # chain state and collected draws at chunk boundaries)
    # ------------------------------------------------------------------
    def _save_checkpoint(self, path, state, offset, burn_done, collected,
                         chunks_out, pdata=None):
        """Write the chain head (state + counters) atomically, and each
        collected sample chunk to its own write-once file. Chunks are
        immutable after collection, so a run of N chunks does O(N) total
        checkpoint IO (round 1 rewrote every chunk at every boundary:
        O(N^2) and unbounded npz growth — VERDICT.md Weak #8).

        With ``pdata`` (traced_callback runs, where the hook mutates the
        prepared-data pytree that the likelihood reads — e.g. the
        doseresponse U embeddings, reference fit.py:102-150) the pdata
        leaves are persisted too, so a resumed run continues from the
        exact carried data rather than re-preparing from the original."""
        for ci, chunk in enumerate(chunks_out):
            cpath = f"{path}.chunk{ci}.npz"
            if not os.path.exists(cpath):
                tmp = cpath + ".tmp.npz"
                np.savez(tmp, **{k: np.asarray(v) for k, v in chunk.items()})
                os.replace(tmp, cpath)
        payload = {"__offset": offset, "__burn_done": burn_done,
                   "__collected": collected, "__nchunks_out": len(chunks_out)}
        for k, v in state.items():
            payload["state__" + k] = np.asarray(jax.device_get(v))
        if pdata is not None:
            leaves = jax.tree_util.tree_leaves(pdata)
            payload["__npdata_leaves"] = len(leaves)
            for i, leaf in enumerate(leaves):
                payload[f"pdata__{i}"] = np.asarray(jax.device_get(leaf))
        tmp = path + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, path)

    def _load_checkpoint(self, path, pdata_template=None):
        """Returns (state, offset, burn_done, collected, chunks_out, pdata);
        pdata is None unless the checkpoint carried data leaves AND
        ``pdata_template`` (a freshly prepared pytree, providing the tree
        structure) is given."""
        z = np.load(path)
        offset = int(z["__offset"])
        burn_done = int(z["__burn_done"])
        collected = int(z["__collected"])
        nchunks = int(z["__nchunks_out"])
        state = {k[len("state__"):]: jnp.asarray(z[k])
                 for k in z.files if k.startswith("state__")}
        pdata = None
        if pdata_template is not None and "__npdata_leaves" in z.files:
            n = int(z["__npdata_leaves"])
            treedef = jax.tree_util.tree_structure(pdata_template)
            assert treedef.num_leaves == n, (
                f"checkpoint pdata has {n} leaves but prepare_data(data) "
                f"yields {treedef.num_leaves}; the data passed to the "
                "resumed run must have the same structure")
            leaves = [jnp.asarray(z[f"pdata__{i}"]) for i in range(n)]
            pdata = jax.tree_util.tree_unflatten(treedef, leaves)
        chunks_out = []
        for ci in range(nchunks):
            cpath = f"{path}.chunk{ci}.npz"
            if os.path.exists(cpath):
                with np.load(cpath) as cz:
                    chunks_out.append({k: cz[k] for k in cz.files})
            else:  # legacy monolithic checkpoint (round-1 format)
                pre = f"out{ci}__"
                chunks_out.append({k[len(pre):]: z[k] for k in z.files
                                   if k.startswith(pre)})
        return state, offset, burn_done, collected, chunks_out, pdata

    def mark_data_dirty(self):
        """Tell the callback-mode driver that the `data` object changed and
        must be re-prepared before the next sweep (see run_gibbs)."""
        self._data_dirty = True

    # ------------------------------------------------------------------
    # abstract pieces
    # ------------------------------------------------------------------
    def prepare_data(self, data):
        raise NotImplementedError

    def _make_sweep(self):
        """Return sweep(state, pdata, key) -> state for a single chain."""
        raise NotImplementedError

    def logprob(self, data, **params):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Gibbs driver (genlasso.py:37-66 semantics)
    # ------------------------------------------------------------------
    def _sample_flags(self):
        return (self.sample_sigma2, self.sample_Tau2, self.sample_lam2,
                self.sample_W, self.sample_V)

    # ------------------------------------------------------------------
    # mesh sharding: explicit per-model partition specs (no heuristics)
    # ------------------------------------------------------------------
    def state_partition_specs(self):
        """Explicit {state key: PartitionSpec}. Axis 0 is always chains
        (dp); W shards rows and V/Tau2 shard columns over mp — the mesh
        equivalent of the reference's per-row/per-column process fan-out
        (factor.py:984-1000). Subclasses MUST extend this dict for every
        state key they add (enforced in _shard_specs)."""
        from jax.sharding import PartitionSpec as P
        from functionalmf_tpu.parallel.mesh import DP_AXIS as dp, MP_AXIS as mp
        return {
            "sigma2": P(dp), "lam2": P(dp), "lam2_a": P(dp),
            "nan_fallbacks": P(dp), "pivot_repairs": P(dp),
            "Tau2": P(dp, mp), "Tau2_a": P(dp, mp),
            "Tau2_b": P(dp, mp), "Tau2_c": P(dp, mp),
            "W": P(dp, mp),   # rows over mp
            "V": P(dp, mp),   # columns over mp
        }

    def _shard_specs(self):
        specs = self.state_partition_specs()
        missing = set(self._state) - set(specs)
        assert not missing, (
            f"state keys {sorted(missing)} have no partition spec; extend "
            f"{type(self).__name__}.state_partition_specs")
        return specs

    def state_shardings(self, mesh=None):
        """NamedShardings for this model's state on `mesh` (default
        self.mesh), with indivisible dims falling back to replication."""
        from functionalmf_tpu.parallel.mesh import specs_to_shardings
        mesh = self.mesh if mesh is None else mesh
        return specs_to_shardings(mesh, self._shard_specs(), self._state)

    def _shard_state(self, state):
        if self.mesh is None:
            return state
        shardings = self.state_shardings()
        return {k: jax.device_put(v, shardings[k]) for k, v in state.items()}

    def _collect(self, state):
        return {k: state[k] for k in self._collect_keys}

    # Upper bound on Gibbs sweeps executed per device call. Long runs are
    # chunked into repeated invocations of one compiled executable, which
    # bounds the length of any single device execution and provides
    # progress reporting and checkpoint boundaries.
    max_sweeps_per_call = 1024

    def _batched_sweep(self):
        """The model's sweep (`_make_sweep`) vmapped over the leading chain
        axis and traced at float32 matmul precision.

        The chain axis is *named* (CHAIN_AXIS) so the numerical-retry conds
        inside the sweep can chain-reduce their predicates
        (ops/banded.py:chain_reduced_pred) and keep real lazy branches
        under batching. Draw streams are unchanged:
        vmap(f)(k[None]) == f(k)[None].

        Precision policy: this is the one place it is set. Every dot the
        sweep traces without an explicit `precision` runs at full float32
        (no TF32 or bf16 passes), so an accelerator targets the same
        posterior as the CPU. GASS compares a 1-point `cur_ll` against
        ngrid-point candidate sums over thousands of cells; a ~1e-3
        relative error in tau would move those sums by whole nats and
        bias the slice test. Every compiled path (the chunked executables
        and the host-callback loop) traces through here."""
        from functionalmf_tpu.ops.banded import CHAIN_AXIS
        vsweep = jax.vmap(self._make_sweep(), in_axes=(0, None, 0),
                          axis_name=CHAIN_AXIS)

        def sweep(state, pdata, keys):
            with jax.default_matmul_precision("float32"):
                return vsweep(state, pdata, keys)
        return sweep

    def _get_compiled_chunks(self, nthin, burn_chunk_size, sample_chunk,
                             traced_callback=None, collect_data_keys=()):
        """Jitted (burn_chunk, sample_chunk) executables, cached per
        (sample flags, nchains, nthin, chunk sizes). The chunk offset is a
        traced argument, so every chunk of a run reuses one compilation.

        With `traced_callback` the per-step hook compiles INTO the chunked
        executables: the data pytree joins the loop carry so the hook's
        updates (e.g. the doseresponse U embeddings the likelihood reads,
        fit.py:102-150 in the reference) reach the next sweep without any
        host round-trip, and `collect_data_keys` names data entries to
        collect alongside the state draws."""
        cache = getattr(self, "_run_cache", None)
        if cache is None:
            cache = self._run_cache = {}
        ckey = (self._sample_flags(), self.nchains, nthin, burn_chunk_size,
                sample_chunk, id(self.mesh), id(traced_callback),
                tuple(collect_data_keys))
        if ckey in cache:
            return cache[ckey]

        vsweep = self._batched_sweep()
        collect_keys = self._collect_keys
        nchains = self.nchains
        tc = traced_callback

        # Pin the carried state to the model's (dp, mp) shardings so the
        # partitioner keeps W-rows / V-columns distributed across every
        # sweep of the loop instead of drifting to replicated (the mp-axis
        # equivalent of the reference's per-row/column worker ownership,
        # factor.py:709, 845).
        if self.mesh is not None:
            shardings = self.state_shardings()

            def pin(st):
                return {k: jax.lax.with_sharding_constraint(v, shardings[k])
                        for k, v in st.items()}
        else:
            def pin(st):
                return st

        def step_keys(base_key, step):
            base = jax.random.fold_in(base_key, step)
            return jax.vmap(lambda c: jax.random.fold_in(base, c))(
                jnp.arange(nchains, dtype=jnp.uint32))

        if tc is None:
            @jax.jit
            def burn_chunk(state, pdata, base_key, offset):
                def one(i, st):
                    return pin(vsweep(st, pdata, step_keys(base_key, offset + i)))
                return jax.lax.fori_loop(0, burn_chunk_size, one, state)

            @jax.jit
            def sample_chunk_fn(state, pdata, base_key, offset):
                def body(st, t):
                    def inner(i, s):
                        return pin(vsweep(s, pdata,
                                          step_keys(base_key, offset + t * nthin + i)))
                    st = jax.lax.fori_loop(0, nthin, inner, st)
                    return st, {k: st[k] for k in collect_keys}
                return jax.lax.scan(body, state, jnp.arange(sample_chunk))

            cache[ckey] = (burn_chunk, sample_chunk_fn)
            return cache[ckey]

        # traced-callback variants: pdata joins the carry; the hook runs
        # after every sweep with its own key stream (fold tag 0xCB)
        def one_step(carry, base_key, step):
            st, pd = carry
            st = vsweep(st, pd, step_keys(base_key, step))
            st, pd = tc(st, pd, _fold(base_key, 0xCB, step), step)
            return pin(st), pd

        @jax.jit
        def burn_chunk_tc(state, pdata, base_key, offset):
            def one(i, carry):
                return one_step(carry, base_key, offset + i)
            return jax.lax.fori_loop(0, burn_chunk_size, one, (state, pdata))

        @jax.jit
        def sample_chunk_tc(state, pdata, base_key, offset):
            def body(carry, t):
                def inner(i, c):
                    return one_step(c, base_key, offset + t * nthin + i)
                st, pd = jax.lax.fori_loop(0, nthin, inner, carry)
                out = {k: st[k] for k in collect_keys}
                out.update({"data:" + k: pd[k] for k in collect_data_keys})
                return (st, pd), out
            return jax.lax.scan(body, (state, pdata), jnp.arange(sample_chunk))

        cache[ckey] = (burn_chunk_tc, sample_chunk_tc)
        return cache[ckey]

    def run_gibbs(self, data, nburn=1000, nthin=1, nsamples=1000, verbose=True,
                  print_freq=100, callback=None, key=None,
                  traced_callback=None, collect_data_keys=(), **kwargs):
        """Blocked Gibbs: burn-in, then nsamples thinned draws.

        Returns a dict of numpy arrays with a leading sample axis; with
        nchains > 1 the chains are concatenated along the sample axis
        (chain-major), matching how the reference's examples concatenate
        chains (examples/poisson_tensor_filtering.py:260-265).

        Per-step hooks come in two flavors:
          * ``callback(model, data, step)`` — arbitrary host code (the
            reference's contract, genlasso.py:44-48); forces a per-step
            host dispatch loop, one device call per sweep.
          * ``traced_callback(state, pdata, key, step) -> (state, pdata)``
            — a jax-traceable hook compiled INTO the chunked executables
            (state/pdata are the chain-batched state dict and prepared data
            pytree, key a per-step PRNG key, step a traced int32). The
            sampler stays inside one XLA loop; use for hooks that resample
            side variables the likelihood reads (e.g. the doseresponse U
            embeddings, reference fit.py:102-150). ``collect_data_keys``
            names pdata entries to record at every thinned draw (returned
            in the results dict with a leading sample axis).
        """
        if callback is not None and traced_callback is not None:
            raise ValueError("pass either callback (host) or traced_callback "
                             "(compiled), not both")
        if key is None:
            key = _fold(self._base_key, 0x515B5)
        pdata = self.prepare_data(data)
        vsweep = self._batched_sweep()

        def step_keys(step):
            base = _fold(key, step)
            return jax.vmap(lambda c: jax.random.fold_in(base, c))(
                jnp.arange(self.nchains, dtype=jnp.uint32))

        state = self._shard_state(self._state)

        if callback is None:
            has_tc = traced_callback is not None
            nburn, nthin, nsamples = int(nburn), int(nthin), int(nsamples)
            C = max(1, min(nburn, self.max_sweeps_per_call)) if nburn else 1
            M = self.max_sweeps_per_call
            ck = dict(traced_callback=traced_callback,
                      collect_data_keys=tuple(collect_data_keys))
            thin_plan = []  # (chunk_fn, size, reps) run between draws
            nthin_chunk = max(1, nthin)
            if nthin > M:
                # long-call guard (VERDICT round-4 Weak #6): a collecting
                # chunk would otherwise execute nthin > max_sweeps_per_call
                # sweeps in one device call. Split each thin interval into
                # burn-style chunks plus a 1-sweep collecting chunk; draw
                # streams key on the absolute sweep offset, so the chain is
                # identical to the monolithic loop.
                q, r = divmod(nthin - 1, M)
                nthin_chunk = 1
                if q:
                    thin_plan.append(
                        (self._get_compiled_chunks(1, M, 1, **ck)[0], M, q))
                if r:
                    thin_plan.append(
                        (self._get_compiled_chunks(1, r, 1, **ck)[0], r, 1))
            # one draw per outer iteration when the thin interval is
            # chunked (the thin_plan must run before EVERY collect)
            S = 1 if thin_plan else max(1, min(nsamples, M // nthin_chunk))
            burn_chunk, sample_chunk = self._get_compiled_chunks(
                nthin_chunk, C, S, **ck)

            # optional one-shot profiler capture (SURVEY.md §5 tracing axis;
            # the reference has print-based progress only): the first
            # executed chunk runs under jax.profiler.trace. On a cold
            # compilation cache the capture includes compile time — pass
            # the same run twice (or enable the persistent cache,
            # utils/cache.py) for a pure steady-state trace.
            profile_pending = kwargs.get("profile_dir")

            def run_chunk(fn, *a):
                nonlocal profile_pending
                if profile_pending:
                    pdir, profile_pending = profile_pending, None
                    with jax.profiler.trace(pdir):
                        out = fn(*a)
                        jax.block_until_ready(out)
                    return out
                return fn(*a)

            checkpoint_path = kwargs.get("checkpoint_path")
            offset = 0
            burn_done = 0
            chunks_out = []
            collected = 0
            if checkpoint_path and kwargs.get("resume") and \
                    os.path.exists(checkpoint_path):
                state, offset, burn_done, collected, chunks_out, pd_ck = \
                    self._load_checkpoint(
                        checkpoint_path,
                        pdata_template=pdata if has_tc else None)
                if pd_ck is not None:
                    pdata = pd_ck
                if verbose:
                    print("\tResumed at step {} ({} samples)".format(
                        offset, collected))

            def maybe_checkpoint():
                if checkpoint_path:
                    self._save_checkpoint(checkpoint_path, state, offset,
                                          burn_done, collected, chunks_out,
                                          pdata=pdata if has_tc else None)

            # burn-in, rounded UP to whole chunks (a few extra burn sweeps
            # are harmless and avoid a second compilation for the remainder)
            nchunks = -(-nburn // C) if nburn else 0
            while burn_done < nchunks:
                out = run_chunk(burn_chunk, state, pdata, key,
                                jnp.uint32(offset))
                state, pdata = out if has_tc else (out, pdata)
                offset += C
                burn_done += 1
                if verbose and burn_done % max(1, print_freq // C) == 0:
                    jax.block_until_ready(state["W"])
                    print("\tStep {}".format(offset))
                maybe_checkpoint()

            # sampling, in chunks of S thinned draws; surplus truncated
            while collected < nsamples:
                for fn, sz, reps in thin_plan:  # only when nthin > M
                    for _ in range(reps):
                        out = run_chunk(fn, state, pdata, key,
                                        jnp.uint32(offset))
                        state, pdata = out if has_tc else (out, pdata)
                        offset += sz
                carry, outs = run_chunk(sample_chunk, state, pdata, key,
                                        jnp.uint32(offset))
                state, pdata = carry if has_tc else (carry, pdata)
                offset += S * nthin_chunk
                chunks_out.append(jax.device_get(outs))
                collected += S
                maybe_checkpoint()
            outs = {k: np.concatenate([c[k] for c in chunks_out])[:nsamples]
                    for k in chunks_out[0]}
            self._state = state
            # traced-callback data collections carry no chain axis; split
            # them off before the chain-major reformat
            data_outs = {k[len("data:"):]: np.asarray(outs.pop(k))
                         for k in list(outs) if k.startswith("data:")}
            results = self._format_results(outs, nsamples)
            results.update(data_outs)
            self._report_run_health(results, verbose)
            return results

        # Callback path: per-step host loop (callback may mutate model state,
        # e.g. doseresponse/fit.py:102-150 resamples side variables).
        nsteps = nburn + nthin * nsamples
        jsweep = jax.jit(vsweep)
        outs_host = None
        self._data_dirty = False
        for step in range(nsteps):
            if verbose and step % print_freq == 0:
                print("\tStep {}".format(step))
            self._state = jsweep(self._state, pdata, step_keys(step))
            callback(self, data, step, **kwargs)
            if self._data_dirty:
                # the callback changed side data (e.g. the U feature
                # embeddings the likelihood reads); re-prepare so the
                # compiled sweep sees the new values as traced inputs
                pdata = self.prepare_data(data)
                self._data_dirty = False
            if step >= nburn and (step - nburn) % nthin == 0:
                sidx = (step - nburn) // nthin
                snap = jax.device_get(self._collect(self._state))
                if outs_host is None:
                    outs_host = {k: np.zeros((nsamples,) + np.shape(v))
                                 for k, v in snap.items()}
                for k, v in snap.items():
                    outs_host[k][sidx] = v
        outs = {k: jnp.asarray(v) for k, v in outs_host.items()}
        results = self._format_results(outs, nsamples)
        self._report_run_health(results, verbose)
        return results

    def _report_run_health(self, results, verbose):
        """Surface the numerical-failsafe counters (VERDICT.md Weak #5): a
        chain that silently kept stale draws through _nan_guard (or sampled
        from a pivot-repaired banded factor, ops/banded.py) must say so.
        The counts land in the results dict and, when nonzero, on stderr.
        With nchains > 1, split-R-hat across the chain axis is computed for
        every collected variable and returned as results['rhat'] (VERDICT
        round-4 item 7: first-class multi-chain convergence reporting)."""
        import sys
        fb = np.asarray(jax.device_get(self._state["nan_fallbacks"]))
        pr = np.asarray(jax.device_get(self._state["pivot_repairs"]))
        results["nan_fallbacks"] = fb.reshape(self.nchains)
        results["pivot_repairs"] = pr.reshape(self.nchains)
        total = float(fb.sum())
        if total > 0 and verbose is not False:
            print(f"\tWARNING: {int(total)} numerical-failsafe event(s) "
                  f"across {self.nchains} chain(s) (nan_fallbacks="
                  f"{fb.reshape(-1).tolist()}, pivot_repairs="
                  f"{pr.reshape(-1).tolist()}); affected draws kept previous "
                  "values or a regularized conditional — inspect convergence "
                  "diagnostics.", file=sys.stderr)
        if self.nchains > 1:
            results["rhat"] = rhat = self._compute_rhat(results)
            if verbose is not False and rhat.get("max", 1.0) > 1.1:
                worst = max((v, k) for k, v in rhat.items() if k != "max")
                print(f"\tWARNING: split-R-hat {worst[0]:.3f} on "
                      f"'{worst[1]}' exceeds 1.1 — the chains have not "
                      "converged to a common distribution; increase nburn "
                      "or inspect per-chain traces.", file=sys.stderr)

    def _compute_rhat(self, results, max_params: int = 4096):
        """Max split-R-hat per collected variable across the chain axis
        (subsampled above `max_params` scalars per variable), plus the
        overall 'max'. Draws arrive chain-major concatenated
        (_format_results), so reshape to (nchains, nsamples, -1)."""
        from functionalmf_tpu.utils.diagnostics import split_rhat
        rng = np.random.default_rng(0)
        out = {}
        for k in self._collect_keys:
            if k not in results:
                continue
            v = np.asarray(results[k])
            if v.shape[0] % self.nchains:
                continue
            v = v.reshape(self.nchains, v.shape[0] // self.nchains, -1)
            if v.shape[1] < 4:
                continue
            cols = v.shape[-1]
            idx = (range(cols) if cols <= max_params
                   else rng.choice(cols, size=max_params, replace=False))
            out[k] = float(max(split_rhat(v[:, :, j]) for j in idx))
        if out:
            out["max"] = float(max(out.values()))
        return out

    def _format_results(self, outs, nsamples):
        """(nsamples, nchains, ...) device outputs -> reference-shaped numpy."""
        results = {}
        for k, v in outs.items():
            v = np.asarray(jax.device_get(v))
            # chain-major concatenation
            v = np.swapaxes(v, 0, 1).reshape((self.nchains * nsamples,) + v.shape[2:])
            if v.ndim == 1:  # scalars stored as (nsamples, 1) (genlasso.py:61)
                v = v[:, None]
            results[k] = v
        return results

    # ------------------------------------------------------------------
    # DIC hyperparameter selection (genlasso.py:69-136)
    # ------------------------------------------------------------------
    def _default_hyperparam_options(self, hyperparams, lam2=None,
                                    min_lam2=1e-6, max_lam2=1e3, num_lam2=10,
                                    **kwargs):
        # factor.py:267-275 (with the undefined-`lam` bug fixed: test lam2)
        if lam2 is None:
            hyperparams["lam2"] = np.exp(np.linspace(np.log(min_lam2),
                                                     np.log(max_lam2),
                                                     num_lam2))[::-1]
        else:
            hyperparams["lam2"] = lam2

    def _set_hyperparameters(self, hyperparams):
        self._state["lam2"] = self._chain_full((), hyperparams["lam2"])

    def select_hyperparams_DIC(self, data, verbose=True, **kwargs):
        """DIC grid search (genlasso.py:69-136)."""
        hyperparam_options = {}
        run_kwarg_names = ("nburn", "nthin", "nsamples", "print_freq", "callback")
        run_kwargs = {k: kwargs.pop(k) for k in run_kwarg_names if k in kwargs}
        self._default_hyperparam_options(hyperparam_options, **kwargs)

        param_names = list(hyperparam_options.keys())
        param_options = [hyperparam_options[n] for n in param_names]
        all_indices = [d for d in np.ndindex(*[len(p) for p in param_options])]
        dic_scores = np.zeros(len(all_indices))
        best_results, best_score, best_idx = None, None, None

        for score_idx, indices in enumerate(all_indices):
            cur = {param_names[p]: param_options[p][i] for p, i in enumerate(indices)}
            if verbose:
                print(" ".join(f"{k}={v}" for k, v in cur.items()))
            self._set_hyperparameters(cur)
            results = self.run_gibbs(data, verbose=False, **run_kwargs)
            # posterior-draw arrays only (results also carries run-health
            # diagnostics like nan_fallbacks, which have no sample axis)
            draws = {k: results[k] for k in self._collect_keys if k in results}
            nsamples = next(iter(draws.values())).shape[0]
            mean_results = {k: v.mean(axis=0) for k, v in draws.items()}
            D_mean = -2 * self.logprob(data, **mean_results)
            mean_D = -2 * np.mean([
                self.logprob(data, **{k: v[i] for k, v in draws.items()})
                for i in range(nsamples)])
            dic_scores[score_idx] = 2 * mean_D - D_mean
            if best_score is None or dic_scores[score_idx] < best_score:
                best_results, best_score, best_idx = results, dic_scores[score_idx], score_idx

        best = {param_names[p]: param_options[p][i]
                for p, i in enumerate(all_indices[best_idx])}
        self._set_hyperparameters(best)
        return {"scores": dic_scores, "options": hyperparam_options,
                "best": best, "fit": best_results}
