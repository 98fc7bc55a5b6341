"""Constrained black-box-likelihood BTF — the reference's flagship model.

JAX re-design of ConstrainedNonconjugateBayesianTensorFiltering
(reference functionalmf/factor.py:894-1017 + module-level workers
factor.py:656-892): per-row / per-column GASS updates under user linear
constraints ``A tau >= c`` on every curve tau_ij. = <w_i, v_j.>, with
constraints re-derived each step from the *opposite* embedding
(factor.py:711-725, 847-854), optional fixed Row_constraints, and optional
EP centering of the Gaussian proposal (factor.py:677-683, 771-797).

Architecture deltas from the reference (SURVEY.md §2.5, §7):
  * the multiprocessing Pool + POSIX shared-memory fan-out
    (factor.py:929-1000) is replaced by `vmap` over rows and columns inside
    one jitted sweep — the row updates are mutually conditionally
    independent given V (and vice versa), so the batched update is exact;
  * GASS runs with static shapes (see samplers/gass.py);
  * the user log-likelihood is a jax-traceable function with the
    reference's signature ``loglikelihood(data, WV, W, V, row=None,
    col=None) -> scalar`` evaluated *unbatched* — the framework supplies
    the grid batching via vmap (the reference looped candidates in Python,
    factor.py:739, 870). `row`/`col` arrive as traced int32 scalars.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.stats import norm as jnorm

from functionalmf_tpu.models.base import BayesianTensorFiltering, _fold
from functionalmf_tpu.ops.mvn import sample_mvn_from_precision, cholesky_psd
from functionalmf_tpu.samplers.gass import gass
from functionalmf_tpu.samplers.slice1d import shrink_slice_1d

__all__ = ["ConstrainedNonconjugateBayesianTensorFiltering"]


def _cells_from_cellfn(cellfn):
    """Derive the `loglikelihood_cells` contract from an elementwise
    cellfn (VERDICT round-4 item 4: the cellfn logically determines every
    narrower contract, so the framework builds them instead of the user
    hand-synchronizing three variants of the same likelihood). Valid for
    single-tensor (n, m, T[, r]) data; structured data still takes an
    explicit loglikelihood_cells."""
    def cells(data, WV, W, Vb, col=None, t0=None, size=None):
        leaves = jax.tree_util.tree_leaves(data)
        if len(leaves) != 1:
            raise TypeError(
                "deriving loglikelihood_cells from loglikelihood_cellfn "
                "requires single-tensor data; pass an explicit "
                "loglikelihood_cells for structured data")
        Yb = jax.lax.dynamic_slice_in_dim(leaves[0][:, col], t0, size,
                                          axis=1)
        tau = WV if Yb.ndim == WV.ndim else WV[..., None]
        return jnp.sum(cellfn(Yb, jnp.broadcast_to(tau, Yb.shape)))
    return cells


def _block_from_cells(cells):
    """Derive `loglikelihood_block` (static tslice) from the cells
    contract (traced t0): a static slice is just a special case."""
    def block(data, WV, W, Vb, row=None, col=None, tslice=None):
        s0, e0 = tslice
        return cells(data, WV, W, Vb, col=col, t0=s0, size=e0 - s0)
    return block


def _ep_logpdf(tau, mu_ep, sigma_ep):
    """Sum of N(tau | mu_ep, sigma_ep) logpdfs with NaN cells masked
    (the EP renormalization divided out of the likelihood,
    factor.py:754-756, 889-891)."""
    lp = jnorm.logpdf(tau, mu_ep, sigma_ep)
    return jnp.sum(jnp.where(jnp.isnan(mu_ep), 0.0, lp))


class ConstrainedNonconjugateBayesianTensorFiltering(BayesianTensorFiltering):
    """Constrained nonconjugate BTF (factor.py:894-1017)."""

    def __init__(self,
                 nrows, ncols, ndepth,
                 loglikelihood,       # traceable black-box loglikelihood
                 Constraints,         # (J, T+1): rows [A | c], A tau >= c
                 ep_approx=None,      # optional (Mu_ep, Sigma_ep) centering
                 nthreads=None,       # parity kwarg; parallelism is on-device
                 gass_ngrid=100,
                 gass_w_repeats=1,    # GASS updates of W per sweep; >1
                                      # multiplies W mixing at ~linear cost
                                      # in the W block only (the W update
                                      # is a small fraction of sweep time
                                      # at functional shapes, bench/profile)
                 gass_v_repeats=1,    # likewise for the V update
                 gass_method="grid",  # "grid" = reference-parity kernel;
                                      # "shrink" = Neal bracket shrinkage on
                                      # the feasible arc (samplers/gass.py):
                                      # always moves, step scale ~ the
                                      # conditional width — use when the
                                      # grid kernel's per-sweep movement
                                      # collapses (tight data / wide prior)
                 Row_constraints=None,  # optional (nR, k+1) fixed [A | c]
                 multiprocessing=None,  # parity kwarg (unused)
                 sharedprefix=None,     # parity kwarg (unused)
                 worker_init=None,      # parity kwarg (unused)
                 v_block_size=8,        # time-block size for the V GASS
                                        # updates; None/>=ndepth = the
                                        # reference's joint update. 8 gives
                                        # ~nominal posterior coverage on the
                                        # flagship example where the joint
                                        # update reaches only ~78% at the
                                        # 90% level (RESULTS.md)
                 v_schedule="seq",      # "seq" = sequential time blocks
                                        # (Gauss-Seidel); "redblack" = the
                                        # two-color schedule: all even
                                        # blocks update in ONE batched GASS
                                        # call given the odd blocks, then
                                        # vice versa. Exact Gibbs when the
                                        # likelihood factorizes over depth
                                        # (requires loglikelihood_cells),
                                        # the prior bandwidth <= block size
                                        # and every constraint row's
                                        # support width <= block size + 1 —
                                        # then non-adjacent blocks are
                                        # conditionally independent. Cuts
                                        # the V update's sequential depth
                                        # from T/bs GASS rounds to 2-3.
                 loglikelihood_cells=None,  # cellwise likelihood for the
                                        # redblack schedule: (data, WV_blk,
                                        # W, V_blk, col=j, t0=<traced int>,
                                        # size=<static int>) -> scalar
                                        # loglik of the cells in
                                        # [t0, t0+size) of column j alone;
                                        # slice data with
                                        # jax.lax.dynamic_slice_in_dim
                                        # (t0 is traced under the batched
                                        # schedule, size is static)
                 loglikelihood_block=None,  # optional fast path for the
                                        # blocked V updates: ONLY valid when
                                        # the likelihood factorizes over the
                                        # depth axis (e.g. cell-wise Poisson).
                                        # Signature: (data, WV_blk, W, V_blk,
                                        # row=None, col=j, tslice=(s0, e0))
                                        # -> scalar log-lik of the block's
                                        # cells alone; WV_blk is (nrows,
                                        # e0-s0), V_blk (e0-s0, nembeds),
                                        # s0/e0 static Python ints. The
                                        # out-of-block terms are constant
                                        # within a block update, so the
                                        # slice test is exact while the
                                        # evaluated volume shrinks T/bs-fold.
                 loglikelihood_cellfn=None,  # optional ELEMENTWISE cell
                                        # log-likelihood (y, tau) -> ll,
                                        # same-shape arrays, MUST return 0
                                        # where y is NaN. Implies the
                                        # likelihood factorizes over cells.
                                        # Omit y-only terms (e.g. the
                                        # Poisson -gammaln(y+1)): they
                                        # cancel in the GASS slice test.
                                        # Supplying a cellfn is the ONE
                                        # opt-in needed for every blocked
                                        # schedule: loglikelihood_cells and
                                        # loglikelihood_block are DERIVED
                                        # from it (single-tensor data);
                                        # pass them explicitly only for
                                        # structured data pytrees.
                 interweave=True,       # ancillarity-sufficiency
                                        # interweaving (ASIS) moves on the
                                        # global scales: after the
                                        # conjugate lam2 | V and
                                        # sigma2 | W draws, re-draw each
                                        # from its ancillary conditional
                                        # p(scale) * lik(rescaled state)
                                        # by exact 1-D slice sampling and
                                        # rescale V (resp. W). The
                                        # conjugate conditionals have
                                        # shape ~ m*T*k/2, so lam2 | V is
                                        # near-deterministic and mixes
                                        # only as fast as V's global
                                        # scale — the reference's own
                                        # TODO (factor.py:144-146). The
                                        # AA conditional is exact: the
                                        # Gaussian normalizer and the
                                        # reparameterization Jacobian
                                        # cancel (samplers/slice1d.py).
                 factor_rebalance=True,  # per-factor scale-split rebalance
                                        # inside the interweave block: the
                                        # RELATIVE scale of each rank-1
                                        # factor, (W[:,kk], V[:,:,kk]) ->
                                        # (W[:,kk]/c, c V[:,:,kk]), is
                                        # likelihood-invariant (tau's kk-th
                                        # rank-1 term is unchanged) and
                                        # only prior-pinned, exactly like
                                        # the global W<->V split — so it
                                        # random-walks too, and it loads on
                                        # every V[:, :, kk] coordinate (the
                                        # V-tail min-ESS after the global
                                        # moves, BENCH_r05). One collapsed
                                        # 1-D slice draw per factor, no
                                        # likelihood evaluations. Only
                                        # active when interweave=True.
                 **kwargs):
        super().__init__(nrows, ncols, ndepth, **kwargs)
        self.loglikelihood = loglikelihood
        # contract derivation: cellfn => cells => block (explicit kwargs
        # override; they remain supported for structured data)
        if loglikelihood_cellfn is not None and loglikelihood_cells is None:
            loglikelihood_cells = _cells_from_cellfn(loglikelihood_cellfn)
        if loglikelihood_cells is not None and loglikelihood_block is None:
            loglikelihood_block = _block_from_cells(loglikelihood_cells)
        self.loglikelihood_block = loglikelihood_block
        self.loglikelihood_cells = loglikelihood_cells
        self.loglikelihood_cellfn = loglikelihood_cellfn
        self.interweave = bool(interweave)
        self.factor_rebalance = bool(factor_rebalance)
        self.gass_ngrid = int(gass_ngrid)
        self.gass_w_repeats = max(1, int(gass_w_repeats))
        self.gass_v_repeats = max(1, int(gass_v_repeats))
        if gass_method not in ("grid", "shrink"):
            raise ValueError(f"unknown gass_method {gass_method!r}")
        self.gass_method = gass_method
        self.v_block_size = (None if v_block_size is None
                             else int(v_block_size))
        if v_schedule not in ("seq", "redblack"):
            raise ValueError(f"unknown v_schedule {v_schedule!r}")
        self.v_schedule = v_schedule
        if v_schedule == "redblack":
            bs = self.v_block_size
            if bs is None or bs >= ndepth:
                raise ValueError("redblack needs a finite v_block_size < T")
            if loglikelihood_cells is None:
                raise ValueError(
                    "the redblack schedule updates non-adjacent blocks "
                    "simultaneously, which is only an exact Gibbs kernel "
                    "for likelihoods that factorize over the depth axis — "
                    "pass loglikelihood_cells")
            supp = np.abs(np.asarray(self.Delta)) > 0
            extents = [np.nonzero(r)[0] for r in supp if r.any()]
            delta_ext = max(int(e.max() - e.min()) for e in extents)
            if delta_ext > bs:  # DtLD bandwidth = Delta row extent
                raise ValueError(
                    f"prior bandwidth {delta_ext} > v_block_size {bs}: "
                    "non-adjacent blocks would couple through the prior")
            csupp = np.abs(np.asarray(Constraints[:, :-1])) > 0
            cext = [np.nonzero(r)[0] for r in csupp if r.any()]
            cons_w = max((int(e.max() - e.min()) + 1 for e in cext),
                         default=0)
            if cons_w > bs + 1:
                raise ValueError(
                    f"a constraint row spans {cons_w} time points > "
                    f"v_block_size + 1 = {bs + 1}: it could couple two "
                    "same-color blocks")

        Constraints = np.asarray(Constraints, dtype=np.float32)
        self._CA_np = Constraints[:, :-1]  # host copy for static block masks
        # host numpy, embedded as jaxpr constants at trace time: the
        # blocked V update slices these once per time block per trace
        self.Constraints_A = Constraints[:, :-1]                 # (J, T)
        self.Constraints_C = Constraints[:, -1]                  # (J,)
        self.nconstraints = int(Constraints.shape[0])

        # Row_constraints live in the state dict so they are *traced* inputs:
        # the doseresponse pipeline rewrites them every step from a callback
        # (fit.py:133-137), which must reach the compiled sweep.
        self._has_row_constraints = Row_constraints is not None
        if self._has_row_constraints:
            Row_constraints = np.asarray(Row_constraints, dtype=np.float32)
            assert Row_constraints.shape[1] == self.nembeds + 1
            self._state["Row_constraints"] = self._chain_broadcast(
                Row_constraints, Row_constraints.shape)

        if ep_approx is None:
            self.Mu_ep, self.Sigma_ep = None, None
        else:
            # host numpy (trace-time constants), same rationale as above
            self.Mu_ep = np.asarray(ep_approx[0], np.float32)
            self.Sigma_ep = np.asarray(ep_approx[1], np.float32)
            # An overconfident EP traps the chain: the subtracted EP logpdf
            # grows quadratically with distance from Mu_ep, so once an
            # excursion leaves the EP bulk, every candidate nearer the
            # center falls below the slice. The reference's ep_from_mf
            # deliberately OVERestimates Sigma (utils.py:423-438); warn if
            # Sigma_ep looks tight relative to the centers' spread.
            mu_np = np.asarray(ep_approx[0], np.float64)
            sig_np = np.asarray(ep_approx[1], np.float64)
            spread = np.nanstd(mu_np)
            if np.nanmedian(sig_np) < 0.5 * spread:
                import warnings
                warnings.warn(
                    "Sigma_ep is small relative to the spread of Mu_ep "
                    f"(median {np.nanmedian(sig_np):.3g} vs std {spread:.3g}); "
                    "overconfident EP approximations can trap the GASS chain "
                    "— consider ep_from_mf(mode='multiplier', multiplier>=3).")

    def state_partition_specs(self):
        from jax.sharding import PartitionSpec as P
        from functionalmf_tpu.parallel.mesh import DP_AXIS as dp
        specs = super().state_partition_specs()
        if self._has_row_constraints:
            # small (nR, k+1) matrix read whole by every row update
            specs["Row_constraints"] = P(dp)
        return specs

    @property
    def Row_constraints(self):
        if not self._has_row_constraints:
            return None
        return self._get_var("Row_constraints")

    @Row_constraints.setter
    def Row_constraints(self, value):
        assert self._has_row_constraints, \
            "Row_constraints must be provided at construction to be updatable"
        self._set_var("Row_constraints", value)

    def shutdown(self):
        """Parity no-op (the reference tears down its pool and shared
        memory, factor.py:963-982; there is nothing to tear down here)."""

    def prepare_data(self, data):
        dt = self.data_dtype or self.dtype
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x, dtype=np.float32), dt), data)

    # ------------------------------------------------------------------
    # W update: vmapped GASS over rows (factor.py:665-757, 984-991)
    # ------------------------------------------------------------------
    def _mp_spec(self):
        """(axis_name, size) when a model-parallel mesh axis is active."""
        if self.mesh is None:
            return None
        from functionalmf_tpu.parallel.mesh import MP_AXIS
        if MP_AXIS not in self.mesh.axis_names:
            return None
        size = int(self.mesh.shape[MP_AXIS])
        return (MP_AXIS, size) if size > 1 else None

    @staticmethod
    def _data_shardable(data, axis, size):
        leaves = jax.tree_util.tree_leaves(data)
        return bool(leaves) and all(
            getattr(lf, "ndim", 0) > axis and lf.shape[axis] % size == 0
            for lf in leaves)

    @staticmethod
    def _data_single_tensor(data):
        """True when `data` is one (n, m, T) or (n, m, T, 1) tensor — the
        shapes a cellfn can be applied to directly."""
        leaves = jax.tree_util.tree_leaves(data)
        if len(leaves) != 1:
            return False
        lf = leaves[0]
        nd = getattr(lf, "ndim", 0)
        return nd == 3 or (nd == 4 and lf.shape[-1] == 1)

    @staticmethod
    def _data_specs(data, axis_pos, axis_name):
        from jax.sharding import PartitionSpec as P

        def spec(lf):
            dims = [None] * lf.ndim
            dims[axis_pos] = axis_name
            return P(*dims)
        return jax.tree_util.tree_map(spec, data)

    def _update_W_gass(self, state, data, key):
        """GASS over rows (factor.py:665-757, 984-991).

        Under an mp mesh axis the row fan-out runs inside an explicit
        `jax.shard_map` region — the mesh equivalent of the reference's
        per-row worker ownership (factor.py:984-991). Measured rationale
        (bench/mp_hlo.json, round 4): left to GSPMD, the traced-index data
        gather inside the vmapped likelihood makes the partitioner
        replicate the whole candidate chain — 274 MB/sweep of all-gathers
        at GDELT shape. Explicit SPMD keeps candidates row-local; the only
        cross-shard term is the (m*J, k) constraint matrix assembled from
        all of V (einsum below), which shard_map all-gathers at ~100 KB.
        All randomness (v_all, per-row keys) is drawn OUTSIDE the region
        with global-index folds, so the sharded path reproduces the
        unsharded draw stream exactly (tests/test_parallel.py).
        """
        n, m, T, k = self.nrows, self.ncols, self.ndepth, self.nembeds
        V = state["V"]
        sigma2 = state["sigma2"]
        CA, CC = self.Constraints_A, self.Constraints_C

        # Constraints from the opposite embedding (factor.py:711-719):
        # A_w[(j', col), a] = sum_t CA[j', t] V[col, t, a], shared across rows
        # up to the per-row dim mask. HIGHEST precision is required: the
        # default matmul pass rounds V to bfloat16 inside the contraction,
        # so feasibility would be enforced against a ~0.3%-off constraint
        # matrix and accepted W draws could violate the true constraints by
        # up to ~1e-3 (caught by an end-to-end feasibility audit).
        _hp = jax.lax.Precision.HIGHEST
        A_base = jnp.einsum("jt,mta->mja", CA, V,
                            precision=_hp).reshape(m * self.nconstraints, k)
        c_base = jnp.asarray(np.tile(np.asarray(CC), m))
        if self._has_row_constraints:
            RC = state["Row_constraints"]
            A_base = jnp.concatenate([A_base, RC[:, :k]], axis=0)
            c_base = jnp.concatenate([c_base, RC[:, k]], axis=0)

        mask = self._wmask  # (n, k)
        eye = np.eye(k, dtype=np.float32)

        # Proposal Gaussian: EP-centered GLS or the isotropic prior
        # (factor.py:677-687). EP tensors go to device once here (they are
        # indexed by row position inside the core below).
        if self.Mu_ep is not None:
            Mu_ep_d = jnp.asarray(self.Mu_ep, self.dtype)
            Sigma_ep_d = jnp.asarray(self.Sigma_ep, self.dtype)
            Sinv2 = 1.0 / (Sigma_ep_d ** 2)
            Sinv2 = jnp.where(jnp.isnan(Mu_ep_d), 0.0, Sinv2)
            Mu0 = jnp.where(jnp.isnan(Mu_ep_d), 0.0, Mu_ep_d)
            # HIGHEST: the proposal Gaussian must match the EP factor that
            # the acceptance divides out analytically (_ep_logpdf)
            Q = (jnp.einsum("imt,mta,mtb->iab", Sinv2, V, V, precision=_hp)
                 * mask[:, :, None] * mask[:, None, :] + eye / sigma2)
            mu_part = jnp.einsum("imt,mta->ia", Mu0 * Sinv2, V,
                                 precision=_hp) * mask
            L = cholesky_psd(Q, **{"eps": self.linalg_opts["force_psd_eps"],
                                   "attempts": self.linalg_opts["force_psd_attempts"]})
            mu_all = jax.vmap(lambda Lq, b: jax.scipy.linalg.cho_solve((Lq, True), b))(
                L, mu_part)
        else:
            Mu_ep_d = Sigma_ep_d = None
            Q = jnp.broadcast_to(eye / sigma2, (n, k, k))
            mu_all = jnp.zeros((n, k), self.dtype)

        # one batched prior draw for all rows
        v_all = sample_mvn_from_precision(_fold(key, 0), Q,
                                          **self.linalg_opts) * mask
        keys = jax.vmap(lambda i: _fold(key, 1, i))(
            jnp.arange(n, dtype=jnp.uint32))

        user_ll = self.loglikelihood
        has_ep = self.Mu_ep is not None
        ngrid, method = self.gass_ngrid, self.gass_method

        def rows_core(W_rows, rmask, mu_rows, v_rows, krows, data_r,
                      mu_ep_r, sig_ep_r, A_base, c_base, V):
            """GASS over a row block; data_r / EP slices are row-aligned
            with W_rows, so in-likelihood `row` indices are positions
            within the block (the contract indexes the data argument)."""
            nr = W_rows.shape[0]

            def row_gass(i, w_i, dmask, mu_i, v_i, k_i):
                A_i = A_base * dmask[None, :]

                def loglik(cands):  # (G, k) -> (G,)
                    w = cands * dmask[None, :]
                    tau = jnp.einsum("gk,mtk->gmt", w, V)

                    def one(tau_g, w_g):
                        ll = user_ll(data_r, tau_g, w_g, V, row=i, col=None)
                        if has_ep:
                            ll = ll - _ep_logpdf(tau_g, mu_ep_r[i],
                                                 sig_ep_r[i])
                        return ll

                    return jax.vmap(one)(tau, w)

                x_new, _ = gass(k_i, w_i, None, loglik, A_i, c_base,
                                mu=mu_i, ngrid=ngrid,
                                dim_mask=dmask, v=v_i, method=method)
                return x_new

            W_new = jax.vmap(row_gass)(jnp.arange(nr), W_rows, rmask,
                                       mu_rows, v_rows, krows)
            return W_new * rmask

        mask_d = jnp.asarray(mask)
        mp = self._mp_spec()
        if (mp is not None and n % mp[1] == 0
                and self._data_shardable(data, 0, mp[1])):
            axis = mp[0]
            from jax.sharding import PartitionSpec as P
            rspec = P(axis)
            ep_in = ((self._data_specs(Mu_ep_d, 0, axis),
                      self._data_specs(Sigma_ep_d, 0, axis))
                     if has_ep else (P(), P()))
            zero = jnp.zeros((), self.dtype)
            sm = jax.shard_map(
                rows_core, mesh=self.mesh,
                in_specs=(rspec, rspec, rspec, rspec, rspec,
                          self._data_specs(data, 0, axis),
                          ep_in[0], ep_in[1], P(), P(), P()),
                out_specs=rspec, check_vma=False)
            W_new = sm(state["W"], mask_d, mu_all, v_all, keys, data,
                       Mu_ep_d if has_ep else zero,
                       Sigma_ep_d if has_ep else zero,
                       A_base, c_base, V)
        else:
            W_new = rows_core(state["W"], mask_d, mu_all, v_all, keys, data,
                              Mu_ep_d, Sigma_ep_d, A_base, c_base, V)
        return dict(state, W=W_new.astype(self.dtype))

    # ------------------------------------------------------------------
    # V update: vmapped GASS over columns (factor.py:759-892, 993-1000)
    # ------------------------------------------------------------------
    def _update_V_gass(self, state, data, key):
        """Blocked GASS over time segments of each column.

        The reference updates each V_j *jointly* (all kT coordinates on one
        ellipse, factor.py:759-845). At scale this mixes pathologically: the
        feasible arc of a 1000+-dim ellipse under thousands of constraints
        is O(1e-3) radians, so per-sweep movement is negligible. We instead
        run GASS sequentially on time blocks of size `v_block_size`
        conditional on the rest — still an exact Gibbs kernel (the
        conditional Gaussian prior of a block under the block-banded
        precision has a closed form), with far larger feasible arcs and
        lower dimension per update. v_block_size >= T reproduces the
        reference's joint update exactly.

        Design notes:
          * GASS runs in *block coordinates* (D = size*k, t-major): frozen
            out-of-block coordinates contribute a constant to every
            constraint row, folded into the offsets c' = c - A_out x_out.
          * The constraint matrix A[(i,jc),(t,a)] = CA[jc,t] W[i,a] is never
            materialized: gass() receives the factorized operator
            y -> (W (CA_blk y)^T), two small matmuls instead of hundreds of
            MB of HBM traffic per sweep.
          * The conditional precision of a block is a direct slice
            DtLD[s0:e0, s0:e0] (+ the EP Gram on its t-diagonal) — the prior
            couples blocks only through DtLD, the EP Gram is t-diagonal.
          * Under an mp mesh axis the column fan-out runs inside an
            explicit `jax.shard_map` region (the reference's per-column
            worker ownership, factor.py:993-1000): columns are mutually
            independent given W, so the region needs NO collectives at
            all — W enters replicated, data/EP enter column-sharded.
            Left to GSPMD, the traced-index data gather in the likelihood
            replicated the whole (m, G, T, k) candidate chain — 274
            MB/sweep of all-gathers at GDELT shape (bench/mp_hlo.json).
            Randomness (block z's, per-column keys) is drawn OUTSIDE the
            region with global-index folds: sharded == unsharded draws.
        """
        from functionalmf_tpu.ops.mvn import _cho_solve, cholesky_psd

        n, m, T, k = self.nrows, self.ncols, self.ndepth, self.nembeds
        W = state["W"] * self._wmask
        CA, CC = self.Constraints_A, self.Constraints_C
        _hp = jax.lax.Precision.HIGHEST

        if self.Mu_ep is not None:
            Mu_ep_d = jnp.asarray(self.Mu_ep, self.dtype)
            Sigma_ep_d = jnp.asarray(self.Sigma_ep, self.dtype)
        else:
            Mu_ep_d = Sigma_ep_d = None

        data_c = data
        user_ll = self.loglikelihood
        user_ll_blk = self.loglikelihood_block
        has_ep = self.Mu_ep is not None
        ngrid, method = self.gass_ngrid, self.gass_method
        linalg_opts = self.linalg_opts
        CA_np, CC_np = self._CA_np, np.asarray(CC)
        dtype = self.dtype
        dtld_fn = self._v_prior_dtld  # full-f32 matmul scoping (base.py)

        bs = self.v_block_size or T
        blocks = [(bi, s0, min(s0 + bs, T))
                  for bi, s0 in enumerate(range(0, T, bs))]

        # all randomness, drawn with GLOBAL column folds (stream parity
        # between the sharded and unsharded paths)
        zs = tuple(jax.random.normal(_fold(key, 2, bi), (m, e0 - s0, k),
                                     dtype)
                   for bi, s0, e0 in blocks)
        gkeys = tuple(jax.vmap(lambda j, bi=bi: _fold(key, 3, bi, j))(
            jnp.arange(m, dtype=jnp.uint32)) for bi, s0, e0 in blocks)

        def cols_core(X, Tau2, lam2, W, data_c, mu_ep_c, sig_ep_c,
                      zs, gkeys):
            """Blocked GASS over a column block; data/EP slices are
            column-aligned with X, so in-likelihood `col` indices are
            positions within the block."""
            mm = X.shape[0]
            DtLD = dtld_fn(lam2, Tau2)                       # (mm, T, T)
            if has_ep:
                Sinv2 = 1.0 / (sig_ep_c ** 2)
                Sinv2 = jnp.where(jnp.isnan(mu_ep_c), 0.0, Sinv2)
                Mu0 = jnp.where(jnp.isnan(mu_ep_c), 0.0, mu_ep_c)
                G = jnp.einsum("ijt,ia,ib->jtab", Sinv2, W, W,
                               precision=_hp)               # (mm, T, k, k)
                mu_part = jnp.einsum("ijt,ia->jta", Mu0 * Sinv2, W,
                                     precision=_hp)         # (mm, T, k)
            else:
                G = None
                mu_part = jnp.zeros((mm, T, k), dtype)

            for bi, s0, e0 in blocks:
                size = e0 - s0

                # ---- conditional Gaussian of the block given the rest ----
                # (HIGHEST precision: the horseshoe gives DtLD a 1e-6..1e6
                # dynamic range, and the ellipse center must be the exact
                # conditional mean for the slice sampler to target the right
                # distribution — a reduced-precision TF32/bf16 pass biases
                # it)
                DtLD_blk = DtLD[:, s0:e0, s0:e0]             # (mm, size, size)
                X_out = X.at[:, s0:e0].set(0.0)
                cross = jnp.einsum("mts,msk->mtk", DtLD[:, s0:e0, :], X_out,
                                   precision=_hp)
                rhs_tk = mu_part[:, s0:e0] - cross           # (mm, size, k)
                z = zs[bi]
                if has_ep:
                    # coupled (size*k) system: kron-embed DtLD_blk, add the
                    # EP Gram on the t-diagonal (t-major packing)
                    Qd = jnp.einsum("mts,ab->mtasb", DtLD_blk,
                                    np.eye(k, dtype=np.float32),
                                    precision=_hp)
                    Qd = Qd + jnp.einsum("mtab,ts->mtasb", G[:, s0:e0],
                                         np.eye(size, dtype=np.float32),
                                         precision=_hp)
                    Qbb = Qd.reshape(mm, size * k, size * k)
                    rhs = rhs_tk.reshape(mm, size * k)
                    d = jnp.diagonal(Qbb, axis1=-2, axis2=-1)
                    dinv = jax.lax.rsqrt(jnp.where(d > 0, d, 1.0))
                    Qe = Qbb * dinv[:, :, None] * dinv[:, None, :]
                    L = cholesky_psd(Qe, eps=linalg_opts["force_psd_eps"],
                                     attempts=linalg_opts["force_psd_attempts"])
                    mu_b = (_cho_solve(L, rhs * dinv) * dinv).reshape(
                        mm, size, k)
                    v_b = (jax.lax.linalg.triangular_solve(
                        L, (z.reshape(mm, size * k))[..., None],
                        left_side=True, lower=True,
                        transpose_a=True)[..., 0]
                        * dinv).reshape(mm, size, k)
                else:
                    # without EP the conditional precision is
                    # kron(I_k, DtLD_blk): factor (mm, size, size) once,
                    # solve all k embeddings as RHS
                    d = jnp.diagonal(DtLD_blk, axis1=-2, axis2=-1)
                    dinv = jax.lax.rsqrt(jnp.where(d > 0, d, 1.0))
                    Qe = DtLD_blk * dinv[:, :, None] * dinv[:, None, :]
                    L = cholesky_psd(Qe, eps=linalg_opts["force_psd_eps"],
                                     attempts=linalg_opts["force_psd_attempts"])
                    y = jax.lax.linalg.triangular_solve(
                        L, rhs_tk * dinv[..., None], left_side=True,
                        lower=True)
                    mu_b = jax.lax.linalg.triangular_solve(
                        L, y, left_side=True, lower=True,
                        transpose_a=True) * dinv[..., None]
                    v_b = jax.lax.linalg.triangular_solve(
                        L, z, left_side=True, lower=True,
                        transpose_a=True) * dinv[..., None]

                # ---- constraints restricted to the block (factor.py:847-854,
                # in block coordinates). Only rows whose support intersects
                # the block can change; frozen coordinates fold into the
                # offsets.
                rel = np.nonzero(
                    np.abs(CA_np[:, s0:e0]).sum(axis=1) > 0)[0]
                if len(rel) == 0:
                    # one trivially satisfied row keeps static shapes
                    A_op = lambda y: jnp.zeros((1,), dtype)  # noqa: E731
                    c_cols = jnp.full((mm, 1), -1.0, jnp.float32)
                else:
                    # host-side constant slicing (CA/CC are numpy): no eager
                    # device ops per block per trace
                    CA_blk = CA[rel][:, s0:e0]               # (J_rel, size)
                    CA_out = CA[rel].copy()                  # (J_rel, T)
                    CA_out[:, s0:e0] = 0.0

                    def A_op(y):  # (size*k,) -> (n*J_rel,)
                        M = jnp.dot(CA_blk, y.reshape(size, k),
                                    precision=_hp)
                        return jnp.dot(W, M.T, precision=_hp).reshape(-1)

                    # frozen contribution per column: tau_out = W X_j_out^T
                    tau_out = jnp.einsum("mtk,nk->mnt", X_out, W,
                                         precision=_hp)     # (mm, n, T)
                    frozen = jnp.einsum("mnt,jt->mnj", tau_out, CA_out,
                                        precision=_hp)
                    c_cols = (CC_np[rel][None, None, :] - frozen).reshape(
                        mm, n * len(rel))

                def make_col_gass(A_op, s0, e0, size):
                    def col_gass(j, xb_j, mu_j, v_j, c_j, x_full_j, k_j):
                        def loglik(cands):  # (G, size*k) -> (G,)
                            Vg_blk = cands.reshape(-1, size, k)
                            if user_ll_blk is not None:
                                tau = jnp.einsum("gtk,nk->gnt", Vg_blk, W)

                                def one(tau_g, Vb_g):
                                    ll = user_ll_blk(data_c, tau_g, W, Vb_g,
                                                     row=None, col=j,
                                                     tslice=(s0, e0))
                                    if has_ep:
                                        ll = ll - _ep_logpdf(
                                            tau_g, mu_ep_c[:, j, s0:e0],
                                            sig_ep_c[:, j, s0:e0])
                                    return ll

                                return jax.vmap(one)(tau, Vg_blk)
                            # full-V candidates by static concatenation (a
                            # vmapped scatter into a broadcast lowers poorly)
                            Gn = Vg_blk.shape[0]
                            parts = []
                            if s0 > 0:
                                parts.append(jnp.broadcast_to(
                                    x_full_j[:s0], (Gn, s0, k)))
                            parts.append(Vg_blk)
                            if e0 < T:
                                parts.append(jnp.broadcast_to(
                                    x_full_j[e0:], (Gn, T - e0, k)))
                            Vg = parts[0] if len(parts) == 1 else \
                                jnp.concatenate(parts, axis=1)
                            tau = jnp.einsum("gtk,nk->gnt", Vg, W)

                            def one(tau_g, V_g):
                                ll = user_ll(data_c, tau_g, W, V_g,
                                             row=None, col=j)
                                if has_ep:
                                    ll = ll - _ep_logpdf(tau_g,
                                                         mu_ep_c[:, j],
                                                         sig_ep_c[:, j])
                                return ll

                            return jax.vmap(one)(tau, Vg)

                        xb_new, _ = gass(k_j, xb_j, None, loglik, A_op, c_j,
                                         mu=mu_j, ngrid=ngrid, v=v_j,
                                         method=method)
                        return xb_new
                    return col_gass

                col_gass = make_col_gass(A_op, s0, e0, size)
                Xb = jax.vmap(col_gass)(
                    jnp.arange(mm), X[:, s0:e0].reshape(mm, size * k),
                    mu_b.reshape(mm, size * k), v_b.reshape(mm, size * k),
                    c_cols, X, gkeys[bi])
                X = X.at[:, s0:e0].set(Xb.reshape(mm, size, k))
            return X

        mp = self._mp_spec()
        if (mp is not None and m % mp[1] == 0
                and self._data_shardable(data, 1, mp[1])):
            axis = mp[0]
            from jax.sharding import PartitionSpec as P
            cspec = P(axis)
            ep_in = ((self._data_specs(Mu_ep_d, 1, axis),
                      self._data_specs(Sigma_ep_d, 1, axis))
                     if has_ep else (P(), P()))
            zero = jnp.zeros((), dtype)
            sm = jax.shard_map(
                cols_core, mesh=self.mesh,
                in_specs=(cspec, cspec, P(), P(),
                          self._data_specs(data, 1, axis),
                          ep_in[0], ep_in[1],
                          tuple(P(axis) for _ in zs),
                          tuple(P(axis) for _ in gkeys)),
                out_specs=cspec, check_vma=False)
            X_new = sm(state["V"], state["Tau2"], state["lam2"], W, data_c,
                       Mu_ep_d if has_ep else zero,
                       Sigma_ep_d if has_ep else zero,
                       zs, gkeys)
        else:
            gk = tuple(gkeys)
            X_new = cols_core(state["V"], state["Tau2"], state["lam2"], W,
                              data_c, Mu_ep_d, Sigma_ep_d, zs, gk)
        return dict(state, V=X_new.astype(self.dtype))

    def _update_V_gass_redblack(self, state, data, key):
        """Two-color blocked V update. Same per-block conditionals as the
        sequential schedule (exactness argument in __init__'s validation:
        same-color blocks are conditionally independent because the prior
        couples only adjacent blocks, every constraint row touches at most
        adjacent blocks, and the likelihood factorizes over depth), but all
        same-color blocks across ALL columns update in ONE vmapped GASS
        call — the sequential depth per sweep drops from ceil(T/bs) GASS
        rounds to 2 (+1 for a ragged tail block)."""
        from functionalmf_tpu.ops.mvn import _cho_solve, cholesky_psd

        n, m, T, k = self.nrows, self.ncols, self.ndepth, self.nembeds
        W = state["W"] * self._wmask
        CA, CC = self.Constraints_A, self.Constraints_C
        bs = self.v_block_size
        _hp = jax.lax.Precision.HIGHEST

        DtLD = self._v_prior_dtld(state["lam2"], state["Tau2"])  # (m, T, T)
        has_ep = self.Mu_ep is not None
        if has_ep:
            Mu_ep = jnp.asarray(self.Mu_ep, self.dtype)
            Sigma_ep = jnp.asarray(self.Sigma_ep, self.dtype)
            Sinv2 = jnp.where(jnp.isnan(Mu_ep), 0.0, 1.0 / Sigma_ep ** 2)
            Mu0 = jnp.where(jnp.isnan(Mu_ep), 0.0, Mu_ep)
            G = jnp.einsum("ijt,ia,ib->jtab", Sinv2, W, W, precision=_hp)
            mu_part = jnp.einsum("ijt,ia->jta", Mu0 * Sinv2, W, precision=_hp)
        else:
            G = None
            mu_part = jnp.zeros((m, T, k), self.dtype)

        nb_full = T // bs
        rem = T % bs
        phases = [list(range(0, nb_full, 2)), list(range(1, nb_full, 2))]
        user_cells = self.loglikelihood_cells
        data_c = data

        def phase_update(X, starts, size, pkey):
            nblk = len(starts)
            t_mask = np.ones(T, np.float32)
            for s in starts:
                t_mask[s:s + size] = 0.0
            X_out = X * t_mask[None, :, None]

            DtLD_blk = jnp.stack([DtLD[:, s:s + size, s:s + size]
                                  for s in starts], 1)   # (m, nblk, sz, sz)
            DtLD_rows = jnp.stack([DtLD[:, s:s + size, :]
                                   for s in starts], 1)  # (m, nblk, sz, T)
            cross = jnp.einsum("mbts,msk->mbtk", DtLD_rows, X_out,
                               precision=_hp)
            mu_p = jnp.stack([mu_part[:, s:s + size] for s in starts], 1)
            rhs_tk = mu_p - cross                        # (m, nblk, sz, k)
            z = jax.random.normal(_fold(pkey, 0), (m, nblk, size, k),
                                  self.dtype)
            D = size * k
            if has_ep:
                G_blk = jnp.stack([G[:, s:s + size] for s in starts], 1)
                Qd = jnp.einsum("mbts,ac->mbtasc", DtLD_blk,
                                np.eye(k, dtype=np.float32), precision=_hp)
                Qd = Qd + jnp.einsum("mbtac,ts->mbtasc", G_blk,
                                     np.eye(size, dtype=np.float32),
                                     precision=_hp)
                Qbb = Qd.reshape(m, nblk, D, D)
                rhs = rhs_tk.reshape(m, nblk, D)
                d = jnp.diagonal(Qbb, axis1=-2, axis2=-1)
                dinv = jax.lax.rsqrt(jnp.where(d > 0, d, 1.0))
                Qe = Qbb * dinv[..., :, None] * dinv[..., None, :]
                L = cholesky_psd(Qe, eps=self.linalg_opts["force_psd_eps"],
                                 attempts=self.linalg_opts["force_psd_attempts"])
                mu_b = (_cho_solve(L, rhs * dinv) * dinv)
                v_b = (jax.lax.linalg.triangular_solve(
                    L, (z.reshape(m, nblk, D))[..., None], left_side=True,
                    lower=True, transpose_a=True)[..., 0] * dinv)
            else:
                d = jnp.diagonal(DtLD_blk, axis1=-2, axis2=-1)
                dinv = jax.lax.rsqrt(jnp.where(d > 0, d, 1.0))
                Qe = DtLD_blk * dinv[..., :, None] * dinv[..., None, :]
                L = cholesky_psd(Qe, eps=self.linalg_opts["force_psd_eps"],
                                 attempts=self.linalg_opts["force_psd_attempts"])
                y = jax.lax.linalg.triangular_solve(
                    L, rhs_tk * dinv[..., None], left_side=True, lower=True)
                mu_b = (jax.lax.linalg.triangular_solve(
                    L, y, left_side=True, lower=True, transpose_a=True)
                    * dinv[..., None]).reshape(m, nblk, D)
                v_b = (jax.lax.linalg.triangular_solve(
                    L, z, left_side=True, lower=True, transpose_a=True)
                    * dinv[..., None]).reshape(m, nblk, D)

            # constraints restricted to each block (host-side, padded to a
            # uniform J so blocks batch; padded rows are 0 x >= -1)
            rels = [np.nonzero(np.abs(self._CA_np[:, s:s + size]).sum(1) > 0)[0]
                    for s in starts]
            Jb = max(1, max(len(r) for r in rels))
            CA_blk = np.zeros((nblk, Jb, size), np.float32)
            CA_out = np.zeros((nblk, Jb, T), np.float32)
            CC_pad = np.full((nblk, Jb), -1.0, np.float32)
            for b, (s, rel) in enumerate(zip(starts, rels)):
                if len(rel) == 0:
                    continue
                CA_blk[b, :len(rel)] = self._CA_np[rel][:, s:s + size]
                co = self._CA_np[rel].copy()
                co[:, s:s + size] = 0.0
                CA_out[b, :len(rel)] = co
                CC_pad[b, :len(rel)] = np.asarray(CC)[rel]
            tau_out = jnp.einsum("mtk,nk->mnt", X_out, W, precision=_hp)
            frozen = jnp.einsum("mnt,bjt->mbnj", tau_out,
                                jnp.asarray(CA_out), precision=_hp)
            c_all = (jnp.asarray(CC_pad)[None, :, None, :] - frozen
                     ).reshape(m, nblk, n * Jb)

            CA_blk_d = jnp.asarray(CA_blk)
            starts_d = jnp.asarray(np.array(starts, np.int32))

            def col_blk_gass(j, b, xb, mu_jb, v_jb, c_jb, k_jb):
                CA_b = CA_blk_d[b]                        # (Jb, size)
                t0 = starts_d[b]

                def A_op(y):  # (size*k,) -> (n*Jb,)
                    M = jnp.dot(CA_b, y.reshape(size, k), precision=_hp)
                    return jnp.dot(W, M.T, precision=_hp).reshape(-1)

                def loglik(cands):  # (G, size*k) -> (G,)
                    Vg = cands.reshape(-1, size, k)
                    tau = jnp.einsum("gtk,nk->gnt", Vg, W)

                    def one(tau_g, Vb_g):
                        ll = user_cells(data_c, tau_g, W, Vb_g,
                                        col=j, t0=t0, size=size)
                        if has_ep:
                            mu_sl = jax.lax.dynamic_slice_in_dim(
                                Mu_ep[:, j], t0, size, axis=1)
                            sg_sl = jax.lax.dynamic_slice_in_dim(
                                Sigma_ep[:, j], t0, size, axis=1)
                            ll = ll - _ep_logpdf(tau_g, mu_sl, sg_sl)
                        return ll

                    return jax.vmap(one)(tau, Vg)

                xb_new, _ = gass(k_jb, xb, None, loglik, A_op, c_jb,
                                 mu=mu_jb, ngrid=self.gass_ngrid, v=v_jb,
                                 method=self.gass_method)
                return xb_new

            Xb_cur = jnp.stack([X[:, s:s + size] for s in starts],
                               1).reshape(m, nblk, D)
            keys = jax.vmap(lambda j: jax.vmap(
                lambda b: _fold(pkey, 1, j, b))(
                np.arange(nblk, dtype=np.uint32)))(
                np.arange(m, dtype=np.uint32))
            inner = jax.vmap(col_blk_gass, in_axes=(None, 0, 0, 0, 0, 0, 0))
            Xb_new = jax.vmap(lambda j, xb, mu_j, v_j, c_j, k_j: inner(
                j, np.arange(nblk), xb, mu_j, v_j, c_j, k_j))(
                np.arange(m), Xb_cur, mu_b, v_b, c_all, keys)
            Xb_new = Xb_new.reshape(m, nblk, size, k)
            for b, s in enumerate(starts):
                X = X.at[:, s:s + size].set(Xb_new[:, b])
            return X

        X = state["V"]
        for ph, starts in enumerate(phases):
            if starts:
                X = phase_update(X, [s * bs for s in starts], bs,
                                 _fold(key, 80 + ph))
        if rem:
            # ragged tail block, one extra single-block round
            X = phase_update(X, [nb_full * bs], rem, _fold(key, 83))
        return dict(state, V=X.astype(self.dtype))

    # ------------------------------------------------------------------
    # ASIS interweaving of the global scales (lam2, sigma2)
    # ------------------------------------------------------------------
    def _scale_bounds(self, vals, cs):
        """Feasible interval for a global rescale tau -> s * tau: each
        linear constraint value v with offset c needs s*v >= c, so
        s >= c/v for v > 0 and s <= c/v for v < 0 (v == 0 rows are
        s-independent and already feasible). Returns (s_lo, s_hi),
        guaranteed to contain s = 1 up to clipping."""
        ratio = cs / jnp.where(vals == 0, 1.0, vals)
        s_lo = jnp.max(jnp.where(vals > 0, ratio, -jnp.inf))
        s_hi = jnp.min(jnp.where(vals < 0, ratio, jnp.inf))
        # tiny interior margin so the rescaled state never lands exactly
        # on a boundary (GASS requires a feasible start, run_gibbs gate)
        s_lo = jnp.clip(s_lo, 1e-6, None) * (1.0 + 1e-6)
        s_hi = jnp.clip(s_hi, None, 1e6) * (1.0 - 1e-6)
        return s_lo, s_hi

    def _interweave_scales(self, state, pdata, key):
        """ASIS (Yu & Meng 2011) re-draws of lam2 and sigma2 in their
        ancillary parameterizations (per-chain; runs after the W/V GASS
        updates in the sweep).

        Sufficient step (already done in _prior_sweep): lam2 | V is
        conjugate IG with shape ~ nD*m*k/2 — near-deterministic given V,
        so lam2 tracks V's global scale and mixes at V's pace (min
        ESS/sweep 0.003, BENCH_r04; the reference's own TODO at
        factor.py:144-146). Ancillary step (here): hold eta = DV/sqrt(
        lam2*Tau2) fixed; since lam2 is a global factor, V(lam2') =
        sqrt(lam2'/lam2) V — and the Gaussian prior normalizer
        lam2^{-dim/2} cancels the reparameterization Jacobian
        lam2^{+dim/2} exactly, leaving

            p(lam2 | eta, data) ∝ p(lam2 | lam2_a) · lik(s·tau),
            s = sqrt(lam2/lam2_cur).

        We slice-sample x = log lam2 exactly on the feasibility interval
        (a global rescale maps the constraint values A·tau linearly, so
        the feasible set in s is one interval — _scale_bounds). The
        sigma2 | W move is identical with W(sigma2') = sqrt(s2'/s2) W,
        which also rescales tau and any Row_constraints values.
        Likelihood evaluations are full-tensor (the same call logprob
        makes) — a handful per sweep via shrinkage slice; EP centering
        does not enter (it only shapes GASS proposals, not the target).
        """
        k = self.nembeds
        _hp = jax.lax.Precision.HIGHEST
        W = state["W"] * jnp.asarray(self._wmask)
        V = state["V"]
        tau = jnp.einsum("nk,mtk->nmt", W, V, precision=_hp)

        # --- collapsed scale-split rebalance (generalized Gibbs along
        # the group (W, V) -> (W/c, c V), Liu & Sabatti 2000; sigma2 and
        # lam2 collapsed). tau = W V^T and the likelihood are invariant
        # under the map, so the W<->V scale split is pinned only by the
        # priors — a wide, weakly-identified direction that the
        # conjugate sigma2 | W and lam2 | V draws random-walk in
        # O(1/sqrt(dim)) steps (the geometry behind min ESS/sweep ~0.003
        # on lam2/sigma2/V-tail, BENCH_r04; a non-collapsed c-move is
        # just as slow — measured). Integrating the conjugate scales out
        # of the c-conditional gives the t-like target
        #   log pi(x) = (dV - dW) x
        #     - (a_s + dW/2) log(b_s + e^{-2x} ||W||^2 / 2)
        #     - (1/2 + dV/2) log(1/lam2_a + e^{2x} Qbar / 2),
        #   Qbar = sum_j ||Delta V_j||^2 / Tau2_j   (lam2 excluded),
        # which is nearly FLAT over many nats (the two log terms cancel
        # the Jacobian to O(a_s)), so one slice draw refreshes the split
        # near-independently; sigma2 and lam2(+aux) are then redrawn
        # from their exact conditionals at the new split (required for
        # partially-collapsed-Gibbs validity). The AA moves below cover
        # the orthogonal, data-pinned direction (s tau vs the data):
        # together the 2-D scale subspace is Gibbs-sampled directly.
        if self.sample_W and self.sample_V:
            inv_tau2 = 1.0 / jnp.clip(state["Tau2"], self.stability,
                                      1.0 / self.stability)     # (m, nD)
            deltas = jnp.einsum("dt,jtk->jdk", jnp.asarray(self.Delta), V,
                                precision=_hp)
            Qbar = jnp.sum(deltas * deltas * inv_tau2[:, :, None])
            Qbar = jnp.clip(Qbar, 1e-20, None)
            W2 = jnp.sum(W * W)
            dW_free = float(self._w_len)
            dV_free = float(self.ncols * self.ndepth * k)
            a_s, b_s = self.sigma2_a, self.sigma2_b
            inv_la = 1.0 / jnp.clip(state["lam2_a"], 1e-20, None)

            if self.sample_sigma2:
                def w_term(x):
                    return -(a_s + dW_free / 2.0) * jnp.log(
                        b_s + jnp.exp(-2.0 * x) * W2 / 2.0)
            else:  # sigma2 fixed: condition instead of collapse
                inv_s2 = 1.0 / jnp.clip(state["sigma2"], 1e-20, None)

                def w_term(x):
                    return -0.5 * jnp.exp(-2.0 * x) * W2 * inv_s2
            if self.sample_lam2:
                def v_term(x):
                    return -(0.5 + dV_free / 2.0) * jnp.log(
                        inv_la + jnp.exp(2.0 * x) * Qbar / 2.0)
            else:  # lam2 fixed
                inv_l2 = 1.0 / jnp.clip(state["lam2"], 1e-20, None)

                def v_term(x):
                    return -0.5 * jnp.exp(2.0 * x) * Qbar * inv_l2

            def logdens_c(x):
                return (dV_free - dW_free) * x + w_term(x) + v_term(x)

            lo_c = jnp.asarray(-6.0, self.dtype)
            hi_c = jnp.asarray(6.0, self.dtype)
            if self._has_row_constraints:
                # W scales by e^{-x}: row-constraint feasibility bounds
                RC = state["Row_constraints"]
                rv = jnp.einsum("nk,jk->nj", W, RC[:, :k], precision=_hp)
                s_lo, s_hi = self._scale_bounds(
                    rv.reshape(-1),
                    jnp.broadcast_to(RC[None, :, k], rv.shape).reshape(-1))
                lo_c = jnp.maximum(lo_c, -jnp.log(s_hi))
                hi_c = jnp.minimum(hi_c, -jnp.log(s_lo))
                lo_c = jnp.minimum(lo_c, 0.0)
                hi_c = jnp.maximum(hi_c, 0.0)
            x_c, _ = shrink_slice_1d(_fold(key, 2), jnp.zeros((), self.dtype),
                                     logdens_c, lo_c, hi_c)
            c_w = jnp.exp(-x_c).astype(self.dtype)
            c_v = jnp.exp(x_c).astype(self.dtype)
            W = W * c_w
            V = V * c_v
            state = dict(state, W=state["W"] * c_w, V=V)
            Qbar_cur = jnp.exp(2.0 * x_c) * Qbar

            # --- per-factor scale-split rebalance. The global move above
            # fixes the OVERALL W<->V split; the relative scale of each
            # rank-1 factor, (W[:,kk], V[:,:,kk]) -> (W[:,kk]/c, c V[:,:,kk]),
            # is likewise likelihood-invariant (tau's kk-th term W[:,kk]
            # V[:,:,kk]^T is unchanged) and only prior-pinned, so it
            # random-walks the same way — and it loads on every V[:,:,kk]
            # coordinate, which is where the min-ESS moved once the global
            # moves landed (BENCH_r05 slowest param = a V coordinate).
            # Same collapsed conditional restricted to factor kk, the other
            # factors entering the two log terms as constants:
            #   log pi(x) = (dVk - dWk) x
            #     - (a_s + dW/2) log(b_s + (W2_rest + e^{-2x} W2_kk)/2)
            #     - (1/2 + dV/2) log(1/lam2_a + (Q_rest + e^{2x} Q_kk)/2).
            # No likelihood evaluations; curve constraints (on tau) cannot
            # bind; Row_constraints (on W) give one feasible s-interval per
            # factor since the constraint values are affine in s. None of
            # the k moves condition on sigma2 / lam2, so the single
            # conjugate redraw after the loop keeps the partially-collapsed
            # sequencing valid.
            if self.factor_rebalance and k > 1:
                w2k = jnp.sum(W * W, axis=0)                       # (k,)
                qk = jnp.clip(
                    jnp.sum(deltas * deltas * inv_tau2[:, :, None],
                            axis=(0, 1)) * jnp.exp(2.0 * x_c),
                    1e-20, None)                                   # (k,)
                dwk = np.asarray(self._wmask).sum(axis=0)          # (k,)
                dvk = float(self.ncols * self.ndepth)
                if not self.sample_sigma2:
                    inv_s2_f = 1.0 / jnp.clip(state["sigma2"], 1e-20, None)
                if not self.sample_lam2:
                    inv_l2_f = 1.0 / jnp.clip(state["lam2"], 1e-20, None)
                for kk in range(k):
                    W2_rest = jnp.sum(w2k) - w2k[kk]
                    Q_rest = jnp.sum(qk) - qk[kk]
                    w2_kk = w2k[kk]
                    q_kk = qk[kk]

                    if self.sample_sigma2:
                        def wt(x, W2_rest=W2_rest, w2_kk=w2_kk):
                            return -(a_s + dW_free / 2.0) * jnp.log(
                                b_s + (W2_rest
                                       + jnp.exp(-2.0 * x) * w2_kk) / 2.0)
                    else:
                        def wt(x, w2_kk=w2_kk):
                            return -0.5 * jnp.exp(-2.0 * x) * w2_kk * inv_s2_f
                    if self.sample_lam2:
                        def vt(x, Q_rest=Q_rest, q_kk=q_kk):
                            return -(0.5 + dV_free / 2.0) * jnp.log(
                                inv_la + (Q_rest
                                          + jnp.exp(2.0 * x) * q_kk) / 2.0)
                    else:
                        def vt(x, q_kk=q_kk):
                            return -0.5 * jnp.exp(2.0 * x) * q_kk * inv_l2_f

                    jac = float(dvk - float(dwk[kk]))

                    def logdens_f(x, wt=wt, vt=vt, jac=jac):
                        return jac * x + wt(x) + vt(x)

                    lo_f = jnp.asarray(-6.0, self.dtype)
                    hi_f = jnp.asarray(6.0, self.dtype)
                    if self._has_row_constraints:
                        # constraint values are affine in s = e^{-x}:
                        # rest + s * part_kk >= c, one interval in s > 0
                        RC = state["Row_constraints"]
                        rvf = jnp.einsum("nk,jk->nj", W, RC[:, :k],
                                         precision=_hp)
                        pk = W[:, kk, None] * RC[None, :, kk]
                        restv = rvf - pk
                        cs_r = jnp.broadcast_to(RC[None, :, k], pk.shape)
                        num = cs_r - restv
                        ratio = num / jnp.where(pk == 0, 1.0, pk)
                        s_lo = jnp.max(jnp.where(pk > 0, ratio, -jnp.inf))
                        s_hi = jnp.min(jnp.where(pk < 0, ratio, jnp.inf))
                        s_lo = jnp.clip(s_lo, 1e-6, None) * (1.0 + 1e-6)
                        s_hi = jnp.clip(s_hi, None, 1e6) * (1.0 - 1e-6)
                        lo_f = jnp.maximum(lo_f, -jnp.log(s_hi))
                        hi_f = jnp.minimum(hi_f, -jnp.log(s_lo))
                        lo_f = jnp.minimum(lo_f, 0.0)
                        hi_f = jnp.maximum(hi_f, 0.0)
                    x_f, _ = shrink_slice_1d(
                        _fold(key, 10 + kk), jnp.zeros((), self.dtype),
                        logdens_f, lo_f, hi_f)
                    f_w = jnp.exp(-x_f).astype(self.dtype)
                    f_v = jnp.exp(x_f).astype(self.dtype)
                    W = W.at[:, kk].multiply(f_w)
                    V = V.at[:, :, kk].multiply(f_v)
                    w2k = w2k.at[kk].multiply(f_w * f_w)
                    qk = qk.at[kk].multiply(f_v * f_v)
                    state = dict(state,
                                 W=state["W"].at[:, kk].multiply(f_w), V=V)
                Qbar_cur = jnp.sum(qk)

            # redraw the collapsed scales at the new split (their exact
            # conjugate conditionals; skipping this would leave stale
            # values that the collapse removed from the state)
            if self.sample_sigma2:
                state = self._update_sigma2(state, _fold(key, 3))
            if self.sample_lam2:
                from functionalmf_tpu.samplers.horseshoe import resample_lam2
                lam2_new, lam2_a_new = resample_lam2(
                    _fold(key, 4), Qbar_cur, state["lam2_a"], self.nD,
                    self.ncols, self.nembeds)
                state = dict(state, lam2=lam2_new.astype(self.dtype),
                             lam2_a=lam2_a_new.astype(self.dtype))
            # tau (and any A tau values) are exactly invariant
        # When every constraint offset is 0 the feasible set is a cone:
        # A tau >= 0 is invariant under any s > 0, so the s-interval is
        # the full sanity window and the (n*m*J*T) A-values einsum is
        # skipped (the positivity-constraint production configs hit this).
        cone = bool((np.asarray(self.Constraints_C) == 0.0).all())
        if cone:
            Av = cs_curve = None
        else:
            CA = jnp.asarray(self.Constraints_A)
            CC = jnp.asarray(self.Constraints_C)
            Av = jnp.einsum("jt,nmt->nmj", CA, tau, precision=_hp)
            cs_curve = jnp.broadcast_to(CC[None, None, :], Av.shape)
        # Full-tensor likelihood for the AA slice targets. When a cellfn is
        # available (y-only terms omitted by contract — they are constant
        # in the rescale s, so the slice target is unchanged) use it
        # directly: the user's full loglikelihood typically recomputes
        # y-only transcendentals like gammaln(y+1) on every slice
        # evaluation, which at 128x128x256 cost ~7.5 ms/sweep (measured,
        # bench/roofline_redblack.json round-5 first pass).
        user_ll = self.loglikelihood
        cellfn = self.loglikelihood_cellfn
        if cellfn is not None and self._data_single_tensor(pdata):
            _leaf = jax.tree_util.tree_leaves(pdata)[0]

            def full_ll(tau_s, W_s, V_s):
                t = tau_s if _leaf.ndim == tau_s.ndim else tau_s[..., None]
                return jnp.sum(cellfn(_leaf, jnp.broadcast_to(t, _leaf.shape)))
        else:
            def full_ll(tau_s, W_s, V_s):
                return user_ll(pdata, tau_s, W_s, V_s, row=None, col=None)
        LOG_LAM2_MIN = float(np.log(1e-5))  # lam2 support clamp, matching
        # the conjugate draw's lam2_min (samplers/horseshoe.py:resample_lam2)

        if self.sample_lam2 and self.sample_V:
            x0 = jnp.log(jnp.clip(state["lam2"], 1e-20, None))
            if cone:
                lo_s = x0 - 12.0
                hi_s = x0 + 12.0
            else:
                s_lo, s_hi = self._scale_bounds(Av.reshape(-1),
                                                cs_curve.reshape(-1))
                lo_s = jnp.maximum(x0 + 2.0 * jnp.log(s_lo), x0 - 12.0)
                hi_s = jnp.minimum(x0 + 2.0 * jnp.log(s_hi), x0 + 12.0)
            lo = jnp.maximum(lo_s, LOG_LAM2_MIN)
            hi = hi_s
            lo = jnp.minimum(lo, x0)  # containment under fp rounding
            hi = jnp.maximum(hi, x0)
            inv_a = 1.0 / jnp.clip(state["lam2_a"], 1e-20, None)

            def logdens(x):
                s = jnp.exp(0.5 * (x - x0))
                ll = full_ll(s * tau, W, s * V)
                # prior of x = log lam2 under 1/lam2 ~ Gamma(1/2, rate=1/a):
                # p(x) ∝ exp(-x/2 - e^{-x}/a)
                return -0.5 * x - jnp.exp(-x) * inv_a + ll

            x_new, _ = shrink_slice_1d(_fold(key, 0), x0, logdens, lo, hi)
            s = jnp.exp(0.5 * (x_new - x0)).astype(self.dtype)
            V = V * s
            tau = tau * s
            if Av is not None:
                Av = Av * s
            state = dict(state, lam2=jnp.exp(x_new).astype(self.dtype), V=V)

        if self.sample_sigma2 and self.sample_W:
            x0 = jnp.log(jnp.clip(state["sigma2"], 1e-20, None))
            if cone and not self._has_row_constraints:
                lo = x0 - 12.0
                hi = x0 + 12.0
            else:
                if cone:  # curve part is a cone; only RC rows can bind
                    vals = jnp.zeros((1,), self.dtype)
                    cs = jnp.full((1,), -1.0, self.dtype)
                else:
                    vals = Av.reshape(-1)
                    cs = cs_curve.reshape(-1)
                if self._has_row_constraints:
                    RC = state["Row_constraints"]
                    rv = jnp.einsum("nk,jk->nj", W, RC[:, :k], precision=_hp)
                    vals = jnp.concatenate([vals, rv.reshape(-1)])
                    cs = jnp.concatenate(
                        [cs, jnp.broadcast_to(RC[None, :, k], rv.shape)
                         .reshape(-1)])
                s_lo, s_hi = self._scale_bounds(vals, cs)
                lo = jnp.maximum(x0 + 2.0 * jnp.log(s_lo), x0 - 12.0)
                hi = jnp.minimum(x0 + 2.0 * jnp.log(s_hi), x0 + 12.0)
            lo = jnp.minimum(lo, x0)
            hi = jnp.maximum(hi, x0)
            a, b = self.sigma2_a, self.sigma2_b

            def logdens(x):
                s = jnp.exp(0.5 * (x - x0))
                ll = full_ll(s * tau, s * W, V)
                # x = log sigma2 under 1/sigma2 ~ Gamma(a, rate=b):
                # p(x) ∝ exp(-a x - b e^{-x})
                return -a * x - b * jnp.exp(-x) + ll

            x_new, _ = shrink_slice_1d(_fold(key, 1), x0, logdens, lo, hi)
            s = jnp.exp(0.5 * (x_new - x0)).astype(self.dtype)
            state = dict(state, sigma2=jnp.exp(x_new).astype(self.dtype),
                         W=state["W"] * s)
        return state

    # ------------------------------------------------------------------
    def _make_sweep(self):
        rW, rV = self.gass_w_repeats, self.gass_v_repeats

        def update_W(state, pdata, key):
            for r in range(rW):  # unrolls at trace time (small static count)
                state = self._update_W_gass(state, pdata, _fold(key, 40 + r))
            return state

        upd_v = (self._update_V_gass_redblack
                 if self.v_schedule == "redblack" else self._update_V_gass)

        def update_V(state, pdata, key):
            for r in range(rV):
                state = upd_v(state, pdata, _fold(key, 60 + r))
            return state

        def sweep(state, pdata, key):
            state = self._prior_sweep(state, pdata, key, update_W, update_V)
            if self.interweave:
                state = self._interweave_scales(state, pdata, _fold(key, 90))
            return state
        return sweep

    # ------------------------------------------------------------------
    def logprob(self, data, **params):
        """factor.py:1002-1005 (without the undefined rowcol_args bug)."""
        W = jnp.asarray(params.get("W", self.W))
        V = jnp.asarray(params.get("V", self.V))
        tau = jnp.einsum("nk,mtk->nmt", W, V)
        pdata = self.prepare_data(data)
        return float(self.loglikelihood(pdata, tau, W, V, row=None, col=None))

    def check_constraints(self, atol=1e-5):
        """Host-side feasibility audit of the current state (replaces the
        reference's in-sampler assertion, gass.py:35): every curve
        constraint A tau >= c AND, when present, every row constraint
        A_r w_i >= c_r (fit.py:116-118 semantics), across ALL chains."""
        return self._worst_constraint_slack() >= -atol

    def _worst_constraint_slack(self):
        """min over chains/cells/constraints of (A tau - c), i.e. the most
        violated constraint margin of the current state (negative =
        infeasible)."""
        W = np.asarray(self.W)
        V = np.asarray(self.V)
        if W.ndim == 2:  # normalize to a leading chain axis
            W, V = W[None], V[None]
        tau = np.einsum("cnk,cmtk->cnmt", W, V)
        A = np.asarray(self.Constraints_A)
        c = np.asarray(self.Constraints_C)
        vals = np.einsum("jt,cnmt->cnmj", A, tau)
        worst = float((vals - c).min())
        if self._has_row_constraints:
            RC = np.asarray(self.Row_constraints)
            if RC.ndim == 3:  # leading chain axis
                RC = RC[0]
            rvals = (np.einsum("cnk,jk->cnj", W, RC[:, : self.nembeds])
                     - RC[:, self.nembeds])
            worst = min(worst, float(rvals.min()))
        return worst

    def run_gibbs(self, data, *args, **kwargs):
        """Refuse to sample from an infeasible start. GASS is only a valid
        transition kernel from a feasible point (the reference asserts this
        inside the sampler, gass.py:35; its examples guarantee it via NMF
        warm starts). From an infeasible state our stay-put fallback would
        silently freeze W/V at the bad init instead."""
        worst = self._worst_constraint_slack()
        if worst < -1e-5:
            raise ValueError(
                "Initial state violates the constraints (worst margin "
                f"A@tau - c = {worst:.3e}). GASS requires a feasible "
                "starting point (reference gass.py:35). Pass feasible "
                "W_init/V_init — e.g. a nonnegative warm start from "
                "functionalmf_tpu.utils.nmf.tensor_nmf, as the reference "
                "examples do.")
        return super().run_gibbs(data, *args, **kwargs)
