"""Gaussian Bayesian Tensor Filtering: the conditionally conjugate model.

JAX re-design of GaussianBayesianTensorFiltering
(reference functionalmf/factor.py:286-423). The reference's two hot Python
loops — per-row dense-Cholesky W updates (factor.py:333-362) and per-column
sparse-CHOLMOD V updates (factor.py:378-409) — become two *batched* dense
updates: one (nrows, k, k) Cholesky and one (ncols, kT, kT) Cholesky, each a
single XLA op over the whole tensor. Missing data and the lower-triangular
identification of W are handled with fixed-shape masks instead of ragged
recomputation.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from functionalmf_tpu.models.base import BayesianTensorFiltering, _fold
from functionalmf_tpu.ops.banded import _mm_f32
from functionalmf_tpu.ops.mvn import sample_mvn_from_precision

__all__ = ["GaussianBayesianTensorFiltering"]


class GaussianBayesianTensorFiltering(BayesianTensorFiltering):
    """Conjugate Gaussian BTF (factor.py:286-423)."""

    _collect_keys = ("W", "V", "sigma2", "lam2", "Tau2", "nu2")

    def __init__(self, nrows, ncols, ndepth,
                 nu2_init=None, nu2_true=None,
                 nu2_a=0.1, nu2_b=0.1,
                 nu2_mode="scalar", **kwargs):
        """nu2_mode: 'scalar' (reference parity — one shared sampled
        observation variance, factor.py:295) or 'row' (per-row sampled
        variances, a framework extension: on the flu-trends benchmark each
        state has its own noise level, and a shared nu2 caps the
        posterior-predictive coverage well below nominal)."""
        super().__init__(nrows, ncols, ndepth, **kwargs)
        self.nu2_a = nu2_a
        self.nu2_b = nu2_b
        assert nu2_mode in ("scalar", "row"), nu2_mode
        self.nu2_mode = nu2_mode
        row_shape = (self.nrows, 1, 1)

        def nu2_state(value):
            # scalar (homoskedastic) or (nrows, ncols, ndepth) heteroskedastic
            # observation variance (factor.py:343-346, 388-391)
            v = np.asarray(value, dtype=np.float32)
            if v.ndim == 0:
                if self.nu2_mode == "row":
                    return self._chain_broadcast(np.full(row_shape, v), row_shape)
                return self._chain_full((), value)
            assert v.shape == (self.nrows, self.ncols, self.ndepth)
            return self._chain_broadcast(v, v.shape)

        if nu2_true is not None:
            self._state["nu2"] = nu2_state(nu2_true)
            self.sample_nu2 = False
        else:
            self.sample_nu2 = True
            if nu2_init is not None:
                assert np.ndim(nu2_init) == 0, (
                    "heteroskedastic nu2 must be fixed (nu2_true); sampled "
                    "nu2 is scalar or per-row (nu2_mode)")
                self._state["nu2"] = nu2_state(nu2_init)
            else:
                # factor.py:418-419: nu2 = 1 / IG-prior draw
                k = self._next_init_keys()
                shape = row_shape if self.nu2_mode == "row" else ()
                self._state["nu2"] = jax.vmap(
                    lambda kk: 1.0 / (jax.random.gamma(kk, jnp.full(shape, nu2_a))
                                      / nu2_b)
                )(k).astype(self.dtype)

    nu2 = property(lambda s: s._get_var("nu2"), lambda s, v: s._set_var("nu2", v))

    def state_partition_specs(self):
        from jax.sharding import PartitionSpec as P
        from functionalmf_tpu.parallel.mesh import DP_AXIS as dp, MP_AXIS as mp
        specs = super().state_partition_specs()
        # nu2 is (C,), (C, n, 1, 1) or (C, n, m, T): rows align with W's mp
        # sharding (the spec is trimmed to the array's ndim downstream)
        specs["nu2"] = P(dp, mp)
        return specs

    # ------------------------------------------------------------------
    # data preparation: NaN-masked sufficient statistics over replicates
    # (factor.py:323-330), computed once instead of per sweep.
    # ------------------------------------------------------------------
    def prepare_data(self, data):
        Y = np.asarray(data, dtype=np.float32)
        assert Y.ndim in (3, 4), "Observations must be 3- or 4-tensor."
        if Y.ndim == 3:
            Y = Y[..., None]
        obs = ~np.isnan(Y)
        counts = obs.sum(axis=-1).astype(np.float32)
        Yz = np.where(obs, Y, 0.0)
        ysum = Yz.sum(axis=-1)
        ysqsum = (Yz * Yz).sum(axis=-1)
        return {
            "counts": jnp.asarray(counts, self.dtype),
            "ysum": jnp.asarray(ysum, self.dtype),
            "ysqsum": jnp.asarray(ysqsum, self.dtype),
        }

    # ------------------------------------------------------------------
    # batched conjugate updates, shared with the Polya-Gamma subclasses
    # ------------------------------------------------------------------
    @_mm_f32
    def _gaussian_update_W(self, state, w8, wy, key):
        """All-rows ridge posterior in one batched Cholesky (factor.py:313-362).

        w8[i,j,t] = effective precision weight (counts/nu2 here; omega for
        PG models); wy[i,j,t] = w8 * target so that mu_part = X^T wy.

        Full-f32 matmuls (_mm_f32): the Gram/mean products feed a Cholesky
        draw; a reduced-precision (bf16/TF32) pass biases the conditional
        (same failure class as the constrained sampler's HIGHEST einsums,
        and the chip-only flu k=10 excursions — see ops/banded.py:_mm_f32).
        """
        k = self.nembeds
        V = state["V"]
        Vf = V.reshape(-1, k)                                   # (P, k)
        w8f = w8.reshape(self.nrows, -1)
        wyf = wy.reshape(self.nrows, -1)
        VV = (Vf[:, :, None] * Vf[:, None, :]).reshape(-1, k * k)
        Q_lik = (w8f @ VV).reshape(self.nrows, k, k)
        mask = self._wmask
        eye = np.eye(k, dtype=np.float32)  # trace-time host constant
        Q = Q_lik * mask[:, :, None] * mask[:, None, :] + eye / state["sigma2"]
        mu_part = (wyf @ Vf) * mask
        Wnew = sample_mvn_from_precision(key, Q, mu_part=mu_part,
                                         equilibrate=True, **self.linalg_opts)
        return dict(state, W=(Wnew * mask).astype(self.dtype))

    @_mm_f32
    def _gaussian_update_V(self, state, w8, wy, key):
        """All-columns GLS posterior via the block-banded Cholesky kernel
        (factor.py:364-409, where the reference crossed into CHOLMOD).
        Full-f32 matmuls for the Gram/mean assembly (see _gaussian_update_W).

        In time-major ordering the precision Q_j = Q_lik + kron(I_k, DtLD_j)
        is block-banded: diagonal blocks G_t + DtLD[t,t] I_k (dense over
        embeddings), off-diagonals DtLD[t,t-d] I_k — O(T p^2 k^3) per column
        instead of a dense (kT)^3 factorization (ops/banded.py).
        """
        from functionalmf_tpu.ops.banded import (
            build_v_bands, sample_mvn_block_banded_retiled)
        from functionalmf_tpu.ops.penalty import penalty_half_bandwidth
        W = state["W"] * self._wmask
        # G[j,t,a,b] = sum_i w8[i,j,t] W[i,a] W[i,b]
        G = jnp.einsum("ijt,ia,ib->jtab", w8, W, W)
        DtLD = self._v_prior_dtld(state["lam2"], state["Tau2"])   # (m, T, T)
        bands = build_v_bands(DtLD, G, penalty_half_bandwidth(self.tf_order))
        mu_part = jnp.einsum("ijt,ia->jta", wy, W)                # (m, T, k)
        # super-block retiling: the scan runs T/B dense steps instead of
        # T tiny ones (scans are latency-bound in step count, and batched
        # Cholesky cost grows faster than linearly in the superblock size)
        Vnew, repaired, gersh = sample_mvn_block_banded_retiled(
            key, bands, mu_part=mu_part, B=8, equilibrate=True,
            return_repairs=True)
        # Pivot-repair telemetry (ADVICE r1): factoring a perturbed
        # conditional must never be silent. Ordinary jitter-rung repairs are
        # counted in pivot_repairs; Gershgorin-shift repairs (a materially
        # perturbed conditional variance) also count as failsafe events.
        return dict(state, V=Vnew.astype(self.dtype),
                    pivot_repairs=state["pivot_repairs"] + repaired.sum(),
                    nan_fallbacks=state["nan_fallbacks"] + gersh.sum())

    @_mm_f32
    def _update_nu2(self, state, pdata, key):
        """Observation-noise IG update (factor.py:411-416); shared scalar
        or per-row depending on nu2_mode. Full-f32 Mu: a bf16 Mu biases
        the squared-error sum that sets the noise scale."""
        Mu = jnp.einsum("nk,mtk->nmt", state["W"], state["V"])
        cellerr = (pdata["ysqsum"] - 2.0 * Mu * pdata["ysum"]
                   + pdata["counts"] * Mu * Mu)
        if self.nu2_mode == "row":
            sqerr = jnp.sum(cellerr, axis=(1, 2))          # (nrows,)
            nobs = jnp.sum(pdata["counts"], axis=(1, 2))
            prec = jax.random.gamma(key, self.nu2_a + nobs / 2.0) / (
                self.nu2_b + sqerr / 2.0)
            return dict(state,
                        nu2=(1.0 / prec)[:, None, None].astype(self.dtype))
        sqerr = jnp.sum(cellerr)
        nobs = jnp.sum(pdata["counts"])
        prec = jax.random.gamma(key, self.nu2_a + nobs / 2.0) / (
            self.nu2_b + sqerr / 2.0)
        return dict(state, nu2=(1.0 / prec).astype(self.dtype))

    # ------------------------------------------------------------------
    def _make_sweep(self):
        sample_nu2 = self.sample_nu2

        def update_W(state, pdata, key):
            w8 = pdata["counts"] / state["nu2"]
            wy = pdata["ysum"] / state["nu2"]
            return self._gaussian_update_W(state, w8, wy, key)

        def update_V(state, pdata, key):
            w8 = pdata["counts"] / state["nu2"]
            wy = pdata["ysum"] / state["nu2"]
            return self._gaussian_update_V(state, w8, wy, key)

        def sweep(state, pdata, key):
            # order per factor.py:306-311: nu2 first, then the base dispatch
            if sample_nu2:
                state = self._update_nu2(state, pdata, _fold(key, 10))
            return self._prior_sweep(state, pdata, key, update_W, update_V)

        return sweep

    # ------------------------------------------------------------------
    def logprob(self, data, **params):
        """Gaussian log-likelihood of the data at given posterior params.

        Fixes the reference's logprob bug (factor.py:262-264 references an
        undefined global and uses sigma2 instead of the observation noise).
        """
        W = np.asarray(params.get("W", self.W))
        V = np.asarray(params.get("V", self.V))
        nu2 = np.asarray(params.get("nu2", self.nu2), dtype=np.float64)
        # logprob evaluates ONE parameter set; with nchains > 1 the model
        # attributes carry a leading chain axis — use chain 0 (matching the
        # reference's single-chain semantics). Expected per-chain ndims:
        # W 2, V 3, nu2 {0, 3}.
        if W.ndim == 3:
            W = W[0]
        if V.ndim == 4:
            V = V[0]
        if nu2.ndim in (1, 4):
            nu2 = nu2[0] if nu2.shape[0] == self.nchains else nu2.reshape(-1)[0]
        Y = np.asarray(data, dtype=np.float64)
        if Y.ndim == 3:
            Y = Y[..., None]
        Mu = np.einsum("nk,mtk->nmt", W, V)[..., None]
        # nu2: scalar, (nrows,1,1) per-row, or (n,m,t) heteroskedastic
        nu2b = np.broadcast_to(nu2.reshape(nu2.shape + (1,) * (4 - nu2.ndim))
                               if nu2.ndim else nu2, Y.shape)
        obs = ~np.isnan(Y)
        resid2 = (Y - Mu) ** 2
        return float(np.sum(-0.5 * resid2[obs] / nu2b[obs]
                            - 0.5 * np.log(2 * np.pi * nu2b[obs])))
