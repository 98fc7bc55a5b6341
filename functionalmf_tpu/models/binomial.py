"""Binomial / Bernoulli Bayesian Tensor Filtering via Polya-Gamma augmentation.

JAX re-design of BinomialBayesianTensorFiltering
(reference functionalmf/factor.py:425-460). The PG draws — previously a
sequential C++ stream (`pgdrawv`, factor.py:458-460) — become one
vectorized, counter-based `polya_gamma` call over the whole tensor, and the
pseudo-data transform kappa = (Y - N/2) (factor.py:439, 444) feeds the
batched Gaussian W/V updates directly as (weight, weighted-target) pairs,
avoiding the reference's division by nu2 = 1/omega.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from functionalmf_tpu.models.base import _fold
from functionalmf_tpu.models.gaussian import GaussianBayesianTensorFiltering
from functionalmf_tpu.ops.polyagamma import polya_gamma

__all__ = ["BinomialBayesianTensorFiltering"]


class BinomialBayesianTensorFiltering(GaussianBayesianTensorFiltering):
    """PG-augmented binomial BTF (factor.py:425-460). Data is (Y, N)."""

    def __init__(self, nrows, ncols, ndepth, pg_seed=42, pg_num_terms=16,
                 **kwargs):
        super().__init__(nrows, ncols, ndepth, **kwargs)
        self.pg_num_terms = int(pg_num_terms)
        self.pg_seed = pg_seed  # parity kwarg; keys derive from the model seed
        # nu2 is the (nrows, ncols, ndepth) PG latent-variance tensor
        # (factor.py:433-435) and is always resampled.
        self._state["nu2"] = jnp.zeros(
            (self.nchains, self.nrows, self.ncols, self.ndepth), self.dtype)
        self.sample_nu2 = True

    # ------------------------------------------------------------------
    def prepare_data(self, data):
        Y, N = data
        Y = np.asarray(Y, dtype=np.float32)
        N = np.asarray(N, dtype=np.float32)
        assert Y.ndim == 3 and N.shape == Y.shape, \
            "Binomial data must be a (Y, N) pair of 3-tensors."
        mask = (~np.isnan(Y)) & (~np.isnan(N))
        return {
            "Y": jnp.asarray(np.where(mask, Y, 0.0), self.dtype),
            "N": jnp.asarray(np.where(mask, N, 0.0), self.dtype),
            "mask": jnp.asarray(mask.astype(np.float32), self.dtype),
        }

    # ------------------------------------------------------------------
    def _pg_update(self, state, Y, N, mask, key):
        """omega ~ PG(N, psi), psi = <w_i, v_jt> (factor.py:447-460).

        Returns (state with nu2 = 1/omega, w8 = omega, wy = kappa) where
        kappa = (Y - N/2) so that the Gaussian cores see weight omega and
        weighted target omega * kappa/omega = kappa.
        """
        Mu = jnp.einsum("nk,mtk->nmt", state["W"], state["V"],
                        precision=jax.lax.Precision.HIGHEST)
        omega = polya_gamma(key, N * mask, Mu, num_terms=self.pg_num_terms)
        nu2 = jnp.where(omega > 0, 1.0 / jnp.where(omega > 0, omega, 1.0), jnp.inf)
        w8 = omega * mask
        wy = (Y - N / 2.0) * mask
        return dict(state, nu2=nu2.astype(self.dtype)), w8, wy

    def _make_sweep(self):
        def sweep(state, pdata, key):
            Y, N, mask = pdata["Y"], pdata["N"], pdata["mask"]
            # PG latent update first (factor.py:306-311 dispatch order)
            state, w8, wy = self._pg_update(state, Y, N, mask, _fold(key, 10))

            def update_W(st, pd, k):
                return self._gaussian_update_W(st, w8, wy, k)

            def update_V(st, pd, k):
                return self._gaussian_update_V(st, w8, wy, k)

            return self._prior_sweep(state, pdata, key, update_W, update_V)

        return sweep

    # ------------------------------------------------------------------
    def logprob(self, data, **params):
        """Binomial log-likelihood at given posterior params."""
        from scipy.special import gammaln as _gammaln
        W = np.asarray(params.get("W", self.W))
        V = np.asarray(params.get("V", self.V))
        Y, N = data
        Y = np.asarray(Y, dtype=np.float64)
        N = np.asarray(N, dtype=np.float64)
        Mu = np.clip(np.einsum("nk,mtk->nmt", W, V), -30, 30)
        p = 1.0 / (1.0 + np.exp(-Mu))
        ll = (_gammaln(N + 1) - _gammaln(Y + 1) - _gammaln(N - Y + 1)
              + Y * np.log(np.clip(p, 1e-12, 1)) + (N - Y) * np.log(np.clip(1 - p, 1e-12, 1)))
        return float(np.nansum(ll))
