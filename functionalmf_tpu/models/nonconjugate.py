"""Unconstrained black-box-likelihood BTF via elliptical slice sampling.

JAX re-design of NonconjugateBayesianTensorFiltering
(reference functionalmf/factor.py:567-612): joint ESS updates of the packed
W and the packed V under the trend-filtering prior, with a user-supplied
jax-traceable ``loglikelihood(W, V, data) -> scalar``.

Design deltas: the reference packs W into a ragged lower-triangular vector
and V into one long block vector, drawing prior samples through CHOLMOD
(factor.py:573-590). Here the ellipse runs directly in the natural (masked)
array shapes — a masked prior draw is combined on the ellipse elementwise,
so no pack/unpack is needed — and the per-column V prior draws come from
one batched dense Cholesky.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from functionalmf_tpu.models.base import BayesianTensorFiltering
from functionalmf_tpu.samplers.ess import elliptical_slice

__all__ = ["NonconjugateBayesianTensorFiltering"]


class NonconjugateBayesianTensorFiltering(BayesianTensorFiltering):
    """ESS-based BTF with loglikelihood(W, V, data) (factor.py:567-607)."""

    def __init__(self, nrows, ncols, ndepth, loglikelihood,
                 ess_max_iters=100, **kwargs):
        super().__init__(nrows, ncols, ndepth, **kwargs)
        self.loglikelihood = loglikelihood
        self.ess_max_iters = int(ess_max_iters)

    def prepare_data(self, data):
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x, dtype=np.float32), self.dtype), data)

    # ------------------------------------------------------------------
    def _update_W_ess(self, state, data, key):
        """factor.py:572-582: prior draw from N(0, sigma2 I) on the packed
        support, then one joint ESS step over all of W."""
        k1, k2 = jax.random.split(key)
        mask = self._wmask
        prior = (jax.random.normal(k1, state["W"].shape, dtype=self.dtype)
                 * jnp.sqrt(state["sigma2"]) * mask)

        V = state["V"]

        def loglik(Wf):
            return self.loglikelihood(Wf.reshape(mask.shape) * mask, V, data)

        x, _ = elliptical_slice(k2, state["W"].reshape(-1), prior.reshape(-1),
                                loglik, max_iters=self.ess_max_iters)
        return dict(state, W=(x.reshape(mask.shape) * mask).astype(self.dtype))

    def _update_V_ess(self, state, data, key):
        """factor.py:584-590: prior draw from the block trend-filtering
        precision (batched over columns), then one joint ESS step over V."""
        k1, k2 = jax.random.split(key)
        m, k, T = self.ncols, self.nembeds, self.ndepth
        draw = self._sample_v_prior(k1, state["lam2"], state["Tau2"])  # (m, kT)
        prior = draw.reshape(m, k, T).transpose(0, 2, 1)  # (m, T, k)

        W = state["W"]

        def loglik(Vf):
            return self.loglikelihood(W, Vf.reshape(m, T, k), data)

        x, _ = elliptical_slice(k2, state["V"].reshape(-1), prior.reshape(-1),
                                loglik, max_iters=self.ess_max_iters)
        return dict(state, V=x.reshape(m, T, k).astype(self.dtype))

    def _make_sweep(self):
        def sweep(state, pdata, key):
            return self._prior_sweep(state, pdata, key,
                                     self._update_W_ess, self._update_V_ess)
        return sweep

    # ------------------------------------------------------------------
    def logprob(self, data, **params):
        W = jnp.asarray(params.get("W", self.W))
        V = jnp.asarray(params.get("V", self.V))
        pdata = self.prepare_data(data)
        return float(self.loglikelihood(W, V, pdata))
