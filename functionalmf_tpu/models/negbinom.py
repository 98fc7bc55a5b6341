"""Negative-Binomial Bayesian Tensor Filtering.

JAX re-design of NegativeBinomialBayesianTensorFiltering
(reference functionalmf/factor.py:463-563): NB modeled as a PG-augmented
binomial with pseudo-count N = sum_reps(Y + R), where the dispersion R is
sampled by `nmetropolis` vectorized random-walk Metropolis-Hastings steps in
log space with per-dimension aggregation `rdims` and a log-normal prior
(factor.py:513-554). The reference's per-step numpy loop becomes a
`lax.fori_loop` over MH steps with counter-based keys; all cells'
accept/reject decisions happen in one masked tensor op.

Behavioral parity notes:
  * the acceptance log-ratio clip to [-10, 1] (factor.py:542) and the
    R > 1 acceptance gate (factor.py:547, marked TEMP upstream) are kept,
    exposed as `accept_clip` / `r_min`.
  * the reference never sets self.N when R_true is given (a latent
    upstream crash); here N is always derived from the current R.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln
from jax.scipy.stats import norm as jnorm

from functionalmf_tpu.models.base import _fold
from functionalmf_tpu.models.binomial import BinomialBayesianTensorFiltering

__all__ = ["NegativeBinomialBayesianTensorFiltering"]


class NegativeBinomialBayesianTensorFiltering(BinomialBayesianTensorFiltering):
    """NB BTF (factor.py:463-563). Data is Y (n, m, t[, r]) counts."""

    _collect_keys = ("W", "V", "sigma2", "lam2", "Tau2", "nu2", "R")

    def __init__(self, nrows, ncols, ndepth,
                 R_true=None, R_init=None,
                 nmetropolis=30, rpropstdev=0.1, rstdev=1.0,
                 rdims=(0, 1, 2), accept_clip=(-10.0, 1.0), r_min=1.0,
                 **kwargs):
        super().__init__(nrows, ncols, ndepth, **kwargs)
        self.nmetropolis = int(nmetropolis)
        self.rpropstdev = float(rpropstdev)
        self.rstdev = float(rstdev)
        self.accept_clip = accept_clip
        self.r_min = float(r_min)
        rdims = tuple(sorted(rdims)) if rdims is not None else ()
        self.rdims = rdims
        # aggregation axes in the (n, m, t, r) likelihood tensor: replicates
        # always (factor.py:486), plus the user's rdims.
        self._agg_axes = tuple(rdims) + (3,)
        self._R_shape = tuple(1 if i in rdims else c
                              for i, c in enumerate([nrows, ncols, ndepth]))

        if R_true is not None:
            self.sample_R = False
            self._state["R"] = self._chain_broadcast(R_true, self._R_shape)
        else:
            self.sample_R = True
            if R_init is not None:
                self._state["R"] = self._chain_broadcast(R_init, self._R_shape)
            else:
                # factor.py:560-563: R = exp(N(0, rstdev)) + 1
                k = self._next_init_keys()
                self._state["R"] = jax.vmap(
                    lambda kk: jnp.exp(
                        jax.random.normal(kk, self._R_shape) * self.rstdev) + 1.0
                )(k).astype(self.dtype)

    R = property(lambda s: s._get_var("R"), lambda s, v: s._set_var("R", v))

    def state_partition_specs(self):
        from jax.sharding import PartitionSpec as P
        from functionalmf_tpu.parallel.mesh import DP_AXIS as dp
        specs = super().state_partition_specs()
        # R aggregates over rdims (axes may be size 1); replicate over mp
        specs["R"] = P(dp)
        return specs

    # ------------------------------------------------------------------
    def prepare_data(self, data):
        Y = np.asarray(data, dtype=np.float32)
        assert Y.ndim in (3, 4), "Observations must be 3- or 4-tensor."
        if Y.ndim == 3:
            Y = Y[..., None]
        repmask = ~np.isnan(Y)
        return {
            "Yrep": jnp.asarray(np.where(repmask, Y, 0.0), self.dtype),
            "repmask": jnp.asarray(repmask.astype(np.float32), self.dtype),
            "mask": jnp.asarray(repmask.any(axis=-1).astype(np.float32), self.dtype),
        }

    # ------------------------------------------------------------------
    def _update_R(self, state, pdata, key):
        """Vectorized RW-MH on log R (factor.py:513-554)."""
        Y, rm = pdata["Yrep"], pdata["repmask"]
        lo, hi = self.accept_clip
        # success probability from the current embeddings (factor.py:519)
        Mu = jnp.einsum("nk,mtk->nmt", state["W"], state["V"],
                        precision=jax.lax.Precision.HIGHEST)
        P = jax.nn.sigmoid(jnp.clip(Mu, -10, 10))[..., None]
        log1mP = jnp.log1p(-P)
        logR0 = jnp.log(state["R"])

        def body(i, logR):
            k1 = _fold(key, 2 * i)
            k2 = _fold(key, 2 * i + 1)
            cand = logR + jax.random.normal(k1, logR.shape, dtype=logR.dtype) * self.rpropstdev
            Rc = jnp.exp(cand)[..., None]       # broadcast (R_shape, 1)
            R0 = jnp.exp(logR)[..., None]
            ap = (jnorm.logpdf(cand, loc=0.0, scale=self.rstdev)
                  - jnorm.logpdf(logR, loc=0.0, scale=self.rstdev))
            al = (gammaln(Y + Rc) - gammaln(Rc) - gammaln(Y + R0) + gammaln(R0)
                  + (Rc - R0) * log1mP) * rm
            al = jnp.sum(al, axis=self._agg_axes, keepdims=True)
            al = al.reshape(logR.shape)
            prob = jnp.exp(jnp.clip(ap + al, lo, hi))
            u = jax.random.uniform(k2, logR.shape, dtype=logR.dtype)
            accept = (u <= prob) & (jnp.exp(cand) > self.r_min)
            return jnp.where(accept, cand, logR)

        logR = jax.lax.fori_loop(0, self.nmetropolis, body, logR0)
        return dict(state, R=jnp.exp(logR).astype(self.dtype))

    def _make_sweep(self):
        def sweep(state, pdata, key):
            if self.sample_R:
                state = self._update_R(state, pdata, _fold(key, 9))

            # Binomial reduction: sum successes; N = sum_reps(Y + R)
            # (factor.py:507-511, 553).
            rm, mask = pdata["repmask"], pdata["mask"]
            Ysum = jnp.sum(pdata["Yrep"] * rm, axis=-1)
            N = jnp.sum((pdata["Yrep"] + state["R"][..., None]) * rm, axis=-1)

            state, w8, wy = self._pg_update(state, Ysum, N, mask, _fold(key, 10))

            def update_W(st, pd, k):
                return self._gaussian_update_W(st, w8, wy, k)

            def update_V(st, pd, k):
                return self._gaussian_update_V(st, w8, wy, k)

            return self._prior_sweep(state, pdata, key, update_W, update_V)

        return sweep

    # ------------------------------------------------------------------
    def logprob(self, data, **params):
        """NB log-likelihood at given posterior params."""
        from scipy.special import gammaln as _gammaln
        W = np.asarray(params.get("W", self.W))
        V = np.asarray(params.get("V", self.V))
        R = np.asarray(params.get("R", self.R))
        Y = np.asarray(data, dtype=np.float64)
        if Y.ndim == 3:
            Y = Y[..., None]
        Mu = np.clip(np.einsum("nk,mtk->nmt", W, V), -10, 10)
        P = 1.0 / (1.0 + np.exp(-Mu))
        Rb = np.broadcast_to(R, Mu.shape)[..., None]
        Pb = P[..., None]
        ll = (_gammaln(Y + Rb) - _gammaln(Rb) - _gammaln(Y + 1)
              + Rb * np.log1p(-Pb) + Y * np.log(np.clip(Pb, 1e-12, 1)))
        return float(np.nansum(ll))
