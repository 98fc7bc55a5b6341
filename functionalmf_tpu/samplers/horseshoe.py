"""Horseshoe / horseshoe+ shrinkage ladders and their Gibbs updates.

Reimplements the prior draws in the reference (functionalmf/utils.py:115-124)
and the ladder resampling steps embedded in the BTF model
(functionalmf/factor.py:134-153) as pure, vectorized, key-passing functions.

Design deltas from the reference:
* The per-column Python loop in _resample_Tau2 (factor.py:135-141) becomes a
  single vectorized update over all columns.
* The reference's _resample_lam2 has a bug (factor.py:147-151): the `rate`
  accumulator is overwritten inside the column loop, so only the last
  column's deltas and none of the 1/lam2_a auxiliary term contribute. We
  implement the correct horseshoe update (sum over all columns plus the
  auxiliary inverse term) — documented deviation, per SURVEY.md §7.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "sample_horseshoe",
    "sample_horseshoe_plus",
    "resample_tau2_ladder",
    "resample_lam2",
]


def _inv_gamma(key, shape, scale):
    """Draw 1 / Gamma(shape, scale) with numpy's (shape, scale) convention.

    numpy's np.random.gamma(a, s) has mean a*s; jax.random.gamma(key, a)
    is Gamma(a, 1), so we multiply by the scale.
    """
    a = jnp.asarray(shape)
    g = jax.random.gamma(key, a, shape=jnp.broadcast_shapes(jnp.shape(shape), jnp.shape(scale)))
    return 1.0 / (g * scale)


def sample_horseshoe_plus(key, size=()):
    """Draw from the horseshoe+ auxiliary ladder (utils.py:115-120).

    Returns (d, c, b, a) with a ~ IG(1/2, 1), b ~ IG(1/2, a), ... matching
    the reference's nesting: each level's *scale* is the previous draw.
    """
    k1, k2, k3, k4 = jax.random.split(key, 4)
    half = jnp.asarray(0.5)
    # numpy convention: np.random.gamma(0.5, s) is Gamma(0.5, scale=s),
    # so 1/np.random.gamma(0.5, a) == 1/(g * a) with g ~ Gamma(0.5, 1).
    a = 1.0 / (jax.random.gamma(k1, half, shape=size) * 1.0)
    b = 1.0 / (jax.random.gamma(k2, half, shape=size) * a)
    c = 1.0 / (jax.random.gamma(k3, half, shape=size) * b)
    d = 1.0 / (jax.random.gamma(k4, half, shape=size) * c)
    return d, c, b, a


def sample_horseshoe(key, size=()):
    """Draw from the horseshoe ladder (utils.py:122-124)."""
    k1, k2 = jax.random.split(key)
    a = 1.0 / jax.random.gamma(k1, jnp.asarray(0.5), shape=size)
    return 1.0 / (jax.random.gamma(k2, jnp.asarray(0.5), shape=size) * a), a


def resample_tau2_ladder(key, deltas_sq, lam2, tau2, tau2_c, tau2_b, tau2_a,
                         nembeds: int, stability: float = 1e-6):
    """Vectorized horseshoe+ local-shrinkage update (factor.py:134-141).

    Args:
      deltas_sq: (ncols, nD) — per column j, ((Delta @ V_j)**2).sum(-1) over
        the embedding axis.
      tau2 / tau2_c / tau2_b / tau2_a: (ncols, nD) ladder state.

    Returns updated (tau2, tau2_c, tau2_b, tau2_a).
    """
    lo, hi = stability, 1.0 / stability
    k1, k2 = jax.random.split(key)

    rate = deltas_sq / (2.0 * lam2) + 1.0 / jnp.clip(tau2_c, lo, hi)
    shape = (nembeds + 1) / 2.0
    tau2 = _inv_gamma(k1, jnp.full(rate.shape, shape), 1.0 / jnp.clip(rate, lo, hi))
    # The c/b/a auxiliary levels are all IG(1, rate) = rate / Exp(1). A
    # Gamma(1,1) variate IS an Exp(1) variate, so one batched exponential
    # replaces three jax.random.gamma calls — each of those lowers to a
    # rejection while_loop whose latency dominates this whole block at
    # (ncols, nD) shapes (the draws only enter through their scale,
    # so the ladder's sequential rate dependence costs nothing).
    # guard the divisor: exponential() can return exactly 0.0 (uniform in
    # [0,1) hits 0 with prob ~2^-23 in f32), which would put an inf in the
    # ladder state for one sweep (ADVICE round 3)
    e = jnp.maximum(jax.random.exponential(k2, (3,) + tau2.shape),
                    jnp.finfo(tau2.dtype).tiny)
    tau2_c = jnp.clip(1.0 / tau2 + 1.0 / tau2_b, lo, hi) / e[0]
    tau2_b = jnp.clip(1.0 / tau2_c + 1.0 / tau2_a, lo, hi) / e[1]
    tau2_a = jnp.clip(1.0 / tau2_b + 1.0, lo, hi) / e[2]
    return tau2, tau2_c, tau2_b, tau2_a


def resample_lam2(key, deltas_sq_over_tau2, lam2_a, nD: int, ncols: int,
                  nembeds: int, lam2_min: float = 1e-5):
    """Global shrinkage update (factor.py:143-153, with the accumulation
    bug fixed: the rate sums over *all* columns and includes 1/lam2_a).

    Args:
      deltas_sq_over_tau2: scalar — sum over columns j of
        ((Delta @ V_j)**2 / Tau2_j[:, None]).sum().

    Returns (lam2, lam2_a).
    """
    k1, k2 = jax.random.split(key)
    rate = 1.0 / lam2_a + deltas_sq_over_tau2 / 2.0
    shape = (nD * ncols * nembeds + 1) / 2.0
    lam2 = jnp.maximum(lam2_min, _inv_gamma(k1, shape, 1.0 / rate))
    # IG(1, r) = r / Exp(1): exponential instead of a gamma rejection loop.
    # maximum(..., tiny) guards the prob ~2^-23 exact-zero draw (ADVICE r3).
    e = jnp.maximum(jax.random.exponential(k2), jnp.finfo(jnp.asarray(lam2).dtype).tiny)
    lam2_a = (1.0 / lam2 + 1.0) / e
    return lam2, lam2_a
