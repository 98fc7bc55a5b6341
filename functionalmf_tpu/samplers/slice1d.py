"""Scalar shrinkage slice sampler (Neal 2003, §4.1 fig. 5) on an interval.

Built for the ancillarity-sufficiency interweaving (ASIS, Yu & Meng 2011)
moves on the global scale hyperparameters lam2 / sigma2
(models/constrained.py:_interweave_scales): the reference's conjugate
updates draw lam2 | V from a huge-shape inverse gamma
(functionalmf/factor.py:143-153), which is nearly deterministic given V —
lam2 then moves only as fast as V's global scale drifts, and the
reference's own TODO flags it (factor.py:144-146 "better sampler for
lam2"). The ASIS move needs an exact 1-D kernel for
p(x) ∝ prior(x) · lik(scale(x)); slice sampling is tuning-free and exact.

Design: the shrink loop is a `lax.while_loop` with a hard iteration
cap — shrinkage halves the bracket in expectation per rejection, so the
cap is hit with vanishing probability; on the cap the move degrades to
stay-put (still a valid kernel: it is the slice kernel composed with a
measurable truncation event, and the caller counts it).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["shrink_slice_1d"]


def shrink_slice_1d(key, x0, logdensity, lo, hi, max_shrink: int = 16):
    """One exact shrinkage-slice update of scalar ``x`` on ``[lo, hi]``.

    Args:
      key: PRNG key.
      x0: current point; must lie in [lo, hi] with logdensity(x0) finite.
      logdensity: traceable ``x -> scalar`` log target, up to a constant,
        evaluated only inside [lo, hi].
      lo, hi: the initial bracket — the full (truncated) support, so no
        stepping-out phase is needed.
      max_shrink: iteration cap on the shrink loop.

    Returns ``(x_new, accepted)``; ``accepted`` False means the cap was
    hit and ``x_new == x0``.
    """
    x0 = jnp.asarray(x0)
    k_y, k_u = jax.random.split(key)
    y = logdensity(x0) - jax.random.exponential(k_y)  # log slice height

    def cond(carry):
        i, L, R, x, acc, k = carry
        return jnp.logical_and(i < max_shrink, jnp.logical_not(acc))

    def body(carry):
        i, L, R, x, acc, k = carry
        k, sub = jax.random.split(k)
        xp = L + (R - L) * jax.random.uniform(sub, dtype=x0.dtype)
        ok = logdensity(xp) >= y
        # shrink toward x0 on rejection (Neal fig. 5: the bracket always
        # contains x0, so the loop terminates onto the slice)
        L = jnp.where(jnp.logical_and(~ok, xp < x0), xp, L)
        R = jnp.where(jnp.logical_and(~ok, xp >= x0), xp, R)
        x = jnp.where(ok, xp, x)
        return (i + 1, L, R, x, ok, k)

    lo = jnp.asarray(lo, x0.dtype)
    hi = jnp.asarray(hi, x0.dtype)
    _, _, _, x, acc, _ = jax.lax.while_loop(
        cond, body,
        (jnp.zeros((), jnp.int32), lo, hi, x0, jnp.zeros((), bool), k_u))
    return x, acc
