"""Fixed-round Marsaglia-Tsang gamma sampler.

`jax.random.gamma` uses a rejection `while_loop` that iterates until the
*slowest* lane accepts; over ~1e6 lanes the max iteration count is ~2-3x
the mean, and each iteration re-runs the whole tensor. For the
Polya-Gamma augmentation (ops/polyagamma.py) — the hot op of the Binomial /
Negative-Binomial sweeps — we instead run a *fixed* number of
Marsaglia-Tsang (2000) rounds with acceptance masking. With per-round
acceptance >= 0.95, the probability a lane misses all `rounds=6` proposals
is < 2e-8; such lanes fall back to the distribution mean, a bias far below
Monte Carlo noise.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["gamma_mt"]


def gamma_mt(key, a, shape=None, rounds: int = 6, dtype=jnp.float32):
    """Draws ~ Gamma(a, 1) with fixed-round Marsaglia-Tsang rejection.

    a broadcasts to `shape` (default: a.shape). Supports a > 0, including
    a < 1 via the boost g(a) = g(a+1) * U^(1/a).
    """
    a = jnp.asarray(a, dtype)
    if shape is None:
        shape = a.shape
    a = jnp.broadcast_to(a, shape)

    small = a < 1.0
    a_eff = jnp.where(small, a + 1.0, a)
    d = a_eff - 1.0 / 3.0
    c = jax.lax.rsqrt(9.0 * d)

    k_boost, k_rounds = jax.random.split(key)

    out = jnp.full(shape, jnp.nan, dtype)
    accepted = jnp.zeros(shape, bool)
    for r in range(rounds):
        kr = jax.random.fold_in(k_rounds, r)
        kx, ku = jax.random.split(kr)
        x = jax.random.normal(kx, shape, dtype)
        u = jax.random.uniform(ku, shape, dtype, minval=1e-12)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (jnp.log(u) < 0.5 * x * x + d - d * v
                        + d * jnp.log(jnp.where(v > 0, v, 1.0)))
        take = ok & ~accepted
        out = jnp.where(take, d * v, out)
        accepted = accepted | ok
    # unaccepted lanes (prob < ~2e-8 per lane at rounds=6): fall back to the
    # mean of Gamma(a_eff, 1)
    out = jnp.where(accepted, out, a_eff)

    # boost for a < 1: multiply by U^(1/a)
    u = jax.random.uniform(k_boost, shape, dtype, minval=1e-12)
    boost = jnp.exp(jnp.log(u) / jnp.clip(a, 1e-12, None))
    out = jnp.where(small, out * boost, out)
    return jnp.where(a > 0, out, 0.0)
