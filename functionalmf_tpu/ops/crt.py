"""Chinese-restaurant-table and multinomial-allocation primitives.

These are the augmentation workhorses of allocation-based Poisson
factorization samplers (the PGDS baseline, Schein/Wallach/Zhou NeurIPS
2016; the reference consumed them through the external Cython `apf`
package, reference functionalmf/pgds.py:17). Design: static
shapes, counter-based keys, bounded exact scans with validated tail
approximations — the same discipline as ops/polyagamma.py.

CRT(n, r) is distributed as sum_{i=1..n} Bernoulli(r / (r + i - 1)):
the number of tables after n customers at concentration r. It arises
when a negative binomial NB(n; a, p) is augmented so that its shape `a`
becomes Poisson-conjugate (l ~ CRT(n, a) has likelihood a^l (1-p)^a).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, polygamma

__all__ = ["chinese_restaurant_table", "multinomial_split"]

_N_EXACT = 128  # exact Bernoulli terms; tail is approximated


def chinese_restaurant_table(key, n, r, n_exact: int = _N_EXACT):
    """Draw CRT(n, r) elementwise; n, r broadcastable float arrays.

    Hybrid sampler:
      * i <= n_exact:  exact Bernoulli(r/(r+i-1)) terms, one batched draw.
      * i  > n_exact:  the remaining sum of independent Bernoullis with
        p_i = r/(r+i-1) <= r/(r+n_exact). Mean and variance are exact in
        closed form via digamma/trigamma:
            mu  = r [psi(r+n) - psi(r+n_exact)]
            var = mu - r^2 [psi1(r+n_exact) - psi1(r+n)]
        Sampled as Poisson(mu) when every tail p_i < ~0.1 (r small; the
        Poisson-binomial is Poisson to O(sum p_i^2)), else as a rounded
        normal (r large => mu large, CLT over the tail). Clipped to the
        feasible range [1[n>n_exact], n - n_exact].

    Matches the validated-tail philosophy of ops/polyagamma.py; exactness
    is tested against a brute-force numpy CRT in tests/test_pgds.py.
    """
    n = jnp.asarray(n, jnp.float32)
    r = jnp.asarray(r, jnp.float32)
    n, r = jnp.broadcast_arrays(n, r)
    kb, kp, kn = jax.random.split(key, 3)

    i = jnp.arange(1, n_exact + 1, dtype=jnp.float32)
    shp = n.shape + (n_exact,)
    p = r[..., None] / (r[..., None] + i - 1.0)
    active = i <= n[..., None]
    u = jax.random.uniform(kb, shp)
    exact = jnp.sum(jnp.where(active & (u < p), 1.0, 0.0), axis=-1)

    has_tail = n > n_exact
    # guard digamma args for masked-out lanes
    nt = jnp.where(has_tail, n, n_exact + 1.0)
    rs = jnp.clip(r, 1e-20, None)
    mu = rs * (digamma(rs + nt) - digamma(rs + n_exact))
    var = mu - rs * rs * (polygamma(1, rs + n_exact) - polygamma(1, rs + nt))
    var = jnp.clip(var, 1e-12, None)
    pois = jax.random.poisson(kp, jnp.clip(mu, 0.0, None)).astype(jnp.float32)
    norm = jnp.round(mu + jnp.sqrt(var) * jax.random.normal(kn, n.shape))
    small_p = rs < 0.1 * (rs + n_exact)
    tail = jnp.where(small_p, pois, norm)
    tail = jnp.clip(tail, 0.0, jnp.clip(nt - n_exact, 0.0, None))
    out = exact + jnp.where(has_tail, tail, 0.0)
    # CRT(n, r) >= 1 whenever n >= 1 (the first customer opens a table
    # with probability r/r = 1)
    return jnp.where(n >= 1.0, jnp.clip(out, 1.0, n), 0.0)


def multinomial_split(key, n, p):
    """Split counts n (...,) into K cells with probabilities p (..., K).

    Binomial chain: cell k gets Binomial(remaining, p_k / p_{k:}). Static
    K-step scan, exact for any n (jax.random.binomial is exact), fully
    batched over the leading dims. Returns (..., K) float counts summing
    to n.
    """
    n = jnp.asarray(n, jnp.float32)
    p = jnp.asarray(p, jnp.float32)
    K = p.shape[-1]
    psum = jnp.cumsum(p[..., ::-1], axis=-1)[..., ::-1]  # tail sums p_{k:}
    keys = jax.random.split(key, K)

    def step(rem, inp):
        pk, tail, kk = inp
        frac = jnp.clip(pk / jnp.clip(tail, 1e-30, None), 0.0, 1.0)
        draw = jax.random.binomial(kk, rem, frac).astype(jnp.float32)
        draw = jnp.minimum(draw, rem)
        return rem - draw, draw

    pk_seq = jnp.moveaxis(p, -1, 0)
    tail_seq = jnp.moveaxis(psum, -1, 0)
    rem, draws = jax.lax.scan(step, n, (pk_seq[:-1], tail_seq[:-1],
                                        keys[:-1]))
    out = jnp.concatenate([jnp.moveaxis(draws, 0, -1), rem[..., None]],
                          axis=-1)
    return out
