"""Batched multivariate-normal samplers on precision / covariance form.

JAX replacement for the reference's CHOLMOD-backed fast_mvn module
(functionalmf/fast_mvn.py:10-179). Design deltas:

* All paths are **dense and batched**: a (..., D, D) precision/covariance
  stack maps to one `jax.lax.linalg.cholesky` + batched triangular solves. The reference instead crossed into C
  (CHOLMOD) once per matrix inside Python loops.
* The reference's ``force_psd`` try/except retry loop (fast_mvn.py:30-72)
  becomes a fixed number of *unrolled* jitter attempts with NaN detection:
  under jit we cannot catch exceptions, so we factor, check for NaNs in the
  factor, and re-factor with exponentially growing diagonal jitter, selecting
  the first finite result. Distributionally equivalent for PSD inputs.
* Randomness is explicit: every sampler takes a `jax.random` key
  (counter-based, reproducibly parallel) instead of global numpy state.

Semantics preserved from the reference:
  - precision path: theta ~ N(Q^-1 mu_part, Q^-1) via L L^T = Q,
    x = L^-T z + Q^-1 mu_part (fast_mvn.py:36-61).
  - covariance path: theta ~ N(mu, S) via x = L z + mu; with mu_part the
    mean is S mu_part (fast_mvn.py:100-129).
  - scalar / vector Q promoted to Q * I (fast_mvn.py:159-165).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from functionalmf_tpu.ops.banded import _mm_f32, chain_reduced_pred

__all__ = [
    "cholesky_psd",
    "sample_mvn_from_precision",
    "sample_mvn_from_covariance",
    "sample_mvn",
]


@_mm_f32
def cholesky_psd(Q, eps: float = 1e-6, attempts: int = 4):
    """Cholesky with unrolled jitter retries (fast_mvn.py:30-72 semantics).

    Returns the lower Cholesky factor of Q, adding eps * 10^a to the
    diagonal for the smallest a in {none, 0, ..., attempts-1} that yields a
    finite factor. If all attempts fail the last (NaN-filled) factor is
    returned; callers surface that as NaNs in the sample, which tests and
    drivers detect host-side.
    """
    L = jnp.linalg.cholesky(Q)
    if attempts <= 0:
        return L
    eye = np.eye(Q.shape[-1], dtype=Q.dtype)

    # Lazy retries: the predicate is a scalar, chain-reduced over the
    # chain-vmap axis (ops/banded.py:chain_reduced_pred), so the cond keeps
    # a real branch both unbatched AND under the chain-level vmap in
    # models/base.py — the all-finite fast path skips every
    # refactorization. (Before the chain reduction, vmapped lowering turned
    # these conds into execute-both-branches selects, costing `attempts`
    # extra Cholesky calls per call site per sweep: the VERDICT round-3
    # multi-chain throughput leak.)
    # Escalate x100 per attempt (the reference escalates x10, fast_mvn.py:68,
    # but in float32 a degenerate horseshoe regime needs a wider ladder).
    def retry(a, L):
        def redo(L):
            bad = ~jnp.all(jnp.isfinite(L), axis=(-2, -1), keepdims=True)
            Lr = jnp.linalg.cholesky(Q + (eps * 100.0**a) * eye)
            return jnp.where(bad, Lr, L)
        return jax.lax.cond(chain_reduced_pred(jnp.all(jnp.isfinite(L))),
                            lambda L: L, redo, L)

    for a in range(attempts):
        L = retry(a, L)
    return L


def _solve_lt(L, z):
    """Solve L^T x = z for lower-triangular L (batched)."""
    return jax.lax.linalg.triangular_solve(
        L, z[..., None], left_side=True, lower=True, transpose_a=True
    )[..., 0]


def _cho_solve(L, b):
    """Solve (L L^T) x = b (batched)."""
    y = jax.lax.linalg.triangular_solve(
        L, b[..., None], left_side=True, lower=True
    )
    x = jax.lax.linalg.triangular_solve(
        L, y, left_side=True, lower=True, transpose_a=True
    )
    return x[..., 0]


@_mm_f32
def sample_mvn_from_precision(
    key,
    Q,
    mu=None,
    mu_part=None,
    chol_factor: bool = False,
    force_psd: bool = True,
    force_psd_eps: float = 1e-6,
    force_psd_attempts: int = 4,
    equilibrate: bool = False,
):
    """theta ~ N(Q^-1 mu_part (or mu), Q^-1) for a (..., D, D) precision stack.

    Mirrors sample_mvn_from_precision (fast_mvn.py:10-74): draw z ~ N(0, I),
    solve L^T x = z so that x ~ N(0, Q^-1), then add the mean term
    Q^-1 mu_part (or mu). `chol_factor=True` means Q is already the lower
    Cholesky factor of the precision.

    `equilibrate=True` applies Jacobi (diagonal) equilibration before
    factorizing: Q' = D Q D with D = diag(Q)^(-1/2), sample x' from Q', and
    return D x'. Exact (D x' has covariance D Q'^-1 D = Q^-1) but keeps the
    factorization well-scaled in float32, where the horseshoe prior can put
    ~1e6 dynamic range on the diagonal. The reference works in float64 and
    never needs this.
    """
    if equilibrate and not chol_factor:
        d = jnp.diagonal(Q, axis1=-2, axis2=-1)
        d = jnp.where(d > 0, d, 1.0)
        dinv = jax.lax.rsqrt(d)
        Qe = Q * dinv[..., :, None] * dinv[..., None, :]
        mp = None if mu_part is None else mu_part * dinv
        mq = None if mu is None else mu / dinv
        x = sample_mvn_from_precision(
            key, Qe, mu=mq, mu_part=mp, chol_factor=False,
            force_psd=force_psd, force_psd_eps=force_psd_eps,
            force_psd_attempts=force_psd_attempts, equilibrate=False)
        return x * dinv
    if chol_factor:
        L = Q
    else:
        L = cholesky_psd(
            Q,
            eps=force_psd_eps,
            attempts=force_psd_attempts if force_psd else 0,
        )
    z = jax.random.normal(key, L.shape[:-1], dtype=L.dtype)
    x = _solve_lt(L, z)
    if mu_part is not None:
        x = x + _cho_solve(L, mu_part)
    elif mu is not None:
        x = x + mu
    return x


@_mm_f32
def sample_mvn_from_covariance(
    key,
    S,
    mu=None,
    mu_part=None,
    chol_factor: bool = False,
    force_psd: bool = True,
    force_psd_eps: float = 1e-6,
    force_psd_attempts: int = 4,
):
    """theta ~ N(mu (or S mu_part), S) for a (..., D, D) covariance stack.

    Mirrors sample_mvn_from_covariance (fast_mvn.py:77-142).
    """
    if chol_factor:
        L = S
        S_full = L @ jnp.swapaxes(L, -1, -2)
    else:
        L = cholesky_psd(
            S,
            eps=force_psd_eps,
            attempts=force_psd_attempts if force_psd else 0,
        )
        S_full = S
    z = jax.random.normal(key, L.shape[:-1], dtype=L.dtype)
    x = jnp.einsum("...ij,...j->...i", L, z)
    if mu_part is not None:
        x = x + jnp.einsum("...ij,...j->...i", S_full, mu_part)
    elif mu is not None:
        x = x + mu
    return x


def sample_mvn(
    key,
    Q,
    mu=None,
    mu_part=None,
    precision: bool = False,
    chol_factor: bool = False,
    **kwargs,
):
    """Dispatcher mirroring sample_mvn (fast_mvn.py:145-179).

    Scalar or vector Q is promoted to Q * I, using mu/mu_part to infer the
    dimension (fast_mvn.py:159-165).
    """
    Q = jnp.asarray(Q)
    if not chol_factor and Q.ndim <= 1:
        ref = mu if mu is not None else mu_part
        if ref is None:
            raise ValueError("scalar/vector Q requires mu or mu_part for the dimension")
        dim = jnp.asarray(ref).shape[-1]
        Q = jnp.eye(dim, dtype=jnp.result_type(Q, jnp.float32)) * Q
    fn = sample_mvn_from_precision if precision else sample_mvn_from_covariance
    return fn(key, Q, mu=mu, mu_part=mu_part, chol_factor=chol_factor, **kwargs)
