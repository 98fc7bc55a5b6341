"""Generalized Analytic Slice Sampling (GASS) with static shapes.

JAX re-design of the reference's gass (functionalmf/gass.py:13-130):
slice sampling on the ellipse through the current point and a Gaussian
proposal, restricted to the region satisfying linear constraints A x >= c,
where each constraint's valid arc is computed *analytically* from
a cos(theta) + b sin(theta) >= c.

Design delta (SURVEY.md §7 "GASS without data-dependent shapes"): the
reference builds a 10000-point grid, prunes it to a variable-length valid
set, and downsamples to ngrid (gass.py:64-110). Here we compute the joint
interval [theta_lo, theta_hi] from the concave ("interval") constraints,
place a *fixed* ngrid of points inside it, mask points by a direct
feasibility check of every candidate (which subsumes the reference's
complement-arc exclusion and guarantees A x_new >= c in float32), evaluate
the batched log-likelihood at all ngrid points, and select uniformly among
the above-slice valid points via the Gumbel-argmax trick. Same stationary
behavior, fully static shapes, vmappable across rows/columns/chains. The
constraints may be given as a dense matrix or as a factorized linear
operator (callable), which the BTF V updates use to avoid materializing
the Kronecker-structured constraint matrix.

Why the stationary distribution is unchanged (candidate placement delta vs
reference gass.py:64-110): both kernels are slice samplers whose proposal,
given the slice height, is a uniform pick among above-slice FEASIBLE grid
points on the same ellipse. Validity does not depend on how the candidate
set is generated — only that (a) its generation is independent of the
likelihood values (it is: both use only the constraint geometry and the
RNG), and (b) the current point remains reachable via the stay-put
fallback when every candidate rejects (both keep x when nothing is
acceptable, reference gass.py:123-128). Any such kernel leaves the
target invariant for the same reason Murray et al.'s ESS does: the
ellipse + slice construction is an auxiliary-variable Gibbs move, and a
uniform pick among an arbitrary likelihood-independent candidate set
above the slice is a valid within-slice transition (it is a mixture of
Metropolized independence moves restricted to the slice). The two
implementations therefore differ only in *mixing* per sweep (candidate
density near the current point), not in the invariant distribution; the
model-level equivalence test (tests/test_constrained.py grid-vs-shrink
posterior agreement) checks this empirically.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["gass"]


def gass(key, x, sample_v, loglik, A, c, *, mu=None, cur_ll=None,
         ngrid: int = 100, dim_mask=None, eps: float = 1e-6, v=None,
         method: str = "grid", max_shrink: int = 30):
    """One GASS update. Returns (x_new, ll_new).

    Args:
      x: (D,) current point, must satisfy A x >= c.
      sample_v: fn(key) -> (D,) draw v ~ N(0, Sigma) (the proposal
        covariance; the reference passes Sigma/precision/factors to
        sample_mvn — here the caller owns that, gass.py:25).
      loglik: fn((G, D)) -> (G,) batched log-likelihood (gass.py:114
        requires batching support too).
      A, c: (J, D), (J,) linear inequality constraints A x >= c
        (the reference packs them as one (J, D+1) matrix, gass.py:32).
        `A` may instead be a *callable* y (D,) -> A@y (J,) — a factorized
        linear operator. The BTF V updates use this to exploit the
        Kronecker structure A[(i,j),(t,a)] = CA[j,t] W[i,a]: the operator
        costs two small matmuls where the materialized matrix would be
        hundreds of MB of HBM traffic per Gibbs sweep.
      mu: optional (D,) Gaussian mean; the ellipse is traced around mu.
      dim_mask: optional (D,) 0/1 mask — masked dims are frozen at x's
        value (used for the lower-triangular W rows, factor.py:671).
      ngrid: number of grid points (factor.py:901 default 100).
      v: optional precomputed proposal draw (D,); overrides sample_v. Use
        this under vmap, where per-item sampler closures cannot vary.
      method: "grid" = the reference's kernel (fixed ngrid candidates over
        the feasible arc, uniform pick above the slice, stay-put fallback,
        gass.py:108-128). "shrink" = Neal (2003) bracket shrinkage on the
        same arc: draw theta ~ U(bracket), reject-and-shrink toward the
        current point until a feasible above-slice point is found. The
        grid kernel's move probability per update is ~ngrid * |acceptable
        region| / |arc|, which collapses when the conditional posterior is
        much narrower than the proposal ellipse (tight data, wide prior) —
        the chain stays put almost every sweep. Shrinkage always moves,
        with step scale ~ the conditional width, at ~log2(arc/width)
        sequential single-point likelihood calls. Validity: the initial
        bracket is ellipse-intrinsic (constraint-arc endpoints), so the
        shrinkage procedure is reversible exactly as in Neal 2003 §4.1 /
        Murray et al. 2010; infeasible candidates reject like ll = -inf.
      max_shrink: iteration bound for the shrink loop (2^-30 of the arc).
    """
    x = jnp.asarray(x)
    if mu is None:
        mu = jnp.zeros_like(x)
    if cur_ll is None:
        cur_ll = loglik(x[None])[0]

    k_h, k_v, k_pick = jax.random.split(key, 3)
    h = cur_ll + jnp.log(jax.random.uniform(k_h))

    if v is None:
        v = sample_v(k_v)
    if dim_mask is not None:
        v = v * dim_mask

    # Constraint geometry must be computed at full f32 precision whatever
    # the caller's matmul precision: a reduced-precision pass (TF32 on an
    # NVIDIA GPU's tensor cores, the GPU's default for f32 dots, or bf16)
    # breaks exact feasibility at arc boundaries. Explicit HIGHEST keeps it
    # exact for callers outside the sweep's float32 policy too.
    _hp = jax.lax.Precision.HIGHEST
    if callable(A):
        Af = A
    else:
        A_mat = jnp.asarray(A)
        Af = lambda y: jnp.dot(A_mat, y, precision=_hp)  # noqa: E731
    x0 = x - mu
    a = Af(x0)
    b = Af(v)
    cc = c - Af(mu)

    # Analytic arc intersection per constraint (gass.py:43-78):
    # a cos(t) + b sin(t) >= cc  <=>  t in/out of [theta1, theta2]
    sq = a * a + b * b - cc * cc
    concerning = (sq >= 0) & (a != -cc)
    s = jnp.sqrt(jnp.clip(sq, 0.0, None))
    denom = a + cc
    denom_safe = jnp.where(jnp.abs(denom) < 1e-30,
                           jnp.where(denom < 0, -1e-30, 1e-30), denom)
    t1 = 2.0 * jnp.arctan((b + s) / denom_safe)
    t2 = 2.0 * jnp.arctan((b - s) / denom_safe)

    # The two roots split the ellipse into two arcs; the valid one is where
    # a cos(t) + b sin(t) - cc >= 0. The reference classifies via
    # a^2 < cc^2 (gass.py:56-62), which assumes the *current* point is
    # strictly feasible; in float32 a boundary sample from the previous
    # sweep can sit ~1e-6 outside and flip the classification. We instead
    # evaluate the sinusoid at the interval midpoint — exact and robust.
    tmin = jnp.minimum(t1, t2)
    tmax = jnp.maximum(t1, t2)
    tmid = 0.5 * (tmin + tmax)
    f_mid = a * jnp.cos(tmid) + b * jnp.sin(tmid) - cc
    interval = concerning & (f_mid >= 0)
    complement = concerning & ~interval

    pi = jnp.pi
    has_interval = jnp.any(interval)
    theta_lo = jnp.where(has_interval,
                         jnp.max(jnp.where(interval, tmin, -pi)) + eps, -pi)
    theta_hi = jnp.where(has_interval,
                         jnp.min(jnp.where(interval, tmax, pi)) - eps, pi)

    if method == "shrink":
        return _gass_shrink(k_pick, x, x0, v, mu, Af, c, loglik, h, cur_ll,
                            theta_lo, theta_hi, has_interval, dim_mask,
                            max_shrink)
    if method != "grid":
        raise ValueError(f"unknown gass method {method!r}")

    # np.linspace: a trace-time host constant
    grid = theta_lo + (theta_hi - theta_lo) * np.linspace(
        0.0, 1.0, ngrid, dtype=np.float32)
    cosg, sing = jnp.cos(grid), jnp.sin(grid)

    pts = (x0[None, :] * cosg[:, None] + v[None, :] * sing[:, None]
           + mu[None, :])
    if dim_mask is not None:
        pts = pts * dim_mask[None, :]

    # Direct feasibility check of every candidate through the constraint
    # operator. The analytic arcs concentrate the grid in the valid region;
    # this mask *guarantees* A x_new >= c even at float32 arc boundaries,
    # where the reference's theta-space eps (gass.py:76-77) under-protects
    # — and it subsumes the complement-arc exclusion (gass.py:68-71). With
    # a factorized operator the batched check costs two small matmuls per
    # candidate instead of reading a materialized (J, D) matrix.
    feas = jnp.all(jax.vmap(Af)(pts) >= c[None, :], axis=1)
    valid = feas & (theta_hi >= theta_lo)

    ll = loglik(pts)
    ok = valid & (ll >= h) & jnp.isfinite(ll)
    # uniform choice among ok points (gass.py:118-121) via Gumbel-argmax
    gumbel = jax.random.gumbel(k_pick, (ngrid,))
    scores = jnp.where(ok, gumbel, -jnp.inf)
    idx = jnp.argmax(scores)
    any_ok = jnp.any(ok)

    x_new = jnp.where(any_ok, pts[idx], x)
    ll_new = jnp.where(any_ok, ll[idx], cur_ll)
    return x_new, ll_new


def _gass_shrink(key, x, x0, v, mu, Af, c, loglik, h, cur_ll,
                 theta_lo, theta_hi, has_interval, dim_mask, max_shrink):
    """Neal-shrinkage slice step on the feasible arc.

    With interval constraints the bracket endpoints are ellipse-intrinsic
    (the constraint boundaries), widened to contain theta=0 (the current
    point, feasible up to the arc eps). Without any interval constraint the
    arc is the full circle, where a deterministic [-pi, pi] window is NOT
    reversible (it is parameterization-relative); use the standard ESS
    randomized wrap [phi - 2pi, phi], phi ~ U(0, 2pi)
    (elliptical_slice.py:95-98 semantics).
    """
    k_wrap, k_loop = jax.random.split(key)
    phi = jax.random.uniform(k_wrap) * (2.0 * jnp.pi)
    lo = jnp.where(has_interval, jnp.minimum(theta_lo, 0.0), phi - 2.0 * jnp.pi)
    hi = jnp.where(has_interval, jnp.maximum(theta_hi, 0.0), phi)

    def propose(th):
        xp = x0 * jnp.cos(th) + v * jnp.sin(th) + mu
        if dim_mask is not None:
            xp = xp * dim_mask
        return xp

    def cond(carry):
        _, _, _, _, done, it = carry
        return (~done) & (it < max_shrink)

    def body(carry):
        lo, hi, xc, llc, done, it = carry
        u = jax.random.uniform(jax.random.fold_in(k_loop, it))
        th = lo + u * (hi - lo)
        xp = propose(th)
        llp = loglik(xp[None])[0]
        # feasibility is part of the slice: infeasible == ll -inf
        feas = jnp.all(Af(xp) >= c)
        acc = feas & (llp >= h) & jnp.isfinite(llp)
        lo = jnp.where(~acc & (th < 0), th, lo)
        hi = jnp.where(~acc & (th >= 0), th, hi)
        xc = jnp.where(acc, xp, xc)
        llc = jnp.where(acc, llp, llc)
        return (lo, hi, xc, llc, acc, it + 1)

    init = (lo, hi, x, cur_ll, jnp.asarray(False), jnp.asarray(0))
    _, _, x_new, ll_new, _, _ = jax.lax.while_loop(cond, body, init)
    return x_new, ll_new
