"""Block-banded Cholesky factorization, solves, and MVN sampling.

JAX replacement for CHOLMOD's sparse Cholesky on the BTF V-update
precision (reference fast_mvn.py:36-47, factor.py:364-409): in time-major
ordering x[(t, a)] = V[t, a], the posterior precision

    Q = Q_lik + kron(I_k, Delta^T Lam Delta)

is *block-banded*: the diagonal blocks are G_t + DtLD[t, t] I_k (G_t the
k x k likelihood Gram at depth t, dense across embeddings) and the d-th
sub-diagonal blocks are DtLD[t, t-d] I_k, with half-bandwidth
p = tf_order + 1 (ops/penalty.py:penalty_half_bandwidth).

The factorization is a `lax.scan` over the T block rows with p unrolled
k x k block operations per step — O(T p^2 k^3) FLOPs instead of the dense
(kT)^3/3, and every op batches over columns/chains via leading dims. This
is the honest sequence-parallelism analog for the depth axis (SURVEY.md §5):
the Markov structure of the precision is what scales long curves.

Layout: bands[..., t, d, :, :] = block (t, t-d), d = 0..p; entries with
d > t must be zero. All functions broadcast over leading batch dims.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "build_v_bands",
    "block_banded_cholesky",
    "block_banded_solve_lower",
    "block_banded_solve_upper",
    "block_banded_solve",
    "sample_mvn_block_banded",
    "bands_to_dense",
]


CHAIN_AXIS = "chains"


def chain_reduced_pred(pred):
    """Reduce a scalar bool over the chain vmap axis so `lax.cond` keeps a
    real, lazily-executed branch under chain batching.

    The chain-level vmap (models/base.py:_batched_sweep) binds
    ``axis_name=CHAIN_AXIS``; a `pmin` over that axis yields an *unbatched*
    predicate, so the retry ladders below stay true conds (skipped when
    every chain's factor is finite) instead of lowering to
    execute-both-branches selects. When ANY chain needs a retry all chains
    re-factor, but the per-element `bad` masks still select the right
    factors — identical draws, only the (rare) retry cost is shared.
    Outside the chain vmap this is the identity. This was the single
    biggest multi-chain throughput leak: the vmapped sweep paid
    `attempts` extra Cholesky calls per call site per sweep (+60% at the
    GDELT shape) purely for dead retry branches.
    """
    try:
        return jax.lax.pmin(pred.astype(jnp.int32), CHAIN_AXIS).astype(bool)
    except NameError:  # not under the chain vmap
        return pred


def _mm_f32(fn):
    """Trace every matmul inside `fn` at full float32 precision.

    An accelerator's default f32 matmul may run in reduced precision: on
    an NVIDIA GPU, XLA may use TF32 tensor-core passes (10-bit mantissa,
    ~1e-3 relative error); other accelerators use bf16 passes. That is
    NOT acceptable inside a Cholesky at horseshoe dynamic range
    (1e-6..1e6 diagonal spread): a ~1e-3 relative error in a
    Schur-complement product routinely flips near-singular pivots
    indefinite, forcing the Gershgorin repair onto a *materially
    perturbed* conditional — observed end to end on the flu-trends
    benchmark at k=10 as retained draws with |Mu| excursions ~100x the
    posterior spread, absent from CPU f32 runs of the same chain. The
    reference factorizes in f64 CHOLMOD (fast_mvn.py:36-47). The sweep is
    already traced at float32 (models/base.py:_batched_sweep); this
    decorator keeps the same guarantee for callers outside the sweep.
    On the CPU backend it changes nothing."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)
    return wrapped


def _tsolve_right(Lcc, S):
    """X such that X Lcc^T = S (Lcc lower-triangular)."""
    return jax.lax.linalg.triangular_solve(
        Lcc, S, left_side=False, lower=True, transpose_a=True)


def build_v_bands(DtLD, G, p: int):
    """Assemble the V-update precision bands.

    Args:
      DtLD: (..., T, T) trend-filtering Gram (banded with half-bandwidth p).
      G:    (..., T, k, k) per-depth likelihood Gram (dense over embeds),
            or None for the prior-only precision.
    Returns bands (..., T, p+1, k, k).
    """
    T = DtLD.shape[-1]
    k = G.shape[-1] if G is not None else 1
    eye = np.eye(k, dtype=DtLD.dtype)
    cols = []
    for d in range(p + 1):
        diag = jnp.diagonal(DtLD, offset=-d, axis1=-2, axis2=-1)  # (..., T-d)
        pad = [(0, 0)] * (diag.ndim - 1) + [(d, 0)]
        diag = jnp.pad(diag, pad)  # align so entry t is block (t, t-d)
        cols.append(diag[..., :, None, None] * eye)
    bands = jnp.stack(cols, axis=-3)  # (..., T, p+1, k, k)
    if G is not None:
        bands = bands.at[..., :, 0, :, :].add(G)
    return bands


@_mm_f32
def block_banded_matvec(bands, x):
    """y = Q x for block-banded symmetric Q; x (..., T, k) -> y (..., T, k)."""
    *batch, T, p1, k, _ = bands.shape
    p = p1 - 1
    y = jnp.einsum("...tij,...tj->...ti", bands[..., :, 0, :, :], x)
    for d in range(1, min(p, T - 1) + 1):
        blk = bands[..., d:, d, :, :]          # blocks (t, t-d) for t >= d
        lo = jnp.einsum("...tij,...tj->...ti", blk, x[..., : T - d, :])
        hi = jnp.einsum("...tji,...tj->...ti", blk, x[..., d:, :])
        pad_lo = [(0, 0)] * (y.ndim - 2) + [(d, 0), (0, 0)]
        pad_hi = [(0, 0)] * (y.ndim - 2) + [(0, d), (0, 0)]
        y = y + jnp.pad(lo, pad_lo) + jnp.pad(hi, pad_hi)
    return y


def slice_bands(bands, start: int, size: int):
    """Extract the principal block-banded submatrix for time block
    [start, start+size): entries that reference rows before `start` are
    zeroed (they belong to the cross term, handled by the caller)."""
    p1 = bands.shape[-3]
    sub = bands[..., start:start + size, :, :, :]
    for d in range(1, p1):
        n_invalid = min(d, size)
        if n_invalid > 0:
            mask = (np.arange(size) >= d).astype(bands.dtype)
            sub = sub.at[..., :, d, :, :].multiply(
                mask[:, None, None])
    return sub


def block_to_dense(bands, start: int, size: int):
    """Dense (..., size*k, size*k) principal submatrix for time block
    [start, start+size). Small-block conditionals are cheaper as one
    batched dense Cholesky than as sequential banded scans (scan-step
    latency dominates at small T)."""
    *batch, T, p1, k, _ = bands.shape
    p = p1 - 1
    Q = jnp.zeros(tuple(batch) + (size, k, size, k), bands.dtype)
    for tl in range(size):
        t = start + tl
        Q = Q.at[..., tl, :, tl, :].set(bands[..., t, 0, :, :])
        for d in range(1, min(p, tl) + 1):
            blk = bands[..., t, d, :, :]
            Q = Q.at[..., tl, :, tl - d, :].set(blk)
            Q = Q.at[..., tl - d, :, tl, :].set(jnp.swapaxes(blk, -1, -2))
    return Q.reshape(tuple(batch) + (size * k, size * k))


def bands_to_dense(bands):
    """Dense (..., T*k, T*k) reconstruction (for tests)."""
    *batch, T, p1, k, _ = bands.shape
    p = p1 - 1
    Q = jnp.zeros(tuple(batch) + (T, k, T, k), bands.dtype)
    for t in range(T):
        for d in range(min(p, t) + 1):
            blk = bands[..., t, d, :, :]
            Q = Q.at[..., t, :, t - d, :].set(blk)
            if d > 0:
                Q = Q.at[..., t - d, :, t, :].set(jnp.swapaxes(blk, -1, -2))
    return Q.reshape(tuple(batch) + (T * k, T * k))


@_mm_f32
def block_banded_cholesky(bands, jitter: float = 0.0,
                          psd_attempts: int = 3, psd_eps: float = 1e-4,
                          return_repairs: bool = False):
    """Lower block-banded Cholesky: L with the same band layout.

    Sequential scan over block rows; the carry is the sliding window of the
    previous p factor rows. Batch dims broadcast.

    Every diagonal pivot goes through _chol_pivot_guarded, which repairs
    indefinite blocks locally (escalating relative jitter, then a
    guaranteed Gershgorin dominance shift) and ALWAYS yields a finite
    factor. Consequently the global psd_attempts retry ladder below is a
    backstop only for non-finite *inputs* (NaN/inf bands), not for
    indefiniteness — with finite inputs it never fires. Repair telemetry:
    pass return_repairs=True to get (L, repaired, gershgorin) counts per
    batch element so a materially perturbed conditional is never silent
    (ADVICE round 1, banded.py:175).

    The retry predicate is chain-reduced (chain_reduced_pred) so the skip
    survives the chain-level vmap in models/base.py: the cond stays a real
    branch and the backstop costs nothing unless some chain's inputs are
    non-finite.
    """
    L, repaired, gersh = _block_banded_cholesky_once(bands, jitter)
    if psd_attempts > 0:
        k = bands.shape[-1]
        eyek = np.eye(k, dtype=bands.dtype)
        # jitter is relative to the diagonal scale (callers equilibrate
        # first, so the diagonal is ~1); (*batch, 1, 1, 1) broadcasts
        # against the (*batch, T, k, k) diag slice
        dscale = jnp.mean(jnp.abs(jnp.diagonal(bands[..., :, 0, :, :],
                                               axis1=-2, axis2=-1)),
                          axis=(-2, -1), keepdims=True)[..., None]

        def retry(a, L):
            def redo(L):
                bad = ~jnp.all(jnp.isfinite(L), axis=(-4, -3, -2, -1),
                               keepdims=True)
                eps = psd_eps * (100.0 ** a) * dscale
                bands_j = bands.at[..., :, 0, :, :].add(eps * eyek)
                Lr, _, _ = _block_banded_cholesky_once(bands_j, jitter)
                return jnp.where(bad, Lr, L)
            return jax.lax.cond(chain_reduced_pred(jnp.all(jnp.isfinite(L))),
                                lambda L: L, redo, L)

        for a in range(psd_attempts):
            L = retry(a, L)
    if return_repairs:
        return L, repaired, gersh
    return L


def _chol_pivot_guarded(S, rungs=(1e-2,)):
    """Cholesky of a diagonal block with per-batch-element pivot repair.

    Where the plain factorization comes out non-finite, retry the SAME
    small block with escalating relative jitter, ending with a Gershgorin
    shift (diagonal dominance) that guarantees a finite factor. This keeps
    the repair local to the failing block — at horseshoe dynamic range the
    f32 Schur complements of a long trend-filter chain go indefinite
    routinely (observed on the flu-trends T=541 curves on EVERY sweep), and
    a stalled V update wrecks the chain, so finiteness must be
    unconditional. Cost: len(rungs)+1 extra small Cholesky calls per scan
    step, all on the (batch, Bk, Bk) diagonal block only.

    Returns (L, repaired, gershgorin): `repaired` flags batch elements that
    needed any jitter rung (idx > 0) and `gershgorin` those that fell
    through to the last-resort dominance shift — a *materially* perturbed
    conditional. Callers surface these counts (models/base.py run-health
    reporting) so repairs are never silent.
    """
    eye = np.eye(S.shape[-1], dtype=S.dtype)
    scale = jnp.mean(jnp.abs(jnp.diagonal(S, axis1=-2, axis2=-1)),
                     axis=-1)[..., None, None]
    scale = jnp.maximum(scale, 1e-30)
    # guaranteed rung: S + g I with g >= max row abs-sum is diagonally
    # dominant with nonnegative diagonal, hence PSD
    g = jnp.max(jnp.sum(jnp.abs(S), axis=-1), axis=-1)[..., None, None]
    shifts = [jnp.zeros_like(scale)]
    shifts += [r * scale for r in rungs]
    shifts += [1.001 * g + 1e-6 * scale]
    # ONE batched Cholesky over all rungs (an extra per-rung call inside the
    # factor scan costs ~an op launch per step; a 3x batch is nearly free)
    Ls = jnp.linalg.cholesky(jnp.stack([S + d * eye for d in shifts]))
    finite = jnp.all(jnp.isfinite(Ls), axis=(-2, -1))      # (R, *batch)
    idx = jnp.argmax(finite, axis=0)                       # first finite
    L = jnp.take_along_axis(Ls, idx[None, ..., None, None], axis=0)[0]
    repaired = (idx > 0).astype(S.dtype)
    gershgorin = (idx == len(shifts) - 1).astype(S.dtype)
    return L, repaired, gershgorin


def _block_banded_cholesky_once(bands, jitter=0.0):
    *batch, T, p1, k, _ = bands.shape
    p = p1 - 1
    eyek = np.eye(k, dtype=bands.dtype)
    # jitter may be a python float or a traced scalar (relative jitter)
    if not (isinstance(jitter, (int, float)) and jitter == 0):
        bands = bands.at[..., :, 0, :, :].add(jnp.asarray(jitter) * eyek)

    # window[r] = factor row (t-1-r), blocks d=0..p; virtual rows (t-1-r < 0)
    # hold identity diagonals so triangular solves are harmless no-ops.
    init_window = jnp.asarray(np.broadcast_to(
        eyek * (np.arange(p1) == 0)[:, None, None],
        tuple(batch) + (p, p1, k, k)).astype(bands.dtype))

    def step(window, B_t):
        # B_t: (..., p+1, k, k) = row t of the precision bands
        row = [None] * p1
        # off-diagonal blocks, leftmost column first (d = p..1)
        for d in range(p, 0, -1):
            S = B_t[..., d, :, :]
            # subtract L[t, kcol] L[c, kcol]^T for kcol < c = t-d
            for dd in range(p, d, -1):  # kcol = t - dd < c
                Lc_k = window[..., d - 1, dd - d, :, :]  # L[c, kcol], c-kcol = dd-d
                S = S - jnp.einsum("...ij,...kj->...ik", row[dd], Lc_k)
            Lcc = window[..., d - 1, 0, :, :]  # L[c, c]
            row[d] = _tsolve_right(Lcc, S)
        # diagonal block (pivot-guarded: see _chol_pivot_guarded)
        S = B_t[..., 0, :, :]
        for d in range(1, p1):
            S = S - jnp.einsum("...ij,...kj->...ik", row[d], row[d])
        row[0], repaired, gersh = _chol_pivot_guarded(S)
        row_stack = jnp.stack(row, axis=-3)  # (..., p+1, k, k)
        new_window = jnp.concatenate(
            [row_stack[..., None, :, :, :],
             window[..., : p - 1, :, :, :]], axis=-4) if p > 0 else window
        return new_window, (row_stack, repaired, gersh)

    # move T to the front for scan
    bands_t = jnp.moveaxis(bands, -4, 0)
    _, (rows, repaired, gersh) = jax.lax.scan(step, init_window, bands_t)
    # per-batch-element counts over the T scan steps
    return jnp.moveaxis(rows, 0, -4), repaired.sum(0), gersh.sum(0)


@_mm_f32
def block_banded_solve_lower(L, b):
    """Solve L z = b with L block-banded lower; b (..., T, k)."""
    *batch, T, p1, k, _ = L.shape
    p = p1 - 1
    init = jnp.zeros(tuple(batch) + (p, k), L.dtype)

    def step(zwin, inp):
        L_t, b_t = inp
        s = b_t
        for d in range(1, p1):
            s = s - jnp.einsum("...ij,...j->...i", L_t[..., d, :, :],
                               zwin[..., d - 1, :])
        z_t = jax.lax.linalg.triangular_solve(
            L_t[..., 0, :, :], s[..., None], left_side=True, lower=True)[..., 0]
        new_win = jnp.concatenate(
            [z_t[..., None, :], zwin[..., : p - 1, :]], axis=-2) if p > 0 else zwin
        return new_win, z_t

    L_t = jnp.moveaxis(L, -4, 0)
    b_t = jnp.moveaxis(b, -2, 0)
    _, z = jax.lax.scan(step, init, (L_t, b_t))
    return jnp.moveaxis(z, 0, -2)


@_mm_f32
def block_banded_solve_upper(L, b):
    """Solve L^T x = b; b (..., T, k). Reverse scan."""
    *batch, T, p1, k, _ = L.shape
    p = p1 - 1
    # x_t = L[t,t]^-T (b_t - sum_d L[t+d, d]^T x_{t+d})
    init_x = jnp.zeros(tuple(batch) + (p, k), L.dtype)
    init_rows = jnp.zeros(tuple(batch) + (p, p1, k, k), L.dtype)

    def step(carry, inp):
        xwin, rowwin = carry  # rows t+1..t+p (nearest first)
        L_t, b_t = inp
        s = b_t
        for d in range(1, p1):
            Ltpd = rowwin[..., d - 1, d, :, :]  # L[t+d, d]
            s = s - jnp.einsum("...ji,...j->...i", Ltpd, xwin[..., d - 1, :])
        x_t = jax.lax.linalg.triangular_solve(
            L_t[..., 0, :, :], s[..., None], left_side=True, lower=True,
            transpose_a=True)[..., 0]
        new_xwin = jnp.concatenate(
            [x_t[..., None, :], xwin[..., : p - 1, :]], axis=-2) if p > 0 else xwin
        new_rowwin = jnp.concatenate(
            [L_t[..., None, :, :, :], rowwin[..., : p - 1, :, :, :]],
            axis=-4) if p > 0 else rowwin
        return (new_xwin, new_rowwin), x_t

    L_rev = jnp.moveaxis(L, -4, 0)[::-1]
    b_rev = jnp.moveaxis(b, -2, 0)[::-1]
    _, x = jax.lax.scan(step, (init_x, init_rows), (L_rev, b_rev))
    return jnp.moveaxis(x[::-1], 0, -2)


def block_banded_solve(L, b):
    """Solve (L L^T) x = b."""
    return block_banded_solve_upper(L, block_banded_solve_lower(L, b))


def retile_bands(bands, B: int):
    """Re-tile a block-banded system into super-blocks of B time steps.

    Returns (bands2, T2): a block-TRIDIAGONAL system (half-bandwidth 1) with
    (B*k x B*k) dense blocks, zero-padded to T2 = ceil(T/B) super-rows
    (padding gets identity diagonals). The factor/solve scans are
    latency-bound in the number of sequential steps, so trading T tiny steps
    for T/B dense steps is a large win at equal FLOP order.
    Requires B >= bandwidth p.
    """
    *batch, T, p1, k, _ = bands.shape
    p = p1 - 1
    assert B >= p, (B, p)
    T2 = -(-T // B)
    Tp = T2 * B
    eye = np.eye(k, dtype=bands.dtype)
    pad_spec = [(0, 0)] * (bands.ndim - 4) + [(0, Tp - T), (0, 0), (0, 0), (0, 0)]
    bpad = jnp.pad(bands, pad_spec)
    if Tp > T:
        # identity diagonal blocks on the padded tail keep the factor finite
        tail_mask = (np.arange(Tp) >= T).astype(bands.dtype)
        bpad = bpad.at[..., :, 0, :, :].add(
            tail_mask[:, None, None] * eye)
    br = bpad.reshape(tuple(batch) + (T2, B, p1, k, k))

    D = jnp.zeros(tuple(batch) + (T2, B, k, B, k), bands.dtype)
    E = jnp.zeros(tuple(batch) + (T2, B, k, B, k), bands.dtype)
    for d in range(p + 1):
        for i in range(B):
            j = i - d
            if j >= 0:
                blk = br[..., :, i, d, :, :]
                D = D.at[..., :, i, :, j, :].set(blk)
                if d > 0:
                    D = D.at[..., :, j, :, i, :].set(jnp.swapaxes(blk, -1, -2))
            else:
                # couples into the previous super-block at local column B + j
                blk = br[..., :, i, d, :, :]
                E = E.at[..., 1:, i, :, B + j, :].set(blk[..., 1:, :, :])
    Bk = B * k
    D = D.reshape(tuple(batch) + (T2, Bk, Bk))
    E = E.reshape(tuple(batch) + (T2, Bk, Bk))
    return jnp.stack([D, E], axis=-3), T2


@_mm_f32
def sample_mvn_block_banded_retiled(key, bands, mu_part=None, B: int = 32,
                                    equilibrate: bool = True,
                                    base_jitter: float = 1e-4,
                                    return_repairs: bool = False):
    """theta ~ N((Q+eps I)^-1 mu_part, (Q+eps I)^-1) via super-block retiling.

    bands: (..., T, p+1, k, k); returns (..., T, k). The retiled system is
    the same matrix. With equilibrate=True a `base_jitter` * I is added to
    the equilibrated system (unit diagonal) up front: at horseshoe dynamic
    range the un-jittered f32 factorization fails routinely in realistic
    chain states, so most draws came from the retry ladder's first rung
    anyway — jittering up front makes the common case ONE factor scan
    instead of two-plus, with identical numerics. This draws from a
    slightly regularized conditional (eps relative to the unit-equilibrated
    diagonal), not the exact CHOLMOD/f64 conditional the reference draws —
    a small permanent bias documented at the model level
    (models/gaussian.py). With equilibrate=False the jitter is scaled by
    the mean diagonal magnitude so it cannot swamp small-scaled bands.

    No in-kernel retry ladder (a retry would cost a full extra factor scan
    per call whenever it fires): indefinite pivots are repaired locally inside the factor scan (_chol_pivot_guarded),
    which always yields a finite factor. Those repairs are counted —
    pass return_repairs=True for (x, repaired, gershgorin) per batch
    element; models fold the counts into run-health reporting.
    """
    *batch, T, p1, k, _ = bands.shape
    if equilibrate:
        bands, s = equilibrate_bands(bands)
        mp = None if mu_part is None else mu_part * s
        out = sample_mvn_block_banded_retiled(key, bands, mu_part=mp, B=B,
                                              equilibrate=False,
                                              base_jitter=base_jitter,
                                              return_repairs=return_repairs)
        if return_repairs:
            x, repaired, gersh = out
            return x * s, repaired, gersh
        return out * s
    # relative jitter: equilibrated systems have unit diagonal (scale ~1);
    # for direct equilibrate=False callers scale by the diagonal magnitude
    diag = jnp.abs(jnp.diagonal(bands[..., :, 0, :, :], axis1=-2, axis2=-1))
    dscale = jnp.maximum(jnp.mean(diag), 1e-30)
    B = min(max(B, p1 - 1), max(T, 1))
    bands2, T2 = retile_bands(bands, B)
    mp2 = None
    if mu_part is not None:
        pad = [(0, 0)] * (mu_part.ndim - 2) + [(0, T2 * B - T), (0, 0)]
        mp2 = jnp.pad(mu_part, pad).reshape(tuple(batch) + (T2, B * k))
    out = sample_mvn_block_banded(key, bands2, mu_part=mp2,
                                  jitter=base_jitter * dscale,
                                  psd_attempts=0,
                                  return_repairs=return_repairs)
    if return_repairs:
        x, repaired, gersh = out
        x = x.reshape(tuple(batch) + (T2 * B, k))[..., :T, :]
        return x, repaired, gersh
    return out.reshape(tuple(batch) + (T2 * B, k))[..., :T, :]


def equilibrate_bands(bands):
    """Block-Jacobi equilibration: Q' = D Q D, D = diag(Q)^(-1/2).

    Returns (bands', s) with s (..., T, k); undo a draw with x = s * x'.
    Keeps the horseshoe's 1e-6..1e6 diagonal range factorizable in f32
    (same trick as the dense path, ops/mvn.py).
    """
    p1 = bands.shape[-3]
    diag = jnp.diagonal(bands[..., :, 0, :, :], axis1=-2, axis2=-1)  # (..., T, k)
    s = jax.lax.rsqrt(jnp.where(diag > 0, diag, 1.0))
    scaled = []
    for d in range(p1):
        s_t = s[..., :, :, None]
        # s_{t-d}: shift forward by d along T
        s_shift = jnp.roll(s, d, axis=-2)
        if d > 0:
            mask = (np.arange(s.shape[-2]) >= d).astype(s.dtype)
            s_shift = s_shift * mask[..., :, None]
        scaled.append(bands[..., :, d, :, :] * s_t * s_shift[..., :, None, :])
    return jnp.stack(scaled, axis=-3), s


@_mm_f32
def sample_mvn_block_banded(key, bands=None, mu_part=None, L=None,
                            jitter=0.0, equilibrate: bool = False,
                            psd_attempts: int = 3,
                            return_repairs: bool = False):
    """theta ~ N(Q^-1 mu_part, Q^-1) for block-banded Q (or its factor L).

    Matches the dense sample_mvn_from_precision semantics
    (ops/mvn.py): x = L^-T z + Q^-1 mu_part. Returns (..., T, k), or
    (x, repaired, gershgorin) with return_repairs=True (pivot-repair
    telemetry; requires bands rather than a precomputed L).
    """
    if equilibrate and L is None:
        bands, s = equilibrate_bands(bands)
        mp = None if mu_part is None else mu_part * s
        out = sample_mvn_block_banded(key, bands, mu_part=mp, jitter=jitter,
                                      equilibrate=False,
                                      psd_attempts=psd_attempts,
                                      return_repairs=return_repairs)
        if return_repairs:
            x, repaired, gersh = out
            return x * s, repaired, gersh
        return out * s
    repaired = gersh = None
    if L is None:
        L, repaired, gersh = block_banded_cholesky(
            bands, jitter=jitter, psd_attempts=psd_attempts,
            return_repairs=True)
    *batch, T, p1, k, _ = L.shape
    z = jax.random.normal(key, tuple(batch) + (T, k), dtype=L.dtype)
    if mu_part is not None:
        # x = L^-T (L^-1 mu_part + z): one lower + one upper scan instead
        # of an upper for z plus a full solve for the mean
        z = z + block_banded_solve_lower(L, mu_part)
    x = block_banded_solve_upper(L, z)
    if return_repairs:
        assert repaired is not None, "return_repairs requires bands, not L"
        return x, repaired, gersh
    return x
