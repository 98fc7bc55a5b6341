"""Exact Polya-Gamma PG(1, c) sampler (test-only, pure numpy).

Devroye's alternating-series rejection sampler as described by Polson,
Scott & Windle (2013, JASA, "Bayesian inference for logistic models using
Polya-Gamma latent variables", Algorithm 1) — the same construction the
reference's native pypolyagamma dependency implements in C++
(reference functionalmf/factor.py:458-460). Used as the distributional
ground truth for KS tests of the framework's device sampler
(functionalmf_tpu/ops/polyagamma.py); never imported by library code.

PG(1, c) = J*(1, c/2) / 4 where J* is the Jacobi variable sampled below.
All rejection loops are vectorized over lanes with masks.
"""
from __future__ import annotations

import numpy as np
from scipy.stats import norm as _norm

_T = 0.64  # Devroye's series crossover point


def _a_n(n, x):
    """Piecewise coefficients of the alternating series (PSW eq. 16)."""
    np_half = n + 0.5
    left = np.pi * np_half * (2.0 / (np.pi * x)) ** 1.5 \
        * np.exp(-2.0 * np_half ** 2 / x)
    right = np.pi * np_half * np.exp(-np_half ** 2 * np.pi ** 2 * x / 2.0)
    return np.where(x <= _T, left, right)


def _invgauss_cdf(t, mu):
    """CDF of IG(mu, lambda=1) at t."""
    s = 1.0 / np.sqrt(t)
    return _norm.cdf(s * (t / mu - 1.0)) \
        + np.exp(2.0 / mu) * _norm.cdf(-s * (t / mu + 1.0))


def _sample_trunc_invgauss(rng, z, size):
    """IG(mu=1/z, lambda=1) truncated to (0, _T), vectorized (PSW alg. 2-3)."""
    out = np.empty(size)
    todo = np.ones(size, bool)
    big_mu = z < 1.0 / _T  # mu = 1/z > t
    while todo.any():
        idx = np.nonzero(todo)[0]
        m = len(idx)
        zi = np.broadcast_to(z, size)[idx] if np.ndim(z) else np.full(m, z)
        X = np.empty(m)
        bm = np.broadcast_to(big_mu, size)[idx] if np.ndim(big_mu) else \
            np.full(m, big_mu)
        # branch 1: mu > t — sample 1/X from a truncated Levy via the
        # double-exponential squeeze, accept w.p. exp(-z^2 X / 2)
        if bm.any():
            k = int(bm.sum())
            E = rng.exponential(size=k)
            E2 = rng.exponential(size=k)
            ok = E * E <= 2.0 * E2 / _T
            Xb = _T / (1.0 + _T * E) ** 2
            alpha = np.exp(-0.5 * zi[bm] ** 2 * Xb)
            acc = ok & (rng.random(k) <= alpha)
            Xb = np.where(acc, Xb, np.nan)
            X[bm] = Xb
        # branch 2: mu <= t — standard IG transform + reject X > t
        if (~bm).any():
            k = int((~bm).sum())
            mu = 1.0 / zi[~bm]
            Yc = rng.normal(size=k) ** 2
            Xs = mu + 0.5 * mu ** 2 * Yc \
                - 0.5 * mu * np.sqrt(4.0 * mu * Yc + (mu * Yc) ** 2)
            flip = rng.random(k) > mu / (mu + Xs)
            Xs = np.where(flip, mu ** 2 / Xs, Xs)
            Xs = np.where(Xs <= _T, Xs, np.nan)
            X[~bm] = Xs
        good = np.isfinite(X)
        out[idx[good]] = X[good]
        todo[idx[good]] = False
    return out


def exact_pg1(rng, c, size):
    """Draw `size` iid exact PG(1, c) variables (scalar c)."""
    z = abs(float(c)) / 2.0
    K = np.pi ** 2 / 8.0 + z ** 2 / 2.0
    p = np.pi / (2.0 * K) * np.exp(-K * _T)
    if z > 0:
        q = 2.0 * np.exp(-z) * _invgauss_cdf(_T, 1.0 / z)
    else:
        # z -> 0: IG(1/z, 1) -> Levy(0, 1), whose CDF at t is
        # erfc(1/sqrt(2t)) = 2 Phi(-1/sqrt(t))
        q = 4.0 * _norm.cdf(-1.0 / np.sqrt(_T))
    ratio = p / (p + q)

    out = np.empty(size)
    todo = np.ones(size, bool)
    while todo.any():
        m = int(todo.sum())
        idx = np.nonzero(todo)[0]
        # mixture proposal
        use_exp = rng.random(m) < ratio
        X = np.empty(m)
        ne = int(use_exp.sum())
        if ne:
            X[use_exp] = _T + rng.exponential(size=ne) / K
        if ne < m:
            X[~use_exp] = _sample_trunc_invgauss(rng, z, m - ne)
        # alternating-series accept/reject
        S = _a_n(0, X)
        Y = rng.random(m) * S
        decided = np.zeros(m, bool)
        accept = np.zeros(m, bool)
        n = 0
        while not decided.all():
            n += 1
            a = _a_n(n, X)
            if n % 2 == 1:
                S = np.where(decided, S, S - a)
                newly = (~decided) & (Y <= S)
                accept |= newly
                decided |= newly
            else:
                S = np.where(decided, S, S + a)
                newly = (~decided) & (Y > S)
                decided |= newly
        ok = accept
        out[idx[ok]] = X[ok] / 4.0
        todo[idx[ok]] = False
    return out


def exact_pg(rng, b, c, size):
    """Exact PG(b, c) for integer b as a sum of b exact PG(1, c) draws."""
    b = int(b)
    total = np.zeros(size)
    for _ in range(b):
        total += exact_pg1(rng, c, size)
    return total
