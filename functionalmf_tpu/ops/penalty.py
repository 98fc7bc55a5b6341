"""Trend-filtering penalty matrix builders.

JAX reimplementation of the penalty-construction utilities in the
reference library (functionalmf/utils.py:5-98). Penalty matrices are built
once at model-construction time on the host (numpy) and then used as dense
jnp constants inside jitted sweeps: ``ndepth`` is small relative to device
memory and a dense (nD x T) matrix lets XLA fuse the quadratic-form products
``Delta^T diag(w) Delta`` into a single batched matmul, instead of
the reference's scipy.sparse CSC products.

The *banded structure* of Delta (row support <= tf_order + 2) is still
exploited: :func:`penalty_half_bandwidth` reports the half-bandwidth of
``Delta^T diag(w) Delta``, which the block-banded Cholesky kernel in
``functionalmf_tpu.ops.banded`` uses.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "first_difference_matrix",
    "get_delta",
    "bayes_delta",
    "bayes_grid_penalty",
    "hypercube_edges",
    "matrix_from_edges",
    "grid_penalty_matrix",
    "penalty_half_bandwidth",
    "num_penalty_rows",
]


def first_difference_matrix(n: int) -> np.ndarray:
    """Dense 1-D first-difference (oriented edge incidence) matrix.

    Mirrors get_1d_penalty_matrix (reference utils.py:93-98): D is
    (n-1, n) with rows [-1, 1] on adjacent entries.
    """
    if n < 2:
        raise ValueError("need at least 2 grid points")
    D = np.zeros((n - 1, n))
    idx = np.arange(n - 1)
    D[idx, idx] = -1.0
    D[idx, idx + 1] = 1.0
    return D


def get_delta(D: np.ndarray, k: int) -> np.ndarray:
    """k-th order trend filtering matrix from the edge-incidence matrix D.

    Mirrors get_delta (reference utils.py:56-64): alternating D^T / D
    composition, so get_delta(D, 0) = D, get_delta(D, 1) = D^T D,
    get_delta(D, 2) = D D^T D, ...
    """
    if k < 0:
        raise ValueError("k must be at least 0th order.")
    result = D
    for i in range(k):
        result = D.T @ result if i % 2 == 0 else D @ result
    return result


def bayes_delta(D: np.ndarray, K: int, anchor: int = 0) -> np.ndarray:
    """Anchored Bayesian trend-filtering penalty.

    Mirrors bayes_delta (reference utils.py:66-81): stacks an anchor row
    ``e_anchor`` (pinning mu[anchor] ~ N(0, .)) with the 0..K order
    difference operators. The result is (nD, n) with
    nD = 1 + sum_k rows(get_delta(D, k)).
    """
    rows = [np.zeros((1, D.shape[1]))]
    rows[0][0, anchor] = 1.0
    for k in range(K + 1):
        rows.append(get_delta(D, k))
    return np.concatenate(rows, axis=0)


def hypercube_edges(dims) -> list:
    """Edge list of an arbitrary hypercube grid (reference utils.py:5-15)."""
    edges = []
    nodes = np.arange(int(np.prod(dims))).reshape(dims)
    for i, d in enumerate(dims):
        for j in range(d - 1):
            a = np.take(nodes, [j], axis=i).flatten()
            b = np.take(nodes, [j + 1], axis=i).flatten()
            edges.extend(zip(a.tolist(), b.tolist()))
    return edges


def matrix_from_edges(edges) -> np.ndarray:
    """Dense oriented incidence matrix from an edge list (utils.py:24-49).

    Each edge may carry an optional weight as a third element.
    """
    nedges = len(edges)
    max_col = max(max(e[0], e[1]) for e in edges)
    D = np.zeros((nedges, max_col + 1))
    for i, edge in enumerate(edges):
        s, t = edge[0], edge[1]
        w = 1.0 if len(edge) == 2 else edge[2]
        D[i, min(s, t)] = w
        D[i, max(s, t)] = -w
    return D


def grid_penalty_matrix(dims, k: int) -> np.ndarray:
    """Graph trend-filtering penalty over a hypercube grid (utils.py:51-54)."""
    return get_delta(matrix_from_edges(hypercube_edges(dims)), k)


def bayes_grid_penalty(dims, k: int, anchor: int = 0) -> np.ndarray:
    """Anchored penalty over a 1-D chain or hypercube grid (utils.py:83-90)."""
    if not hasattr(dims, "__len__"):
        dims = [dims]
    if len(dims) == 1:
        D = first_difference_matrix(dims[0])
    else:
        D = matrix_from_edges(hypercube_edges(dims))
    return bayes_delta(D, k, anchor=anchor)


def penalty_half_bandwidth(tf_order: int) -> int:
    """Half-bandwidth of Delta^T diag(w) Delta for a 1-D chain penalty.

    The widest row of bayes_grid_penalty(T, k) has support tf_order + 2,
    so the Gram matrix has half-bandwidth tf_order + 1.
    """
    return tf_order + 1


def num_penalty_rows(ndepth: int, tf_order: int) -> int:
    """Number of rows (nD) of bayes_grid_penalty(ndepth, tf_order)."""
    # anchor row + rows of get_delta(D, k) for k = 0..tf_order.
    # get_delta alternates between (T-1, T) and (T, T) shapes.
    n = 1
    for k in range(tf_order + 1):
        n += ndepth if k % 2 == 1 else ndepth - 1
    return n
