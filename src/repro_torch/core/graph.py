"""Graph generation and adjacency-matrix utilities for APSP workloads.

The port's own copy of ``repro.core.graph`` (numpy only), so that the same
seed gives the same matrix in both packages.

The paper benchmarks on random dense weighted digraphs with single-precision
edge weights.  We reproduce that plus a few structured generators used by the
examples (ring/grid topologies for the routing demo).

``inf`` handling: missing edges are +inf.  IEEE semantics make min-plus with
+inf exact (inf + x = inf, min(inf, x) = x); no sentinel values needed.
"""
from __future__ import annotations

import numpy as np


def random_digraph(
    n: int,
    *,
    density: float = 1.0,
    w_lo: float = 1.0,
    w_hi: float = 10.0,
    seed: int = 0,
    dtype=np.float32,
    allow_negative: bool = False,
) -> np.ndarray:
    """Random dense/sparse weighted digraph as an n×n adjacency matrix.

    Mirrors the paper's setup: uniform single-precision positive weights on a
    dense graph.  ``density < 1`` drops edges to +inf.  ``allow_negative``
    produces negative edges with no negative cycles via potential
    reweighting (inverse of Johnson's trick): w'_ij = w_ij + h_i - h_j for
    random potentials h.  Every cycle's total weight is unchanged (>= 0),
    but individual edges go negative wherever h_j - h_i exceeds w_ij.
    """
    rng = np.random.default_rng(seed)
    w = rng.uniform(w_lo, w_hi, size=(n, n)).astype(dtype)
    if allow_negative:
        h = rng.uniform(0.0, w_hi, size=n).astype(dtype)
        w = (w + h[:, None] - h[None, :]).astype(dtype)
    if density < 1.0:
        mask = rng.uniform(size=(n, n)) < density
        w = np.where(mask, w, np.asarray(np.inf, dtype=dtype))
    np.fill_diagonal(w, 0.0)
    return w


def ring_graph(n: int, *, dtype=np.float32) -> np.ndarray:
    """Directed ring 0→1→…→n-1→0 with unit weights (known shortest paths)."""
    w = np.full((n, n), np.inf, dtype=dtype)
    np.fill_diagonal(w, 0.0)
    for i in range(n):
        w[i, (i + 1) % n] = 1.0
    return w


def grid_graph(side: int, *, dtype=np.float32) -> np.ndarray:
    """4-neighbour grid with unit weights; n = side²."""
    n = side * side
    w = np.full((n, n), np.inf, dtype=dtype)
    np.fill_diagonal(w, 0.0)
    for r in range(side):
        for c in range(side):
            u = r * side + c
            for dr, dc in ((0, 1), (1, 0), (0, -1), (-1, 0)):
                rr, cc = r + dr, c + dc
                if 0 <= rr < side and 0 <= cc < side:
                    w[u, rr * side + cc] = 1.0
    return w


def pad_to_multiple(w: np.ndarray, block: int) -> tuple[np.ndarray, int]:
    """Pad an n×n matrix with +inf rows/cols to a multiple of ``block``.

    Padding vertices are unreachable (all-inf rows/cols, inf diagonal), so
    they never participate in any finite shortest path; the top-left n×n
    sub-matrix of the padded result equals FW on the original matrix.
    Returns (padded, original_n).
    """
    n = w.shape[0]
    m = ((n + block - 1) // block) * block
    if m == n:
        return w, n
    out = np.full((m, m), np.inf, dtype=w.dtype)
    out[:n, :n] = w
    return out, n
