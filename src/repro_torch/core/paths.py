"""Shortest-path reconstruction (successor matrix) for APSP.

Torch counterparts of ``repro.core.paths``: a successor matrix rides beside
the distances, succ[i,j] = next vertex after i on the shortest i→j path,
updated wherever the distance *strictly* improves (``cand < w``).

  * ``fw_with_successors`` — one relaxation sweep per k.
  * ``fw_blocked_with_successors`` — the blocked 3-phase algorithm; the
    successor operand of each phase is its "A-side" block: the diagonal's
    successor tile (phases 1 / 2-row), the band's own successor columns
    (phase 2-col), or the successor column band (phase 3).

Both are batch-rank-agnostic.  The host-side walks (``extract_path``,
``extract_path_from_dist``, ``path_cost``) take numpy arrays or tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def _init_successors(w: torch.Tensor) -> torch.Tensor:
    """succ[...,i,j] = j where an edge exists, i on the diagonal, else -1."""
    n = w.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=w.device)
    idx = torch.arange(n, dtype=torch.int32, device=w.device)
    has_edge = torch.isfinite(w) & ~eye
    minus1 = torch.tensor(-1, dtype=torch.int32, device=w.device)
    succ = torch.where(has_edge, idx.expand(w.shape), minus1)
    return torch.where(eye, idx[:, None], succ)


def relax_succ(k: int, t, ts, a, asucc, b):
    """Strict-improvement step k: cand = a[:,k] + b[k,:]; where cand < t the
    distance and the next hop asucc[:,k] are taken."""
    cand = a[..., :, k, None] + b[..., k, None, :]
    better = cand < t
    return (
        torch.where(better, cand, t),
        torch.where(better, asucc[..., :, k, None], ts),
    )


def fw_with_successors(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """FW returning (dist, succ); succ = -1 where no path exists."""
    succ = _init_successors(w)
    for k in range(w.shape[-1]):
        w, succ = relax_succ(k, w, succ, w, succ, w)
    return w, succ


def fw_blocked_with_successors(
    w: torch.Tensor, *, block_size: int = 128
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked 3-phase FW carrying a successor matrix (min-plus only)."""
    n = w.shape[-1]
    s = block_size
    if n % s:
        raise ValueError(f"n={n} not a multiple of block_size={s}")
    succ = _init_successors(w)
    w = w.clone()  # the rounds splice bands into w and succ in place
    for b in range(n // s):
        o = slice(b * s, (b + 1) * s)
        diag, dsucc = w[..., o, o], succ[..., o, o]
        for k in range(s):
            diag, dsucc = relax_succ(k, diag, dsucc, diag, dsucc, diag)
        w[..., o, o] = diag
        succ[..., o, o] = dsucc

        row, rsucc = w[..., o, :], succ[..., o, :]
        for k in range(s):
            row, rsucc = relax_succ(k, row, rsucc, diag, dsucc, row)
        row[..., :, o] = diag
        rsucc[..., :, o] = dsucc

        col, csucc = w[..., :, o], succ[..., :, o]
        for k in range(s):
            col, csucc = relax_succ(k, col, csucc, col, csucc, diag)
        col[..., o, :] = diag
        csucc[..., o, :] = dsucc

        w[..., o, :] = row
        succ[..., o, :] = rsucc
        w[..., :, o] = col
        succ[..., :, o] = csucc
        for k in range(s):
            w, succ = relax_succ(k, w, succ, col, csucc, row)
    return w, succ


def _as_numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def extract_path(succ, src: int, dst: int, max_len: int | None = None) -> list[int]:
    """Walk the successor matrix from src to dst (host-side)."""
    succ = _as_numpy(succ)
    if succ[src, dst] < 0:
        return []
    path = [src]
    cur = src
    limit = max_len or succ.shape[0] + 1
    while cur != dst and len(path) <= limit:
        cur = int(succ[cur, dst])
        if cur < 0:
            return []
        path.append(cur)
    return path


def _lift_distances(a) -> np.ndarray:
    """Tables in any storage → host arrays with IEEE semantics for the walks:
    int16 saturating tables to float64 with their sentinels as ±inf, bf16 /
    f16 to float64, f32 / f64 as they are."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        a = (a.double() if a.dtype in (torch.bfloat16, torch.float16) else a).numpy()
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        from repro_torch.core.semiring import I16_INF, I16_NINF

        out = a.astype(np.float64)
        out[a == I16_INF] = np.inf
        out[a == I16_NINF] = -np.inf
        return out
    if a.dtype.kind == "f" and a.dtype.itemsize >= 4:
        return a
    return a.astype(np.float64)  # bf16 / f16


def extract_path_from_dist(
    w, dist, src: int, dst: int, *, max_len: int | None = None,
) -> list[int]:
    """Reconstruct a shortest path from the distance matrix alone (host).

    From u the next hop is the unvisited neighbour v minimising
    w[u, v] + dist[v, dst].  Returns [] when dst is unreachable or no path
    materialises within ``max_len`` hops.
    """
    w = _lift_distances(w)
    dist = _lift_distances(dist)
    if not np.isfinite(dist[src, dst]):
        return []
    path = [src]
    cur = src
    visited = np.zeros(dist.shape[0], dtype=bool)
    visited[src] = True
    limit = max_len or dist.shape[0] + 1
    while cur != dst and len(path) <= limit:
        cand = w[cur, :] + dist[:, dst]
        # Masking visited vertices keeps zero-weight cycles from trapping
        # the greedy walk.
        cand[visited] = np.inf
        nxt = int(np.argmin(cand))
        if not np.isfinite(cand[nxt]):
            return []
        path.append(nxt)
        visited[nxt] = True
        cur = nxt
    return path if cur == dst else []


def path_cost(w, path: list[int]) -> float:
    """Sum of edge weights along ``path`` in the original adjacency matrix."""
    w = _lift_distances(w)
    if not path:
        return float("inf")
    return float(sum(w[a, b] for a, b in zip(path, path[1:])))
