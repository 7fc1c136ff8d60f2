"""Reference Floyd-Warshall implementations (the paper's baselines).

Torch counterparts of ``repro.core.floyd_warshall``:

  * ``fw_numpy``   — the textbook host loop (numpy, min-plus).
  * ``fw_naive``   — one relaxation sweep over the whole matrix per k.
  * ``fw_blocked`` — the blocked 3-phase algorithm in plain torch ops.

``fw_naive`` and ``fw_blocked`` are batch-rank-agnostic: a (B, n, n) input
runs every graph through the same loop with a leading batch dim.  Each
per-element ⊕/⊗ chain is the reference's, step for step, so results are
bitwise equal to it, in every storage a lowering takes (the steps are the
lowering's own ``Semiring`` ops: bf16 / f16, int16, packed words).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.semiring import MIN_PLUS, Semiring


def fw_numpy(w: np.ndarray) -> np.ndarray:
    """Textbook triple-loop FW on the host (the paper's CPU baseline)."""
    w = np.array(w, copy=True)
    n = w.shape[0]
    for k in range(n):
        w = np.minimum(w, w[:, k : k + 1] + w[k : k + 1, :])
    return w


def fw_naive(w: torch.Tensor, *, semiring: Semiring = MIN_PLUS) -> torch.Tensor:
    """One relaxation pass per k over the whole matrix; (n,n) or (B,n,n)."""
    n = w.shape[-1]
    for k in range(n):
        w = semiring.relax(w, w[..., :, k, None], w[..., k, None, :])
    return w


def _close_diag(t: torch.Tensor, semiring: Semiring) -> torch.Tensor:
    """Phase 1: s sequential FW steps inside one (…, s, s) tile."""
    for k in range(t.shape[-1]):
        t = semiring.relax(t, t[..., :, k, None], t[..., k, None, :])
    return t


def _close_row_panel(d: torch.Tensor, p: torch.Tensor, semiring: Semiring) -> torch.Tensor:
    """Phase 2, row band (…, s, t): p ⊕= d[:,k] ⊗ p[k,:], k sequential."""
    for k in range(d.shape[-1]):
        p = semiring.relax(p, d[..., :, k, None], p[..., k, None, :])
    return p


def _close_col_panel(d: torch.Tensor, p: torch.Tensor, semiring: Semiring) -> torch.Tensor:
    """Phase 2, col band (…, t, s): p ⊕= p[:,k] ⊗ d[k,:], k sequential."""
    for k in range(d.shape[-1]):
        p = semiring.relax(p, p[..., :, k, None], d[..., k, None, :])
    return p


def _phase3(w, col, row, semiring: Semiring) -> torch.Tensor:
    """Phase 3: W ⊕= col ⊗ row as s rank-1 updates, k ascending."""
    for k in range(col.shape[-1]):
        w = semiring.relax(w, col[..., :, k, None], row[..., k, None, :])
    return w


def fw_blocked(
    w: torch.Tensor, *, block_size: int = 128, semiring: Semiring = MIN_PLUS
) -> torch.Tensor:
    """Blocked 3-phase FW in plain torch; n must be a multiple of block_size."""
    n = w.shape[-1]
    s = block_size
    if n % s:
        raise ValueError(f"n={n} not a multiple of block_size={s}")
    w = w.clone()  # the rounds below splice bands into it in place
    for b in range(n // s):
        o = slice(b * s, (b + 1) * s)
        diag = _close_diag(w[..., o, o], semiring)
        w[..., o, o] = diag
        row = _close_row_panel(diag, w[..., o, :], semiring)
        row[..., :, o] = diag
        col = _close_col_panel(diag, w[..., :, o], semiring)
        col[..., o, :] = diag
        w[..., o, :] = row
        w[..., :, o] = col
        w = _phase3(w, col, row, semiring)
    return w


def check_no_negative_cycles(w: torch.Tensor) -> torch.Tensor:
    """True iff the FW result certifies no negative cycle (diag ≥ 0)."""
    return torch.all(torch.diagonal(w, dim1=-2, dim2=-1) >= 0)
