"""Public wrappers over the kernels: counterpart of ``repro.kernels.ops``.

``minplus_matmul``, ``fw_phase3`` and ``transitive_closure`` as in the
reference, and the same re-exports.  Every kernel takes f32 or a storage
lowering and keeps it: ``fw_phase3(semiring=<lowering>)`` on int16 or
packed words, any float semiring on bf16 / f16 tensors, the int32 carrier
of an integer or_and / plus_mul storage (``minplus_matmul`` stays
min-plus, as in the reference; ``fw_round_with_successors`` takes f32,
bf16 and f16 distances).  Each runs where its tensors lie: the CUDA
kernels for tensors on the card, the plain versions for tensors on the
CPU.  The reference's ``default_interpret`` / ``default_gpu_interpret``
choose Pallas's interpret mode on a machine without a TPU or GPU; the
port's kernels have no interpret mode, so they have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import MIN_PLUS, OR_AND, Semiring
from repro_torch.core.staged import fw_staged
from repro_torch.kernels import ref
from repro_torch.kernels.fw_phase1 import fw_phase1
from repro_torch.kernels.fw_phase2 import fw_phase2_col, fw_phase2_row
from repro_torch.kernels.fw_round import fw_round, fw_round_with_successors
from repro_torch.kernels.minplus_matmul import semiring_matmul


def minplus_matmul(
    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None, *,
    bm: int = 256, bn: int = 256, bk: int = 32, variant: str = "fori",
) -> torch.Tensor:
    """(min,+) matmul, optionally fused with a ⊕= accumulator C."""
    return semiring_matmul(a, b, c, semiring=MIN_PLUS, bm=bm, bn=bn, bk=bk,
                           variant=variant)


def fw_phase3(
    w: torch.Tensor, col_band: torch.Tensor, row_band: torch.Tensor, *,
    bm: int = 256, bn: int = 256, bk: int = 32, variant: str = "fori",
    semiring: Semiring = MIN_PLUS,
) -> torch.Tensor:
    """Doubly-dependent update: W ⊕= col_band ⊗ row_band (staged kernel);
    returns a new tensor."""
    return semiring_matmul(col_band, row_band, w, semiring=semiring, bm=bm, bn=bn,
                           bk=bk, variant=variant)


def transitive_closure(adj: torch.Tensor) -> torch.Tensor:
    """Boolean transitive closure via the OR-AND semiring (Warshall 1962).

    adj: (n,n) {0,1} f32 matrix with 1s on the diagonal, n % 128 == 0.
    """
    return fw_staged(adj, semiring=OR_AND)


__all__ = [
    "minplus_matmul",
    "fw_phase1",
    "fw_phase2_row",
    "fw_phase2_col",
    "fw_phase3",
    "fw_round",
    "fw_round_with_successors",
    "semiring_matmul",
    "transitive_closure",
    "ref",
]
