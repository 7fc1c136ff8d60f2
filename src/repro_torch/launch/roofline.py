"""Roofline terms on one NVIDIA H100.

Counterpart of ``repro.launch.roofline``'s ``RooflineTerms`` and
``extrapolate``, on the H100's datasheet figures in place of the TPU's:

    compute term    = flops      / (peak FLOP/s; bf16 tensor cores by default)
    memory term     = HBM bytes  / 3.35e12 B/s
    collective term = coll bytes / 450e9 B/s (NVLink, one direction)

The reference reads its flops and bytes from XLA's cost analysis of a
compiled executable and its collective bytes from the compiled HLO
(``cost_flops_bytes``, ``parse_collective_bytes``); the port compiles no
HLO, so it has no counterpart of either.  Its flops come from the plan
models (``apsp.plan``) and ``models.model.model_flops``, its collective
bytes from ``plan.dist_round_comm_bytes``.  These bounds are derived from
the datasheet, not measured.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM 80GB datasheet figures (dense, no sparsity; at the
# card's 700 W power limit).
PEAK_FLOPS_BF16 = 989.4e12  # bf16 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12      # fp32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12            # HBM3 B/s
HBM_BYTES = 80e9            # HBM3 capacity, bytes
NVLINK_BW = 450e9           # NVLink 4 B/s, one direction


@dataclasses.dataclass
class RooflineTerms:
    flops: float            # total per-device FLOPs (or semiring ops)
    bytes_hbm: float        # total per-device HBM bytes
    coll_bytes: float       # total per-device collective bytes
    chips: int
    model_flops: float      # useful work: 6·N·D (train) or 2·N·D (inference), global
    coll_detail: dict[str, float] = dataclasses.field(default_factory=dict)
    peak_flops: float = PEAK_FLOPS_BF16  # the compute term's rate (PEAK_FLOPS_F32 for min-plus)

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """model_flops / counted flops (global) — catches redundant work."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs rate achievable at the bound, as a fraction of peak:
        (model_flops/chips / max_term) / peak."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t == 0:
            return 0.0
        return (self.model_flops / self.chips / t) / self.peak_flops

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_hbm,
            "coll_bytes_per_chip": self.coll_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "peak_flops": self.peak_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_detail": self.coll_detail,
        }


def extrapolate(v1: float, v2: float, n_periods: int) -> float:
    """Linear trip-count extrapolation from L=1 and L=2 period counts."""
    return v1 + (v2 - v1) * (n_periods - 1)
