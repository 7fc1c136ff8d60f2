"""Planning arithmetic for APSP solves — the port's own copy.

Host-side integer arithmetic from ``repro.apsp.plan`` (lines 24-223 and
310-414): word sizes, padding, round counts, the block-size pick, the
fused round's device-memory traffic model, the rank-1 repair's and the
decremental repair's with its policy (``should_repair_del``), and the mesh
plan of the distributed solve (``distributed_plan`` with its grid
factorization and communication models).  The rest of the reference's
planner (autotuning, recursive plans) is ROADMAP A.5 / A.10.
"""
from __future__ import annotations

import math

from repro_torch.core.semiring import dtype_name

# Shared memory one thread block may use on an H100 (227 KB of the SM's
# 256 KB, above 48 KB only as opt-in dynamic shared memory).
H100_SMEM_PER_BLOCK = 232_448

_WORD_BYTES = {
    "float64": 8, "int64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1,
}


def word_for(dtype=None, *, semiring=None) -> int:
    """Bytes per stored element of a dtype (name, numpy or torch dtype), or
    of the dtype a lowering pins (``semiring.dtype`` wins over ``dtype``);
    4 when none is named."""
    if semiring is not None and semiring.dtype is not None:
        dtype = semiring.dtype
    if dtype is None:
        return 4
    try:
        return _WORD_BYTES[dtype_name(dtype)]
    except KeyError:
        raise ValueError(
            f"no byte-model word size for dtype {dtype!r}; "
            f"known: {sorted(_WORD_BYTES)}"
        ) from None


def padded_size(n: int, block: int) -> int:
    """Smallest multiple of ``block`` that is >= n."""
    return ((n + block - 1) // block) * block


def round_count(n: int, block_size: int) -> int:
    """Pivot rounds of blocked FW at a given tile size (padded n)."""
    return padded_size(n, block_size) // block_size


def auto_block_size(n: int, *, max_block: int = 128) -> int:
    """Pivot-tile size for an n-vertex graph: 128 once n >= 256, below that
    the largest power of two <= ~n/4 (floor 16)."""
    if n >= max_block * 2:
        return max_block
    s = 1 << max(4, (max(n, 2) - 1).bit_length() - 2)
    return min(s, max_block)


def mesh_factorization(devices: int, pods: int = 1) -> tuple[int, int]:
    """(R, C) process-grid factorization: R = pods × rows, C the rest."""
    if pods > 1:
        rows = max(1, devices // pods // 2)
        return pods * rows, devices // pods // rows
    rows = max(1, devices // 2)
    return rows, devices // rows


def distributed_multiple(block_size: int, R: int, C: int) -> int:
    """n must be a multiple of this for ``fw_distributed`` on an R×C grid
    (every rank's (n/R, n/C) block a whole number of (s, s) tiles)."""
    return block_size * math.lcm(R, C)


def summa_comm_bound_bytes(n: int, R: int, C: int, word: int = 4) -> float:
    """SUMMA comm lower bound per rank over a whole solve: n²(1/R + 1/C)
    words."""
    return n * n * (1.0 / R + 1.0 / C) * word


def dist_round_comm_bytes(
    n: int, R: int, C: int, s: int, *, word: int = 4, batch: int = 1
) -> float:
    """Bytes each rank hands to collectives in ONE distributed round: the
    raw (s, s) pivot tile across the grid, the raw (s, n/C) row-panel slice
    along its grid column and the (n/R, s) column-panel slice along its
    grid row.  Over n/s rounds this exceeds ``summa_comm_bound_bytes`` by
    the diagonal term alone."""
    return batch * (s * s + s * (n // C) + (n // R) * s) * word


def bordered_band_bytes(rows: int, cols: int, s: int, *, word: int = 4,
                        batch: int = 1) -> int:
    """Device memory of the bordered round's two closed-band buffers,
    rowband (B, s, cols) and colband (B, rows, s)
    (``kernels.fw_round.bordered_round_buffers``)."""
    return batch * (s * cols + rows * s) * word


def distributed_plan(
    n: int,
    devices: int,
    *,
    grid: tuple[int, int] | None = None,
    batch: int = 1,
    block_size: int | None = None,
    pods: int = 1,
    word: int = 4,
) -> dict:
    """The mesh plan of a distributed solve: (R, C, s) and the padding.

    Picks the (R, C) grid through ``mesh_factorization`` (``grid=(R, C)``
    pins an existing grid), the pivot width through ``auto_block_size``
    walked down while the mesh padding wastes more than a third of n (the
    least-padding candidate when no tile fits), and pads n to the
    ``distributed_multiple``.  ``solve(method="distributed")``,
    ``ApspEngine`` and ``launch.fw_dist_check`` all plan through here.

    Returns the reference's fields (``R``, ``C``, ``block_size``, ``n``,
    ``n_padded``, ``rounds``, ``tile`` (n_r, n_c), ``bordered`` (the
    per-rank bordered matrix), ``batch``, ``comm_bytes_per_round``,
    ``summa_bound_bytes``, ``comm_model_efficiency``) except its VMEM
    model (``batch_block``, ``vmem_bytes``), which has no meaning on the
    card: there the closed bands live in device buffers, whose size is
    ``band_bytes`` instead.
    """
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if grid is not None:
        R, C = grid
        if R * C != devices:
            raise ValueError(f"grid {grid} does not cover {devices} devices")
    else:
        R, C = mesh_factorization(devices, pods)
    if block_size is None:
        cands = []
        s = auto_block_size(n)
        while s >= 16:
            cands.append((s, padded_size(n, distributed_multiple(s, R, C))))
            s //= 2
        fitting = [(sc, mc) for sc, mc in cands if 3 * (mc - n) <= n]
        s, m = fitting[0] if fitting else min(cands, key=lambda t: (t[1], -t[0]))
    else:
        s = block_size
        m = padded_size(n, distributed_multiple(s, R, C))
    n_r, n_c = m // R, m // C
    rounds = m // s
    rows, cols = n_r + s, n_c + s
    per_round = dist_round_comm_bytes(m, R, C, s, word=word, batch=batch)
    bound = batch * summa_comm_bound_bytes(m, R, C, word)
    return dict(
        R=R, C=C, block_size=s, n=n, n_padded=m, rounds=rounds,
        tile=(n_r, n_c), bordered=(rows, cols), batch=batch,
        band_bytes=bordered_band_bytes(rows, cols, s, word=word, batch=batch),
        comm_bytes_per_round=per_round,
        summa_bound_bytes=bound,
        comm_model_efficiency=bound / (rounds * per_round),
    )


def round_smem_bytes(s: int, bk: int, *, successors: bool = False, word: int = 4) -> int:
    """Largest shared-memory footprint of one block among the three launches
    of a round (``kernels/csrc/fw_round.cuh``): the bands launch stages the
    closed (s, s+1) diagonal, the relax launch an (s, bk+1) col slice and a
    (bk, s) row slice, in the storage ``word``; successors add an int32
    copy of the diag / col slice.  Must stay within
    ``H100_SMEM_PER_BLOCK``."""
    succ = 4 if successors else 0
    bands = (word + succ) * s * (s + 1)
    relax = (word + succ) * s * (bk + 1) + word * bk * s
    return max(bands, relax)


def fused_round_hbm_bytes(n: int, s: int, *, word: int = 4, batch: int = 1) -> float:
    """Traffic of ONE fused round if every tile is read and written once:
    T² + 2T - 1 tile visits of (s,s) each, ×batch graphs."""
    T = padded_size(n, s) // s
    return 2.0 * batch * (T * T + 2 * T - 1) * s * s * word


def fused_solve_hbm_bytes(n: int, s: int, *, word: int = 4, batch: int = 1) -> float:
    """n/s rounds × ``fused_round_hbm_bytes``."""
    return round_count(n, s) * fused_round_hbm_bytes(n, s, word=word, batch=batch)


def repair_hbm_bytes(
    n: int, s: int, *, word: int = 4, edges: int = 1,
    successors: bool = False,
) -> float:
    """HBM traffic of ONE fused rank-1 repair dispatch
    (``kernels.fw_repair``): E stage steps each read+write one (s, n) row
    band (byte-identical copy-out — the write is the price of the
    prefetch-safety rule), then T apply steps read+write every band once.
    Successor tracking doubles it (distance + next-hop tables).

    The repair-vs-resolve crossover the serving policy uses
    (``ApspEngine.should_repair``): this is ~2·(E+T)·s·n words against
    ``fused_solve_hbm_bytes``'s ~2·(n/s)·(T²+2T-1)·s² — repair wins by
    roughly a factor of n/s per small edge batch.

    This is the reference's model of the TPU kernel, kept verbatim so that
    ``should_repair`` decides as the reference does.  The CUDA kernel
    (``kernels/csrc/fw_repair.cu``) moves less: E pivot rows in, E staged
    rows out, then every row read and written once (~2·n²·word).
    """
    m = padded_size(n, s)
    bands = edges + m // s
    return 2.0 * bands * s * m * word * (2 if successors else 1)


def repair_del_hbm_bytes(
    n: int, s: int, *, affected_rows: int, word: int = 4, edges: int = 1,
    successors: bool = False,
) -> float:
    """HBM traffic of ONE decremental repair (``kernels.fw_repair_del``).

    Stage 1 (marking) streams the closure once per deleted edge plus the
    updated weights and the reset write — (2 + E)·n² words.  Stage 2 (the
    restricted row sweep) runs T rounds, each reading one (s, n) pivot band
    and reading+writing the (a, n) affected-row strip — T·(s + 2a)·n words.
    Successor tracking doubles it (distance + next-hop).

    The reference's model of the TPU kernels, kept verbatim so that
    ``should_repair_del`` decides as the reference does.  The CUDA sweep
    (``kernels/csrc/fw_repair_del.cu``) is bound by operations, n²·(s + a)
    relaxations, not by these bytes.
    """
    m = padded_size(n, s)
    T = m // s
    mark = (2.0 + edges) * m * m * word
    sweep = T * (s + 2.0 * affected_rows) * m * word
    return (mark + sweep) * (2 if successors else 1)


def should_repair_del(
    n: int, affected_rows: int, *, block_size: int | None = None,
    word: int = 4, edges: int = 1, successors: bool = False,
    threshold: float = 0.5,
) -> bool:
    """The affected-fraction policy: is the restricted sweep still cheaper
    than a full fused re-solve once marking has counted the damage?

    Runs between the two ``repair_del`` stages (the affected row count only
    exists after marking).  Compares ``repair_del_hbm_bytes`` against
    ``threshold ×`` the full solve's modelled traffic.
    """
    if affected_rows < 1:
        return False
    s = block_size or auto_block_size(n)
    cost = repair_del_hbm_bytes(
        n, s, affected_rows=affected_rows, word=word, edges=edges,
        successors=successors,
    )
    full = fused_solve_hbm_bytes(n, s, word=word) * (2 if successors else 1)
    return cost <= threshold * full
