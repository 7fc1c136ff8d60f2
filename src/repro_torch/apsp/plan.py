"""Planning arithmetic for APSP solves — the port's own copy.

Host-side integer arithmetic from ``repro.apsp.plan`` (lines 24-68 and
310-414): word sizes, padding, round counts, the block-size pick, the
fused round's device-memory traffic model, the rank-1 repair's and the
decremental repair's with its policy (``should_repair_del``).  The
rest of the reference's planner (autotuning, mesh and recursive plans) is
ROADMAP A.5 / A.10 / A.11.
"""
from __future__ import annotations

from repro_torch.core.semiring import dtype_name

# Shared memory one thread block may use on an H100 (227 KB of the SM's
# 256 KB, above 48 KB only as opt-in dynamic shared memory).
H100_SMEM_PER_BLOCK = 232_448

_WORD_BYTES = {
    "float64": 8, "int64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2, "uint16": 2,
}


def word_for(dtype=None) -> int:
    """Bytes per stored element of a dtype (name, numpy or torch dtype);
    4 when none is named."""
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


def round_smem_bytes(s: int, bk: int, *, successors: bool = False) -> int:
    """Largest shared-memory footprint of one block among the three launches
    of a round (``kernels/csrc/fw_round.cu``): the bands launch stages the
    closed (s, s+1) diagonal, the relax launch an (s, bk+1) col slice and a
    (bk, s) row slice; successors add an int32 copy of the diag / col
    slice.  Must stay within ``H100_SMEM_PER_BLOCK``."""
    copies = 2 if successors else 1
    bands = copies * s * (s + 1)
    relax = copies * s * (bk + 1) + bk * s
    return 4 * max(bands, relax)


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
