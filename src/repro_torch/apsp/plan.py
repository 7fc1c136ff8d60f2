"""Planning arithmetic for APSP solves — the port's own copy.

Host-side integer arithmetic from ``repro.apsp.plan`` (lines 24-223,
310-414 and 745-928): word sizes, padding, round counts, the block-size
pick, the fused round's device-memory traffic model, the rank-1 repair's
and the decremental repair's with its policy (``should_repair_del``), the
mesh plan of the distributed solve (``distributed_plan`` with its grid
factorization and communication models), and the recursive (R-Kleene)
plan with its leaf ranges, transfer and residency models
(``recursive_plan``).  The autotuner (``fw_candidates`` / ``autotune_fw``)
is ROADMAP A.5.
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


def staged_hbm_bytes_per_round(
    n_r: int, n_c: int, s: int, *, bm: int = 256, bn: int = 256, word: int = 4
) -> float:
    """HBM traffic model of one round of the multi-kernel (staged) round on
    one rank's (n_r, n_c) block: phase 3 reads + writes W once (the C tile
    resident across k) and streams (bm × bk) / (bk × bn) panel slices;
    phase 2 reads + writes the two panels with the diag broadcast; phase 1
    round-trips the diag tile.  The reference's model (bm = bn = 256, its
    Pallas tiles); the card's relax tiles are 128 × 128."""
    return (
        2 * n_r * n_c                         # C in/out, resident over k
        + s * n_r * n_c * (1 / bm + 1 / bn)   # streamed panel slices
        + 4 * s * (n_r + n_c)                 # phase-2 panel r/w
        + 2 * s * s * 3                       # diag r/w + phase-2 reads
    ) * word


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


# --------------------------------------------------------------- recursive
# Planning arithmetic for the recursive (R-Kleene) out-of-core schedule
# (apsp/kleene.py), copied from the reference (``repro/apsp/plan.py:745-928``)
# so that both packages plan the same schedule: host-side integer math that
# the executor, the byte models and fw_oocore's measured-vs-model check all
# walk in ONE traversal order.


def kleene_ranges(
    rounds: int, leaf_rounds: int
) -> tuple[list[tuple[int, int]], int]:
    """Binary R-Kleene recursion over pivot-round ranges → in-order leaves.

    Splits [0, rounds) recursively at a leaf-aligned midpoint until every
    range holds at most ``leaf_rounds`` rounds.  Returns the leaf ranges in
    round order (executing them left to right IS the depth-first traversal
    of the 2×2 Kleene recursion — A11 before the off-diagonal products
    before A22) plus the recursion depth.  The executor (KleeneExecutor),
    ``recursive_plan``'s byte models, and the tests all consume this one
    decomposition, so schedule and model cannot drift.
    """
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    if leaf_rounds < 1:
        raise ValueError(f"leaf_rounds must be >= 1, got {leaf_rounds}")
    out: list[tuple[int, int]] = []

    def split(lo: int, hi: int, depth: int) -> int:
        if hi - lo <= leaf_rounds:
            out.append((lo, hi))
            return depth
        # Leaf-aligned ceil-half split keeps every interior leaf full-width
        # (only the last panel may be ragged).
        half = -(-(hi - lo) // (2 * leaf_rounds)) * leaf_rounds
        mid = lo + half
        return max(split(lo, mid, depth + 1), split(mid, hi, depth + 1))

    depth = split(0, rounds, 1)
    return out, depth


def recursive_transfer_bytes(
    n_padded: int, s: int, leaf_rounds: int, *, word: int = 4, batch: int = 1
) -> tuple[int, int]:
    """(h2d, d2h) bytes of one out-of-core recursive solve — the model side
    of the 15%-of-measured acceptance check.

    Mirrors the executor's store traffic exactly: per leaf panel of width
    P, the resident pivot cross (the (m, P) column band + (P, m) row band,
    the (P, P) diagonal overlap fetched in both) streams in and back out
    (2·P·m each way), and every outside tile — the (m−P)² area excluding
    the cross — streams in for ONE deferred factor matmul and back out.
    Total ≈ 2·m³/P + O(m²) per direction: the leaf size is the streaming
    amortization knob, exactly the paper's staging-depth trade one memory
    level up.
    """
    m = n_padded
    ranges, _ = kleene_ranges(m // s, leaf_rounds)
    per_dir = 0
    for lo, hi in ranges:
        P = (hi - lo) * s
        per_dir += 2 * P * m + (m - P) * (m - P)
    per_dir *= word * batch
    return per_dir, per_dir


def recursive_hbm_resident_bytes(
    n_padded: int, s: int, leaf_rounds: int, *, word: int = 4,
    batch: int = 1, out_of_core: bool = True,
) -> int:
    """Peak device residency of the recursive schedule.

    Out of core, only the pivot cross plus its factor snapshots (4·P·m
    words: two resident bands + the two concatenated phase-2 factors) and
    up to three streamed sweep tiles (current + prefetched + retiring
    write-back, ≤ P² each) live on device — the matrix itself stays in the
    host store.  In core the full matrix is resident too.
    """
    m = n_padded
    P = min(leaf_rounds * s, m)
    panels = 4 * P * m + 3 * P * P
    if not out_of_core:
        panels += m * m
    return batch * panels * word


def recursive_plan(
    n: int,
    *,
    leaf: int | None = None,
    hbm_budget: int | None = None,
    block_size: int | None = None,
    batch: int = 1,
    word: int | None = None,
    dtype=None,
    bk: int = 32,
    variant: str = "fori",
) -> dict:
    """THE plan for a recursive (R-Kleene) solve — leaf size + streaming.

    Pads n exactly like the fused path (``auto_block_size`` +
    ``padded_size``; the recursive schedule replays the fused rounds at the
    same pivot width, which is what makes it bitwise-comparable), then
    resolves the leaf:

      * ``leaf=None`` with an ``hbm_budget``: the fattest power-of-two
        multiple of the block size whose out-of-core residency model fits
        the budget (bigger leaves amortize streaming — transfer ≈ 2·m³/leaf
        — so the fattest fitting leaf minimizes PCIe bytes).
      * ``leaf=None`` without a budget: min(m, 4·s) — a compute-granularity
        default for the in-core path.
      * explicit ``leaf``: validated (multiple of the block size), clamped
        to the padded size.

    ``out_of_core`` is True when the full matrix does not fit the budget;
    the returned byte models then mirror ``apsp.kleene``'s host-store
    traffic exactly (``recursive_transfer_bytes``).  Returns block_size /
    n_padded / rounds / leaf / leaf_rounds / ranges / panels / depth /
    out_of_core / matrix_bytes / hbm_resident_bytes / h2d_bytes /
    d2h_bytes / transfer_bytes / hbm_bytes_total / leaf_calls /
    sweep_calls.
    """
    if word is None:
        word = word_for(dtype)
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    s = block_size or auto_block_size(n)
    m = padded_size(n, s)
    T = m // s
    matrix_bytes = batch * m * m * word
    out_of_core = hbm_budget is not None and matrix_bytes > hbm_budget
    if leaf is None:
        if out_of_core:
            # Fattest power-of-two leaf whose streaming residency fits.
            lr = 1
            while (
                2 * lr * s <= m
                and recursive_hbm_resident_bytes(
                    m, s, 2 * lr, word=word, batch=batch
                ) <= hbm_budget
            ):
                lr *= 2
            leaf = lr * s
        else:
            leaf = min(m, 4 * s)
    else:
        if leaf % s:
            raise ValueError(
                f"leaf ({leaf}) must be a multiple of block_size ({s}) — "
                f"leaves replay whole fused pivot rounds"
            )
        leaf = min(leaf, m)
    lr = leaf // s
    ranges, depth = kleene_ranges(T, lr)
    h2d, d2h = (
        recursive_transfer_bytes(m, s, lr, word=word, batch=batch)
        if out_of_core else (0, 0)
    )
    # Device-side traffic model: every leaf round reads+writes the resident
    # cross (2·P·m each way), the sweep reads+writes each outside tile once
    # and streams the (m−P)·P factor operands past it.
    hbm_total = 0
    sweep_calls = 0
    npanels = len(ranges)
    for lo, hi in ranges:
        P = (hi - lo) * s
        hbm_total += (hi - lo) * 2 * (2 * P * m)
        hbm_total += 2 * (m - P) * (m - P) + 2 * (m - P) * P
        sweep_calls += (npanels - 1) ** 2
    hbm_total *= word * batch
    return dict(
        impl="recursive", block_size=s, n=n, n_padded=m, rounds=T,
        leaf=leaf, leaf_rounds=lr, ranges=ranges, panels=npanels,
        depth=depth, out_of_core=out_of_core, batch=batch, word=word,
        bk=min(bk, s), variant=variant,
        matrix_bytes=matrix_bytes,
        hbm_resident_bytes=recursive_hbm_resident_bytes(
            m, s, lr, word=word, batch=batch, out_of_core=out_of_core
        ),
        h2d_bytes=h2d, d2h_bytes=d2h, transfer_bytes=h2d + d2h,
        hbm_bytes_total=hbm_total,
        leaf_calls=npanels, sweep_calls=sweep_calls,
    )
