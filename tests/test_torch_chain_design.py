"""The fused round's diag and bands kernels, emulated in plain torch, vs the
JAX reference.

The diag kernel (``csrc/fw_round.cuh:diag_kernel`` on
``fw_phases.cuh:close_tile_blocks``) closes the pivot tile on T x T
threads of M x M register blocks: thread (ty, tx) holds rows 4ty + 4T·h + e
and columns 4tx + 4T·h + e (h < H, e < 4; ``DiagShape<S>``).  Step k =
4T·h + 4·tk + e is published by its owners, register row / column 4h + e
of the threads ty == tk / tx == tk, into shared vectors of parity e & 1,
and every thread relaxes its block against them.

The bands kernel (``bands_kernel`` on ``close_band_lanes``) gives each
warp 16 whole columns of a row panel (rows of a col panel, which it holds
transposed): lane (rg, cg) holds rows rg·S/8 .. and columns 16v + 4cg ..,
takes the owner's p[k][c] (q[r][k]) by shuffle from lane (k / (S/8), cg),
register k % (S/8), before any lane updates it, and its operands from the
closed diagonal staged in shared memory (transposed for the row panel).
A tile's S/16 warps are cut into ``split`` CTAs, each staging its own copy
of the diagonal; owner-echo tiles are left to the diag launch.

Both keep their values as ``semiring.cuh:Lifted`` says: each operand
lifted once where it is published, staged or shuffled (int16 min-plus /
max-plus map their sentinels past the int16 range, so a relaxation is an
add, a min / max and one clamp; bf16 / f16 min-plus / max-plus keep their
accumulators unrounded in f32 and round each operand and each stored
value), the other steps as they are.

The emulations follow those loops, index maps and arithmetic, then the relax phase
runs as the port's plain version, and the whole round is held by bits to
the reference's ``repro.kernels.ref.fw_round_ref`` /
``fw_round_bordered_ref`` on numpy inputs from a seed: every s, the five
semirings in f32 and every storage lowering, square, batched and bordered
blocks, and planted diagonals that are not the ⊗-identity (negative
cycles, a plus_mul diagonal of 0.5), where reading the shuffled value
after its owner's update would show.  The kernels themselves are held to
the plain phases on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.core import semiring as jsr
from repro.kernels import ref as jref
from repro_torch.core import semiring as tsr
from repro_torch.kernels import ref as tref
from test_torch_semiring import (
    NAMES,
    assert_same,
    from_port,
    semiring_graph,
    storage_data,
    storage_semiring,
    to_port,
)

SMS = 132  # the H100's SMs, which the band split is sized to


@pytest.fixture(autouse=True)
def one_thread():
    """The emulations are many small torch ops: run them on one thread, as
    a pool of threads each would only wait on them beside other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ----------------------------------------------------- the chains' values
class Arith:
    """``Lifted<Op>`` of a storage's step: acc (storage → accumulator),
    lift (accumulator → operand), relax, out (accumulator → storage)."""

    def __init__(self, semiring, dtype: torch.dtype):
        self.acc = self.lift = self.out = lambda v: v
        self.relax = semiring.relax
        name = semiring.name
        if name in ("min_plus_i16", "max_plus_i16"):
            self.acc = lambda v: v.to(torch.int64)
            self.lift, self.relax = lifted(name)
            self.out = lambda v: v.to(torch.int16)
        elif name in ("min_plus", "max_plus") and dtype in (torch.bfloat16, torch.float16):
            pick = tsr.minimum if name == "min_plus" else tsr.maximum
            self.acc = lambda v: v.float()
            self.lift = lambda v: v.to(dtype).float()
            self.relax = lambda acc, a, b: pick(acc, a + b)
            self.out = lambda v: v.to(dtype)


# ------------------------------------------------------------------ diag
def diag_shape(s: int) -> tuple[int, int, int]:
    """(H, T, M) of ``DiagShape<S>``."""
    H = 2 if s == 128 else 1
    return H, s // (4 * H), 4 * H


def block_index(s: int) -> torch.Tensor:
    """(T, M): the tile row (column) of register row (column) i of thread
    row ty (column tx): 4ty + 4T·(i // 4) + i % 4."""
    H, T, M = diag_shape(s)
    t, i = torch.arange(T)[:, None], torch.arange(M)[None, :]
    return 4 * t + 4 * T * (i // 4) + i % 4


def diag_blocks(tile: torch.Tensor, semiring) -> torch.Tensor:
    """``close_tile_blocks`` on a (..., s, s) tile: the closed tile."""
    s = tile.shape[-1]
    H, T, M = diag_shape(s)
    at = block_index(s)
    assert sorted(at.flatten().tolist()) == list(range(s))  # every row once
    ar = Arith(semiring, tile.dtype)
    # regs[..., ty, tx, i, j] = tile[at[ty, i], at[tx, j]]
    regs = ar.acc(tile[..., at[:, None, :, None], at[None, :, None, :]])
    lead = tile.shape[:-2]
    rowbuf = [torch.zeros((*lead, s), dtype=regs.dtype) for _ in range(2)]
    colbuf = [torch.zeros((*lead, s), dtype=regs.dtype) for _ in range(2)]
    steps = []
    for h in range(H):
        for tk in range(T):
            for e in range(4):
                k, m, p = 4 * T * h + 4 * tk + e, 4 * h + e, e & 1
                assert at[tk, m] == k  # the owner's register row / column m is k
                steps.append(k)
                rowbuf[p][..., at] = ar.lift(regs[..., tk, :, m, :])  # row owners: ty == tk
                colbuf[p][..., at] = ar.lift(regs[..., :, tk, :, m])  # col owners: tx == tk
                rv, cv = rowbuf[p][..., at], colbuf[p][..., at]  # (..., tx, j), (..., ty, i)
                regs = ar.relax(regs, cv[..., :, None, :, None], rv[..., None, :, None, :])
    assert steps == list(range(s))  # k ascending
    out = torch.empty_like(tile)
    out[..., at[:, None, :, None], at[None, :, None, :]] = ar.out(regs)
    return out


# ----------------------------------------------------------------- bands
def band_split(s: int, tiles: int, batch: int, sms: int = SMS) -> int:
    """``band_split<S>``: the most of 1, 2, 4 (at most S/16) CTAs a tile
    that keeps the launch within one CTA an SM."""
    split = 1
    while 2 * split <= min(4, s // 16) and tiles * batch * 2 * split <= sms:
        split *= 2
    return split


def band_lanes(panel: torch.Tensor, diag: torch.Tensor, semiring, *, col: bool,
               split: int, late: bool = False) -> torch.Tensor:
    """``close_band_lanes`` of one (..., s, s) band tile, its warps cut into
    ``split`` CTAs: the closed row panel (col False) or col panel (col
    True).  late: read the shuffled value after its owner's update (the
    hazard the kernel avoids)."""
    s = panel.shape[-1]
    RL, W = s // 8, s // 16
    assert W % split == 0
    ar = Arith(semiring, panel.dtype)
    x = ar.acc(panel.transpose(-1, -2) if col else panel)
    out = torch.empty_like(x)
    for piece in range(split):
        # each CTA stages its own diagonal, lifted: dS[k][r] = d[r][k] (row
        # panel), d[k][c] (col panel)
        dS = ar.lift(ar.acc(diag if col else diag.transpose(-1, -2)))
        for v in range(piece * (W // split), (piece + 1) * (W // split)):
            # regs[..., rg, i, cg, j] = x[rg·RL + i, 16v + 4cg + j]
            regs = x[..., :, 16 * v:16 * v + 16].reshape(*x.shape[:-2], 8, RL, 4, 4)
            for kb in range(8):
                for kk in range(RL):
                    k = kb * RL + kk
                    sh = ar.lift(regs[..., kb, kk, :, :])  # lane (kb, cg), register [kk][j]
                    dv = dS[..., k, :].reshape(*dS.shape[:-2], 8, RL)  # (rg, i)
                    a, b = dv[..., :, :, None, None], sh[..., None, None, :, :]
                    new = ar.relax(regs, b, a) if col else ar.relax(regs, a, b)
                    if late:  # the owner's updated value instead
                        sh = ar.lift(new[..., kb, kk, :, :])
                        b = sh[..., None, None, :, :]
                        new = ar.relax(regs, b, a) if col else ar.relax(regs, a, b)
                    regs = new
            out[..., :, 16 * v:16 * v + 16] = regs.reshape(*x.shape[:-2], s, 16)
    out = ar.out(out)
    return out.transpose(-1, -2) if col else out


def chains(w: torch.Tensor, s: int, b: int, pr: int, pc: int, semiring, *,
           split: int | None = None, late: bool = False):
    """The diag and bands launches of a round on (..., rows, cols) w: the
    (rowband (..., s, cols), colband (..., rows, s)) buffers they leave."""
    rows, cols = w.shape[-2:]
    TR, TC = rows // s, cols // s
    o = slice(b * s, (b + 1) * s)
    diag = diag_blocks(w[..., o, o], semiring)
    rowband = torch.zeros((*w.shape[:-2], s, cols), dtype=w.dtype)
    colband = torch.zeros((*w.shape[:-2], rows, s), dtype=w.dtype)
    rowband[..., :, o] = diag
    colband[..., o, :] = diag
    if pc >= 0:
        rowband[..., :, pc * s:(pc + 1) * s] = diag
    if pr >= 0:
        colband[..., pr * s:(pr + 1) * s, :] = diag
    tiles = (TC - 1) + (TR - 1)
    batch = int(np.prod(w.shape[:-2], dtype=np.int64))
    split = band_split(s, tiles, batch) if split is None else split
    for u in range(tiles):
        is_row = u < TC - 1
        x = u if is_row else u - (TC - 1)
        x = x if x < b else x + 1
        if x == (pc if is_row else pr):
            continue  # the owner echo: the diag launch wrote it
        t = slice(x * s, (x + 1) * s)
        if is_row:
            rowband[..., :, t] = band_lanes(w[..., o, t], diag, semiring, col=False,
                                            split=split, late=late)
        else:
            colband[..., t, :] = band_lanes(w[..., t, o], diag, semiring, col=True,
                                            split=split, late=late)
    return rowband, colband


def emulated_round(w, s: int, b: int, semiring, **kw):
    rowband, colband = chains(w, s, b, -1, -1, semiring, **kw)
    return tref.relax(w, rowband, colband, b, semiring=semiring)


def emulated_bordered(w, s: int, pr: int, pc: int, semiring, **kw):
    rowband, colband = chains(w, s, 0, pr, pc, semiring, **kw)
    return tref.relax_bordered(w, rowband, colband, pr, pc, semiring=semiring)


def splits(s: int) -> list[int]:
    return [p for p in (1, 2, 4) if p <= s // 16]


def test_band_split_fills_the_card():
    """n = 8192 (126 tiles) stays whole; n = 4096 (62) and the 2×2 rank
    block (4224, 4224) (64) cut each tile in two; s <= 32 has too few
    warps to cut further."""
    assert band_split(128, 126, 1) == 1
    assert band_split(128, 62, 1) == 2
    assert band_split(128, 64, 1) == 2
    assert band_split(128, 30, 1) == 4
    assert band_split(128, 14, 4) == 2
    assert band_split(32, 6, 1) == 2 and band_split(16, 4, 1) == 1
    for s in (16, 32, 64, 128):
        H, T, M = diag_shape(s)
        assert T * M == s and T * T in (16, 64, 256)


# ------------------------------------------------------ lifted operands
def lifted(name: str):
    """(lift, relax) of ``semiring.cuh:Lifted`` for an int16 lowering, in
    int64 arithmetic as the kernel's int32 registers compute it."""
    inf, ninf = tsr.I16_INF, tsr.I16_NINF
    if name == "min_plus_i16":
        def lift(v):
            return torch.where(v == inf, 1 << 20, torch.where(v == ninf, -(1 << 17), v))

        def relax(acc, a, b):
            return torch.clamp(torch.minimum(acc, a + b), min=ninf)
    else:
        def lift(v):
            return torch.where(v == ninf, -(1 << 20), torch.where(v == inf, 1 << 17, v))

        def relax(acc, a, b):
            return torch.clamp(torch.maximum(acc, a + b), max=inf)
    return lift, relax


@pytest.mark.parametrize("name", ["min_plus_i16", "max_plus_i16"])
def test_lifted_int16_steps_equal_the_saturating_step(name):
    """The chains' lifted int16 step == the saturating step (widen, add,
    clamp, the other sentinel, then the dominant one) on every pair of
    operands among the sentinels, their neighbours, values whose sums
    saturate and random ones, against accumulators of the same kinds."""
    rng = np.random.default_rng(0)
    edge = [-32768, -32767, -32766, -16385, -16384, -1, 0, 1, 16383, 16384, 32765, 32766,
            32767]
    vals = torch.tensor(edge + rng.integers(-32768, 32768, 243).tolist(), dtype=torch.int64)
    accs = torch.tensor(edge + rng.integers(-32768, 32768, 19).tolist(), dtype=torch.int64)
    a, b, acc = vals[:, None, None], vals[None, :, None], accs[None, None, :]
    sr = tsr.LOWERED_SEMIRINGS[name]
    want = sr.relax(*(t.to(torch.int16) for t in torch.broadcast_tensors(acc, a, b)))
    lift, relax = lifted(name)
    got = relax(acc, lift(a), lift(b))
    assert got.min() >= tsr.I16_NINF and got.max() <= tsr.I16_INF
    assert torch.equal(got.to(torch.int16), want)


# ------------------------------------------------------------- the cases
ROUND_CASES = [  # (shape, s, b)
    ((96, 96), 16, 2), ((3, 160, 160), 32, 4), ((192, 192), 64, 1), ((384, 384), 128, 1),
]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,s,b", ROUND_CASES)
def test_chain_emulation_matches_reference_round(name, shape, s, b):
    """f32, every s: the diag blocks and the band lanes at every split
    agree, and the round they start == the reference's, by bits."""
    sr = tsr.SEMIRINGS[name]
    w = semiring_graph(name, shape, seed=s + b)
    want = jref.fw_round_ref(jnp.asarray(w), b, block_size=s, semiring=jsr.SEMIRINGS[name])
    t = torch.from_numpy(w)
    got = [emulated_round(t, s, b, sr, split=p) for p in splits(s)]
    for g in got:
        assert_same(g, want)


LOWERED = ([("int16", n) for n in ("max_min", "max_plus", "min_plus", "or_and")]
           + [(dt, n) for dt in ("bfloat16", "float16") for n in NAMES]
           + [("packed", "or_and"), ("uint32", "or_and"), ("int8", "plus_mul")])


@pytest.mark.parametrize("i,case", list(enumerate(LOWERED)), ids=lambda c: "-".join(c)
                         if isinstance(c, tuple) else str(c))
def test_chain_emulation_matches_reference_round_lowered(i, case):
    """Every storage lowering (an integer storage on its int32 carrier),
    batched, s cycling through 16 .. 128."""
    storage, name = case
    s = (16, 32, 64, 128)[i % 4]
    shape, b = (2, 3 * s, 3 * s), i % 3
    x = storage_data(storage, name, shape, seed=40 + i)
    want = jref.fw_round_ref(jnp.asarray(x), b, block_size=s,
                             semiring=storage_semiring(storage, name, jsr))
    t, sr, dt = to_port(x, storage_semiring(storage, name))
    got = emulated_round(t, s, b, sr)
    assert_same(from_port(got, dt, storage_semiring(storage, name)), np.asarray(want))


BORDERED = [  # (shape, s, owner echo)
    ((80, 48), 16, (1, 1)), ((3, 96, 160), 32, (2, -1)), ((192, 128), 64, (-1, 1)),
    ((384, 256), 128, (2, 1)),
]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,s,echo", BORDERED)
def test_chain_emulation_matches_reference_bordered(name, shape, s, echo):
    """Tall, wide and batched bordered blocks with the owner echo: the
    echo tiles hold the closed corner and are not closed again."""
    m = max(shape[-2:])
    w = semiring_graph(name, (*shape[:-2], m, m), seed=s)[..., :shape[-2], :shape[-1]].copy()
    want = jref.fw_round_bordered_ref(jnp.asarray(w), *echo, block_size=s,
                                      semiring=jsr.SEMIRINGS[name])
    t = torch.from_numpy(w)
    for p in splits(s):
        assert_same(emulated_bordered(t, s, *echo, tsr.SEMIRINGS[name], split=p), want)


@pytest.mark.parametrize("case", [("int16", "min_plus"), ("bfloat16", "plus_mul"),
                                  ("float16", "plus_mul"), ("packed", "or_and")],
                         ids="-".join)
def test_chain_emulation_matches_reference_bordered_lowered(case):
    storage, name = case
    s, shape, echo = 32, (2, 96, 128), (1, 2)
    x = storage_data(storage, name, shape, seed=7)
    want = jref.fw_round_bordered_ref(jnp.asarray(x), *echo, block_size=s,
                                      semiring=storage_semiring(storage, name, jsr))
    t, sr, dt = to_port(x, storage_semiring(storage, name))
    got = emulated_bordered(t, s, *echo, sr)
    assert_same(from_port(got, dt, storage_semiring(storage, name)), np.asarray(want))


def planted(storage: str, name: str, shape, s: int, b: int, seed: int) -> np.ndarray:
    """A graph whose pivot block's diagonal is not the ⊗-identity: negative
    self-loops for min_plus (a negative cycle), positive ones for
    max_plus, 0.5 for plus_mul."""
    if storage == "float32":
        x = semiring_graph(name, shape, seed)
        if name == "plus_mul":
            x = (x * 4.0).astype(np.float32)
    elif storage == "int16":  # small weights: no sum saturates in one round
        rng = np.random.default_rng(seed)
        x = rng.integers(1, 40, size=shape).astype(np.int16)
        x[rng.uniform(size=shape) < 0.3] = tsr.I16_INF
        x[..., np.arange(shape[-1]), np.arange(shape[-1])] = 0
    else:
        x = storage_data(storage, name, shape, seed)
    idx = np.arange(b * s, (b + 1) * s, 3)
    value = {"min_plus": -3, "max_plus": 3, "plus_mul": 0.5}[name]
    x = x.copy()
    x[..., idx, idx] = np.asarray(value).astype(x.dtype)
    return x


@pytest.mark.parametrize("storage,name,s", [
    ("float32", "min_plus", 128), ("float32", "max_plus", 64), ("float32", "plus_mul", 32),
    ("int16", "min_plus", 16), ("bfloat16", "plus_mul", 64), ("float16", "plus_mul", 128),
    ("float16", "min_plus", 32)])
def test_chain_emulation_holds_planted_diagonals(storage, name, s):
    """Where d[k][k] is not 1̄ the owner's step-k update moves p[k][c]: the
    emulation that shuffles the value before it == the reference, the one
    that shuffles it after does not."""
    b = 1
    shape = (2, 3 * s, 3 * s)
    x = planted(storage, name, shape, s, b, seed=s)
    sr_j = jsr.SEMIRINGS[name] if storage == "float32" else storage_semiring(storage, name, jsr)
    want = np.asarray(jref.fw_round_ref(jnp.asarray(x), b, block_size=s, semiring=sr_j))
    sr_t = tsr.SEMIRINGS[name] if storage == "float32" else storage_semiring(storage, name)
    t, sr, dt = to_port(x, sr_t)
    assert_same(from_port(emulated_round(t, s, b, sr), dt, sr_t), want)
    late = from_port(emulated_round(t, s, b, sr, late=True), dt, sr_t)
    assert not np.array_equal(np.asarray(late.view(torch.int16) if late.element_size() == 2
                                         else late.view(torch.int32)),
                              want.view(np.int16 if want.itemsize == 2 else np.int32))
