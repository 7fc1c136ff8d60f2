"""The successor round's diag and bands kernels, emulated in plain torch, vs
the JAX reference.

The successor diag (``csrc/fw_round.cuh:succ_diag_kernel`` on
``fw_phases.cuh:close_tile_blocks_succ``) closes the pivot tile on the
fused diag's ``DiagShape<S>`` register blocks, with a block of next hops
beside each block of distances: step k = 4T·h + 4·tk + e is published by its
owners, register row m = 4h + e of the threads ty == tk (distances) and
register column m of the threads tx == tk (distances and hops, the a-side
hop being the tile's own column k), into shared vectors of parity e & 1,
and every thread relaxes its block against them.

The successor bands (``succ_bands_kernel`` on ``close_band_lanes_succ``)
give each warp 16 whole chains of a band tile, as the fused bands do: lane
(rg, cg) holds rows rg·S/8 .. and columns 16v + 4cg .. (the col tile
transposed), takes step k's band value from lane (k / (S/8), cg), register
k % (S/8), by shuffle before any lane updates it, and its S/8 operands
from the closed diagonal's distances staged in shared memory; a loop body
is KU = min(S/8, 4) steps, so the owner's register is x[kk + KU·q], q the
body's index modulo S/8/KU.  A col lane
shuffles each value's hop with it (the a-side hop is the band's own
evolving column); a row lane keeps, in place of a hop, the k of the
element's last strict improvement and gathers the closed diagonal's hop
ds[r][k] once after the chain (the a-side hop of a row panel never
changes), or keeps its start's.  A tile's warps are cut into ``split``
CTAs, each staging its own copy of the diagonal.

Every relaxation rounds its candidate to the storage before the strict
compare (``semiring.cuh:relax_succ``); nothing is lifted.  The emulations
follow those loops, index maps and arithmetic; then the relax phase runs as
the port's plain version, and the whole round, distances and next hops, is
held by bits to the reference's ``repro.kernels.ref.
fw_round_with_successors_ref`` on numpy inputs from a seed: s = 16 .. 128,
f32, bf16 and f16, single and batched, tie-heavy integer weights (where
only the strict compare decides a hop), NaN off the diagonal tiles and
planted negative diagonals.  Two variants the kernels avoid are shown to
differ: a compare of unrounded (lifted) bf16 sums, and a shuffle read after
its owner's update.  The kernels themselves are held to the plain phases on
the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.core import paths as jpaths
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.utils.interop import from_numpy
from test_torch_chain_design import band_split, block_index, diag_shape, splits
from test_torch_semiring import HALF_DTYPES, assert_same

KEPT = -1  # a row lane's "no k improved" (``fw_phases.cuh:kKept``)
DTYPES = ("float32", "bfloat16", "float16")


@pytest.fixture(autouse=True)
def one_thread():
    """The emulations are many small torch ops: run them on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ----------------------------------------------------------- the step
class Step:
    """``relax_succ<Op>`` on float registers holding storage values: cand =
    a + b in f32, rounded to the storage (bf16 / f16), then taken only
    where cand < t.  lifted: the variant the kernels avoid, whose
    accumulators and candidates stay unrounded in f32 (each operand
    rounded where it is published, staged or shuffled, the result on
    store), as ``semiring.cuh:Lifted`` keeps the plain min-plus chains."""

    def __init__(self, dtype: torch.dtype, lifted: bool = False):
        self.dtype, self.lifted = dtype, lifted

    def round(self, v):
        return v if self.dtype == torch.float32 else v.to(self.dtype).float()

    def lift(self, v):
        """An operand as it is published, staged or shuffled."""
        return self.round(v) if self.lifted else v

    def __call__(self, t, ts, a, a_hop, b):
        cand = a + b
        if not self.lifted:
            cand = self.round(cand)
        better = cand < t
        return torch.where(better, cand, t), torch.where(better, a_hop, ts)


# ------------------------------------------------------------------ diag
def diag_blocks_succ(tile, tsucc, step: Step):
    """``close_tile_blocks_succ`` on a (..., s, s) tile and its hops: the
    closed tile and its next hops."""
    s = tile.shape[-1]
    H, T, M = diag_shape(s)
    at = block_index(s)
    # regs[..., ty, tx, i, j] = tile[at[ty, i], at[tx, j]]; hops likewise
    ix = (..., at[:, None, :, None], at[None, :, None, :])
    regs, hops = tile[ix].float(), tsucc[ix]
    lead = tile.shape[:-2]
    rowbuf = [torch.zeros((*lead, s)) for _ in range(2)]
    colbuf = [torch.zeros((*lead, s)) for _ in range(2)]
    colsbuf = [torch.zeros((*lead, s), dtype=tsucc.dtype) for _ in range(2)]
    steps = []
    for h in range(H):
        for tk in range(T):
            for e in range(4):
                k, m, p = 4 * T * h + 4 * tk + e, 4 * h + e, e & 1
                assert at[tk, m] == k  # the owner's register row / column m is k
                steps.append(k)
                rowbuf[p][..., at] = step.lift(regs[..., tk, :, m, :])  # row owners
                colbuf[p][..., at] = step.lift(regs[..., :, tk, :, m])  # col owners
                colsbuf[p][..., at] = hops[..., :, tk, :, m]  # ... and their hops
                # after the barrier: (..., tx, j), (..., ty, i), (..., ty, i)
                rv, cv, cs = rowbuf[p][..., at], colbuf[p][..., at], colsbuf[p][..., at]
                regs, hops = step(regs, hops, cv[..., :, None, :, None],
                                  cs[..., :, None, :, None], rv[..., None, :, None, :])
    assert steps == list(range(s))  # k ascending
    out, outs = torch.empty_like(tile), torch.empty_like(tsucc)
    out[ix] = regs.to(tile.dtype)
    outs[ix] = hops
    return out, outs


# ----------------------------------------------------------------- bands
def band_lanes_succ(panel, psucc, diag, dsucc, step: Step, *, col: bool, split: int,
                    late: bool = False):
    """``close_band_lanes_succ`` of one (..., s, s) band tile, its warps cut
    into ``split`` CTAs: the closed row panel (col False) or col panel
    (col True) and its next hops.  late: read the shuffled value (and hop)
    after its owner's update (the hazard the kernel avoids)."""
    s = panel.shape[-1]
    RL, W = s // 8, s // 16
    assert W % split == 0
    x = (panel.transpose(-1, -2) if col else panel).float()
    # col lanes: the hops; row lanes: the k of the last improvement
    xs = psucc.transpose(-1, -2) if col else torch.full_like(psucc, KEPT)
    out, outs = torch.empty_like(x), torch.empty_like(xs)
    for piece in range(split):
        # each CTA stages its own copy of the diagonal's distances:
        # dS[k][r] = d[r][k] (row panel), d[k][c] (col panel)
        dS = step.lift((diag if col else diag.transpose(-1, -2)).float())
        for v in range(piece * (W // split), (piece + 1) * (W // split)):
            # regs[..., rg, i, cg, j] = x[rg·RL + i, 16v + 4cg + j]
            cut = (..., slice(None), slice(16 * v, 16 * v + 16))
            regs = x[cut].reshape(*x.shape[:-2], 8, RL, 4, 4)
            hops = xs[cut].reshape(*x.shape[:-2], 8, RL, 4, 4)
            KU = min(RL, 4)  # steps a loop body
            for kb in range(s // KU):
                for kk in range(KU):
                    k = kb * KU + kk
                    # the owner lane (src, cg) and its register x[kk + 4q],
                    # q = kb % (RL / KU)
                    src, reg = kb * KU // RL, kb * KU % RL + kk
                    assert src * RL + reg == k

                    def relax(sh, shs):
                        dv = dS[..., k, :].reshape(*dS.shape[:-2], 8, RL)[..., None, None]
                        sh = step.lift(sh)[..., None, None, :, :]
                        if col:
                            return step(regs, hops, sh, shs[..., None, None, :, :], dv)
                        return step(regs, hops, dv, torch.tensor(k, dtype=hops.dtype), sh)

                    # lane (src, cg), register [reg][j]: value and (col) hop
                    new, newh = relax(regs[..., src, reg, :, :], hops[..., src, reg, :, :])
                    if late:  # the owner's updated value and hop instead
                        new, newh = relax(new[..., src, reg, :, :], newh[..., src, reg, :, :])
                    regs, hops = new, newh
            out[cut] = regs.reshape(*x.shape[:-2], s, 16)
            outs[cut] = hops.reshape(*x.shape[:-2], s, 16)
    out = out.to(panel.dtype)
    if col:
        return out.transpose(-1, -2), outs.transpose(-1, -2)
    # the gather after the chain: ds[r][k] where some k improved, else the
    # start's hop
    gathered = torch.gather(dsucc, -1, outs.clamp(min=0).long())
    return out, torch.where(outs == KEPT, psucc, gathered)


def chains_succ(w, succ, s: int, b: int, step: Step, *, split: int | None = None,
                late: bool = False):
    """The successor diag and bands launches of round b on (..., n, n): the
    (rw, rs, cw, cs) band buffers they leave."""
    n = w.shape[-1]
    T = n // s
    o = slice(b * s, (b + 1) * s)
    d, ds = diag_blocks_succ(w[..., o, o], succ[..., o, o], step)
    lead = w.shape[:-2]
    rw, cw = torch.zeros((*lead, s, n), dtype=w.dtype), torch.zeros((*lead, n, s), dtype=w.dtype)
    rs = torch.zeros((*lead, s, n), dtype=succ.dtype)
    cs = torch.zeros((*lead, n, s), dtype=succ.dtype)
    rw[..., :, o], rs[..., :, o], cw[..., o, :], cs[..., o, :] = d, ds, d, ds
    tiles = 2 * (T - 1)
    batch = int(np.prod(lead, dtype=np.int64))
    split = band_split(s, tiles, batch) if split is None else split
    for u in range(tiles):
        is_row = u < T - 1
        x = u if is_row else u - (T - 1)
        x = x if x < b else x + 1
        t = slice(x * s, (x + 1) * s)
        if is_row:
            rw[..., :, t], rs[..., :, t] = band_lanes_succ(
                w[..., o, t], succ[..., o, t], d, ds, step, col=False, split=split, late=late)
        else:
            cw[..., t, :], cs[..., t, :] = band_lanes_succ(
                w[..., t, o], succ[..., t, o], d, ds, step, col=True, split=split, late=late)
    return rw, rs, cw, cs


def emulated_round(w, succ, s: int, b: int, *, lifted: bool = False, **kw):
    rw, rs, cw, cs = chains_succ(w, succ, s, b, Step(w.dtype, lifted), **kw)
    return tref.relax_succ_tiles(w, succ, rw, rs, cw, cs, b)


# ---------------------------------------------------------------- inputs
def tie_graph(shape, seed: int) -> np.ndarray:
    """Integer weights in [1, 4] (equal candidates everywhere: only a
    strictly smaller one takes its hop), 30 % missing, node 5 isolated."""
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 5, size=shape).astype(np.float32)
    w[rng.uniform(size=shape) < 0.3] = np.inf
    w[..., 5, :] = np.inf
    w[..., :, 5] = np.inf
    idx = np.arange(shape[-1])
    w[..., idx, idx] = 0.0
    return w


def random_graph(shape, seed: int) -> np.ndarray:
    """Weights in [1, 10) (their 16-bit sums round), 30 % missing."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(1.0, 10.0, size=shape).astype(np.float32)
    w[rng.uniform(size=shape) < 0.3] = np.inf
    idx = np.arange(shape[-1])
    w[..., idx, idx] = 0.0
    return w


def nan_off_diagonal_tiles(w: np.ndarray, s: int, seed: int, count: int = 4) -> np.ndarray:
    """w with ``count`` NaNs a graph outside its diagonal (s, s) tiles."""
    rng = np.random.default_rng(seed)
    w = w.copy()
    placed = 0
    while placed < count:
        i, j = (int(v) for v in rng.integers(0, w.shape[-1], 2))
        if i // s != j // s:
            w[..., i, j] = np.nan
            placed += 1
    return w


def planted(w: np.ndarray, s: int, b: int) -> np.ndarray:
    """w with -3 on every third diagonal entry of pivot block b: a negative
    cycle, so the owner's step-k update moves the value every lane takes."""
    w = w.copy()
    idx = np.arange(b * s, (b + 1) * s, 3)
    w[..., idx, idx] = -3.0
    return w


def case(graph: np.ndarray, dtype: str):
    """(w, succ) as numpy in the storage (bf16 as ml_dtypes) and as the
    port's CPU tensors."""
    x = np.asarray(jnp.asarray(graph, HALF_DTYPES.get(dtype, jnp.float32)))
    succ = np.array(jpaths._init_successors(jnp.asarray(x)))
    return (x, succ), (from_numpy(x, device="cpu"), torch.from_numpy(succ))


def reference(x, succ, s: int, b: int):
    wd, ws = jref.fw_round_with_successors_ref(jnp.asarray(x), jnp.asarray(succ), b,
                                               block_size=s)
    return np.asarray(wd), np.asarray(ws)


def differs(got, want) -> bool:
    g = np.asarray(got.view(torch.int16) if got.element_size() == 2 else got.view(torch.int32))
    w = want.view(np.int16 if want.itemsize == 2 else np.int32)
    return not np.array_equal(g, w)


# ------------------------------------------------------------- the cases
ROUND_CASES = [  # (shape, s, b): single and batched, every s
    ((96, 96), 16, 2), ((3, 160, 160), 32, 4), ((192, 192), 64, 1), ((384, 384), 128, 1),
    ((3, 96, 96), 16, 0),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("graph", ["ties", "random"])
@pytest.mark.parametrize("shape,s,b", ROUND_CASES)
def test_succ_chain_emulation_matches_reference_round(dtype, graph, shape, s, b):
    """Distances and next hops of the round the emulated chains start ==
    the reference's, by bits, at every band split."""
    make = tie_graph if graph == "ties" else random_graph
    (x, succ), (t, ts) = case(make(shape, seed=s + b), dtype)
    wd, ws = reference(x, succ, s, b)
    for p in splits(s):
        gd, gs = emulated_round(t, ts, s, b, split=p)
        assert_same(gd, wd)
        assert_same(gs, ws)
    assert bool((ws != ts.numpy()).any())  # some hop moved


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,s,b", [((96, 96), 16, 1), ((2, 192, 192), 64, 0),
                                       ((384, 384), 128, 2)])
def test_succ_chain_emulation_keeps_nan_off_the_diagonal_tiles(dtype, shape, s, b):
    """A NaN candidate or distance is never strictly smaller: NaNs in the
    band and relax tiles stay where they are and take no hop."""
    w = nan_off_diagonal_tiles(random_graph(shape, seed=s), s, seed=s)
    (x, succ), (t, ts) = case(w, dtype)
    wd, ws = reference(x, succ, s, b)
    gd, gs = emulated_round(t, ts, s, b)
    assert_same(gd, wd)
    assert_same(gs, ws)
    assert bool(torch.isnan(gd.float()).any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,s,b", [((96, 96), 16, 2), ((2, 128, 128), 32, 1),
                                       ((256, 256), 128, 1)])
def test_succ_chain_emulation_holds_planted_diagonals(dtype, shape, s, b):
    """Where d[k][k] < 0 the owner's step-k update moves the value (and,
    in a col panel, the hop) every lane takes at step k: the emulation that
    shuffles it before the update == the reference, the one that shuffles
    it after does not."""
    (x, succ), (t, ts) = case(planted(tie_graph(shape, seed=s + b), s, b), dtype)
    wd, ws = reference(x, succ, s, b)
    gd, gs = emulated_round(t, ts, s, b)
    assert_same(gd, wd)
    assert_same(gs, ws)
    ld, ls = emulated_round(t, ts, s, b, late=True)
    assert differs(ld, wd) or differs(ls, ws)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_lifted_16bit_compare_would_take_other_hops(dtype):
    """The rounding before the strict compare is needed: where a sum rounds
    to the current distance while its f32 value is smaller, the reference
    keeps the old hop, and a compare of unrounded (lifted) sums takes the
    new one; the rounded emulation == the reference on the same input."""
    s, b = 32, 1
    (x, succ), (t, ts) = case(random_graph((2, 128, 128), seed=11), dtype)
    wd, ws = reference(x, succ, s, b)
    gd, gs = emulated_round(t, ts, s, b)
    assert_same(gd, wd)
    assert_same(gs, ws)
    _, lifted_hops = emulated_round(t, ts, s, b, lifted=True)
    assert differs(lifted_hops, ws)


def test_lifted_steps_differ_on_one_tie():
    """The case in one step: t = 256 (bf16), a + b = 255.5 exactly, which
    rounds (to even) to 256: the rounded compare keeps the old hop, the
    unrounded one takes the new."""
    t, ts = torch.tensor([256.0]), torch.tensor([7], dtype=torch.int32)
    a, b, hop = torch.tensor([127.5]), torch.tensor([128.0]), torch.tensor([9], dtype=torch.int32)
    assert Step(torch.bfloat16)(t, ts, a, hop, b)[1].item() == 7
    assert Step(torch.bfloat16, lifted=True)(t, ts, a, hop, b)[1].item() == 9
    assert Step(torch.float32)(t, ts, a, hop, b)[1].item() == 9  # f32: 255.5 < 256


def test_row_lanes_winning_k_equals_carried_hops():
    """The row lanes' winning-k gather == carrying ds[r][k] beside every
    distance through the chain (the plain ``close_row_panel_succ``), on
    tie-heavy inputs whose closed diagonal has hops of every kind."""
    s = 64
    (_, _), (t, ts) = case(tie_graph((2, 3 * s, 3 * s), seed=5), "float32")
    o, x = slice(0, s), slice(s, 2 * s)
    d, ds = tref.close_diag_succ(t[..., o, o], ts[..., o, o])
    want = tref.close_row_panel_succ(t[..., o, x], ts[..., o, x], d, ds)
    got = band_lanes_succ(t[..., o, x], ts[..., o, x], d, ds, Step(torch.float32), col=False,
                          split=2)
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])
