"""The relax kernels' tiling, emulated in plain torch, vs the JAX reference.

The fused round's relax (``csrc/fw_round.cuh:relax_kernel``) folds one
128 x 128 output tile per CTA on the semiring matmul's mainloop, whatever the
pivot width s: every element starts from ``start(r, c)`` (the row band in
row block b or the owner echo pr, else the col band in column block b or
pc, else w) and folds colband[r, k] ⊗ rowband[k, c] for k ascending, in
fixed slices of ``kBKOf`` (16 in 4-byte storages, 8 in 2-byte ones).  The
successor relax (``succ_relax_kernel``) folds 128 x 64 output tiles in
8-deep slices and keeps, beside each distance, the k of the last strict
improvement (-1 = none); it gathers the next hop colsucc[r, k] once after
the fold.

The emulations below follow those loops tile by tile and slice by slice.
Each is held by bits to the reference's whole round
(``repro.kernels.ref.fw_round_ref``, ``fw_round_bordered_ref``,
``fw_round_with_successors_ref``) on numpy inputs from a seed, with phases 1
and 2 from the port's plain versions, which the other port tests hold to
the reference.  The kernels themselves are held to the plain versions on
the card by ``tests/test_torch_kernels_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.core import paths as jpaths
from repro.core import semiring as jsr
from repro.kernels import ref as jref
from repro_torch.core import paths as tpaths
from repro_torch.core import semiring as tsr
from repro_torch.kernels import ref as tref
from repro_torch.utils.interop import from_numpy
from test_torch_semiring import (
    NAMES,
    assert_same,
    semiring_graph,
    storage_data,
    storage_semiring,
)

TILE = 128  # the relax kernels' output tile edge


@pytest.fixture(autouse=True)
def one_thread():
    """The emulations are many small torch ops: run them on one thread, as
    a pool of threads each would only wait on them beside other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
SUCC_COLS, SUCC_DEPTH = 64, 8  # the successor relax's tile width and slice depth
KEPT = -1  # the successor relax's "no k improved"


def slice_depth(dtype: torch.dtype) -> int:
    """``kBKOf<T>`` of ``csrc/minplus_matmul.cuh``."""
    return 8 if torch.empty((), dtype=dtype).element_size() == 2 else 16


def start(w, rowband, colband, s: int, b: int, pr: int = -1, pc: int = -1):
    """start(r, c) of every element: the row band in row block b or pr, else
    the col band in column block b or pc, else w."""
    rows, cols = w.shape[-2:]
    rblk, cblk = torch.arange(rows) // s, torch.arange(cols) // s
    from_row = ((rblk == b) | (rblk == pr))[:, None]
    from_col = ((cblk == b) | (cblk == pc))[None, :]
    by_row = rowband[..., torch.arange(rows) % s, :]
    by_col = colband[..., :, torch.arange(cols) % s]
    return torch.where(from_row, by_row, torch.where(from_col, by_col, w))


def tiles(rows: int, cols: int, width: int = TILE):
    for i0 in range(0, rows, TILE):
        for j0 in range(0, cols, width):
            yield slice(i0, i0 + TILE), slice(j0, j0 + width)


def relax_tiled(w, rowband, colband, s: int, b: int, semiring, pr: int = -1, pc: int = -1):
    """The relax kernel's loops: each 128 x 128 tile from its start, k
    ascending in slices of the storage's depth."""
    out = start(w, rowband, colband, s, b, pr, pc)
    depth = slice_depth(w.dtype)
    assert s % depth == 0  # k = s is a whole number of slices
    for ri, ci in tiles(*w.shape[-2:]):
        acc = out[..., ri, ci]
        for k0 in range(0, s, depth):
            for k in range(k0, k0 + depth):
                acc = semiring.relax(acc, colband[..., ri, k, None], rowband[..., k, None, ci])
        out[..., ri, ci] = acc
    return out


def succ_relax_tiled(w, succ, rw, rs, cw, cs, s: int, b: int):
    """The successor relax kernel's loops: 128 x 64 tiles, distances with
    the strict step in 8-deep slices, the k of the last strict improvement
    an element, then one gather of cs[r, k] (the start's hop where no k
    improved)."""
    dist = start(w, rw, cw, s, b)
    hop0 = start(succ, rs, cs, s, b)
    hop = hop0.clone()
    step = tsr.SEMIRINGS["min_plus"].mul
    for ri, ci in tiles(*w.shape[-2:], SUCC_COLS):
        acc = dist[..., ri, ci]
        ks = torch.full(acc.shape, KEPT, dtype=torch.int64)
        for k0 in range(0, s, SUCC_DEPTH):
            for k in range(k0, k0 + SUCC_DEPTH):
                cand = step(cw[..., ri, k, None], rw[..., k, None, ci])
                better = cand < acc
                acc = torch.where(better, cand, acc)
                ks = torch.where(better, k, ks)
        dist[..., ri, ci] = acc
        gathered = torch.gather(cs[..., ri, :], -1, ks.clamp(min=0))
        hop[..., ri, ci] = torch.where(ks == KEPT, hop0[..., ri, ci], gathered)
    return dist, hop


# ------------------------------------------------------------ fused round
ROUND_CASES = [  # (shape, s, b): first / middle / last pivot, every s
    ((96, 96), 16, 0), ((96, 96), 16, 3), ((96, 96), 16, 5),
    ((256, 256), 32, 4), ((3, 160, 160), 32, 4),
    ((3, 192, 192), 64, 0), ((3, 192, 192), 64, 2),
    ((384, 384), 128, 0), ((384, 384), 128, 1), ((384, 384), 128, 2),
]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,s,b", ROUND_CASES)
def test_relax_tiling_matches_reference_round(name, shape, s, b):
    sr = tsr.SEMIRINGS[name]
    w = semiring_graph(name, shape, seed=s + b)
    want = jref.fw_round_ref(jnp.asarray(w), b, block_size=s, semiring=jsr.SEMIRINGS[name])
    t = torch.from_numpy(w)
    o = slice(b * s, (b + 1) * s)
    row, col = tref.close_bands(t, tref.close_diag(t[..., o, o], sr), b, sr)
    assert_same(relax_tiled(t, row, col, s, b, sr), want)


@pytest.mark.parametrize("storage,name", [("bfloat16", "min_plus"), ("bfloat16", "plus_mul"),
                                          ("int16", "min_plus"), ("packed", "or_and")],
                         ids="-".join)
@pytest.mark.parametrize("shape,s,b", [((96, 96), 16, 2), ((3, 256, 256), 128, 1)])
def test_relax_tiling_matches_reference_round_lowered(storage, name, shape, s, b):
    """The 2-byte storages fold 8-deep slices."""
    x = storage_data(storage, name, shape, seed=s)
    want = jref.fw_round_ref(jnp.asarray(x), b, block_size=s,
                             semiring=storage_semiring(storage, name, jsr))
    sr = storage_semiring(storage, name)
    t = from_numpy(x, device="cpu")
    o = slice(b * s, (b + 1) * s)
    row, col = tref.close_bands(t, tref.close_diag(t[..., o, o], sr), b, sr)
    assert_same(relax_tiled(t, row, col, s, b, sr), want)


# ---------------------------------------------------------- bordered round
BORDERED_CASES = [((80, 48), 16), ((3, 96, 160), 32), ((272, 400), 16)]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,s", BORDERED_CASES)
@pytest.mark.parametrize("echo", ["none", "both", "one"])
def test_relax_tiling_matches_reference_bordered_round(name, shape, s, echo):
    """Blocks that are multiples of s, not of the 128 tile, and the three
    owner-echo forms: none, a row and a column block, one of the two."""
    tr, tc = shape[-2] // s, shape[-1] // s
    pr, pc = {"none": (-1, -1), "both": (tr - 1, 1), "one": (-1, tc - 1)}[echo]
    sr = tsr.SEMIRINGS[name]
    m = max(shape[-2:])  # cut from a square graph: the diagonal is its own
    w = semiring_graph(name, (*shape[:-2], m, m), seed=s + tr)[..., :shape[-2], :shape[-1]].copy()
    want = jref.fw_round_bordered_ref(jnp.asarray(w), pr, pc, block_size=s,
                                      semiring=jsr.SEMIRINGS[name])
    t = torch.from_numpy(w)
    row, col = tref.close_bordered_bands(t, tref.close_diag(t[..., :s, :s], sr), pr, pc, sr)
    assert_same(relax_tiled(t, row, col, s, 0, sr, pr, pc), want)


# --------------------------------------------------------- successor round
def tie_graph(shape, seed: int) -> np.ndarray:
    """Integer weights in [1, 4] (equal candidates everywhere: only a
    strictly smaller one takes its hop), 30 % missing, and node 5 isolated:
    its row and column are never improved."""
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 5, size=shape).astype(np.float32)
    w[rng.uniform(size=shape) < 0.3] = np.inf
    w[..., 5, :] = np.inf
    w[..., :, 5] = np.inf
    idx = np.arange(shape[-1])
    w[..., idx, idx] = 0.0
    return w


@pytest.mark.parametrize("shape,s,b", [((96, 96), 16, 0), ((96, 96), 16, 5),
                                       ((3, 160, 160), 32, 2), ((192, 192), 64, 1),
                                       ((384, 384), 128, 1)])
def test_successor_relax_tiling_matches_reference_round(shape, s, b):
    w = tie_graph(shape, seed=s + b)
    succ = np.array(jpaths._init_successors(jnp.asarray(w)))
    wd, ws = jref.fw_round_with_successors_ref(jnp.asarray(w), jnp.asarray(succ), b,
                                               block_size=s)
    t, ts = torch.from_numpy(w), torch.from_numpy(succ)
    o = slice(b * s, (b + 1) * s)
    diag, dsucc = tref.close_diag_succ(t[..., o, o], ts[..., o, o])
    rw, rs, cw, cs = tref.close_bands_succ(t, ts, diag, dsucc, b)
    gd, gs = succ_relax_tiled(t, ts, rw, rs, cw, cs, s, b)
    assert_same(gd, wd)
    assert_same(gs, ws)
    unchanged = (gs == ts).all(-1)
    assert bool(unchanged[..., 5].all())  # the isolated node's row keeps its hops
    assert bool((gs != ts).any())


def test_successor_start_hops_match_the_port():
    """``_init_successors`` of the port and the reference agree on the tie
    graph (the successor relax starts from those hops)."""
    w = tie_graph((3, 64, 64), seed=3)
    assert_same(tpaths._init_successors(torch.from_numpy(w)),
                jpaths._init_successors(jnp.asarray(w)))
