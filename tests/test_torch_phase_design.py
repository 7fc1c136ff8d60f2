"""The 4-dispatch round's closure and band kernels, emulated in plain torch,
vs the JAX reference's Pallas phase kernels.

The closure kernel (``csrc/fw_phase.cuh:closure_kernel``) closes each
graph's (s, s) tile on the fused round's register blocks
(``fw_phases.cuh:close_tile_blocks``, ``DiagShape<S>``), one CTA a graph.
The band kernel (``band_kernel<S, Col>``) runs ``close_band_lanes`` on
every s-wide tile of an (s, n) row band (its columns) or s-high tile of an
(n, s) col band (its rows), the pivot's own tile included: warp v of tile u
owns chains u·s + 16v .., the tile's s/16 warps are cut into
``band_split`` CTAs that each stage the closed diagonal, chains past n load
0 and are never stored, and a warp that has none of the band's chains
leaves after the staging.

The emulations reuse ``diag_blocks``, ``band_lanes`` and ``band_split`` of
``test_torch_chain_design.py`` for the bodies the kernel families share,
and add the 4-dispatch launches' index maps (``band_launch`` below). They
are held by bits to the reference's ``repro.kernels.fw_phase1.fw_phase1``
and ``repro.kernels.fw_phase2.fw_phase2_row`` / ``fw_phase2_col`` in
interpret mode, on numpy inputs from a seed: batches of 3 graphs, s 16 ..
128, band lengths 1, s - 3, 5s and 5s - 3, the five semirings in f32 and
every storage lowering, and planted diagonals that are not the
⊗-identity, where a shuffled value read after its owner's update differs.
The kernels themselves are held to the plain phases on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.core import semiring as jsr
from repro.kernels import fw_phase1 as jp1
from repro.kernels import fw_phase2 as jp2
from repro_torch.core import semiring as tsr
from test_torch_chain_design import (  # noqa: F401  (one_thread: the autouse fixture)
    band_lanes,
    band_split,
    diag_blocks,
    one_thread,
    planted,
)
from test_torch_semiring import (
    NAMES,
    REF_STORAGES,
    assert_same,
    from_port,
    semiring_graph,
    storage_data,
    storage_id,
    storage_semiring,
    to_port,
)

B = 3  # graphs a launch (blockIdx.z)
POISON = 0x5A  # every byte of what a launch never writes


# -------------------------------------------------------------- launches
def closure_launch(tile: torch.Tensor, semiring) -> torch.Tensor:
    """``closure_kernel`` on (..., s, s) tiles: one CTA a graph, the
    register blocks of ``close_tile_blocks``."""
    return diag_blocks(tile, semiring)


def band_launch(diag: torch.Tensor, band: torch.Tensor, semiring, *, col: bool,
                split: int | None = None, late: bool = False) -> torch.Tensor:
    """``band_kernel<S, col>`` on a (..., s, n) row band (col False) or a
    (..., n, s) col band against the closed diagonal: the closed band.
    Every tile of the band is closed, the pivot's included; chains past n
    load 0, a warp with none of the band's chains leaves, and no chain past
    n is stored (the padded output keeps its poison there)."""
    s = diag.shape[-1]
    x = band.transpose(-1, -2) if col else band  # (..., s, n): a chain a column
    n = x.shape[-1]
    tiles = -(-n // s)
    lead = x.shape[:-2]
    split = band_split(s, tiles, int(np.prod(lead, dtype=np.int64))) if split is None else split
    padded = torch.zeros((*lead, s, tiles * s), dtype=x.dtype)  # chains past n load 0
    padded[..., :n] = x
    out = torch.full_like(padded.view(torch.uint8), POISON).view(x.dtype)
    warps, stored = s // 16, 0
    for u in range(tiles):
        t = slice(u * s, (u + 1) * s)
        tile = padded[..., t].transpose(-1, -2) if col else padded[..., t]
        closed = band_lanes(tile, diag, semiring, col=col, split=split, late=late)
        closed = closed.transpose(-1, -2) if col else closed
        for v in range(warps):  # CTA (u, v // (warps // split)) holds warp v
            x0 = u * s + 16 * v
            if x0 >= n:
                continue  # none of the band's chains: the warp leaves
            live = min(16, n - x0)  # a lane's 4 chains stored up to n
            out[..., x0:x0 + live] = closed[..., 16 * v:16 * v + live]
            stored += live
    assert stored == n
    assert (out[..., n:].contiguous().view(torch.uint8) == POISON).all()  # never stored
    out = out[..., :n]
    return out.transpose(-1, -2) if col else out


# ------------------------------------------------------------- the layout
def test_phase_grid_fills_the_card():
    """n = 8192, s = 128: 64 tiles a band cut in two (128 CTAs of 4
    warps); a band of one tile (n = 1, s - 3) in four at s >= 64; a batch
    of 3 at n = 5s: 15 tiles, cut in four at s = 128 (60 CTAs)."""
    assert band_split(128, 64, 1) == 2 and 64 * 2 <= 132 < 64 * 4
    assert band_split(128, 1, 1) == 4 and band_split(64, 1, 1) == 4
    assert band_split(32, 1, 1) == 2 and band_split(16, 1, 1) == 1
    assert band_split(128, 5, B) == 4 and band_split(16, 5, B) == 1


def band_lengths(s: int) -> list[int]:
    """1, n < s, n = 5s and the ragged 5s - 3."""
    return [1, s - 3, 5 * s, 5 * s - 3]


def phase_inputs(x: np.ndarray, s: int, n: int):
    """(tile, row band, col band) of (B, m, m) x as the 4-dispatch round
    reads them: the pivot block o = [s, 2s) where the band holds it (its
    own tile then inside each band), else [0, s); bands of length n."""
    o = slice(s, 2 * s) if n >= 2 * s else slice(0, s)
    return (x[..., o, o].copy(), x[..., o, :n].copy(), x[..., :n, o].copy())


def phases(x: np.ndarray, s: int, n: int, sr_j, sr_t, *, late: bool = False):
    """(the reference's, the emulation's) closed tile, row band and col band
    of x's phase inputs, in x's storage (late: the bands emulated with the
    late shuffle)."""
    tile, row, col = phase_inputs(x, s, n)
    want_d = np.asarray(jp1.fw_phase1(tile, semiring=sr_j, interpret=True))
    # bt = n: one program a graph; bt chooses no element's chain
    want = (want_d,
            np.asarray(jp2.fw_phase2_row(want_d, row, bt=n, semiring=sr_j, interpret=True)),
            np.asarray(jp2.fw_phase2_col(want_d, col, bt=n, semiring=sr_j, interpret=True)))
    tt, sr, dt = to_port(tile, sr_t)
    diag = closure_launch(tt, sr)
    got = [diag] + [band_launch(diag, to_port(b, sr_t)[0], sr, col=c, late=late)
                    for b, c in ((row, False), (col, True))]
    return want, [from_port(g, dt, sr_t) for g in got]


def held(x: np.ndarray, s: int, n: int, sr_j, sr_t):
    """The emulated closure and bands == the reference's, by bits."""
    for w, g in zip(*phases(x, s, n, sr_j, sr_t)):
        assert_same(g, w)


# ------------------------------------------------------------- the cases
# Semiring j at s_k takes band length (j + k) % 4: every semiring at every
# s and at every band length, every (s, length) pair under a semiring.
F32_CASES = [(name, s, (j + k) % 4) for j, name in enumerate(NAMES)
             for k, s in enumerate((16, 32, 64, 128))]


@pytest.mark.parametrize("name,s,i", F32_CASES)
def test_phase_emulation_matches_reference(name, s, i):
    """f32, the five semirings, a batch of 3."""
    n = band_lengths(s)[i]
    x = semiring_graph(name, (B, max(n, 2 * s), max(n, 2 * s)), seed=s + n)
    held(x, s, n, jsr.SEMIRINGS[name], tsr.SEMIRINGS[name])


@pytest.mark.parametrize("i,case", list(enumerate(REF_STORAGES)),
                         ids=lambda c: storage_id(c) if isinstance(c, tuple) else str(c))
def test_phase_emulation_matches_reference_lowered(i, case):
    """Every storage lowering (an integer storage on its int32 carrier), a
    batch of 3, s cycling through 16 .. 128 and the band length through 1,
    s - 3, 5s and 5s - 3."""
    storage, name = case
    s = (16, 32, 64, 128)[i % 4]
    n = band_lengths(s)[(i // 4 + i) % 4]
    m = max(n, 2 * s)
    x = storage_data(storage, name, (B, m, m), seed=80 + i)
    held(x, s, n, storage_semiring(storage, name, jsr), storage_semiring(storage, name))


@pytest.mark.parametrize("storage,name,s", [
    ("float32", "min_plus", 128), ("float32", "max_plus", 64), ("float32", "plus_mul", 32),
    ("int16", "min_plus", 16), ("bfloat16", "plus_mul", 64), ("float16", "min_plus", 32)])
def test_phase_emulation_holds_planted_diagonals(storage, name, s):
    """Where d[k][k] is not 1̄ the owner's step-k update moves the value it
    shuffles: the bands that shuffle it before the update == the
    reference, the ones that shuffle it after do not."""
    n = 5 * s - 3
    x = planted(storage, name, (B, n, n), s, 1, seed=s)
    sr_j = jsr.SEMIRINGS[name] if storage == "float32" else storage_semiring(storage, name, jsr)
    sr_t = tsr.SEMIRINGS[name] if storage == "float32" else storage_semiring(storage, name)
    held(x, s, n, sr_j, sr_t)
    want, late = phases(x, s, n, sr_j, sr_t, late=True)
    bits = (torch.int16, np.int16) if late[0].element_size() == 2 else (torch.int32, np.int32)
    for got, w in zip(late[1:], want[1:]):  # both bands differ
        assert not np.array_equal(got.view(bits[0]).numpy(), w.view(bits[1]))
