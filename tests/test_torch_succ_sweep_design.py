"""The successor sweep's diag and panels kernels, emulated in plain torch, vs
the JAX reference.

The successor sweep's diag (``csrc/fw_repair_del.cuh:succ_diag_kernel``)
runs the successor round's ``close_tile_blocks_succ`` on the overlaid pivot
tile: each row of the tile and of its next hops is read through
``band_row`` (the strip row where the matrix row is affected, else the
``d_init`` / ``s_init`` row).  Its panels (``succ_panels_kernel``) run
``close_band_lanes_succ`` on the grid of the plain sweep's panels: the
band's T - 1 tiles as row lanes, each cut into ``band_split`` CTAs, and the
strip's block column b as col lanes, in CTAs of s / split strip rows, 16 a
warp, after the band's CTAs; a strip row past a_pad loads 0 and is never
stored, and a warp holding none of the strip's rows leaves after the
staging.  Every CTA stages the closed diagonal's distances for itself and
no hop tile.  A col lane shuffles each strip row's hop with its value
before the owner's update; a row lane keeps the k of each element's last
strict improvement and gathers the closed diagonal's hop ds[r][k] after the
chain, or keeps the overlay's start hop.

The emulations follow those loops and index maps (``diag_blocks_succ`` and
``band_lanes_succ`` of ``test_torch_succ_chain_design.py``, the overlay of
``test_torch_sweep_design.py``, ``strip_lanes_succ`` below for the strip
CTAs), then the relax phase runs as the port's plain version
(``kernels.ref.sweep_relax_succ_ref``), round by round.  The whole sweep,
distances and next hops, is held by bits to the reference's
``repro.kernels.fw_repair_del.fw_repair_del_sweep_with_successors_ref`` on
numpy inputs from a seed: s 16 .. 128; f32, bf16 and f16; strips of 8, 16
and 24 rows with rows inside every pivot block and a padding row;
tie-heavy integer weights (only the strict compare decides a hop), NaN off
the diagonal tiles and planted negative diagonals.  Two variants the
kernels avoid are shown to differ: a compare of unrounded (lifted) 16-bit
sums, and a shuffle read after its owner's update.  The kernels themselves
are held to the plain phases on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.kernels import fw_repair_del as jd
from repro_torch.kernels import ref as tref
from test_torch_chain_design import band_split
from test_torch_semiring import assert_same
from test_torch_succ_chain_design import (  # noqa: F401  (one_thread: the autouse fixture)
    DTYPES,
    Step,
    band_lanes_succ,
    case,
    diag_blocks_succ,
    differs,
    nan_off_diagonal_tiles,
    one_thread,
    planted,
    random_graph,
    tie_graph,
)
from test_torch_sweep_design import overlay, positions, sweep_rows, sweep_size


# ----------------------------------------------------------------- strip
def warp_lanes_succ(x, xs, dS, step: Step, *, late: bool):
    """One warp of ``close_band_lanes_succ<S, true>`` (the col panel): x /
    xs (s, 16) hold 16 chains (strip rows) and their hops, transposed; lane
    (rg, cg) holds rows rg·s/8 .. of chains 4cg ..; at step k = KU·kb + kk
    each chain's own value at k and its hop come by shuffle from lane
    (k // (s/8), cg), register k % (s/8), before its owner updates them;
    dS[k] (the staged diagonal's row k) gives the b-side operands.  late:
    the owner's updated value and hop instead."""
    s = x.shape[0]
    RL, KU = s // 8, min(s // 8, 4)
    regs, hops = x.reshape(8, RL, 4, 4), xs.reshape(8, RL, 4, 4)  # [rg, i, cg, j]
    for kb in range(s // KU):
        for kk in range(KU):
            k = kb * KU + kk
            src, reg = kb * KU // RL, kb * KU % RL + kk
            assert src * RL + reg == k
            dv = dS[k].reshape(8, RL)[:, :, None, None]

            def relax(sh, shs):
                return step(regs, hops, step.lift(sh)[None, None], shs[None, None], dv)

            new, newh = relax(regs[src, reg], hops[src, reg])
            if late:
                new, newh = relax(new[src, reg], newh[src, reg])
            regs, hops = new, newh
    return regs.reshape(s, 16), hops.reshape(s, 16)


def strip_lanes_succ(q, qs, diag, step: Step, *, split: int, late: bool = False):
    """``succ_panels_kernel``'s strip CTAs on the strip's block column q
    (a_pad, s) and its hops qs: CTA i holds strip rows i·R .. (R = s /
    split), warp v of it 16 of them; each CTA stages the diagonal's
    distances as they lie.  Returns (acol, acol_s)."""
    a, s = q.shape
    R = s // split
    out, outs = torch.empty_like(q), torch.empty_like(qs)
    for cta in range(-(-a * split // s)):
        dS = step.lift(diag.float())  # dS[k][c] = d[k][c]
        for v in range(R // 16):
            r0 = cta * R + 16 * v
            if r0 >= a:
                continue  # none of the strip's rows: the warp leaves
            live = min(a - r0, 16)  # a multiple of 8: a lane's 4 rows all or none
            x = torch.zeros((16, s))  # masked rows load 0 ...
            xs = torch.zeros((16, s), dtype=qs.dtype)
            x[:live], xs[:live] = q[r0:r0 + live].float(), qs[r0:r0 + live]
            x, xs = warp_lanes_succ(x.T.contiguous(), xs.T.contiguous(), dS, step, late=late)
            out[r0:r0 + live] = x.T[:live].to(q.dtype)  # ... and are never stored
            outs[r0:r0 + live] = xs.T[:live]
    return out, outs


# ---------------------------------------------------------------- phases
def panels_succ(band_in, band_in_s, q, qs, diag, dsucc, b: int, step: Step, *,
                late: bool = False):
    """``succ_panels_kernel`` of round b: (band, band_s) with block b the
    closed diagonal and the other tiles closed as row lanes, and (acol,
    acol_s) of the strip's col lanes."""
    s, n = diag.shape[-1], band_in.shape[-1]
    T, a = n // s, q.shape[0]
    split = band_split(s, T - 1 + -(-a // s), 1)
    o = slice(b * s, (b + 1) * s)
    band, band_s = band_in.clone(), band_in_s.clone()
    band[:, o], band_s[:, o] = diag, dsucc
    for u in range(T - 1):
        x0 = (u if u < b else u + 1) * s
        x = slice(x0, x0 + s)
        band[:, x], band_s[:, x] = band_lanes_succ(band_in[:, x], band_in_s[:, x], diag, dsucc,
                                                   step, col=False, split=split, late=late)
    return (band, band_s, *strip_lanes_succ(q, qs, diag, step, split=split, late=late))


def emulated_sweep_succ(d, sd, rows: np.ndarray, s: int, *, lifted: bool = False,
                        late: bool = False, check_phases: bool = False):
    """The successor sweep of (d, sd) with the emulated diag and panels
    launches and the plain relax, round by round: (dist, succ).
    check_phases: each round's diag and panels also == the port's plain
    phases."""
    n = d.shape[-1]
    step = Step(d.dtype, lifted)
    r = torch.from_numpy(rows.astype(np.int64))
    pos = positions(rows, n)
    strip, strip_s = tref._gather_strip(d, r), tref._gather_strip(sd, r)
    for b in range(n // s):
        o = slice(b * s, (b + 1) * s)
        band_in, band_in_s = overlay(d, strip, pos, b, s), overlay(sd, strip_s, pos, b, s)
        diag, dsucc = diag_blocks_succ(band_in[:, o], band_in_s[:, o], step)
        band, band_s, acol, acol_s = panels_succ(band_in, band_in_s, strip[:, o],
                                                 strip_s[:, o], diag, dsucc, b, step, late=late)
        if check_phases:
            want = tref.sweep_diag_succ_ref(d, sd, strip, strip_s, r, b, block_size=s)
            for got, x in zip((diag, dsucc), want):
                assert_same(got, x)
            for got, x in zip((band, band_s, acol, acol_s),
                              tref.sweep_panels_succ_ref(d, sd, strip, strip_s, r, *want, b)):
                assert_same(got, x)
        strip, strip_s = tref.sweep_relax_succ_ref(strip, strip_s, r, band, band_s, acol,
                                                   acol_s, b)
    return tref._scatter_strip(d, r, strip), tref._scatter_strip(sd, r, strip_s)


# ---------------------------------------------------------------- inputs


def make(kind: str, n: int, s: int, seed: int) -> np.ndarray:
    if kind == "ties":
        return tie_graph((n, n), seed)
    if kind == "nan":
        return nan_off_diagonal_tiles(random_graph((n, n), seed), s, seed)
    if kind == "planted":  # negative cycles on the last pivot block's diagonal
        return planted(tie_graph((n, n), seed), s, n // s - 1)
    return random_graph((n, n), seed)


def reference(x, succ, rows, s: int):
    wd, ws = jd.fw_repair_del_sweep_with_successors_ref(jnp.asarray(x), jnp.asarray(succ),
                                                        jnp.asarray(rows), block_size=s)
    return np.asarray(wd), np.asarray(ws)


# ------------------------------------------------------------- the cases
S_A = [(16, 8), (16, 24), (32, 16), (32, 24), (64, 8), (64, 16), (128, 8), (128, 24)]
KINDS = ("ties", "random", "nan")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("i,s,a_pad", [(i, s, a) for i, (s, a) in enumerate(S_A)])
def test_succ_sweep_emulation_matches_reference(dtype, i, s, a_pad):
    """Distances and next hops of the emulated sweep == the reference's, by
    bits; tie-heavy, random and NaN-salted weights in turn; at half of the
    cases each round's emulated diag and panels also == the plain phases."""
    kind = KINDS[(i + DTYPES.index(dtype)) % 3]
    n = sweep_size(s)
    (x, succ), (t, ts) = case(make(kind, n, s, seed=s + a_pad), dtype)
    rows = sweep_rows(n, s, a_pad, seed=a_pad + i)
    wd, ws = reference(x, succ, rows, s)
    gd, gs = emulated_sweep_succ(t, ts, rows, s, check_phases=i % 2 == 0)
    assert_same(gd, wd)
    assert_same(gs, ws)
    assert bool((ws != succ).any())  # some hop moved
    if kind == "nan":
        assert bool(torch.isnan(gd.float()).any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,a_pad", [(16, 16), (64, 24)])
def test_succ_sweep_emulation_holds_planted_diagonals(dtype, s, a_pad):
    """Where d[k][k] < 0 the owner's step-k update moves the value and the
    hop every lane takes at step k: the emulation that shuffles them before
    the update == the reference, the one that shuffles them after does
    not."""
    n = sweep_size(s)
    (x, succ), (t, ts) = case(make("planted", n, s, seed=s), dtype)
    rows = sweep_rows(n, s, a_pad, seed=s + 1)
    wd, ws = reference(x, succ, rows, s)
    gd, gs = emulated_sweep_succ(t, ts, rows, s, check_phases=True)
    assert_same(gd, wd)
    assert_same(gs, ws)
    ld, ls = emulated_sweep_succ(t, ts, rows, s, late=True)
    assert differs(ld, wd) or differs(ls, ws)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_lifted_16bit_compare_would_take_other_hops(dtype):
    """The rounding before the strict compare is needed in the sweep too:
    where a sum rounds to the current distance while its f32 value is
    smaller, the reference keeps the old hop and a compare of unrounded
    (lifted) sums takes the new one; the rounded emulation == the
    reference on the same input."""
    s, a_pad = 32, 24
    n = 3 * s
    (x, succ), (t, ts) = case(random_graph((n, n), seed=11), dtype)
    rows = sweep_rows(n, s, a_pad, seed=3)
    wd, ws = reference(x, succ, rows, s)
    gd, gs = emulated_sweep_succ(t, ts, rows, s)
    assert_same(gd, wd)
    assert_same(gs, ws)
    _, lifted_hops = emulated_sweep_succ(t, ts, rows, s, lifted=True)
    assert differs(lifted_hops, ws)


@pytest.mark.parametrize("s,b", [(32, 1), (64, 0)])
def test_row_lanes_winning_k_equals_carried_hops_on_the_overlay(s, b):
    """The row lanes' winning-k gather on the overlaid band == carrying
    ds[r][k] beside every distance through the chain (the plain
    ``close_row_panel_succ``), on tie-heavy inputs whose overlay holds strip
    rows other than d_init's."""
    n = 3 * s
    (_, _), (t, ts) = case(tie_graph((n, n), seed=5 + s), "float32")
    (_, _), (other, other_s) = case(tie_graph((n, n), seed=6 + s), "float32")
    rows = sweep_rows(n, s, 24, seed=s)
    r = torch.from_numpy(np.minimum(rows, n - 1).astype(np.int64))
    pos = positions(rows, n)
    band, band_s = overlay(t, other[r], pos, b, s), overlay(ts, other_s[r], pos, b, s)
    o = slice(b * s, (b + 1) * s)
    d, ds = tref.close_diag_succ(band[:, o], band_s[:, o])
    x = slice(((b + 1) % 3) * s, ((b + 1) % 3 + 1) * s)
    want = tref.close_row_panel_succ(band[:, x], band_s[:, x], d, ds)
    got = band_lanes_succ(band[:, x], band_s[:, x], d, ds, Step(torch.float32), col=False,
                          split=2)
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])
    assert bool((got[1] != band_s[:, x]).any())  # some hop was gathered


def test_panels_grid_matches_the_plain_sweeps():
    """The successor panels take the plain sweep's grid: n = 4096, s = 128
    (the successor repair_del's): 31 band tiles cut in four, strip CTAs of
    32 rows (a_pad 8, 64, 256: 125, 126, 132 CTAs of two warps); at a_pad =
    512, 35 tiles' worth, cut in two (70 CTAs of four warps)."""
    for a, split, ctas in ((8, 4, 125), (64, 4, 126), (256, 4, 132), (512, 2, 70)):
        T = 4096 // 128
        assert band_split(128, T - 1 + -(-a // 128), 1) == split
        assert (T - 1) * split + -(-a * split // 128) == ctas <= 132
