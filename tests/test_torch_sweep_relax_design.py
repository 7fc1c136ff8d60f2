"""The restricted sweep's relax kernels, emulated in plain torch, vs the JAX reference.

The sweep's relax (``csrc/fw_repair_del.cuh``) relaxes the (a_pad, n) strip
of affected rows against acol ⊗ band, k ascending: every element starts
from acol in block column b, else from the strip; then the strip rows whose
matrix row lies in pivot block b take their band row whole; padding rows
(index n) are relaxed like the others.  It runs on one of two tiles, picked
by the strip's shape (``kernels.fw_repair_del.relax_height``):

  * long strips (128 tiles of 128 x 128 or more), ``relax_kernel`` /
    ``succ_relax_kernel``: the matmul mainloop's 128 x 128 tiles (128 x 64
    with next hops), acol rows past a_pad and band columns past n loaded as
    0, k in slices of ``kBKOf`` (16 in 4-byte storages, 8 in 2-byte ones;
    8 with next hops);
  * short strips, ``short_relax_kernel`` / ``short_succ_relax_kernel``: a
    tile H = 8 or 16 rows high (the strip in a_pad / H tiles), a warp
    owning 16 columns and lane (rg, cg) the H/8 rows from rg·H/8 by 4
    columns, CTAs of 4, 2 or 1 warps (the most that leaves one CTA an SM of
    the H100's 132: ``short_warps``), the CTA's acol slice staged whole and
    the band in 16-deep slices, zero past n.

With next hops an element keeps only the k of its last strict improvement
(-1: none), every candidate rounded to the storage before its compare, and
gathers acol_s[r, k] once after the fold, or keeps the start's hop.

The emulations follow those loops tile by tile and slice by slice.  The
relax alone is held by bits to the reference's phase 3 (its ``_relax_tile``
/ ``_relax_succ`` on the strip with acol spliced in, then the band-row
splice, as ``fw_repair_del_sweep_ref`` / ``..._with_successors_ref`` run it),
on the port's plain diag and panels of a real round; the whole sweep with
the emulated relax is held by bits to the reference's sweep: s 16 .. 128,
a_pad 8, 16, 24, 64, 136 and 256 (rows in every pivot block and a padding
row), both tiles at every height, f32 and every sweep storage, tie-heavy,
NaN-salted and ±0-planted inputs (none subnormal).  A hop gathered from
the first or the last tying k is shown to differ.  The kernels themselves
are held to the plain phases on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.core import semiring as jsr
from repro.kernels import fw_repair_del as jd
from repro.kernels import fw_round as jfr
from repro_torch.core import semiring as tsr
from repro_torch.kernels import fw_repair_del as fd
from repro_torch.kernels import ref as tref
from repro_torch.utils.interop import to_numpy
from test_torch_relax_design import KEPT, SUCC_COLS, SUCC_DEPTH, TILE, slice_depth
from test_torch_semiring import (
    assert_same,
    from_port,
    semiring_graph,
    storage_data,
    storage_semiring,
    to_port,
)
from test_torch_succ_chain_design import (  # noqa: F401  (one_thread: the autouse fixture)
    case,
    differs,
    one_thread,
    tie_graph,
)
from test_torch_sweep_design import sweep_rows

SMS = 132  # the H100's SMs: short_warps' grid rule
SHORT_BK, SHORT_COLS = 16, 16  # the short tile's slice depth and a warp's columns
A_PADS = (8, 16, 24, 64, 136, 256)
S_ALL = (16, 32, 64, 128)


# ----------------------------------------------------------------- tiles
def short_warps(n: int, tiles: int) -> int:
    """``short_warps``: the most of 4, 2, 1 warps a CTA that leaves at
    least one CTA an SM."""
    warps = 4
    while warps > 1 and -(-n // (SHORT_COLS * warps)) * tiles < SMS:
        warps //= 2
    return warps


def lane_rows(H: int) -> torch.Tensor:
    """The tile rows of lane group rg's registers, rg·R + i (R = H/8), in
    (rg, i) order; a permutation of the tile's H rows."""
    R = H // 8
    perm = torch.tensor([rg * R + i for rg in range(8) for i in range(R)])
    assert sorted(perm.tolist()) == list(range(H))
    return perm


def starts(strip, acol, b: int):
    """start(r, c): acol in block column b, else the strip."""
    s = acol.shape[-1]
    out = strip.clone()
    out[:, b * s:(b + 1) * s] = acol
    return out


def padded(x, rows: int, cols: int):
    """x in the top left of a (rows, cols) tile of zeros (what rows past a
    and columns past n load)."""
    out = torch.zeros((rows, cols), dtype=x.dtype)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def tile_plan(a: int, n: int, height: int, succ: bool):
    """(rows, cols, depth, perm) of the launch's tiles: the mainloop's
    128 x 128 (128 x 64 with next hops) or the short tile's H x W, its
    slice depth, and the lane order of its rows (None: the mainloop's)."""
    if height == fd.LONG_HEIGHT:
        return TILE, SUCC_COLS if succ else TILE, None, None
    W = SHORT_COLS * short_warps(n, -(-a // height))
    return height, W, SHORT_BK, lane_rows(height)


def tiles_of(a: int, n: int, rows: int, cols: int):
    for i0 in range(0, a, rows):
        for j0 in range(0, n, cols):
            yield slice(i0, min(i0 + rows, a)), slice(j0, min(j0 + cols, n))


def in_block(rows, b: int, s: int):
    local = torch.as_tensor(rows, dtype=torch.int64) - b * s
    return (local >= 0) & (local < s), local


def relax_tiled(strip, rows, band, acol, b: int, semiring, height: int):
    """The plain relax launch at tile height ``height``: each tile from its
    start, k ascending slice by slice, acol rows past a and band columns
    past n loaded as 0; then the live part stored, the band row for a strip
    row inside block b."""
    a, n = strip.shape
    s = acol.shape[-1]
    TR, TC, depth, perm = tile_plan(a, n, height, succ=False)
    depth = depth or slice_depth(strip.dtype)
    init, out = starts(strip, acol, b), strip.clone()
    blk, local = in_block(rows, b, s)
    for ri, ci in tiles_of(a, n, TR, TC):
        A = padded(acol[ri], TR, s)  # the staged acol slice
        acc = padded(init[ri, ci], TR, TC)
        if perm is not None:  # lane order: rg, then the lane's rows
            A, acc = A[perm], acc[perm]
        for k0 in range(0, s, depth):
            B = padded(band[k0:k0 + depth, ci], depth, TC)  # the band slice
            for kk in range(depth):
                acc = semiring.relax(acc, A[:, k0 + kk, None], B[kk, None, :])
        if perm is not None:
            acc = acc[torch.argsort(perm)]
        live = acc[:ri.stop - ri.start, :ci.stop - ci.start]
        r = torch.arange(ri.start, ri.stop)
        out[ri, ci] = torch.where(blk[r, None], band[local[r].clamp(0, s - 1)][:, ci], live)
    return out


def relax_succ_tiled(strip, strip_s, rows, band, band_s, acol, acol_s, b: int, height: int,
                     *, gather: str = "strict"):
    """The successor relax launch at tile height ``height``: distances with
    the strict step, the k of each element's last strict improvement, then
    one gather of acol_s[r, k] (the start's hop where no k improved); the
    band and band_s rows for a strip row inside block b.  gather "last_tie":
    the k of the last candidate that ties or improves; "first_tie": the
    first k whose candidate equals the final distance (variants the kernels
    do not take)."""
    a, n = strip.shape
    s = acol.shape[-1]
    TR, TC, depth, perm = tile_plan(a, n, height, succ=True)
    depth = depth or SUCC_DEPTH
    step = tsr.SEMIRINGS["min_plus"].mul
    init, hop0 = starts(strip, acol, b), starts(strip_s, acol_s, b)
    out, outs = strip.clone(), strip_s.clone()
    blk, local = in_block(rows, b, s)
    for ri, ci in tiles_of(a, n, TR, TC):
        A = padded(acol[ri], TR, s)
        acc = padded(init[ri, ci], TR, TC)
        if perm is not None:
            A, acc = A[perm], acc[perm]
        ks = torch.full(acc.shape, KEPT, dtype=torch.int64)
        cands = []
        for k0 in range(0, s, depth):
            B = padded(band[k0:k0 + depth, ci], depth, TC)
            for kk in range(depth):
                cand = step(A[:, k0 + kk, None], B[kk, None, :])
                better = cand < acc
                ks = torch.where((cand <= acc) if gather == "last_tie" else better, k0 + kk, ks)
                acc = torch.where(better, cand, acc)
                cands.append(cand)
        if gather == "first_tie":
            ks = torch.full(acc.shape, KEPT, dtype=torch.int64)
            for k, cand in enumerate(cands):
                ks = torch.where((cand == acc) & (ks == KEPT), k, ks)
        if perm is not None:
            back = torch.argsort(perm)
            acc, ks = acc[back], ks[back]
        nr, nc = ri.stop - ri.start, ci.stop - ci.start
        live, ks = acc[:nr, :nc], ks[:nr, :nc]
        gathered = torch.gather(acol_s[ri].long(), 1, ks.clamp(min=0)).to(strip_s.dtype)
        hops = torch.where(ks == KEPT, hop0[ri, ci], gathered)
        r = torch.arange(ri.start, ri.stop)
        at = local[r].clamp(0, s - 1)
        out[ri, ci] = torch.where(blk[r, None], band[at][:, ci], live)
        outs[ri, ci] = torch.where(blk[r, None], band_s[at][:, ci], hops)
    return out, outs


# ------------------------------------------------------------- reference
@functools.cache
def reference_relax(storage: str, name: str, b: int, s: int):
    """The reference's phase 3 of round b, jitted: the strip with acol
    spliced in, ``_relax_tile`` against acol ⊗ band in the reference's bk
    chunks, then the band rows of the strip rows inside block b."""
    sr = jsr.SEMIRINGS[name] if storage == "float32" else storage_semiring(storage, name, jsr)

    def relax(strip, rows, band, acol):
        local = rows - b * s
        in_blk = (local >= 0) & (local < s)
        A = jax.lax.dynamic_update_slice(strip, acol, (0, b * s))
        A = jfr._relax_tile(A, acol, band, s, min(32, s), sr, "fori")
        closed = jnp.take(band, jnp.where(in_blk, local, 0), axis=0, mode="clip")
        return jnp.where(in_blk[:, None], closed, A)

    return jax.jit(relax)


@functools.cache
def reference_relax_succ(b: int, s: int):
    """The reference successor sweep's p3 of round b, jitted."""

    def relax(strip, strip_s, rows, band, band_s, acol, acol_s):
        local = rows - b * s
        in_blk = (local >= 0) & (local < s)
        A = jax.lax.dynamic_update_slice(strip, acol, (0, b * s))
        As = jax.lax.dynamic_update_slice(strip_s, acol_s, (0, b * s))
        A, As = jax.lax.fori_loop(
            0, s, lambda k, c: jfr._relax_succ(k, *c, acol, acol_s, band), (A, As))
        safe = jnp.where(in_blk, local, 0)
        return (jnp.where(in_blk[:, None], jnp.take(band, safe, axis=0, mode="clip"), A),
                jnp.where(in_blk[:, None], jnp.take(band_s, safe, axis=0, mode="clip"), As))

    return jax.jit(relax)


# ---------------------------------------------------------------- inputs
def size(s: int, a_pad: int) -> int:
    """n: three pivot blocks (two at s = 128), more where the strip needs
    them (a_pad - 1 distinct real rows)."""
    return s * max(3 if s < 128 else 2, -(-a_pad // s) + (a_pad % s == 0))


def salted(name: str, n: int, s: int, salt: str, seed: int) -> np.ndarray:
    """An f32 graph of ``semiring_graph``'s domain: "ties" rounds the
    weights to a few integers (equal candidates everywhere), "nan" puts
    NaNs outside the diagonal tiles, "zeros" turns a fifth of the finite
    off-diagonal entries into +0 or -0."""
    rng = np.random.default_rng(seed)
    w = semiring_graph(name, (n, n), seed)
    off = ~np.eye(n, dtype=bool)
    if salt == "ties" and name != "or_and":
        fin = np.isfinite(w) & off
        w[fin] = np.floor(np.abs(w[fin]) / 3.0) + 1.0
    elif salt == "nan":
        placed = 0
        while placed < 4:
            i, j = (int(v) for v in rng.integers(0, n, 2))
            if i // s != j // s:
                w[i, j] = np.nan
                placed += 1
    elif salt == "zeros":
        hit = np.isfinite(w) & off & (rng.uniform(size=w.shape) < 0.2)
        w[hit] = np.where(rng.uniform(size=w.shape) < 0.5, 0.0, -0.0)[hit]
    return w


FLOATS = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
SALTS = ("ties", "nan", "zeros")


def storage_input(storage: str, name: str, n: int, s: int, i: int) -> np.ndarray:
    """Case i's input in the storage: the float storages salted in turn,
    the others as ``storage_data`` makes them (sentinels, words)."""
    if storage in FLOATS:
        w = salted(name, n, s, SALTS[i % 3], seed=100 + i)
        return np.asarray(jnp.asarray(w, FLOATS[storage]))
    return storage_data(storage, name, (n, n), seed=100 + i)


def succ_input(dtype: str, n: int, s: int, salt: str, seed: int):
    """(numpy (x, succ), port (t, ts)) of a min-plus graph: tie-heavy, NaN
    off the diagonal tiles, or tie-heavy with ±0 weights."""
    w = tie_graph((n, n), seed)
    if salt != "ties":
        w = salted("min_plus", n, s, salt, seed) if salt == "nan" else w
    if salt == "zeros":
        rng = np.random.default_rng(seed)
        hit = np.isfinite(w) & ~np.eye(n, dtype=bool) & (rng.uniform(size=w.shape) < 0.2)
        w[hit] = np.where(rng.uniform(size=w.shape) < 0.5, 0.0, -0.0)[hit]
    return case(w, dtype)


def round_inputs(t, rows: np.ndarray, b: int, s: int, sr):
    """The strip as gathered and round b's band and acol from the port's
    plain diag and panels."""
    r = torch.from_numpy(rows.astype(np.int64))
    strip = tref._gather_strip(t, r)
    diag = tref.sweep_diag_ref(t, strip, r, b, block_size=s, semiring=sr)
    band, acol = tref.sweep_panels_ref(t, strip, r, diag, b, semiring=sr)
    return strip, band, acol


def heights(a_pad: int, n: int):
    """The height ``relax_height`` picks on the strip, then the long tile
    and the other short one (the sizes here are too small for the rule to
    take the long tile)."""
    auto = fd.relax_height(a_pad, n)
    assert auto != fd.LONG_HEIGHT
    return auto, fd.LONG_HEIGHT, next(h for h in fd.SHORT_HEIGHTS if h != auto)


# --------------------------------------------------------------- layout
def test_relax_height_takes_the_mainloop_once_its_grid_fills_the_card():
    """The short tile, 8 rows for a strip of 8 and 16 past that, until the
    mainloop has 128 tiles of 128 x 128 (the A/B's picks)."""
    a_pads = (8, 16, 24, 64, 128, 256, 512, 4096)
    assert [fd.relax_height(a, 4096) for a in a_pads] == [8, 16, 16, 16, 16, 16, 128, 128]
    assert [fd.relax_height(a, 8192) for a in a_pads] == [8, 16, 16, 16, 16, 128, 128, 128]
    assert [fd.relax_height(a, 384) for a in (136, 256)] == [16, 16]
    assert fd.relax_height(128, 16384) == 128


@pytest.mark.parametrize("H", fd.SHORT_HEIGHTS)
def test_lane_rows_cover_the_short_tile(H):
    """Each lane group rg holds R = H/8 consecutive rows, read as one 4- or
    8-byte load of a k; the warp's 8 row groups cover the tile's H rows."""
    assert fd.SHORT_HEIGHTS == (8, 16)
    perm = lane_rows(H).reshape(8, H // 8)
    assert (perm[:, 0] == torch.arange(8) * (H // 8)).all()


def test_short_grid_covers_the_card():
    """a_pad 8 .. 64 (one row tile): n = 8192 takes CTAs of 2 warps, n = 4096
    of 1, 256 CTAs either way; two row tiles at n = 4096 take 2 warps."""
    assert [short_warps(n, t) for n, t in ((8192, 1), (4096, 1), (4096, 2), (1 << 16, 1))] == [
        2, 1, 2, 4]
    for n, t in ((8192, 1), (4096, 1)):
        assert -(-n // (SHORT_COLS * short_warps(n, t))) * t == 256 >= SMS


# --------------------------------------------------------- the relax alone
PLAIN = ([("float32", n) for n in ("min_plus", "max_plus", "max_min", "or_and")]
         + [(dt, n) for dt in ("bfloat16", "float16")
            for n in ("min_plus", "max_plus", "max_min", "or_and")]
         + [("int16", n) for n in ("min_plus", "max_plus", "max_min", "or_and")]
         + [("packed", "or_and"), ("uint32", "or_and"), ("int8", "or_and")])
RELAX_CASES = [(i, storage, name, S_ALL[(i + j) % 4], a)
               for i, (storage, name) in enumerate(PLAIN)
               for j, a in enumerate(A_PADS) if (i + j) % 2 == 0 or a in (8, 256)]


@pytest.mark.parametrize("i,storage,name,s,a_pad", RELAX_CASES,
                         ids=[f"{st}-{nm}-s{s}-a{a}" for _, st, nm, s, a in RELAX_CASES])
def test_relax_tiles_match_reference_relax(i, storage, name, s, a_pad):
    """Both tiles == the reference's phase 3 of a real round, by bits, in
    every sweep storage (an integer or_and on its int32 carrier)."""
    n = size(s, a_pad)
    x = storage_input(storage, name, n, s, i)
    rows = sweep_rows(n, s, a_pad, seed=i)
    b = int(rows[0]) // s  # the first row's block: strip rows inside it
    sr_t = tsr.SEMIRINGS[name] if storage == "float32" else storage_semiring(storage, name)
    t, sr, dt = to_port(x, sr_t)
    strip, band, acol = round_inputs(t, rows, b, s, sr)
    as_np = lambda v: to_numpy(from_port(v, dt, sr_t))  # noqa: E731
    want = np.asarray(reference_relax(storage, name, b, s)(
        jnp.asarray(as_np(strip)), jnp.asarray(rows), jnp.asarray(as_np(band)),
        jnp.asarray(as_np(acol))))
    for h in heights(a_pad, n):
        got = relax_tiled(strip, rows, band, acol, b, sr, h)
        assert_same(from_port(got, dt, sr_t), want)
    assert_same(from_port(tref.sweep_relax_ref(strip, rows, band, acol, b, semiring=sr), dt,
                          sr_t), want)


SUCC_CASES = [(dt, S_ALL[(i + j) % 4], a, SALTS[(i + j) % 3])
              for i, dt in enumerate(("float32", "bfloat16", "float16"))
              for j, a in enumerate(A_PADS)]


@pytest.mark.parametrize("dtype,s,a_pad,salt", SUCC_CASES,
                         ids=[f"{dt}-s{s}-a{a}-{salt}" for dt, s, a, salt in SUCC_CASES])
def test_succ_relax_tiles_match_reference_relax(dtype, s, a_pad, salt):
    """Both tiles with the kept-k gather == the reference successor sweep's
    p3 of a real round, distances and next hops, by bits."""
    n = size(s, a_pad)
    (x, xs), (t, ts) = succ_input(dtype, n, s, salt, seed=s + a_pad)
    rows = sweep_rows(n, s, a_pad, seed=a_pad)
    b = int(rows[0]) // s
    r = torch.from_numpy(rows.astype(np.int64))
    strip, strip_s = tref._gather_strip(t, r), tref._gather_strip(ts, r)
    diag = tref.sweep_diag_succ_ref(t, ts, strip, strip_s, r, b, block_size=s)
    band, band_s, acol, acol_s = tref.sweep_panels_succ_ref(t, ts, strip, strip_s, r, *diag, b)
    args = [jnp.asarray(to_numpy(v)) for v in (strip, strip_s)] + [jnp.asarray(rows)] + [
        jnp.asarray(to_numpy(v)) for v in (band, band_s, acol, acol_s)]
    wd, ws = (np.asarray(v) for v in reference_relax_succ(b, s)(*args))
    for h in heights(a_pad, n):
        gd, gs = relax_succ_tiled(strip, strip_s, rows, band, band_s, acol, acol_s, b, h)
        assert_same(gd, wd)
        assert_same(gs, ws)
    assert bool((ws != to_numpy(strip_s)).any())  # some hop moved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gather", ["first_tie", "last_tie"])
def test_tying_k_gathers_would_take_other_hops(dtype, gather):
    """On a tie-heavy input the hop of the last strict improvement is the
    reference's; the hop of the first or the last tying candidate is not
    (on both tiles)."""
    s, a_pad = 32, 64
    n = size(s, a_pad)
    (x, xs), (t, ts) = succ_input(dtype, n, s, "ties", seed=7)
    rows = sweep_rows(n, s, a_pad, seed=5)
    b = int(rows[0]) // s
    r = torch.from_numpy(rows.astype(np.int64))
    strip, strip_s = tref._gather_strip(t, r), tref._gather_strip(ts, r)
    diag = tref.sweep_diag_succ_ref(t, ts, strip, strip_s, r, b, block_size=s)
    bufs = tref.sweep_panels_succ_ref(t, ts, strip, strip_s, r, *diag, b)
    want = tref.sweep_relax_succ_ref(strip, strip_s, r, *bufs, b)
    for h in heights(a_pad, n):
        gd, gs = relax_succ_tiled(strip, strip_s, rows, *bufs, b, h)
        assert_same(gd, want[0])
        assert_same(gs, want[1])
        _, other = relax_succ_tiled(strip, strip_s, rows, *bufs, b, h, gather=gather)
        assert differs(other, to_numpy(want[1]))


# -------------------------------------------------------- the whole sweep
def emulated_sweep(t, rows: np.ndarray, s: int, sr, height: int | None = None):
    """The sweep with the port's plain diag and panels and the emulated
    relax at ``height`` (None: ``relax_height``), round by round."""
    n = t.shape[-1]
    r = torch.from_numpy(rows.astype(np.int64))
    strip = tref._gather_strip(t, r)
    h = height or fd.relax_height(len(rows), n)
    for b in range(n // s):
        diag = tref.sweep_diag_ref(t, strip, r, b, block_size=s, semiring=sr)
        band, acol = tref.sweep_panels_ref(t, strip, r, diag, b, semiring=sr)
        strip = relax_tiled(strip, rows, band, acol, b, sr, h)
    return tref._scatter_strip(t, r, strip)


def emulated_sweep_succ(t, ts, rows: np.ndarray, s: int, height: int | None = None):
    n = t.shape[-1]
    r = torch.from_numpy(rows.astype(np.int64))
    strip, strip_s = tref._gather_strip(t, r), tref._gather_strip(ts, r)
    h = height or fd.relax_height(len(rows), n)
    for b in range(n // s):
        diag = tref.sweep_diag_succ_ref(t, ts, strip, strip_s, r, b, block_size=s)
        bufs = tref.sweep_panels_succ_ref(t, ts, strip, strip_s, r, *diag, b)
        strip, strip_s = relax_succ_tiled(strip, strip_s, rows, *bufs, b, h)
    return tref._scatter_strip(t, r, strip), tref._scatter_strip(ts, r, strip_s)


SWEEP_CASES = [(i, storage, name, S_ALL[i % 4], A_PADS[i % 6])
               for i, (storage, name) in enumerate(PLAIN)]


@pytest.mark.parametrize("i,storage,name,s,a_pad", SWEEP_CASES,
                         ids=[f"{st}-{nm}-s{s}-a{a}" for _, st, nm, s, a in SWEEP_CASES])
def test_sweep_with_tiled_relax_matches_reference_sweep(i, storage, name, s, a_pad):
    n = size(s, a_pad)
    x = storage_input(storage, name, n, s, i + 50)
    rows = sweep_rows(n, s, a_pad, seed=i + 50)
    sr_j = jsr.SEMIRINGS[name] if storage == "float32" else storage_semiring(storage, name, jsr)
    want = np.asarray(jd.fw_repair_del_sweep_ref(jnp.asarray(x), jnp.asarray(rows),
                                                 block_size=s, semiring=sr_j))
    sr_t = tsr.SEMIRINGS[name] if storage == "float32" else storage_semiring(storage, name)
    t, sr, dt = to_port(x, sr_t)
    assert_same(from_port(emulated_sweep(t, rows, s, sr), dt, sr_t), want)


SUCC_SWEEP_CASES = [(dt, s, a, SALTS[i % 3])
                    for i, (dt, s, a) in enumerate(
                        [(dt, s, a) for dt in ("float32", "bfloat16", "float16")
                         for s, a in ((16, 24), (32, 64), (64, 136), (128, 256))])]


@pytest.mark.parametrize("dtype,s,a_pad,salt", SUCC_SWEEP_CASES,
                         ids=[f"{dt}-s{s}-a{a}-{salt}" for dt, s, a, salt in SUCC_SWEEP_CASES])
def test_succ_sweep_with_tiled_relax_matches_reference_sweep(dtype, s, a_pad, salt):
    n = size(s, a_pad)
    (x, xs), (t, ts) = succ_input(dtype, n, s, salt, seed=3 * s + a_pad)
    rows = sweep_rows(n, s, a_pad, seed=s)
    wd, ws = jd.fw_repair_del_sweep_with_successors_ref(jnp.asarray(x), jnp.asarray(xs),
                                                        jnp.asarray(rows), block_size=s)
    gd, gs = emulated_sweep_succ(t, ts, rows, s)
    assert_same(gd, np.asarray(wd))
    assert_same(gs, np.asarray(ws))
    assert bool((np.asarray(ws) != xs).any())  # some hop moved
