"""The restricted sweep's diag and panels kernels, emulated in plain torch, vs
the JAX reference.

The sweep's diag kernel (``csrc/fw_repair_del.cuh:diag_kernel``) runs the
fused round's ``close_tile_blocks`` on the overlaid pivot tile: each row
of the tile is read through ``band_row`` (the strip row where the matrix
row is affected, ``pos[o + r] >= 0``, else the ``d_init`` row).  Its
panels kernel (``panels_kernel``) runs ``close_band_lanes``: the band's
T - 1 tiles as row panels, each cut into ``band_split`` CTAs that stage the
closed diagonal for themselves; and the strip's block column b as col
panels, in CTAs of s / split strip rows, 16 a warp, after the band's CTAs.
A strip row past a_pad loads 0 and is never stored, and a warp that holds
none of the strip's rows leaves after the staging.

The emulations follow those loops and index maps (``diag_blocks``,
``band_lanes`` and ``band_split`` of ``test_torch_chain_design.py`` for the
parts the two kernel families share, ``strip_lanes`` below for the strip
CTAs), then the relax phase runs as the port's plain version
(``kernels.ref.sweep_relax_ref``), round by round.  The whole sweep is held
by bits to the reference's XLA twin
``repro.kernels.fw_repair_del.fw_repair_del_sweep_ref`` on numpy inputs
from a seed: s 16 .. 128, strips of 8, 16 and 24 rows with rows inside
every pivot block and a padding row, the four idempotent semirings in f32
and every sweep storage (int16 ×4, bf16 / f16 ×4, one packed word plane,
the int32 carrier of an integer or_and), and planted diagonals that are
not the ⊗-identity, where a shuffled value read after its owner's update
differs.  The kernels themselves are held to the plain phases on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.core import semiring as jsr
from repro.kernels import fw_repair_del as jd
from repro_torch.core import semiring as tsr
from repro_torch.kernels import ref as tref
from test_torch_chain_design import (  # noqa: F401  (one_thread: the autouse fixture)
    Arith,
    band_lanes,
    band_split,
    diag_blocks,
    one_thread,
    planted,
)
from test_torch_semiring import (
    assert_same,
    from_port,
    semiring_graph,
    storage_data,
    storage_semiring,
    to_port,
)

IDEMPOTENT = ("max_min", "max_plus", "min_plus", "or_and")


# --------------------------------------------------------------- the rows
def sweep_rows(n: int, s: int, a_pad: int, seed: int) -> np.ndarray:
    """a_pad strip rows as the engine passes them: sorted real rows, one in
    every pivot block at least, row n - 1 among them (what a padding row
    gathers), then one padding row (index n)."""
    rng = np.random.default_rng(seed)
    firsts = [b * s + int(rng.integers(0, s)) for b in range(n // s)] + [n - 1]
    rest = np.setdiff1d(np.arange(n), firsts)
    real = np.sort(np.concatenate([np.unique(firsts),
                                   rng.choice(rest, a_pad - 1 - len(set(firsts)),
                                              replace=False)]))
    assert real.size == a_pad - 1
    return np.append(real, n).astype(np.int32)


def positions(rows: np.ndarray, n: int) -> np.ndarray:
    """``pos``: the strip row holding each matrix row, -1 for none."""
    pos = np.full(n, -1, np.int64)
    real = rows < n
    pos[rows[real]] = np.flatnonzero(real)
    return pos


# ----------------------------------------------------------------- phases
def overlay(d, strip, pos, b: int, s: int) -> torch.Tensor:
    """The (s, n) band rows of round b as the kernels read them: row r is
    ``band_row``'s, strip[pos[o + r]] where it is >= 0, else d[o + r]."""
    o = b * s
    return torch.stack([strip[pos[o + r]] if pos[o + r] >= 0 else d[o + r] for r in range(s)])


def warp_lanes(x: torch.Tensor, dS: torch.Tensor, ar: Arith, *, late: bool) -> torch.Tensor:
    """One warp of ``close_band_lanes<S, true>`` (the col panel): x (s, 16)
    holds 16 chains (strip rows), lane (rg, cg) rows rg·s/8 .. of chains
    4cg ..; at step k each chain's own value at k comes by shuffle from
    lane (k // (s/8), cg), register k % (s/8), before its owner updates
    it; dS[k] (the staged diagonal's row k, lifted) gives the operands.
    late: the owner's updated value instead."""
    s = x.shape[0]
    RL = s // 8
    regs = x.reshape(8, RL, 4, 4)  # [rg, i, cg, j]
    for kb in range(8):
        for kk in range(RL):
            k = kb * RL + kk
            sh = ar.lift(regs[kb, kk])  # (cg, j)
            dv = dS[k].reshape(8, RL)[:, :, None, None]
            new = ar.relax(regs, sh[None, None], dv)
            if late:
                new = ar.relax(regs, ar.lift(new[kb, kk])[None, None], dv)
            regs = new
    return regs.reshape(s, 16)


def strip_lanes(q: torch.Tensor, diag: torch.Tensor, semiring, *, split: int,
                late: bool = False) -> torch.Tensor:
    """``panels_kernel``'s strip CTAs on the strip's block column q (a_pad,
    s): CTA i holds strip rows i·R .. (R = s / split), warp v of it 16 of
    them; each CTA stages the diagonal, lifted, as it lies."""
    a, s = q.shape
    R = s // split
    ar = Arith(semiring, q.dtype)
    out = torch.empty_like(q)
    for cta in range(-(-a * split // s)):
        dS = ar.lift(ar.acc(diag))
        for v in range(R // 16):
            r0 = cta * R + 16 * v
            if r0 >= a:
                continue  # none of the strip's rows: the warp leaves
            live = min(a - r0, 16)  # a multiple of 8: a lane's 4 rows all or none
            x = ar.acc(torch.zeros((16, s), dtype=q.dtype))  # masked rows load 0
            x[:live] = ar.acc(q[r0:r0 + live])
            x = warp_lanes(x.T.contiguous(), dS, ar, late=late).T
            out[r0:r0 + live] = ar.out(x[:live])  # masked rows are never stored
    return out


def panels(band_in, q, diag, b: int, semiring, *, late: bool = False):
    """``panels_kernel`` of round b: (band with block b the diagonal and
    the other tiles closed, acol)."""
    s, n = diag.shape[-1], band_in.shape[-1]
    T, a = n // s, q.shape[0]
    split = band_split(s, T - 1 + -(-a // s), 1)
    band = band_in.clone()
    band[:, b * s:(b + 1) * s] = diag
    for u in range(T - 1):
        x = slice((u if u < b else u + 1) * s, (u if u < b else u + 1) * s + s)
        band[:, x] = band_lanes(band_in[:, x], diag, semiring, col=False, split=split,
                                late=late)
    return band, strip_lanes(q, diag, semiring, split=split, late=late)


def emulated_sweep(d: torch.Tensor, rows: np.ndarray, s: int, semiring, *, bk: int = 32,
                   late: bool = False, check_phases: bool = False) -> torch.Tensor:
    """The sweep of d with the emulated diag and panels launches and the
    plain relax, round by round; check_phases: each round's diag and panels
    also == the port's plain phases."""
    n = d.shape[-1]
    r = torch.from_numpy(rows.astype(np.int64))
    pos = positions(rows, n)
    strip = tref._gather_strip(d, r)
    for b in range(n // s):
        o = slice(b * s, (b + 1) * s)
        band_in = overlay(d, strip, pos, b, s)
        diag = diag_blocks(band_in[:, o], semiring)
        band, acol = panels(band_in, strip[:, o], diag, b, semiring, late=late)
        if check_phases:
            want = tref.sweep_diag_ref(d, strip, r, b, block_size=s, semiring=semiring)
            assert_same(diag, want)
            for got, x in zip((band, acol), tref.sweep_panels_ref(d, strip, r, want, b,
                                                                   semiring=semiring)):
                assert_same(got, x)
        strip = tref.sweep_relax_ref(strip, r, band, acol, b, bk=bk, semiring=semiring)
    return tref._scatter_strip(d, r, strip)


# ------------------------------------------------------------- the layout
def test_panels_grid_fills_the_card():
    """n = 8192, s = 128: 63 band tiles cut in two and one strip CTA at
    a_pad = 8 or 64 (127 CTAs of 4 warps), four at 256 (130); n = 2s: one
    tile in four; s = 16 keeps one warp a tile."""
    for n, a, split, ctas in ((8192, 8, 2, 127), (8192, 64, 2, 127), (8192, 256, 2, 130),
                              (256, 8, 4, 5)):
        T = n // 128
        assert band_split(128, T - 1 + -(-a // 128), 1) == split
        assert (T - 1) * split + -(-a * split // 128) == ctas <= 132
    assert band_split(16, 1 + 1, 1) == 1


@pytest.mark.parametrize("s,a_pad", [(16, 8), (32, 24), (64, 16), (128, 8)])
def test_sweep_rows_cover_every_block_and_pad(s, a_pad):
    n = 3 * s
    rows = sweep_rows(n, s, a_pad, seed=s)
    real = rows[rows < n]
    assert rows.size == a_pad and rows[-1] == n and n - 1 in real
    assert np.unique(real).size == real.size and set(real // s) == {0, 1, 2}


# ------------------------------------------------------------- the cases
S_A = [(s, a) for s in (16, 32, 64, 128) for a in (8, 16, 24)]
# min_plus at every (s, a_pad); each other semiring at four of them, one a s.
F32_CASES = ([("min_plus", s, a) for s, a in S_A]
             + [(name, s, a) for i, name in enumerate(("max_min", "max_plus", "or_and"))
                for s, a in S_A[i::3]])


def sweep_size(s: int) -> int:
    """n: three pivot blocks (two band tiles), two at s = 128."""
    return 3 * s if s < 128 else 2 * s


@pytest.mark.parametrize("name,s,a_pad", F32_CASES)
def test_sweep_emulation_matches_reference(name, s, a_pad):
    """f32: the emulated phases == the port's plain phases each round, and
    the sweep == the reference's, by bits."""
    n = sweep_size(s)
    d = semiring_graph(name, (n, n), seed=s + a_pad)
    rows = sweep_rows(n, s, a_pad, seed=a_pad)
    want = jd.fw_repair_del_sweep_ref(jnp.asarray(d), jnp.asarray(rows), block_size=s,
                                      semiring=jsr.SEMIRINGS[name])
    got = emulated_sweep(torch.from_numpy(d), rows, s, tsr.SEMIRINGS[name], check_phases=True)
    assert_same(got, want)


LOWERED = ([("int16", name) for name in IDEMPOTENT]
           + [(dt, name) for dt in ("bfloat16", "float16") for name in IDEMPOTENT]
           + [("packed", "or_and"), ("uint32", "or_and"), ("int8", "or_and")])


@pytest.mark.parametrize("i,case", list(enumerate(LOWERED)),
                         ids=lambda c: "-".join(c) if isinstance(c, tuple) else str(c))
def test_sweep_emulation_matches_reference_lowered(i, case):
    """Every storage the sweep kernels take (an integer or_and on its int32
    carrier), s cycling through 16 .. 128 and a_pad through 8, 16, 24."""
    storage, name = case
    s, a_pad = (16, 32, 64, 128)[i % 4], (8, 16, 24)[i % 3]
    n = sweep_size(s)
    x = storage_data(storage, name, (n, n), seed=60 + i)
    rows = sweep_rows(n, s, a_pad, seed=i)
    want = jd.fw_repair_del_sweep_ref(jnp.asarray(x), jnp.asarray(rows), block_size=s,
                                      semiring=storage_semiring(storage, name, jsr))
    t, sr, dt = to_port(x, storage_semiring(storage, name))
    got = emulated_sweep(t, rows, s, sr, check_phases=i % 2 == 0)
    assert_same(from_port(got, dt, storage_semiring(storage, name)), np.asarray(want))


@pytest.mark.parametrize("storage,name,s,a_pad", [
    ("float32", "min_plus", 128, 16), ("float32", "max_plus", 64, 8),
    ("int16", "min_plus", 16, 24), ("float16", "min_plus", 32, 8),
    ("bfloat16", "max_plus", 64, 16)])
def test_sweep_emulation_holds_planted_diagonals(storage, name, s, a_pad):
    """Where d[k][k] is not 1̄ (negative self-loops under min_plus, positive
    under max_plus) the owner's step-k update moves the value it shuffles:
    the emulation that shuffles it before the update == the reference, the
    one that shuffles it after does not."""
    n = sweep_size(s)
    x = planted(storage, name, (n, n), s, 1, seed=s)
    rows = sweep_rows(n, s, a_pad, seed=s + 1)
    sr_j = jsr.SEMIRINGS[name] if storage == "float32" else storage_semiring(storage, name, jsr)
    want = np.asarray(jd.fw_repair_del_sweep_ref(jnp.asarray(x), jnp.asarray(rows),
                                                 block_size=s, semiring=sr_j))
    sr_t = tsr.SEMIRINGS[name] if storage == "float32" else storage_semiring(storage, name)
    t, sr, dt = to_port(x, sr_t)
    assert_same(from_port(emulated_sweep(t, rows, s, sr), dt, sr_t), want)
    late = from_port(emulated_sweep(t, rows, s, sr, late=True), dt, sr_t)
    bits = np.int16 if want.itemsize == 2 else np.int32
    assert not np.array_equal(late.view(torch.int16 if bits is np.int16 else torch.int32)
                              .numpy(), want.view(bits))
