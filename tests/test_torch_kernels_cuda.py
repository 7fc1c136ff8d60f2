"""The Hopper kernels of ``repro_torch`` against their plain versions.

Every test here needs the card and carries the ``cuda`` marker; the
``cuda_device`` fixture skips it where no card is present (the CUDA
kernels have no CPU mode).  This file imports neither JAX nor ``repro``,
so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.apsp import ApspEngine, solve
from repro_torch.core.paths import _init_successors
from repro_torch.core.semiring import (
    OR_AND_PACKED,
    SEMIRINGS,
    lower_semiring,
)
from repro_torch.core.staged import fw_staged
from repro_torch.kernels import flash_decode as fdec
from repro_torch.kernels import fw_phase1 as fph
from repro_torch.kernels import fw_phase2
from repro_torch.kernels import fw_repair as fp
from repro_torch.kernels import fw_repair_del as fd
from repro_torch.kernels import fw_round as fr
from repro_torch.kernels import minplus_matmul as fmm
from repro_torch.kernels import ref
from repro_torch.launch import fw_dist_check as fdc
from repro_torch.launch.mesh import run_grid
from repro_torch.utils.bits import bits_equal

NAMES = sorted(SEMIRINGS)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import or collection.
    The first use builds every library at once, one nvcc each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from repro_torch.kernels import _build

    _build.build_all()
    return torch.device("cuda")


def _graph(name, shape, seed):
    """Missing edges are 0̄, the diagonal 1̄; max_plus gets a DAG."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    if name == "plus_mul":
        return rng.uniform(0.0, 1.0 / n, size=shape).astype(np.float32)
    if name == "or_and":
        w = (rng.uniform(size=shape) < 0.1).astype(np.float32)
    else:
        w = rng.uniform(1.0, 10.0, size=shape).astype(np.float32)
        if name == "max_plus":
            lo = np.tril_indices(n, -1)
            w[..., lo[0], lo[1]] = -np.inf
        w[rng.uniform(size=shape) < 0.3] = SEMIRINGS[name].zero
    idx = np.arange(n)
    w[..., idx, idx] = SEMIRINGS[name].one
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,s", [((256, 256), 16), ((256, 256), 32),
                                     ((256, 256), 64), ((3, 256, 256), 128)])
def test_kernel_round_matches_plain(cuda_device, name, shape, s):
    w = torch.from_numpy(_graph(name, shape, seed=s)).to(cuda_device)
    sr = SEMIRINGS[name]
    before = fr.LAUNCHES["fw_round/relax"]
    for b in (0, shape[-1] // s - 1):
        got = fr.fw_round(w.clone(), b, block_size=s, semiring=sr)
        want = ref.fw_round_ref(w, b, block_size=s, semiring=sr)
        torch.cuda.synchronize()
        assert bits_equal(got, want)
    assert fr.LAUNCHES["fw_round/relax"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,s", [((256, 256), 16), ((3, 256, 256), 128)])
def test_kernel_successor_round_matches_plain(cuda_device, dtype, shape, s):
    w = torch.from_numpy(_graph("min_plus", shape, seed=s)).to(dtype).to(cuda_device)
    succ = _init_successors(w).contiguous()
    for b in (0, shape[-1] // s - 1):
        gd, gs = fr.fw_round_with_successors(w.clone(), succ.clone(), b, block_size=s)
        wd, ws = ref.fw_round_with_successors_ref(w, succ, b, block_size=s)
        torch.cuda.synchronize()
        assert bits_equal(gd, wd) and bits_equal(gs, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_solve_on_the_card_matches_the_plain_path(cuda_device, name):
    w = _graph(name, (2, 90, 90), seed=1)
    got = solve(w, method="fused", semiring=name, block_size=32)
    want = solve(w, method="fused", semiring=name, block_size=32, device="cpu")
    assert got.dist.is_cuda
    assert bits_equal(got.dist.cpu(), want.dist)
    if name == "min_plus":
        got = solve(w, successors=True, block_size=16)
        want = solve(w, successors=True, block_size=16, device="cpu")
        assert bits_equal(got.succ.cpu(), want.succ)


def _edges(name, n, E, seed):
    """E edges with a repeated u, a u == v edge and a no-op padding edge."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, E).astype(np.int32)
    v = rng.integers(0, n, E).astype(np.int32)
    w = rng.uniform(1.0, 10.0, E).astype(np.float32)
    if E > 2:
        u[1], v[2] = u[0], u[2]
    zero = np.float32(SEMIRINGS[name].zero)
    return np.append(u, 0).astype(np.int32), np.append(v, 0).astype(np.int32), np.append(w, zero)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("E", [1, 5, 37, 70])
def test_kernel_repair_matches_plain(cuda_device, name, E):
    d = torch.from_numpy(_graph(name, (256, 256), seed=E)).to(cuda_device)
    u, v, w = _edges(name, 256, E, seed=E)
    before = fp.LAUNCHES["fw_repair/apply"]
    got = fp.fw_repair(d, u, v, w, semiring=SEMIRINGS[name])
    want = ref.fw_repair_ref(d, u, v, w, semiring=SEMIRINGS[name])
    torch.cuda.synchronize()
    assert bits_equal(got, want)
    assert fp.LAUNCHES["fw_repair/apply"] == before + (2 if E + 1 > fp.MAX_EDGES else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 5, 37, 70])
def test_kernel_successor_repair_matches_plain(cuda_device, E):
    d = torch.from_numpy(_graph("min_plus", (256, 256), seed=E)).to(cuda_device)
    succ = _init_successors(d).contiguous()
    u, v, w = _edges("min_plus", 256, E, seed=E + 1)
    gd, gs = fp.fw_repair_with_successors(d, succ, u, v, w)
    wd, ws = ref.fw_repair_with_successors_ref(d, succ, u, v, w)
    torch.cuda.synchronize()
    assert bits_equal(gd, wd) and bits_equal(gs, ws)


def _held_phases(d, sr, u, v, w, succ=None):
    """Each repair launch alone against its plain twin: the stage's staged
    rows and row scalars (hops), then the apply on every path d's rows
    allow (16-byte vectors, one element at a time)."""
    E = len(u)
    bufs = fp.repair_buffers(d, E, successors=succ is not None)
    if succ is None:
        fp.repair_phase("stage", d, u, v, w, bufs, semiring=sr)
    else:
        fp.repair_succ_phase("stage", d, succ, u, v, w, bufs)
    staged = ref.repair_stage_ref(d, u, v, w, semiring=sr, strict=succ is not None)
    scal, hops = ref.repair_scalars_ref(d, staged, u, v, w, semiring=sr, succ=succ)
    torch.cuda.synchronize()
    assert bits_equal(bufs.staged, staged) and bits_equal(bufs.scalars, scal)
    if succ is not None:
        assert bits_equal(bufs.hops, hops)
    paths = []
    for out in (torch.empty_like(d), _unaligned_like(d)):
        vec = fp.apply_vectors(d, bufs.staged, out)
        paths.append(vec)
        if succ is None:
            fp.repair_phase("apply", d, u, v, w, bufs, out, semiring=sr)
            torch.cuda.synchronize()
            assert bits_equal(out, ref.repair_apply_ref(d, staged, u, w, semiring=sr)), vec
        else:
            sout = torch.empty_like(succ) if vec else _unaligned_like(succ)
            fp.repair_succ_phase("apply", d, succ, u, v, w, bufs, out, sout)
            wd, ws = ref.repair_apply_succ_ref(d, succ, staged, u, v, w)
            torch.cuda.synchronize()
            assert bits_equal(out, wd) and bits_equal(sout, ws), vec
    return tuple(paths)


def _unaligned_like(x):
    """An empty contiguous x-like tensor whose rows start one element off
    16-byte alignment: the apply's element path."""
    return torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view_as(x)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n", [100, 256])
@pytest.mark.parametrize("E", [1, 16, 37, 64])
def test_repair_launches_alone_match_their_twins(cuda_device, name, n, E):
    d = torch.from_numpy(_graph(name, (n, n), seed=E + n)).to(cuda_device)
    u, v, w = (x[:E] for x in _edges(name, n, max(E - 1, 1), seed=E))
    u, v, w = fp.edge_vectors(u, v, w, n, cuda_device)
    assert _held_phases(d, SEMIRINGS[name], u, v, w) == (True, False)
    if name == "min_plus":
        succ = _init_successors(d).contiguous()
        _held_phases(d, SEMIRINGS[name], u, v, w, succ=succ)


@pytest.mark.cuda
def test_repair_apply_refuses_an_aliased_out(cuda_device):
    flat = torch.zeros(2 * 64 * 64, device=cuda_device)
    d = flat[:64 * 64].view(64, 64)
    u, v, w = fp.edge_vectors([0], [1], [1.0], 64, cuda_device)
    bufs = fp.repair_buffers(d, 1)
    fp.repair_phase("stage", d, u, v, w, bufs)
    for out in (d, flat[64:64 + 64 * 64].view(64, 64), bufs.staged.new_empty(0)):
        with pytest.raises(ValueError):
            fp.repair_phase("apply", d, u, v, w, bufs, out)
    succ = torch.zeros(64, 64, dtype=torch.int32, device=cuda_device)
    sb = fp.repair_buffers(d, 1, successors=True)
    fp.repair_succ_phase("stage", d, succ, u, v, w, sb)
    with pytest.raises(ValueError):
        fp.repair_succ_phase("apply", d, succ, u, v, w, sb, torch.empty_like(d), succ)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_engine_repair_on_the_card_matches_the_plain_path(cuda_device, name):
    w = _graph(name, (90, 90), seed=2)
    upd = [(3, 7, 0.5), (40, 2, 0.25), (89, 88, 0.125)]
    eng, host = ApspEngine(semiring=name, validate=False), ApspEngine(
        semiring=name, validate=False, device="cpu")
    r0 = eng.solve(w)
    got = eng.repair(r0.dist, upd)
    want = host.repair(r0.dist.cpu(), upd)
    assert got.dist.is_cuda
    assert bits_equal(got.dist.cpu(), want.dist)
    if name == "min_plus":
        r0 = eng.solve(w, successors=True)
        got = eng.repair(r0.dist, upd, succ=r0.succ)
        want = host.repair(r0.dist.cpu(), upd, succ=r0.succ.cpu())
        assert bits_equal(got.succ.cpu(), want.succ)


@pytest.mark.cuda
def test_launches_refuse_what_the_kernels_do_not_take(cuda_device):
    w = torch.zeros(128, 128, device=cuda_device)
    bands = fr.round_buffers(w, 64)
    with pytest.raises(ValueError):
        fr.fw_round_phase("relax", w, 0, bands, block_size=32)  # buffers for s=64
    # a strided view is staged through an aligned copy, launched, and
    # written back in place (C.7): the plain answer, not a refusal
    wt = torch.from_numpy(_graph("min_plus", (128, 128), seed=3)).to(cuda_device).t()
    want = ref.fw_round_ref(wt.contiguous(), 0, block_size=64)
    before = fr.LAUNCHES["fw_round/relax"]
    assert fr.fw_round(wt, 0, block_size=64) is wt
    torch.cuda.synchronize()
    assert not wt.is_contiguous() and bits_equal(wt, want)
    assert fr.LAUNCHES["fw_round/relax"] == before + 1
    with pytest.raises(ValueError):
        fr.fw_round(w, 0, block_size=64, semiring=SEMIRINGS["min_plus"].__class__(
            "tropical", torch.minimum, torch.add, 0.0, 0.0, torch.addcmul))
    d = torch.zeros(64, 64, device=cuda_device)
    u, v, w = fp.edge_vectors([0] * 65, [1] * 65, [1.0] * 65, 64, cuda_device)
    with pytest.raises(ValueError):  # more edges than one launch pair takes
        fp.repair_phase("stage", d, u, v, w, fp.repair_buffers(d, 65))
    with pytest.raises(ValueError):  # staged buffer of the wrong shape
        fp.repair_phase("stage", d, u[:4], v[:4], w[:4], fp.repair_buffers(d, 3))


def _strip_rows(n, a, seed):
    """a distinct rows, sorted and padded as the engine pads them."""
    rng = np.random.default_rng(seed)
    a_pad = min(max(8, 1 << (a - 1).bit_length()), n)
    rows = np.full(a_pad, n, np.int32)
    rows[:a] = np.sort(rng.choice(n, a, replace=False))
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["min_plus", "max_plus", "max_min", "or_and"])
@pytest.mark.parametrize("s", [16, 64, 128])
@pytest.mark.parametrize("a", [1, 37, 200])
def test_kernel_sweep_matches_plain(cuda_device, name, s, a):
    d = torch.from_numpy(_graph(name, (256, 256), seed=a + s)).to(cuda_device)
    rows = _strip_rows(256, a, seed=a)
    before = fd.LAUNCHES["fw_repair_del_sweep/relax"]
    got = fd.fw_repair_del_sweep(d, rows, block_size=s, semiring=SEMIRINGS[name])
    want = ref.fw_repair_del_sweep_ref(d, rows, block_size=s, semiring=SEMIRINGS[name])
    torch.cuda.synchronize()
    assert bits_equal(got, want)
    assert fd.LAUNCHES["fw_repair_del_sweep/relax"] == before + 256 // s


@pytest.mark.cuda
@pytest.mark.parametrize("s,a", [(16, 5), (32, 37), (128, 1), (128, 200)])
def test_kernel_successor_sweep_matches_plain(cuda_device, s, a):
    d = torch.from_numpy(_graph("min_plus", (256, 256), seed=a)).to(cuda_device)
    succ = _init_successors(d).contiguous()
    rows = _strip_rows(256, a, seed=a + 1)
    gd, gs = fd.fw_repair_del_sweep_with_successors(d, succ, rows, block_size=s)
    wd, ws = ref.fw_repair_del_sweep_with_successors_ref(d, succ, rows, block_size=s)
    torch.cuda.synchronize()
    assert bits_equal(gd, wd) and bits_equal(gs, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_engine_repair_del_on_the_card_matches_the_plain_path(cuda_device, name):
    rng = np.random.default_rng(3)
    w = _graph(name, (90, 90), seed=3)
    sr = SEMIRINGS[name]
    host = ApspEngine(semiring=name, validate=False, device="cpu")
    d0 = host.solve(w).dist.numpy()
    edge = (w != sr.zero) & ~np.eye(90, dtype=bool)
    on_path = edge & (w == d0)  # plus_mul has none: it re-solves anyway
    cand = np.argwhere(on_path if on_path.sum() >= 3 else edge)
    dels, w1 = [], w.copy()
    for u, v in cand[rng.choice(len(cand), 3, replace=False)]:
        dels.append((int(u), int(v), float(w[u, v])))
        w1[u, v] = sr.zero
    eng = ApspEngine(semiring=name, validate=False)
    got = eng.repair_del(torch.from_numpy(d0).to(cuda_device), w1, dels, threshold=100.0)
    want = host.repair_del(d0, w1, dels, threshold=100.0)
    assert got.dist.is_cuda and bits_equal(got.dist.cpu(), want.dist)
    fields = ("repair_dels", "repair_del_rows", "repair_del_fallbacks", "edges_deleted")
    assert [getattr(eng.stats, f) for f in fields] == [getattr(host.stats, f) for f in fields]
    if name == "min_plus":
        r0 = host.solve(w, successors=True)
        got = eng.repair_del(r0.dist.to(cuda_device), w1, dels, succ=r0.succ, threshold=100.0)
        want = host.repair_del(r0.dist, w1, dels, succ=r0.succ, threshold=100.0)
        assert bits_equal(got.dist.cpu(), want.dist) and bits_equal(got.succ.cpu(), want.succ)


@pytest.mark.cuda
def test_sweep_launches_refuse_what_the_kernels_do_not_take(cuda_device):
    d = torch.zeros(128, 128, device=cuda_device)
    with pytest.raises(ValueError):  # plus_mul has no sweep kernel
        fd.fw_repair_del_sweep(d, [3], block_size=64, semiring=SEMIRINGS["plus_mul"])
    with pytest.raises(ValueError):  # a repeated real row
        fd.fw_repair_del_sweep(d, [3, 3], block_size=64)
    with pytest.raises(ValueError):  # beyond the padding index
        fd.fw_repair_del_sweep(d, [129], block_size=64)
    sw = fd.sweep_buffers(d, [3, 70], block_size=64)
    with pytest.raises(ValueError):
        fd.sweep_phase("relax", sw, 2)  # round outside [0, 2)
    with pytest.raises(ValueError):
        fd.sweep_succ_phase("diag", sw, 0)  # no next-hop buffers


# ------------------------------------------ the 4-dispatch round's kernels
def _salted(name, shape, seed):
    """Operands in each semiring's domain, salted with +inf and -inf."""
    rng = np.random.default_rng(seed)
    m = max(shape[-2:])
    x = _graph(name, (*shape[:-2], m, m), seed)[..., : shape[-2], : shape[-1]].copy()
    x[rng.uniform(size=shape) < 0.05] = np.inf
    x[rng.uniform(size=shape) < 0.05] = -np.inf
    return torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("a_shape,b_shape", [((1, 5), (5, 3)), ((1000, 77), (77, 513)),
                                             ((256, 128), (128, 384)),
                                             ((3, 40, 70), (3, 70, 130))])
@pytest.mark.parametrize("with_c", [False, True])
def test_kernel_semiring_matmul_matches_plain(cuda_device, name, a_shape, b_shape, with_c):
    sr = SEMIRINGS[name]
    a = _salted(name, a_shape, 1).to(cuda_device)
    b = _salted(name, b_shape, 2).to(cuda_device)
    c = _salted(name, (*a_shape[:-1], b_shape[-1]), 3).to(cuda_device) if with_c else None
    c0 = None if c is None else c.clone()
    before = fmm.LAUNCHES["semiring_matmul"]
    got = fmm.semiring_matmul(a, b, c, semiring=sr)
    want = ref.semiring_matmul_ref(a, b, c, semiring=sr)
    torch.cuda.synchronize()
    assert bits_equal(got, want)
    assert c is None or bits_equal(c, c0)  # functional
    assert fmm.LAUNCHES["semiring_matmul"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", [(16, 16), (32, 32), (64, 64), (128, 128), (3, 128, 128)])
def test_kernel_phase1_matches_plain(cuda_device, name, shape):
    t = torch.from_numpy(_graph(name, shape, seed=shape[-1])).to(cuda_device)
    got = fph.fw_phase1(t, semiring=SEMIRINGS[name])
    want = ref.fw_phase1_ref(t, semiring=SEMIRINGS[name])
    torch.cuda.synchronize()
    assert bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("lead,s,n", [((), 16, 40), ((), 64, 256), ((), 128, 1000),
                                      ((2,), 32, 97)])
def test_kernel_phase2_matches_plain(cuda_device, name, lead, s, n):
    """Both bands, read as strided slices of a larger matrix."""
    sr = SEMIRINGS[name]
    diag = ref.fw_phase1_ref(torch.from_numpy(_graph(name, (*lead, s, s), seed=s)), semiring=sr)
    w = torch.from_numpy(_graph(name, (*lead, n + s, n + s), seed=n)).to(cuda_device)
    diag = diag.to(cuda_device)
    row, col = w[..., 3:3 + s, 5:5 + n], w[..., 5:5 + n, 3:3 + s]
    got_r = fw_phase2.fw_phase2_row(diag, row, semiring=sr)
    got_c = fw_phase2.fw_phase2_col(diag, col, semiring=sr)
    torch.cuda.synchronize()
    assert bits_equal(got_r, ref.fw_phase2_row_ref(diag, row, semiring=sr))
    assert bits_equal(got_c, ref.fw_phase2_col_ref(diag, col, semiring=sr))


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,s", [((256, 256), 16), ((256, 256), 64), ((2, 256, 256), 128)])
def test_kernel_four_dispatch_matches_plain_and_fused(cuda_device, name, shape, s):
    sr = SEMIRINGS[name]
    w = torch.from_numpy(_graph(name, shape, seed=s)).to(cuda_device)
    fph.reset_launch_counts()
    fmm.reset_launch_counts()
    got = fw_staged(w, block_size=s, semiring=sr, fused=False)
    counts = {k: v for k, v in {**fph.LAUNCHES, **fmm.LAUNCHES}.items() if "[" not in k}
    want = w
    for b in range(shape[-1] // s):
        want = ref.fw_round4_ref(want, b, block_size=s, semiring=sr)
    fused = fw_staged(w, block_size=s, semiring=sr)
    torch.cuda.synchronize()
    assert bits_equal(got, want) and bits_equal(got, fused)
    assert counts == dict.fromkeys(counts, shape[-1] // s)


@pytest.mark.cuda
def test_phase_and_matmul_launches_refuse_what_the_kernels_do_not_take(cuda_device):
    t = torch.zeros(48, 48, device=cuda_device)
    with pytest.raises(ValueError):  # s outside the kernels' block sizes
        fph.fw_phase1(t)
    with pytest.raises(ValueError):  # the band's columns are not unit-strided
        fw_phase2.fw_phase2_row(t[:16, :16], torch.zeros(40, 16, device=cuda_device).t())
    a = torch.zeros(8, 4, device=cuda_device)
    with pytest.raises(ValueError):
        fmm.semiring_matmul(a, a.t().contiguous(), variant="broadcast")
    with pytest.raises(TypeError):
        fmm.semiring_matmul(a.double(), a.t().double())
    with pytest.raises(ValueError):  # c on another shape
        fmm.semiring_matmul(a, a.t().contiguous(), torch.zeros(8, 9, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,s", [((80, 48), 16), ((3, 96, 160), 32), ((384, 256), 128)])
def test_kernel_bordered_round_matches_plain(cuda_device, name, shape, s):
    sr = SEMIRINGS[name]
    w = _salted(name, shape, seed=s).to(cuda_device)
    tr, tc = shape[-2] // s, shape[-1] // s
    before = fr.LAUNCHES["fw_round_bordered/relax"]
    echoes = ((-1, -1), (1, 1), (tr - 1, tc - 1), (1, -1), (-1, tc - 1))
    for echo in echoes:
        got = fr.fw_round_bordered(w.clone(), *echo, block_size=s, semiring=sr)
        want = ref.fw_round_bordered_ref(w, *echo, block_size=s, semiring=sr)
        torch.cuda.synchronize()
        assert bits_equal(got, want), echo
    assert fr.LAUNCHES["fw_round_bordered/relax"] == before + len(echoes)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_grid_solve_on_the_card_matches_fused(cuda_device, grid):
    """Ranks sharing the card over gloo: fw_distributed (chunked and
    restarted) and solve(method="distributed") == the fused solve."""
    from repro_torch.kernels import _build

    _build.build_all()  # once, before the ranks load the libraries
    cfgs = [dict(n=256, bs=32, semiring="min_plus", chunked=True, rounds_per_call=2,
                 restart_at=4),
            dict(n=200, semiring="plus_mul", method="solve")]
    recs = run_grid(fdc.grid_check, *grid, device="cuda", args=(cfgs,), timeout=300)
    for rank_recs in recs:
        direct, via_solve = rank_recs
        assert direct["ok"] and direct["chunked_ok"] and via_solve["ok"]
        assert direct["comm_bytes"] == (direct["model_bytes"] if grid != (1, 1) else 0)
        f32 = {k: v for k, v in direct["launches"].items() if "[" not in k}  # not lowered
        assert f32 == dict.fromkeys(f32, 256 // 32)


def test_distributed_modules_import_without_jax():
    """The distributed solve, the process grid and the check CLI load with
    jax and the reference package blocked."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import repro_torch.core.distributed, repro_torch.launch.mesh, "
            "repro_torch.launch.fw_dist_check")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr


# ------------------------------------------------- signed zero and NaN
IDEMPOTENT = ("min_plus", "max_plus", "max_min", "or_and")


def _domain_graph(name, shape, seed):
    """_graph, but max_plus / max_min weights in [-10, -1) (no cycle grows
    under max, no DAG needed): most of a closure stays finite."""
    if name not in ("max_plus", "max_min"):
        return _graph(name, shape, seed)
    rng = np.random.default_rng(seed)
    w = rng.uniform(-10.0, -1.0, size=shape).astype(np.float32)
    w[rng.uniform(size=shape) < 0.3] = SEMIRINGS[name].zero
    idx = np.arange(shape[-1])
    w[..., idx, idx] = SEMIRINGS[name].one
    return w


def _signed_zero_graph(name, shape, seed):
    """_domain_graph with ±0 salted in and no NaN: 3 % of each sign (max_plus
    0.3 %: a max keeps -0 only where no candidate is +0, and + gives -0
    only from two -0s); or_and 1 % ones, 1 % +0, -0 elsewhere; the
    diagonal 1̄ of min_plus / max_plus as -0, the exact identity of +."""
    rng = np.random.default_rng(seed + 1)
    u = rng.uniform(size=shape)
    if name == "or_and":
        w = np.where(rng.uniform(size=shape) < 0.01, 1.0, -0.0).astype(np.float32)
        w[u < 0.01] = 0.0
        idx = np.arange(shape[-1])
        w[..., idx, idx] = 1.0
        return w
    w = _domain_graph(name, shape, seed)
    if name in ("min_plus", "max_plus"):
        idx = np.arange(shape[-1])
        w[..., idx, idx] = -0.0
    share = 0.003 if name == "max_plus" else 0.03
    w[u < share] = 0.0
    w[(u >= share) & (u < 2 * share)] = -0.0
    return w


def _nan_salted(w, seed, count, s):
    """w with ``count`` NaNs a graph off its diagonal (s, s) tiles, where no
    round or panel closes them over the whole output."""
    rng = np.random.default_rng(seed)
    w = w.copy()
    placed = 0
    while placed < count:
        i, j = (int(x) for x in rng.integers(0, w.shape[-1], 2))
        if i // s != j // s:
            w[..., i, j] = np.nan
            placed += 1
    return w


def _assert_salt_survives(name, want, *, zeros, nans):
    """The plain output stays mostly finite and keeps its salt: zeros of
    both signs for the idempotent semirings (plus_mul sums every term, so
    it holds -0 only where all terms are -0), NaNs where NaNs went in."""
    if not want.is_floating_point():
        return
    want = want.float().cpu()
    zero, neg = want == 0, torch.signbit(want)
    assert torch.isfinite(want).float().mean() >= 0.5
    if zeros and name in IDEMPOTENT:
        assert (zero & neg).any() and (zero & ~neg).any()
    if nans:
        assert want.isnan().any()


def _planted_zero_matrix(name, n=32):
    """0̄ but for the +0 diagonal and four two-step paths whose ⊕ picks
    between +0 and -0 with either sign in the accumulator: cells (1, 2),
    (4, 5) in round 0's pivot tile at s = 16, (17, 18), (20, 21) in the
    block it relaxes.  min must leave -0 in each, max +0."""
    z1, z2 = (0.0, -0.0) if name == "min_plus" else (-0.0, 0.0)
    w = np.full((n, n), SEMIRINGS[name].zero, np.float32)
    np.fill_diagonal(w, 0.0)
    cells = []
    for (i, j), k, acc, step in (((1, 2), 3, z1, z2), ((4, 5), 6, z2, z1),
                                 ((17, 18), 7, z1, z2), ((20, 21), 9, z2, z1)):
        w[i, j], w[i, k], w[k, j] = acc, step, step
        cells.append((i, j))
    return w, cells


@pytest.mark.cuda
def test_min_max_steps_take_xla_signed_zero(cuda_device):
    """min.NaN / max.NaN inside the kernels (the f32 round and phase 1, the
    bf16 / f16 round): -0 / +0 for (±0, ∓0) in either order, what XLA's
    min / max give."""
    for name in ("min_plus", "max_plus"):
        sr = SEMIRINGS[name]
        w32, cells = _planted_zero_matrix(name)
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            w = torch.from_numpy(w32).to(dt).to(cuda_device)
            got = fr.fw_round(w.clone(), 0, block_size=16, semiring=sr)
            assert bits_equal(got, ref.fw_round_ref(w, 0, block_size=16, semiring=sr))
            assert all(bool(got[i, j].signbit()) == (name == "min_plus") for i, j in cells)
        w = torch.from_numpy(w32[:16, :16]).to(cuda_device)
        got = fph.fw_phase1(w, semiring=sr)
        assert bits_equal(got, ref.fw_phase1_ref(w, semiring=sr))
        assert all(bool(got[i, j].signbit()) == (name == "min_plus") for i, j in cells[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_kernels_match_plain_on_signed_zero_and_nan(cuda_device, name):
    """The round, the bordered round, the successor round, the phase
    kernels, the matmul and the repairs, by bits, on two inputs: ±0 salted
    without NaN, and NaNs off the diagonal tiles (one tile of the phase-1
    batch all NaN); each plain output stays mostly finite and keeps its
    salt."""
    sr = SEMIRINGS[name]
    n = 256
    for kind in ("zero", "nan"):
        make = _signed_zero_graph if kind == "zero" else _domain_graph
        w, tiles = make(name, (2, n, n), 3), make(name, (3, 64, 64), 4)
        if kind == "nan":
            w = _nan_salted(w, 11, 4, 64)
            w[:, 7, 70] = w[:, 100, 5] = np.nan  # one in each panel
            tiles[2] = _nan_salted(tiles[2], 6, 1, 1)
        w, tiles = torch.from_numpy(w).to(cuda_device), torch.from_numpy(tiles).to(cuda_device)
        diag = ref.fw_phase1_ref(w[:, :64, :64], semiring=sr)
        a, b = w[0, :, :96].contiguous(), w[1, :96, :].contiguous()
        row, col = w[:, :64, :].contiguous(), w[:, :, :64].contiguous()
        cases = [
            (fr.fw_round(w.clone(), 1, block_size=64, semiring=sr),
             ref.fw_round_ref(w, 1, block_size=64, semiring=sr)),
            (fr.fw_round_bordered(w.clone(), 1, 2, block_size=32, semiring=sr),
             ref.fw_round_bordered_ref(w, 1, 2, block_size=32, semiring=sr)),
            (fmm.semiring_matmul(a, b, w[0], semiring=sr),
             ref.semiring_matmul_ref(a, b, w[0], semiring=sr)),
            (fph.fw_phase1(tiles, semiring=sr), ref.fw_phase1_ref(tiles, semiring=sr)),
            (fw_phase2.fw_phase2_row(diag, row, semiring=sr),
             ref.fw_phase2_row_ref(diag, row, semiring=sr)),
            (fw_phase2.fw_phase2_col(diag, col, semiring=sr),
             ref.fw_phase2_col_ref(diag, col, semiring=sr)),
        ]
        if name == "min_plus":
            succ = _init_successors(w).contiguous()
            gd, gs = fr.fw_round_with_successors(w.clone(), succ.clone(), 2, block_size=64)
            wd, ws = ref.fw_round_with_successors_ref(w, succ, 2, block_size=64)
            cases += [(gd, wd), (gs, ws)]
        if name != "plus_mul":
            d = w[0].contiguous()
            u, v, e = _edges(name, n, 5, seed=5)
            rows = _strip_rows(n, 37, seed=6)
            cases += [(fp.fw_repair(d, u, v, e, semiring=sr),
                       ref.fw_repair_ref(d, u, v, e, semiring=sr)),
                      (fd.fw_repair_del_sweep(d, rows, block_size=64, semiring=sr),
                       ref.fw_repair_del_sweep_ref(d, rows, block_size=64, semiring=sr))]
        torch.cuda.synchronize()
        for i, (got, want) in enumerate(cases):
            assert bits_equal(got, want), (kind, i)
            _assert_salt_survives(name, want, zeros=kind == "zero", nans=kind == "nan")


# ------------------------------------------------------ storage lowerings
def _lowered_case(tag: str, name: str, shape, seed: int, s: int):
    """(w on the CPU, semiring) of a lowered round at block size s: int16
    weights with the ⊕-identity sentinel and near-saturation values
    sprinkled in, {0,1} int16 for or_and_i16, random int32 words for the
    packed closure, or the signed-zero graph cast to bf16 / f16 with two
    NaNs a graph off the diagonal tiles."""
    rng = np.random.default_rng(seed)
    if tag == "packed":
        words = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(words.view(np.int32)), OR_AND_PACKED
    if tag == "int16":
        sr = lower_semiring(SEMIRINGS[name], torch.int16)
        if name == "or_and":
            return torch.from_numpy((rng.uniform(size=shape) < 0.25).astype(np.int16)), sr
        v = rng.integers(-40, 40, size=shape).astype(np.int16)
        v[rng.uniform(size=shape) < 0.02] = 32000
        v[rng.uniform(size=shape) < 0.02] = -32000
        v[rng.uniform(size=shape) < 0.15] = sr.zero
        return torch.from_numpy(v), sr
    dt = {"bf16": torch.bfloat16, "f16": torch.float16}[tag]
    w = _nan_salted(_signed_zero_graph(name, shape, seed), seed, 2, s)
    return torch.from_numpy(w).to(dt), SEMIRINGS[name]


LOWERED_CASES = ([("int16", n) for n in ("min_plus", "max_plus", "max_min", "or_and")]
                 + [("packed", "or_and")]
                 + [(tag, n) for tag in ("bf16", "f16") for n in NAMES])


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name", LOWERED_CASES)
@pytest.mark.parametrize("shape,s", [((256, 256), 16), ((256, 256), 32),
                                     ((256, 256), 64), ((3, 256, 256), 128)])
def test_kernel_lowered_round_matches_plain(cuda_device, tag, name, shape, s):
    w, sr = _lowered_case(tag, name, shape, seed=s, s=s)
    w = w.to(cuda_device)
    kind = f"fw_round/relax[{tag}]"
    before = fr.LAUNCHES[kind]
    for b in (0, shape[-1] // s - 1):
        got = fr.fw_round(w.clone(), b, block_size=s, semiring=sr)
        want = ref.fw_round_ref(w, b, block_size=s, semiring=sr)
        torch.cuda.synchronize()
        assert got.dtype == w.dtype and bits_equal(got, want), (tag, name, b)
        if tag in ("bf16", "f16"):
            _assert_salt_survives(name, want, zeros=True, nans=True)
    assert fr.LAUNCHES[kind] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,s", [((256, 256), 16), ((3, 256, 256), 128)])
def test_kernel_lowered_successor_round_matches_plain(cuda_device, dtype, shape, s):
    w = torch.from_numpy(_signed_zero_graph("min_plus", shape, seed=s)).to(dtype).to(cuda_device)
    succ = _init_successors(w).contiguous()
    for b in (0, shape[-1] // s - 1):
        gd, gs = fr.fw_round_with_successors(w.clone(), succ.clone(), b, block_size=s)
        wd, ws = ref.fw_round_with_successors_ref(w, succ, b, block_size=s)
        torch.cuda.synchronize()
        assert bits_equal(gd, wd) and bits_equal(gs, ws)


@pytest.mark.cuda
def test_lowered_solves_on_the_card_match_the_plain_path(cuda_device):
    rng = np.random.default_rng(4)
    w = rng.integers(1, 50, size=(2, 100, 100)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.5] = np.inf
    w[:, np.arange(100), np.arange(100)] = 0.0
    for kw in (dict(dtype=torch.int16), dict(dtype=torch.bfloat16),
               dict(dtype=torch.float16), dict(dtype=torch.bfloat16, successors=True)):
        got = solve(w, method="fused", block_size=32, **kw)
        want = solve(w, method="fused", block_size=32, device="cpu", **kw)
        assert bits_equal(got.dist.cpu(), want.dist), kw
        if "successors" in kw:
            assert bits_equal(got.succ.cpu(), want.succ)
    bits = (rng.uniform(size=(37, 100, 100)) < 0.05).astype(np.float32)
    got = solve(bits, semiring="or_and", packed=True, block_size=32)
    want = solve(bits, semiring="or_and", packed=True, block_size=32, device="cpu")
    assert got.dist.shape == (37, 100, 100) and bits_equal(got.dist.cpu(), want.dist)


@pytest.mark.cuda
def test_lowered_launches_refuse_what_the_kernels_do_not_take(cuda_device):
    w = torch.zeros(128, 128, dtype=torch.int16, device=cuda_device)
    with pytest.raises(TypeError):  # int16 storage with a float semiring
        fr.fw_round(w, 0, block_size=64)
    with pytest.raises(TypeError):  # packed words must be int32
        fr.fw_round(w, 0, block_size=64, semiring=OR_AND_PACKED)
    with pytest.raises(ValueError):  # band buffers of another dtype
        fr.fw_round(w.float(), 0, block_size=64, bands=fr.round_buffers(w, 64))
    # the bordered round and the matmul run a lowering in its storage,
    # equal to their twins, and refuse a storage that is not the semiring's
    x = torch.arange(128 * 128, device=cuda_device).reshape(128, 128).remainder(97).bfloat16()
    assert bits_equal(fr.fw_round_bordered(x.clone(), block_size=64),
                      ref.fw_round_bordered_ref(x, block_size=64))
    assert bits_equal(fmm.semiring_matmul(x, x), ref.semiring_matmul_ref(x, x))
    with pytest.raises(TypeError):
        fr.fw_round_bordered(w, block_size=64)  # int16 with a float semiring
    with pytest.raises(TypeError):
        fmm.semiring_matmul(x, x.float())  # mixed storages are never converted


# ------------------------------- lowered repair, sweep and the int32 round
INT32 = {"or_and_i32": "or_and", "plus_mul_i32": "plus_mul"}


def _int32_case(tag: str, shape, seed: int):
    """The int32 carrier of an integer storage: or_and on small integers,
    plus_mul on full-range ones (every product and sum wraps)."""
    rng = np.random.default_rng(seed)
    if tag == "or_and_i32":
        return torch.from_numpy(rng.integers(-1000, 1000, size=shape).astype(np.int32))
    return torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=shape).astype(np.int32))


def _storage_case(tag: str, name: str, shape, seed: int, s: int = 16):
    """(x, semiring) in a kernel's storage; a non-square shape is cut from
    the square case of its larger side."""
    m = max(shape[-2:])
    square = (*shape[:-2], m, m)
    if tag in INT32:
        x, sr = _int32_case(tag, square, seed), SEMIRINGS[INT32[tag]]
    else:  # the NaNs go off the diagonal tiles, of at most half the side
        x, sr = _lowered_case(tag, name, square, seed, max(1, min(s, m // 2)))
    return x[..., :shape[-2], :shape[-1]].contiguous(), sr


REPAIR_CASES = LOWERED_CASES + [("or_and_i32", "or_and"), ("plus_mul_i32", "plus_mul")]
SWEEP_CASES = [c for c in REPAIR_CASES if c[1] != "plus_mul"]


def _lowered_edges(d: torch.Tensor, sr, E: int, seed: int):
    """E edges (a repeated u, a u == v edge) in d's dtype, then a no-op
    padding edge (0, 0, ⊕-identity)."""
    rng = np.random.default_rng(seed)
    n = d.shape[-1]
    u = rng.integers(0, n, E + 1).astype(np.int32)
    v = rng.integers(0, n, E + 1).astype(np.int32)
    if E > 2:
        u[1], v[2] = u[0], u[2]
    if d.dtype == torch.int32:
        w = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, E + 1).astype(np.int32))
    elif d.dtype == torch.int16:
        w = torch.from_numpy(rng.integers(-5, 30, E + 1).astype(np.int16))
    else:
        w = torch.from_numpy(rng.uniform(1.0, 10.0, E + 1).astype(np.float32)).to(d.dtype)
    u[-1] = v[-1] = 0
    w[-1] = sr.zero
    return u, v, w


@pytest.mark.cuda
@pytest.mark.parametrize("tag", ["or_and_i32", "plus_mul_i32"])
@pytest.mark.parametrize("shape,s", [((256, 256), 16), ((3, 256, 256), 128)])
def test_kernel_int32_round_matches_plain(cuda_device, tag, shape, s):
    w = _int32_case(tag, shape, seed=s).to(cuda_device)
    sr = SEMIRINGS[INT32[tag]]
    before = fr.LAUNCHES[f"fw_round/relax[{tag}]"]
    for b in (0, shape[-1] // s - 1):
        got = fr.fw_round(w.clone(), b, block_size=s, semiring=sr)
        want = ref.fw_round_ref(w, b, block_size=s, semiring=sr)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and bits_equal(got, want), (tag, b)
    assert fr.LAUNCHES[f"fw_round/relax[{tag}]"] == before + 2


# ------------------------- the lowered 4-dispatch kernels and bordered round
@pytest.mark.cuda
@pytest.mark.parametrize("tag,name", REPAIR_CASES)
@pytest.mark.parametrize("a_shape,b_shape", [((1, 5), (5, 3)), ((1000, 77), (77, 513)),
                                             ((3, 40, 70), (3, 70, 130))])
def test_kernel_lowered_semiring_matmul_matches_plain(cuda_device, tag, name, a_shape, b_shape):
    """Every storage, ragged and batched, with and without c; the
    accumulator is left as it was."""
    a, sr = _storage_case(tag, name, a_shape, 1)
    b, _ = _storage_case(tag, name, b_shape, 2)
    c, _ = _storage_case(tag, name, (*a_shape[:-1], b_shape[-1]), 3)
    a, b, c = a.to(cuda_device), b.to(cuda_device), c.to(cuda_device)
    c0 = c.clone()
    kind = f"semiring_matmul[{tag}]"
    before = fmm.LAUNCHES[kind]
    for cc in (None, c):
        got = fmm.semiring_matmul(a, b, cc, semiring=sr)
        want = ref.semiring_matmul_ref(a, b, cc, semiring=sr)
        torch.cuda.synchronize()
        assert got.dtype == a.dtype and bits_equal(got, want), (tag, name, cc is None)
    assert bits_equal(c, c0) and fmm.LAUNCHES[kind] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name", REPAIR_CASES)
@pytest.mark.parametrize("lead,s,n", [((), 32, 97), ((2,), 128, 300)])
def test_kernel_lowered_phases_match_plain(cuda_device, tag, name, lead, s, n):
    """fw_phase1 on (…, s, s) and both bands, read as strided slices."""
    t, sr = _storage_case(tag, name, (*lead, s, s), s, s)
    w, _ = _storage_case(tag, name, (*lead, n + s, n + s), n, s)
    t, w = t.to(cuda_device), w.to(cuda_device)
    diag = fph.fw_phase1(t, semiring=sr)
    row, col = w[..., 3:3 + s, 5:5 + n], w[..., 5:5 + n, 3:3 + s]
    got_r = fw_phase2.fw_phase2_row(diag, row, semiring=sr)
    got_c = fw_phase2.fw_phase2_col(diag, col, semiring=sr)
    torch.cuda.synchronize()
    assert diag.dtype == t.dtype and bits_equal(diag, ref.fw_phase1_ref(t, semiring=sr))
    assert bits_equal(got_r, ref.fw_phase2_row_ref(diag, row, semiring=sr))
    assert bits_equal(got_c, ref.fw_phase2_col_ref(diag, col, semiring=sr))
    assert fph.LAUNCHES[f"fw_phase2_col[{tag}]"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name", REPAIR_CASES)
@pytest.mark.parametrize("shape,s", [((256, 256), 32), ((2, 256, 256), 128)])
def test_kernel_lowered_four_dispatch_matches_plain_and_fused(cuda_device, tag, name, shape, s):
    w, sr = _storage_case(tag, name, shape, s, s)
    w = w.to(cuda_device)
    fph.reset_launch_counts()
    fmm.reset_launch_counts()
    got = fw_staged(w, block_size=s, semiring=sr, fused=False)
    counts = {k: v for k, v in {**fph.LAUNCHES, **fmm.LAUNCHES}.items() if v}
    want = w
    for b in range(shape[-1] // s):
        want = ref.fw_round4_ref(want, b, block_size=s, semiring=sr)
    fused = fw_staged(w, block_size=s, semiring=sr)
    torch.cuda.synchronize()
    assert got.dtype == w.dtype and bits_equal(got, want) and bits_equal(got, fused)
    assert counts == {f"{k}[{tag}]": shape[-1] // s for k in
                      ("fw_phase1", "fw_phase2_row", "fw_phase2_col", "semiring_matmul")}


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name", REPAIR_CASES)
@pytest.mark.parametrize("shape,s", [((80, 48), 16), ((3, 96, 160), 32), ((384, 256), 128)])
def test_kernel_lowered_bordered_round_matches_plain(cuda_device, tag, name, shape, s):
    w, sr = _storage_case(tag, name, shape, s, s)
    w = w.to(cuda_device)
    tr, tc = shape[-2] // s, shape[-1] // s
    kind = f"fw_round_bordered/relax[{tag}]"
    before = fr.LAUNCHES[kind]
    echoes = ((-1, -1), (1, 1), (tr - 1, tc - 1), (1, -1), (-1, tc - 1))
    for echo in echoes:
        got = fr.fw_round_bordered(w.clone(), *echo, block_size=s, semiring=sr)
        want = ref.fw_round_bordered_ref(w, *echo, block_size=s, semiring=sr)
        torch.cuda.synchronize()
        assert got.dtype == w.dtype and bits_equal(got, want), echo
    assert fr.LAUNCHES[kind] == before + len(echoes)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(2, 2)])
def test_lowered_grid_solve_on_the_card_matches_fused(cuda_device, grid):
    """Ranks sharing the card over gloo, in int16, bf16 and packed words:
    every rank == the lowered fused solve, the bytes == the model in the
    storage's word; a lowered mesh repair == single-device == re-solve."""
    from repro_torch.kernels import _build

    _build.build_all()  # once, before the ranks load the libraries
    cfgs = [dict(n=256, bs=32, semiring="min_plus", dtype="int16"),
            dict(n=256, bs=32, semiring="plus_mul", dtype="bfloat16"),
            dict(n=256, bs=32, semiring="or_and", packed=True),
            dict(n=200, semiring="max_min", dtype="float16", method="solve"),
            dict(n=256, semiring="min_plus", dtype="int16", repair=True, edges=16)]
    recs = run_grid(fdc.grid_check, *grid, device="cuda", args=(cfgs,), timeout=300)
    for rank_recs in recs:
        for rec in rank_recs:
            assert rec["ok"], rec
            if "model_bytes" in rec:
                assert rec["comm_bytes"] == rec["model_bytes"]
                tag = {"int16": "int16", "bfloat16": "bf16", "int32": "packed"}[rec["dtype"]]
                assert rec["launches"][f"fw_round_bordered/relax[{tag}]"] == 256 // 32


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name", REPAIR_CASES)
@pytest.mark.parametrize("E", [1, 16, 37])
def test_kernel_lowered_repair_matches_plain(cuda_device, tag, name, E):
    d, sr = _storage_case(tag, name, (256, 256), seed=E)
    d = d.to(cuda_device)
    u, v, w = _lowered_edges(d, sr, E, seed=E)
    kind = f"fw_repair/apply[{tag}]"
    before = fp.LAUNCHES[kind]
    got = fp.fw_repair(d, u, v, w, block_size=16, semiring=sr)
    want = ref.fw_repair_ref(d, u, v, w, semiring=sr)
    torch.cuda.synchronize()
    assert got.dtype == d.dtype and bits_equal(got, want), (tag, name)
    pairs = -(-(E + 1) // fp.MAX_EDGES)
    assert fp.LAUNCHES[kind] == before + pairs
    # each launch kind alone against its plain phase, on both apply paths
    uu, vv, ww = fp.edge_vectors(u, v, w, 256, cuda_device, d.dtype)
    k = min(len(uu), fp.MAX_EDGES)
    assert _held_phases(d, sr, uu[:k], vv[:k], ww[:k]) == (True, False)
    # rows of 200 bytes in a 2-byte storage: one element at a time
    d100 = d[:100, :100].contiguous()
    u1, v1, w1 = fp.edge_vectors(*_lowered_edges(d100, sr, min(E, 16), seed=E), 100,
                                 cuda_device, d.dtype)
    paths = _held_phases(d100, sr, u1[:16], v1[:16], w1[:16])
    assert paths == ((False, False) if d.element_size() == 2 else (True, False))


@pytest.mark.cuda
@pytest.mark.parametrize("tag", ["bf16", "f16"])
@pytest.mark.parametrize("E", [1, 16, 37])
def test_kernel_lowered_successor_repair_matches_plain(cuda_device, tag, E):
    d, sr = _lowered_case(tag, "min_plus", (256, 256), seed=E, s=16)
    d = d.to(cuda_device)
    succ = _init_successors(d).contiguous()
    u, v, w = _lowered_edges(d, sr, E, seed=E + 1)
    kind = f"fw_repair_with_successors/apply[{tag}]"
    before = fp.LAUNCHES[kind]
    gd, gs = fp.fw_repair_with_successors(d, succ, u, v, w, block_size=16)
    wd, ws = ref.fw_repair_with_successors_ref(d, succ, u, v, w)
    torch.cuda.synchronize()
    assert bits_equal(gd, wd) and bits_equal(gs, ws)
    assert fp.LAUNCHES[kind] == before + -(-(E + 1) // fp.MAX_EDGES)
    uu, vv, ww = fp.edge_vectors(u, v, w, 256, cuda_device, d.dtype)
    k = min(len(uu), fp.MAX_EDGES)
    _held_phases(d, sr, uu[:k], vv[:k], ww[:k], succ=succ)
    d100, s100 = d[:100, :100].contiguous(), succ[:100, :100].contiguous()
    u1, v1, w1 = fp.edge_vectors(*_lowered_edges(d100, sr, 16, seed=E), 100, cuda_device,
                                 d.dtype)
    assert _held_phases(d100, sr, u1[:16], v1[:16], w1[:16], succ=s100) == (False, False)


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name", SWEEP_CASES)
@pytest.mark.parametrize("s,a", [(16, 37), (64, 1), (128, 200)])
def test_kernel_lowered_sweep_matches_plain(cuda_device, tag, name, s, a):
    d, sr = _storage_case(tag, name, (256, 256), seed=a + s, s=s)
    d = d.to(cuda_device)
    rows = _strip_rows(256, a, seed=a)
    kind = f"fw_repair_del_sweep/relax[{tag}]"
    before = fd.LAUNCHES[kind]
    got = fd.fw_repair_del_sweep(d, rows, block_size=s, semiring=sr)
    want = ref.fw_repair_del_sweep_ref(d, rows, block_size=s, semiring=sr)
    torch.cuda.synchronize()
    assert got.dtype == d.dtype and bits_equal(got, want), (tag, name)
    assert fd.LAUNCHES[kind] == before + 256 // s


@pytest.mark.cuda
@pytest.mark.parametrize("tag", ["bf16", "f16"])
@pytest.mark.parametrize("s,a", [(16, 5), (128, 37)])
def test_kernel_lowered_successor_sweep_matches_plain(cuda_device, tag, s, a):
    d, _ = _lowered_case(tag, "min_plus", (256, 256), seed=a, s=s)
    d = d.to(cuda_device)
    succ = _init_successors(d).contiguous()
    rows = _strip_rows(256, a, seed=a + 1)
    gd, gs = fd.fw_repair_del_sweep_with_successors(d, succ, rows, block_size=s)
    wd, ws = ref.fw_repair_del_sweep_with_successors_ref(d, succ, rows, block_size=s)
    torch.cuda.synchronize()
    assert bits_equal(gd, wd) and bits_equal(gs, ws)


@pytest.mark.cuda
def test_lowered_engine_on_the_card_matches_the_plain_path(cuda_device):
    """solve, repair and repair_del of an engine pinned to each storage,
    card == CPU by bits (integer weights, so repair_del sweeps)."""
    from repro_torch.apsp import pack_reachability

    rng = np.random.default_rng(5)
    n = 100
    w = rng.integers(1, 9, size=(n, n)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.7] = np.inf
    np.fill_diagonal(w, 0.0)
    upd = [(3, 7, 1.0), (40, 2, 2.0), (99, 98, 1.0)]
    bits = (rng.uniform(size=(1, n, n)) < 0.05).astype(np.float32)
    bits[:, np.arange(n), np.arange(n)] = 1.0
    words = pack_reachability(bits).numpy()
    cases = [(dict(dtype=torch.int16), w, upd), (dict(dtype=torch.bfloat16), w, upd),
             (dict(dtype=torch.float16), w, upd),
             (dict(semiring="or_and", packed=True), words, [(3, 7, 1), (40, 2, -1)]),
             (dict(semiring="or_and"), (w < 5).astype(np.uint8), [(3, 7, 1)]),
             (dict(semiring="or_and"), (w < 5).astype(np.uint32), [(3, 7, 1)])]
    for kw, x, up in cases:
        eng = ApspEngine(block_size=32, validate=False, **kw)
        host = ApspEngine(block_size=32, validate=False, device="cpu", **kw)
        r0, h0 = eng.solve(x), host.solve(x)
        assert bits_equal(r0.dist.cpu(), h0.dist), kw
        assert bits_equal(eng.repair(r0.dist, up).dist.cpu(), host.repair(h0.dist, up).dist)
        if x.ndim == 3:
            continue
        x0, d0 = x.astype(np.float64), h0.dist.to(torch.float64).numpy()
        on_path = (x0 == d0) & (x0 != 0) & np.isfinite(x0) & ~np.eye(n, dtype=bool)
        u, v = np.argwhere(on_path)[0]
        x1 = x.copy()
        x1[u, v] = np.inf if x.dtype.kind == "f" else 0
        dels = [(int(u), int(v), x[u, v].item())]
        got = eng.repair_del(r0.dist, x1, dels, threshold=100.0)
        want = host.repair_del(h0.dist, x1, dels, threshold=100.0)
        assert bits_equal(got.dist.cpu(), want.dist), kw
        assert eng.stats.repair_dels == host.stats.repair_dels == 1
    for dtype in (torch.bfloat16, torch.float16):
        eng = ApspEngine(block_size=32, validate=False, dtype=dtype)
        host = ApspEngine(block_size=32, validate=False, dtype=dtype, device="cpu")
        r0, h0 = eng.solve(w, successors=True), host.solve(w, successors=True)
        got = eng.repair(r0.dist, upd, succ=r0.succ)
        want = host.repair(h0.dist, upd, succ=h0.succ)
        assert bits_equal(got.dist.cpu(), want.dist) and bits_equal(got.succ.cpu(), want.succ)


@pytest.mark.cuda
def test_a_build_failure_raises_rather_than_falling_back(cuda_device, tmp_path, monkeypatch):
    """A lowered library that does not build raises from the wrapper: the
    CUDA tensor never falls back to the plain version."""
    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for h in _build.CSRC.glob("*.cuh"):
        (csrc / h.name).write_bytes(h.read_bytes())
    (csrc / "fw_repair_lowered.cu").write_text("#error this source does not build\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    fp._lowered_lib.cache_clear()
    try:
        d = torch.zeros(64, 64, dtype=torch.bfloat16, device=cuda_device)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            fp.fw_repair(d, [0], [1], [1.0], block_size=16)
    finally:
        fp._lowered_lib.cache_clear()


@pytest.mark.cuda
def test_lowered_repair_launches_refuse_what_the_kernels_do_not_take(cuda_device):
    d = torch.zeros(64, 64, dtype=torch.bfloat16, device=cuda_device)
    E = fp.MAX_EDGES + 1
    u, v, w = fp.edge_vectors([0] * E, [1] * E, [1.0] * E, 64, cuda_device, d.dtype)
    with pytest.raises(ValueError):  # more edges than one launch pair takes
        fp.repair_phase("stage", d, u, v, w, fp.repair_buffers(d, E))
    with pytest.raises(ValueError):  # buffers of another dtype
        fp.repair_phase("stage", d, u[:4], v[:4], w[:4], fp.repair_buffers(d.float(), 4))
    with pytest.raises(TypeError):  # no int16 successor repair
        fp.fw_repair_with_successors(d.to(torch.int16), torch.zeros_like(d, dtype=torch.int32),
                                     [0], [1], [1], block_size=16)
    with pytest.raises(ValueError):  # plus_mul has no sweep, in any storage
        fd.fw_repair_del_sweep(d.to(torch.int32), [3], block_size=64,
                               semiring=SEMIRINGS["plus_mul"])


# ---------------------------------------------------------- flash decode
def _qkv(shape, dtype, seed, device):
    B, S, Hkv, g, hd = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dtype).to(device)
               for sh in ((B, Hkv, g, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    return q, k, v


def _decode_tolerance(dtype, want):
    """(rtol, atol): f32 the reference's 2e-5; bf16 its rtol 2e-2 with an
    atol of two bf16 ulps of the largest |output| (the kernel rounds each
    softmax weight P to bf16 where it meets V, at most 2^-9 of the weight,
    and sums in f32; both versions round the output once to bf16; the
    outputs shrink as kv_len grows)."""
    if dtype == torch.float32:
        return 2e-5, 2e-5
    top = float(want.float().abs().max())
    return 2e-2, float(2.0 * 2.0 ** (np.floor(np.log2(top)) - 7)) if top > 0 else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,kv_len", [((2, 512, 2, 4, 64), 512), ((1, 1024, 4, 1, 128), 300),
                                          ((2, 256, 1, 8, 64), 1), ((2, 768, 4, 7, 128), 700),
                                          ((1, 512, 2, 2, 64), 0)])
def test_kernel_flash_decode_matches_plain(cuda_device, dtype, tol, shape, kv_len):
    """Within the reference's rtol (``tol``) and ``_decode_tolerance``'s
    atol of the online and the masked plain version."""
    q, k, v = _qkv(shape, dtype, kv_len + shape[1], cuda_device)
    before = fdec.LAUNCHES["flash_decode"]
    got = fdec.flash_decode(q, k, v, torch.tensor(kv_len, device=cuda_device))
    want = ref.flash_decode_online_ref(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = _decode_tolerance(dtype, want)
    assert rtol == tol
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(got.float(), ref.flash_decode_ref(q, k, v, kv_len).float(),
                               rtol=rtol, atol=atol)
    assert fdec.LAUNCHES["flash_decode"] == before + 1
    if 0 < kv_len < shape[1]:  # the masked tail does not leak in
        k2, v2 = k.clone(), v.clone()
        k2[:, kv_len:] = 99.0
        v2[:, kv_len:] = -99.0
        torch.testing.assert_close(fdec.flash_decode(q, k2, v2, kv_len), got, rtol=1e-6,
                                   atol=1e-6)


# ------------------------- semiring_matmul's stagings, every storage
MATMUL_STORAGES = [(None, n) for n in NAMES] + REPAIR_CASES


def _mm_operand(tag, name, shape, seed):
    """(x on the CPU, semiring) in the storage; f32 salted with ±inf."""
    if tag is None:
        return _salted(name, shape, seed), SEMIRINGS[name]
    return _storage_case(tag, name, shape, seed)


def _mm_case(case, tag, name, dev):
    """(a, b, c, out or None, staging) of a named card case on dev; views
    are cut on the card from wider tensors, so their row stride is not
    their width."""
    def x(shape, seed):
        return _mm_operand(tag, name, shape, seed)[0].to(dev)

    if case == "ragged_n":  # (257,128)·(128,1031)
        return x((257, 128), 1), x((128, 1031), 2), x((257, 1031), 3), None, "scalar"
    if case == "k77_view":  # an aligned column slice: lda = 80 != k = 77
        return x((300, 80), 1)[:, :77], x((77, 136), 2), x((300, 136), 3), None, "vector"
    if case == "k77_shifted":  # the slice 3 columns in: no 16-byte rows
        return x((300, 80), 1)[:, 3:80], x((77, 136), 2), x((300, 136), 3), None, "scalar"
    if case == "k1000":
        return x((200, 1000), 1), x((1000, 136), 2), x((200, 136), 3), None, "vector"
    if case == "n130_strided_out":  # partial 4-wide column groups, out a view
        b = x((64, 136), 2)
        out = torch.empty((200, 136), dtype=b.dtype, device=dev)[:, :130]
        return x((200, 64), 1), b[:, :130], x((200, 136), 3)[:, :130], out, "vector"
    if case == "batched":
        return x((3, 40, 70), 1), x((3, 70, 130), 2), x((3, 40, 130), 3), None, "scalar"
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name", MATMUL_STORAGES, ids=lambda v: str(v))
@pytest.mark.parametrize("case", ["ragged_n", "k77_view", "k77_shifted", "k1000",
                                  "n130_strided_out", "batched", "alias"])
def test_kernel_semiring_matmul_stagings_match_plain(cuda_device, tag, name, case):
    """Both stagings of the kernel, by bits against the plain version, with
    and without c: ragged n, k not a multiple of the slice depth (77,
    1000), column-slice views with lda != k, a strided out, batched, and
    ``out`` aliasing ``c`` (the accumulator is otherwise left as it was)."""
    sr = _mm_operand(tag, name, (8, 8), 0)[1]
    kind = "semiring_matmul" + (f"[{tag}]" if tag else "")
    before = fmm.LAUNCHES[kind]
    if case == "alias":
        a, b, c = (_mm_operand(tag, name, sh, s)[0].to(cuda_device)
                   for sh, s in (((256, 128), 1), ((128, 384), 2), ((256, 384), 3)))
        want = ref.semiring_matmul_ref(a, b, c, semiring=sr)
        assert fmm.staging_name(a, b, c, c) == "vector"
        got = fmm.semiring_matmul(a, b, c, semiring=sr, out=c)
        torch.cuda.synchronize()
        assert got.data_ptr() == c.data_ptr() and bits_equal(c, want)
        assert fmm.LAUNCHES[kind] == before + 1
        return
    a, b, c, out, staging = _mm_case(case, tag, name, cuda_device)
    c0 = c.clone()
    for cc in (None, c):
        o = fmm.output(out, (*a.shape[:-1], b.shape[-1]), a)
        assert fmm.staging_name(a, b, cc, o) == staging, case
        got = fmm.semiring_matmul(a, b, cc, semiring=sr, out=out)
        want = ref.semiring_matmul_ref(a, b, cc, semiring=sr)
        torch.cuda.synchronize()
        assert got.dtype == a.dtype and bits_equal(got, want), (tag, name, case, cc is None)
    assert bits_equal(c, c0) and fmm.LAUNCHES[kind] == before + 2


# -------------------------------------- flash_decode's tiles and splits
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("g", [1, 2, 7, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("kv_len", [0, 1, 63, 64, 65, 1000])
def test_kernel_flash_decode_tiles(cuda_device, dtype, g, hd, kv_len):
    """S = 1000, not a multiple of the 16-row KV tile or the 64-row split
    step; kv_len at tile edges and S: within ``_decode_tolerance`` of both
    plain versions, the masked tail poisoned without effect."""
    S = 1000
    q, k, v = _qkv((2, S, 2, g, hd), dtype, g * 1000 + hd + kv_len, cuda_device)
    got = fdec.flash_decode(q, k, v, torch.tensor(kv_len, device=cuda_device))
    want = ref.flash_decode_online_ref(q, k, v, kv_len)
    torch.cuda.synchronize()
    rtol, atol = _decode_tolerance(dtype, want)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(got.float(), ref.flash_decode_ref(q, k, v, kv_len).float(),
                               rtol=rtol, atol=atol)
    if 0 < kv_len < S:
        k2, v2 = k.clone(), v.clone()
        k2[:, kv_len:] = 99.0
        v2[:, kv_len:] = -99.0
        torch.testing.assert_close(fdec.flash_decode(q, k2, v2, kv_len), got, rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------- the relax launches alone
# The relax kernels fold 128 x 128 output tiles on the matmul's mainloop,
# whatever s, in their own fixed slices: each launch alone against its plain
# phase, by bits, at every bk the wrappers accept, every pivot position,
# every s and a batch.
def _bands_of(w, bands):
    """The band buffers as the plain phase takes them: batched like w."""
    return tuple(t if w.ndim == 3 else t[0] for t in bands)


def _relax_input(tag, name, shape, seed, s, salt):
    """(w on the CPU, semiring): f32 salted with ±0 or, apart, with NaN off
    the diagonal tiles; the 16-bit floats likewise; int16, packed and the
    int32 carrier as ``_storage_case`` makes them."""
    if tag in (None, "bf16", "f16"):
        m = max(shape[-2:])  # a non-square block is cut from the square case
        square = (*shape[:-2], m, m)
        w = (_signed_zero_graph(name, square, seed) if salt == "zero"
             else _nan_salted(_domain_graph(name, square, seed), seed, 2, s))
        w = w[..., :shape[-2], :shape[-1]].copy()
        dt = {None: torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[tag]
        return torch.from_numpy(w).to(dt), SEMIRINGS[name]
    return _storage_case(tag, name, shape, seed, s)


RELAX_SHAPES = [((3, 256, 256), 16), ((3, 256, 256), 32), ((3, 256, 256), 64),
                ((3, 384, 384), 128)]
RELAX_STORAGES = ([(None, n, salt) for n in NAMES for salt in ("zero", "nan")]
                  + [(t, n, salt) for t in ("bf16", "f16") for n in NAMES
                     for salt in ("zero", "nan")]
                  + [c + ("-",) for c in REPAIR_CASES if c[0] not in ("bf16", "f16")])


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name,salt", RELAX_STORAGES, ids=lambda v: str(v))
@pytest.mark.parametrize("shape,s", RELAX_SHAPES)
def test_kernel_relax_alone_matches_plain(cuda_device, tag, name, salt, shape, s):
    w, sr = _relax_input(tag, name, shape, s, s, salt)
    w = w.to(cuda_device)
    T = shape[-1] // s
    kind = "fw_round/relax" + (f"[{tag}]" if tag else "")
    before = fr.LAUNCHES[kind]
    for b in (0, T // 2, T - 1):
        bands = fr.round_buffers(w, s)
        fr.fw_round_phase("diag", w, b, bands, block_size=s, semiring=sr)
        fr.fw_round_phase("bands", w, b, bands, block_size=s, semiring=sr)
        want = ref.relax(w, *_bands_of(w, bands), b, semiring=sr)
        for bk in (8, 16, 32, s):
            got = w.clone()
            fr.fw_round_phase("relax", got, b, bands, block_size=s, bk=bk, semiring=sr)
            torch.cuda.synchronize()
            assert got.dtype == w.dtype and bits_equal(got, want), (b, bk)
        if salt != "-":
            _assert_salt_survives(name, want, zeros=salt == "zero", nans=salt == "nan")
    assert fr.LAUNCHES[kind] == before + 12


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name,salt", [(None, "min_plus", "zero"), (None, "plus_mul", "nan"),
                                           ("bf16", "max_plus", "zero"), ("f16", "plus_mul", "nan"),
                                           ("int16", "min_plus", "-"), ("packed", "or_and", "-"),
                                           ("plus_mul_i32", "plus_mul", "-")],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("shape,s", [((80, 48), 16), ((3, 96, 160), 32), ((384, 256), 128),
                                     ((3, 272, 400), 16)])
def test_kernel_bordered_relax_alone_matches_plain(cuda_device, tag, name, salt, shape, s):
    """Ragged bordered blocks (rows, cols multiples of s, not of 128) with
    the owner echo off the pivot (pr / pc != 0)."""
    w, sr = _relax_input(tag, name, shape, s, s, salt)
    w = w.to(cuda_device)
    tr, tc = shape[-2] // s, shape[-1] // s
    for echo in ((-1, -1), (1, 1), (tr - 1, tc - 1), (1, -1), (-1, tc - 1)):
        bands = fr.bordered_round_buffers(w, s)
        for phase in ("diag", "bands"):
            fr.fw_round_bordered_phase(phase, w, *echo, bands, block_size=s, semiring=sr)
        want = ref.relax_bordered(w, *_bands_of(w, bands), *echo, semiring=sr)
        for bk in (8, 16, 32, s):
            got = w.clone()
            fr.fw_round_bordered_phase("relax", got, *echo, bands, block_size=s, bk=bk,
                                       semiring=sr)
            torch.cuda.synchronize()
            assert bits_equal(got, want), (echo, bk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,s", RELAX_SHAPES + [((96, 96), 16), ((160, 160), 32)])
def test_kernel_successor_relax_alone_matches_plain(cuda_device, dtype, shape, s):
    """Integer weights in [1, 4], so that equal candidates are everywhere
    (only a strictly smaller one takes its hop), and an isolated node's row
    and column, which no k improves."""
    rng = np.random.default_rng(s)
    w = rng.integers(1, 5, size=shape).astype(np.float32)
    w[rng.uniform(size=shape) < 0.3] = np.inf
    w[..., 5, :] = np.inf
    w[..., :, 5] = np.inf
    idx = np.arange(shape[-1])
    w[..., idx, idx] = 0.0
    w = torch.from_numpy(w).to(dtype).to(cuda_device)
    succ = _init_successors(w).contiguous()
    T = shape[-1] // s
    for b in (0, T // 2, T - 1):
        bands = fr.succ_round_buffers(w, s)
        for phase in ("diag", "bands"):
            fr.fw_round_with_successors_phase(phase, w, succ, b, bands, block_size=s)
        rw, cw, rs, cs = _bands_of(w, bands)
        wd, ws = ref.relax_succ_tiles(w, succ, rw, rs, cw, cs, b)
        gd, gs = w.clone(), succ.clone()
        fr.fw_round_with_successors_phase("relax", gd, gs, b, bands, block_size=s)
        torch.cuda.synchronize()
        assert bits_equal(gd, wd) and bits_equal(gs, ws), b
        assert bool((ws != succ).any()) and bool((ws == succ).any())


@pytest.mark.cuda
def test_relax_refuses_unaligned_buffers(cuda_device):
    w = torch.zeros(64 * 64 + 1, device=cuda_device)[1:].view(64, 64)
    bands = fr.round_buffers(w, 16)
    with pytest.raises(ValueError, match="16-byte"):
        fr.fw_round_phase("relax", w, 0, bands, block_size=16)


# ------------------------------------ the chains: diag and bands at every s
CHAIN_STORAGES = [(None, n) for n in NAMES] + REPAIR_CASES


def _chain_input(tag, name, shape, seed, s):
    """(w on the CPU, semiring): f32 salted with ±inf, or a storage case."""
    if tag is None:
        return _salted(name, shape, seed), SEMIRINGS[name]
    return _storage_case(tag, name, shape, seed, s)


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name", CHAIN_STORAGES, ids=lambda v: str(v))
@pytest.mark.parametrize("s", [16, 32, 64, 128])
@pytest.mark.parametrize("geometry", ["square", "batched", "bordered"])
def test_chain_kernels_match_plain_phases(cuda_device, tag, name, s, geometry):
    """The diag and bands launches alone, by bits against the plain phases
    (close_diag, close_bands / close_bordered_bands): square at the first
    and a middle pivot, a batch of 3, and a tall bordered block with the
    owner echo at both bands, at one at a time and at none.  n = 5s cuts
    each band tile into 2 or 4 CTAs (fw_round.cuh:band_split); n = 40s at
    s = 128 keeps it whole."""
    if geometry == "bordered":
        shape, b, echoes = (6 * s, 4 * s), 0, ((-1, -1), (2, 1), (5, -1), (-1, 3))
    elif geometry == "batched":
        shape, b, echoes = (3, 5 * s, 5 * s), 4, ((-1, -1),)
    else:
        n = 40 * s if s == 128 else 5 * s
        shape, b, echoes = (n, n), 2, ((-1, -1),)
    w, sr = _chain_input(tag, name, shape, seed=s, s=s)
    w = w.to(cuda_device)
    kinds = {p: f"fw_round{'_bordered' if geometry == 'bordered' else ''}/{p}"
                + (f"[{tag}]" if tag else "") for p in ("diag", "bands")}
    before = {p: fr.LAUNCHES[k] for p, k in kinds.items()}
    o = slice(b * s, (b + 1) * s)
    diag = ref.close_diag(w[..., o, o], sr)
    for echo in echoes:
        if geometry == "bordered":
            bands = fr.bordered_round_buffers(w, s)
            for phase in ("diag", "bands"):
                fr.fw_round_bordered_phase(phase, w, *echo, bands, block_size=s, semiring=sr)
            row, col = ref.close_bordered_bands(w, diag, *echo, sr)
        else:
            bands = fr.round_buffers(w, s)
            for phase in ("diag", "bands"):
                fr.fw_round_phase(phase, w, b, bands, block_size=s, semiring=sr)
            row, col = ref.close_bands(w, diag, b, sr)
        got_row, got_col = _bands_of(w, bands)
        torch.cuda.synchronize()
        assert bits_equal(got_row[..., :, o], diag) and bits_equal(got_col[..., o, :], diag)
        assert bits_equal(got_row, row) and bits_equal(got_col, col), echo
    assert all(fr.LAUNCHES[k] == before[p] + len(echoes) for p, k in kinds.items())


# ----------------------- the successor round's chains: diag and bands at every s
def _tie_graph(shape, seed):
    """Integer weights in [1, 4] (equal candidates everywhere: only a
    strictly smaller one takes its hop), 30 % missing, the diagonal 0."""
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 5, size=shape).astype(np.float32)
    w[rng.uniform(size=shape) < 0.3] = np.inf
    idx = np.arange(shape[-1])
    w[..., idx, idx] = 0.0
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s", [16, 32, 64, 128])
@pytest.mark.parametrize("geometry", ["square", "batched", "ties"])
def test_succ_chain_kernels_match_plain_phases(cuda_device, dtype, s, geometry):
    """The successor diag and bands launches alone, distances and next hops
    by bits against the plain phases (close_diag_succ, close_bands_succ):
    n = 5s (each band tile cut into 2–4 CTAs) and, at s = 128, n = 40s
    (kept whole); a batch of 3; tie-heavy integer weights, where only the
    strict compare decides a hop, with a negative cycle planted on the
    pivot block's diagonal."""
    if geometry == "batched":
        shape, b = (3, 5 * s, 5 * s), 4
        w = _graph("min_plus", shape, seed=s)
    elif geometry == "ties":
        shape, b = (5 * s, 5 * s), 1
        w = _tie_graph(shape, seed=s)
        idx = np.arange(b * s, (b + 1) * s, 3)
        w[..., idx, idx] = -3.0
    else:
        n = 40 * s if s == 128 else 5 * s
        shape, b = (n, n), 2
        w = _graph("min_plus", shape, seed=s)
    w = torch.from_numpy(w).to(dtype).to(cuda_device)
    succ = _init_successors(w).contiguous()
    tag = {torch.float32: "", torch.bfloat16: "[bf16]", torch.float16: "[f16]"}[dtype]
    kinds = [f"fw_round_with_successors/{p}{tag}" for p in ("diag", "bands")]
    before = [fr.LAUNCHES[k] for k in kinds]
    bands = fr.succ_round_buffers(w, s)
    for phase in ("diag", "bands"):
        fr.fw_round_with_successors_phase(phase, w, succ, b, bands, block_size=s)
    o = slice(b * s, (b + 1) * s)
    diag, dsucc = ref.close_diag_succ(w[..., o, o], succ[..., o, o])
    row, rsucc, col, csucc = ref.close_bands_succ(w, succ, diag, dsucc, b)
    rw, cw, rs, cs = _bands_of(w, bands)
    torch.cuda.synchronize()
    assert bits_equal(rw[..., :, o], diag) and bits_equal(rs[..., :, o], dsucc)
    assert bits_equal(rw, row) and bits_equal(rs, rsucc)
    assert bits_equal(cw, col) and bits_equal(cs, csucc)
    assert [fr.LAUNCHES[k] for k in kinds] == [x + 1 for x in before]


# ------------------------- the sweep's chains: diag and panels at every s
SWEEP_CHAIN_STORAGES = ([(None, n, salt) for n in IDEMPOTENT for salt in ("zero", "nan")]
                        + [(t, n, salt) for t in ("bf16", "f16") for n in IDEMPOTENT
                           for salt in ("zero", "nan")]
                        + [c + ("-",) for c in SWEEP_CASES if c[0] not in ("bf16", "f16")])


def _planted_diagonal(x, name):
    """x with every third diagonal element off the ⊗-identity: -3 under
    min_plus (negative cycles), 3 under max_plus."""
    x = x.clone()
    idx = torch.arange(0, x.shape[-1], 3)
    x[idx, idx] = torch.tensor(-3.0 if name == "min_plus" else 3.0).to(x.dtype)
    return x


def _sweep_chain_rows(n, s, a_pad, b, seed):
    """a_pad strip rows: min(a_pad - 1, n / 2) distinct real rows, sorted,
    two of them inside pivot block b; padding rows (index n) after them."""
    rng = np.random.default_rng(seed)
    a = min(a_pad - 1, n // 2)
    inside = b * s + rng.choice(s, 2, replace=False)
    rest = rng.choice(np.setdiff1d(np.arange(n), inside), a - 2, replace=False)
    rows = np.full(a_pad, n, np.int32)
    rows[:a] = np.sort(np.concatenate([inside, rest]))
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name,salt", SWEEP_CHAIN_STORAGES, ids=lambda v: str(v))
@pytest.mark.parametrize("s", [16, 32, 64, 128])
def test_sweep_chain_kernels_match_plain_phases(cuda_device, tag, name, salt, s):
    """The sweep's diag and panels launches alone, by bits against
    ``sweep_diag_ref`` / ``sweep_panels_ref``: strips of 8, 16 and 64 rows
    (two inside the pivot block, padding rows), n = 2s (one band tile, cut
    into CTAs by fw_phases.cuh:band_split) and n = 5s, the strip holding
    other values than d_init's rows (the overlay must read it); f32 and
    bf16 / f16 salted with ±0 or, apart, off-diagonal NaN; and, under
    min_plus / max_plus, planted non-identity diagonals."""
    kinds = {p: f"fw_repair_del_sweep/{p}" + (f"[{tag}]" if tag else "")
             for p in ("diag", "panels")}
    before = {p: fd.LAUNCHES[k] for p, k in kinds.items()}
    launches = 0
    for n, b in ((2 * s, 1), (5 * s, 2)):
        o = slice(b * s, (b + 1) * s)

        def case(seed):
            return (_storage_case(tag, name, (n, n), seed, s) if salt == "-"
                    else _relax_input(tag, name, (n, n), seed, s, salt))

        (x, sr), (other, _) = case(s + n), case(s + n + 1)
        plant = (False, True) if name in ("min_plus", "max_plus") and tag != "packed" else (False,)
        for planted in plant:
            d = (_planted_diagonal(x, name) if planted else x).to(cuda_device)
            src = (_planted_diagonal(other, name) if planted else other).to(cuda_device)
            for a_pad in (8, 16, 64):
                rows = _sweep_chain_rows(n, s, a_pad, b, seed=a_pad + n)
                sw = fd.sweep_buffers(d, rows, block_size=s)
                sw.strip.copy_(src[torch.from_numpy(np.minimum(rows, n - 1)).long().to(cuda_device)])
                fd.sweep_phase("diag", sw, b, semiring=sr)
                fd.sweep_phase("panels", sw, b, semiring=sr)
                diag = ref.sweep_diag_ref(d, sw.strip, sw.rows, b, block_size=s, semiring=sr)
                band, acol = ref.sweep_panels_ref(d, sw.strip, sw.rows, diag, b, semiring=sr)
                torch.cuda.synchronize()
                what = (n, a_pad, planted)
                assert bits_equal(sw.band[:, o], diag), what
                assert bits_equal(sw.band, band) and bits_equal(sw.acol, acol), what
                launches += 1
    assert all(fd.LAUNCHES[k] == before[p] + launches for p, k in kinds.items())


# ------------------- the successor sweep's chains: diag and panels at every s
def _succ_sweep_input(dtype, salt, n, s, seed):
    """(d, its init next hops) on the CPU: min_plus salted with ±0 or, apart,
    NaN off the diagonal tiles, or tie-heavy integer weights (only the
    strict compare decides a hop) with negative cycles planted on every
    third diagonal entry."""
    if salt == "ties":
        w = _tie_graph((n, n), seed)
        idx = np.arange(0, n, 3)
        w[idx, idx] = -3.0
    elif salt == "zero":
        w = _signed_zero_graph("min_plus", (n, n), seed)
    else:
        w = _nan_salted(_domain_graph("min_plus", (n, n), seed), seed, 2, s)
    d = torch.from_numpy(w).to(dtype)
    return d, _init_successors(d).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("salt", ["zero", "nan", "ties"])
@pytest.mark.parametrize("s", [16, 32, 64, 128])
def test_succ_sweep_chain_kernels_match_plain_phases(cuda_device, dtype, salt, s):
    """The successor sweep's diag and panels launches alone, distances and
    next hops by bits against ``sweep_diag_succ_ref`` /
    ``sweep_panels_succ_ref``: strips of 8, 16 and 64 rows (two inside the
    pivot block, padding rows), n = 2s (one band tile, cut into CTAs by
    fw_phases.cuh:band_split) and n = 5s, the strip and its hops holding
    other values than d_init's and s_init's rows (the overlay must read
    them)."""
    tag = {torch.float32: "", torch.bfloat16: "[bf16]", torch.float16: "[f16]"}[dtype]
    kinds = {p: f"fw_repair_del_sweep_with_successors/{p}{tag}" for p in ("diag", "panels")}
    before = {p: fd.LAUNCHES[k] for p, k in kinds.items()}
    launches = 0
    for n, b in ((2 * s, 1), (5 * s, 2)):
        o = slice(b * s, (b + 1) * s)
        d, sd = (t.to(cuda_device) for t in _succ_sweep_input(dtype, salt, n, s, s + n))
        other, other_s = (t.to(cuda_device)
                          for t in _succ_sweep_input(dtype, salt, n, s, s + n + 1))
        for a_pad in (8, 16, 64):
            rows = _sweep_chain_rows(n, s, a_pad, b, seed=a_pad + n)
            sw = fd.sweep_buffers(d, rows, block_size=s, s_init=sd)
            idx = torch.from_numpy(np.minimum(rows, n - 1)).long().to(cuda_device)
            sw.strip.copy_(other[idx])
            sw.strip_s.copy_(other_s[idx])
            fd.sweep_succ_phase("diag", sw, b)
            fd.sweep_succ_phase("panels", sw, b)
            diag, dsucc = ref.sweep_diag_succ_ref(d, sd, sw.strip, sw.strip_s, sw.rows, b,
                                                  block_size=s)
            want = ref.sweep_panels_succ_ref(d, sd, sw.strip, sw.strip_s, sw.rows, diag, dsucc, b)
            torch.cuda.synchronize()
            what = (n, a_pad)
            assert bits_equal(sw.band[:, o], diag) and bits_equal(sw.band_s[:, o], dsucc), what
            for got, x in zip((sw.band, sw.band_s, sw.acol, sw.acol_s), want):
                assert bits_equal(got, x), what
            launches += 1
    assert all(fd.LAUNCHES[k] == before[p] + launches for p, k in kinds.items())


# ------------------- the sweep's relax: both tiles, every height, every storage
RELAX_A_PADS = (8, 16, 24, 64, 136, 256)  # both sides of relax_height's switch
RELAX_HEIGHTS = (*fd.SHORT_HEIGHTS, fd.LONG_HEIGHT)


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name,salt", SWEEP_CHAIN_STORAGES, ids=lambda v: str(v))
@pytest.mark.parametrize("s", [16, 128])
def test_sweep_relax_kernels_match_plain_phase(cuda_device, tag, name, salt, s):
    """The relax launch alone on every tile (the short tile at 8, 16, 32 and
    64 rows, the mainloop's 128), each at a_pad 8, 16, 24, 64, 136 and 256
    (``relax_height`` picks one of them), by bits against
    ``sweep_relax_ref``: n = 384, round 1, real rows inside the pivot block
    and padding rows, the strip holding other values than d_init's rows;
    f32 and bf16 / f16 salted with ±0 or, apart, off-diagonal NaN, and every
    other sweep storage."""
    n, b = 384, 1
    kind = "fw_repair_del_sweep/relax" + (f"[{tag}]" if tag else "")
    before = fd.LAUNCHES[kind]

    def case(seed):
        return (_storage_case(tag, name, (n, n), seed, s) if salt == "-"
                else _relax_input(tag, name, (n, n), seed, s, salt))

    (x, sr), (other, _) = case(s + 7), case(s + 8)
    d, src = x.to(cuda_device), other.to(cuda_device)
    for a_pad in RELAX_A_PADS:
        rows = _sweep_chain_rows(n, s, a_pad, b, seed=a_pad + s)
        sw = fd.sweep_buffers(d, rows, block_size=s)
        sw.strip.copy_(src[torch.from_numpy(np.minimum(rows, n - 1)).long().to(cuda_device)])
        fd.sweep_phase("diag", sw, b, semiring=sr)
        fd.sweep_phase("panels", sw, b, semiring=sr)
        strip = sw.strip.clone()
        want = ref.sweep_relax_ref(strip, sw.rows, sw.band, sw.acol, b, semiring=sr)
        for h in RELAX_HEIGHTS:
            sw.strip.copy_(strip)
            fd.sweep_phase("relax", sw, b, semiring=sr, height=h)
            torch.cuda.synchronize()
            assert bits_equal(sw.strip, want), (a_pad, h)
    assert fd.LAUNCHES[kind] == before + len(RELAX_A_PADS) * len(RELAX_HEIGHTS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("salt", ["zero", "nan", "ties"])
@pytest.mark.parametrize("s", [16, 128])
def test_succ_sweep_relax_kernels_match_plain_phase(cuda_device, dtype, salt, s):
    """The successor relax launch alone on every tile and at every a_pad of
    ``test_sweep_relax_kernels_match_plain_phase``, distances and next hops
    by bits against ``sweep_relax_succ_ref``: the kept-k gather, the start's
    hop where no k improved (from acol_s in block column b), the band and
    band_s rows of the strip rows inside the pivot block."""
    n, b = 384, 1
    tag = {torch.float32: "", torch.bfloat16: "[bf16]", torch.float16: "[f16]"}[dtype]
    kind = f"fw_repair_del_sweep_with_successors/relax{tag}"
    before = fd.LAUNCHES[kind]
    d, sd = (t.to(cuda_device) for t in _succ_sweep_input(dtype, salt, n, s, s + 7))
    other, other_s = (t.to(cuda_device) for t in _succ_sweep_input(dtype, salt, n, s, s + 8))
    for a_pad in RELAX_A_PADS:
        rows = _sweep_chain_rows(n, s, a_pad, b, seed=a_pad + s)
        sw = fd.sweep_buffers(d, rows, block_size=s, s_init=sd)
        idx = torch.from_numpy(np.minimum(rows, n - 1)).long().to(cuda_device)
        sw.strip.copy_(other[idx])
        sw.strip_s.copy_(other_s[idx])
        fd.sweep_succ_phase("diag", sw, b)
        fd.sweep_succ_phase("panels", sw, b)
        strip, strip_s = sw.strip.clone(), sw.strip_s.clone()
        wd, ws = ref.sweep_relax_succ_ref(strip, strip_s, sw.rows, sw.band, sw.band_s, sw.acol,
                                          sw.acol_s, b)
        assert not bits_equal(ws, strip_s)  # some hop moved
        for h in RELAX_HEIGHTS:
            sw.strip.copy_(strip)
            sw.strip_s.copy_(strip_s)
            fd.sweep_succ_phase("relax", sw, b, height=h)
            torch.cuda.synchronize()
            assert bits_equal(sw.strip, wd) and bits_equal(sw.strip_s, ws), (a_pad, h)
    assert fd.LAUNCHES[kind] == before + len(RELAX_A_PADS) * len(RELAX_HEIGHTS)


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name", [(None, n) for n in IDEMPOTENT] + SWEEP_CASES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("s", [32, 128])
def test_kernel_sweep_of_every_row_matches_plain(cuda_device, tag, name, s):
    """The whole sweep at a_pad = m (every row affected: the long tile,
    n / 128 tiles a side), by bits against the plain sweep; with next hops
    in f32, bf16 and f16."""
    n = 256
    d, sr = (torch.from_numpy(_graph(name, (n, n), seed=s)), SEMIRINGS[name]) if tag is None \
        else _storage_case(tag, name, (n, n), seed=s, s=s)
    d = d.to(cuda_device)
    rows = np.arange(n, dtype=np.int32)
    got = fd.fw_repair_del_sweep(d, rows, block_size=s, semiring=sr)
    want = ref.fw_repair_del_sweep_ref(d, rows, block_size=s, semiring=sr)
    torch.cuda.synchronize()
    assert bits_equal(got, want)
    if tag in (None, "bf16", "f16") and name == "min_plus":
        succ = _init_successors(d).contiguous()
        gd, gs = fd.fw_repair_del_sweep_with_successors(d, succ, rows, block_size=s)
        wd, ws = ref.fw_repair_del_sweep_with_successors_ref(d, succ, rows, block_size=s)
        torch.cuda.synchronize()
        assert bits_equal(gd, wd) and bits_equal(gs, ws)


@pytest.mark.cuda
def test_sweep_relax_refuses_an_unknown_height(cuda_device):
    d = torch.zeros(128, 128, device=cuda_device)
    sw = fd.sweep_buffers(d, [3, 70], block_size=64)
    before = dict(fd.LAUNCHES)
    for h in (0, 12, 256):
        with pytest.raises(ValueError, match="height"):
            fd.sweep_phase("relax", sw, 1, height=h)
    assert dict(fd.LAUNCHES) == before


@pytest.mark.cuda
def test_succ_sweep_refuses_a_misaligned_hop_buffer(cuda_device):
    """The successor diag and panels move the hop buffers four at a time: a
    hop buffer 4 bytes off a 16-byte boundary raises before any launch."""
    n, s = 128, 32
    d = torch.zeros(n, n, device=cuda_device)
    sd = torch.zeros(n, n, dtype=torch.int32, device=cuda_device)
    before = dict(fd.LAUNCHES)
    for field in ("s_init", "strip_s", "band_s", "acol_s"):
        sw = fd.sweep_buffers(d, [3, 70], block_size=s, s_init=sd)
        t = getattr(sw, field)
        off = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)[1:].view(t.shape)
        setattr(sw, field, off)
        for phase in fd.PHASES:
            with pytest.raises(ValueError, match="16-byte aligned"):
                fd.sweep_succ_phase(phase, sw, 1)
    assert dict(fd.LAUNCHES) == before


# ------------------- the 4-dispatch round's chains: closure and bands at every s
def _odd_strided(x):
    """x's values as a view at an odd row stride, 3 rows and 5 elements
    into its storage: no operand of it meets the 4-wide moves."""
    B, r, c = x.shape
    v = torch.zeros((B, r + 3, c + 5 + c % 2), dtype=x.dtype, device=x.device)[:, 3:, 5:5 + c]
    v.copy_(x)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name,salt", RELAX_STORAGES, ids=lambda v: str(v))
@pytest.mark.parametrize("s", [16, 32, 64, 128])
def test_phase_chain_kernels_match_plain_phases(cuda_device, tag, name, salt, s):
    """``fw_phase1`` and both bands (fw_phase.cuh: closure_kernel,
    band_kernel) by bits against their plain phases: a batch of 3, band
    lengths 1, s - 3 and 1000 (ragged: the last tile's chains masked, a
    band of one tile cut into CTAs that mostly leave), the pivot's own tile
    inside the band where it fits; operands as aligned slices of one matrix
    (4-wide moves), as slices at an odd row stride and an unaligned base
    (one element at a time), and aligned with outputs into such slices; f32
    and bf16 / f16 salted with ±0 or, apart, NaN off the diagonal tiles (in
    the bands, not in the pivot tile), every other storage; under min_plus
    / max_plus also planted non-identity diagonals."""
    kinds = [k + (f"[{tag}]" if tag else "") for k in ("fw_phase1", "fw_phase2_row",
                                                        "fw_phase2_col")]
    before = {k: fph.LAUNCHES[k] for k in kinds}
    launches = 0
    plants = (False, True) if name in ("min_plus", "max_plus") and tag != "packed" else (False,)
    for n in (1, s - 3, 1000):
        m = max(n, 2 * s)
        o = slice(s, 2 * s) if n >= 2 * s else slice(0, s)
        x, sr = _relax_input(tag, name, (3, m, m), s + n, s, salt)
        for planted in plants:
            if planted:  # every third diagonal element off the ⊗-identity
                x = x.clone()
                idx = torch.arange(0, m, 3)
                x[..., idx, idx] = torch.tensor(-3.0 if name == "min_plus" else 3.0).to(x.dtype)
            for layout in ("aligned", "strided", "out"):
                xs = _odd_strided(x.to(cuda_device)) if layout == "strided" else x.to(cuda_device)
                outs = {} if layout != "out" else {
                    k: _odd_strided(torch.empty(shape, dtype=x.dtype, device=cuda_device))
                    for k, shape in (("d", (3, s, s)), ("r", (3, s, n)), ("c", (3, n, s)))}
                tile, row, col = xs[:, o, o], xs[:, o, :n], xs[:, :n, o]
                got_d = fph.fw_phase1(tile, semiring=sr, out=outs.get("d"))
                diag = ref.fw_phase1_ref(tile, semiring=sr)
                diag = _odd_strided(diag) if layout == "strided" else diag
                got_r = fw_phase2.fw_phase2_row(diag, row, semiring=sr, out=outs.get("r"))
                got_c = fw_phase2.fw_phase2_col(diag, col, semiring=sr, out=outs.get("c"))
                want_r = ref.fw_phase2_row_ref(diag, row, semiring=sr)
                want_c = ref.fw_phase2_col_ref(diag, col, semiring=sr)
                torch.cuda.synchronize()
                what = (n, planted, layout)
                assert got_d.dtype == tile.dtype and bits_equal(got_d, diag), what
                assert bits_equal(got_r, want_r) and bits_equal(got_c, want_c), what
                launches += 1
    assert all(fph.LAUNCHES[k] == before[k] + launches for k in kinds)


@pytest.mark.cuda
@pytest.mark.parametrize("tag,name", [(None, "min_plus"), (None, "plus_mul"),
                                      ("bf16", "plus_mul"), ("f16", "plus_mul"),
                                      ("int16", "min_plus"), ("packed", "or_and")],
                         ids=lambda v: str(v))
def test_public_wrappers_take_strided_and_unaligned_views(cuda_device, tag, name):
    """C.7: a transposed view and a view 2 elements into its storage (not
    16-byte aligned) go through the kernels (launch counts) and give the
    plain answer, in place for the rounds, as new tensors for the repair
    and the sweep, whose inputs are left as they were."""
    s, n = 32, 96
    w, sr = _chain_input(tag, name, (n, n), seed=5, s=s)
    w = w.to(cuda_device)
    suffix = f"[{tag}]" if tag else ""

    def views():
        t = w.t().contiguous().t()  # w's values, column-major
        flat = torch.empty(n * n + 2, dtype=w.dtype, device=cuda_device)
        shifted = flat[2:].view(n, n)
        shifted.copy_(w)
        return t, shifted

    for v in views():
        x = v.clone()
        want = ref.fw_round_ref(x, 1, block_size=s, semiring=sr)
        before = fr.LAUNCHES["fw_round/relax" + suffix]
        assert fr.fw_round(v, 1, block_size=s, semiring=sr) is v
        torch.cuda.synchronize()
        assert bits_equal(v, want) and fr.LAUNCHES["fw_round/relax" + suffix] == before + 1
    for v in views():
        want = ref.fw_round_bordered_ref(v.clone(), 1, 2, block_size=s, semiring=sr)
        before = fr.LAUNCHES["fw_round_bordered/relax" + suffix]
        assert fr.fw_round_bordered(v, 1, 2, block_size=s, semiring=sr) is v
        torch.cuda.synchronize()
        assert bits_equal(v, want) and fr.LAUNCHES["fw_round_bordered/relax" + suffix] == before + 1
    if tag in ("packed", "int16"):
        return
    d = solve(w, semiring=name, method="fused", block_size=s, validate=False,
              device=cuda_device.type).dist
    d = d.to(w.dtype) if d.dtype != w.dtype else d
    u, vv, ew = _lowered_edges(d, sr, 3, seed=1) if tag else _edges(name, n, 3, seed=1)
    for v in (d.t().contiguous().t(), d.t()):
        keep = v.clone()
        want = ref.fw_repair_ref(keep, u, vv, ew, semiring=sr)
        before = fp.LAUNCHES["fw_repair/apply" + suffix]
        got = fp.fw_repair(v, u, vv, ew, block_size=s, semiring=sr)
        torch.cuda.synchronize()
        assert bits_equal(got, want) and bits_equal(v, keep)
        assert fp.LAUNCHES["fw_repair/apply" + suffix] == before + 1
    if name in ("min_plus", "max_plus", "max_min", "or_and"):
        rows = _strip_rows(n, 5, seed=2)
        v = d.t().contiguous().t()
        want = ref.fw_repair_del_sweep_ref(v.contiguous(), rows, block_size=s, semiring=sr)
        before = fd.LAUNCHES["fw_repair_del_sweep/relax" + suffix]
        got = fd.fw_repair_del_sweep(v, rows, block_size=s, semiring=sr)
        torch.cuda.synchronize()
        assert bits_equal(got, want)
        assert fd.LAUNCHES["fw_repair_del_sweep/relax" + suffix] == before + n // s
    if name == "min_plus" and tag in (None, "bf16", "f16"):
        dist = d.t().contiguous().t()
        succ = _init_successors(dist.contiguous()).t().contiguous().t()
        want = ref.fw_round_with_successors_ref(dist.clone(), succ.clone(), 1, block_size=s)
        gd, gs = fr.fw_round_with_successors(dist, succ, 1, block_size=s)
        torch.cuda.synchronize()
        assert gd is dist and gs is succ
        assert bits_equal(dist, want[0]) and bits_equal(succ, want[1])
        e = _lowered_edges(dist, sr, 3, seed=4) if tag else _edges("min_plus", n, 3, seed=4)
        want = ref.fw_repair_with_successors_ref(dist.contiguous(), succ.contiguous(), *e)
        got = fp.fw_repair_with_successors(dist, succ, *e, block_size=s)
        torch.cuda.synchronize()
        assert bits_equal(got[0], want[0]) and bits_equal(got[1], want[1])
        want = ref.fw_repair_del_sweep_with_successors_ref(
            dist.contiguous(), succ.contiguous(), _strip_rows(n, 5, seed=3), block_size=s)
        got = fd.fw_repair_del_sweep_with_successors(dist, succ, _strip_rows(n, 5, seed=3),
                                                     block_size=s)
        torch.cuda.synchronize()
        assert bits_equal(got[0], want[0]) and bits_equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,s", [((64, 64), 16), ((2, 256, 256), 128)])
def test_f16_plus_mul_kernels_are_one_fma(cuda_device, shape, s):
    """f16 plus_mul: the round, the matmul and a solve on the card == the
    plain twin's one rounded f16 FMA a step, on signed operands, where a
    chain rounding the product and the sum apart differs."""
    rng = np.random.default_rng(s)
    scale = 0.5 / np.sqrt(shape[-1])  # a closure that stays finite
    w = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float16)).to(cuda_device)
    sr = SEMIRINGS["plus_mul"]
    got = fr.fw_round(w.clone(), 0, block_size=s, semiring=sr)
    want = ref.fw_round_ref(w, 0, block_size=s, semiring=sr)
    per_op = SEMIRINGS["plus_mul"].__class__("plus_mul_per_op", torch.add, torch.mul, 0.0, 1.0,
                                              lambda c, a, b: c + a * b)
    torch.cuda.synchronize()
    assert bits_equal(got, want)
    assert not bits_equal(want, ref.fw_round_ref(w, 0, block_size=s, semiring=per_op))
    a, b = w[..., :, : s], w[..., : s, :]
    assert bits_equal(fmm.semiring_matmul(a, b, w, semiring=sr),
                      ref.semiring_matmul_ref(a, b, w, semiring=sr))


# ------------------------------------------------------------- serving
@pytest.mark.cuda
def test_router_on_the_card_replays_like_the_host(cuda_device):
    """One seeded log of router calls at n = 256 (4 graphs, 400 calls)
    through a card router and a ``device="cpu"`` router: every published
    table by bits (dist and next hops), every reply, the refresh arms,
    ``engine.stats`` and the batcher's flushes agree."""
    from repro_torch.launch import fw_serve
    from repro_torch.serve.routing import RoutingEngine

    log = fw_serve.serve_log(graphs=4, n=256, ops=400, seed=3)
    card, host = (fw_serve.replay(RoutingEngine(device=d, max_batch=16, repair_threshold=100.0,
                                                clock=fw_serve.ticks()), log, seed=5)
                  for d in ("cuda", "cpu"))
    (cobs, csnaps, creps), (hobs, hsnaps, hreps) = card, host
    assert cobs == hobs and creps == hreps
    assert [(i, g, s.version) for i, g, s in csnaps] == [(i, g, s.version) for i, g, s in hsnaps]
    for (*_, c), (*_, h) in zip(csnaps, hsnaps):
        assert bits_equal(c.dist_tensor(), h.dist_tensor())
        assert bits_equal(c.succ_tensor(), h.succ_tensor())
    assert all(x > 0 for x in cobs[-1]["arms"]) and cobs[-1]["stats"]["repair_dels"] > 0


# ------------------------------------------------- recursive / out of core
@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["host", "device", "host_devices", "host_two_lanes"])
def test_kleene_streamed_solve_matches_plain(cuda_device, name, kind):
    """The recursive schedule at n = 448 (s = 64, leaf 128: 4 panels, a
    ragged last one) through the pinned host store, the device store, the
    host store with ``devices=[cuda:0]`` and with ``[cuda:0, cuda:0]`` (a
    second lane on the card: its own factors, ring and copy streams, the
    sweep's tiles alternating): == its plain run on the CPU and == the
    card's fused solve by bits; the host store's bytes each way ==
    ``plan.recursive_transfer_bytes``; the rise of peak device memory
    within ``plan.recursive_hbm_resident_bytes`` plus the pivot tile (and
    a second lane's factors and ring); one ``fw_phase1`` a round and the
    cross's two products a round beside the sweep's, counted."""
    from repro_torch.apsp import DevicePanelStore, HostPanelStore, KleeneExecutor, plan

    sr = SEMIRINGS[name]
    n, s, leaf = 448, 64, 128
    w = torch.from_numpy(_graph(name, (n, n), seed=61))
    devices = {"host_devices": [torch.device("cuda", 0)],
               "host_two_lanes": [torch.device("cuda", 0)] * 2}.get(kind)
    store = (DevicePanelStore(w.to(cuda_device)) if kind == "device"
             else HostPanelStore(w, device=cuda_device))
    if kind != "device":
        assert store.result().is_pinned()
    ex = KleeneExecutor(semiring=sr, block_size=s, leaf=leaf, devices=devices)
    before = fph.LAUNCHES["fw_phase1"], fmm.LAUNCHES["semiring_matmul"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ex.run(store)
    got = store.result()
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    lane = (2 * leaf * n + 3 * leaf * leaf) * 4 if kind == "host_two_lanes" else 0
    assert rise <= plan.recursive_hbm_resident_bytes(n, s, leaf // s) + s * s * 4 + lane
    rounds = n // s
    assert (fph.LAUNCHES["fw_phase1"] - before[0],
            fmm.LAUNCHES["semiring_matmul"] - before[1]) == (rounds, ex.sweep_calls + 2 * rounds)
    plain = HostPanelStore(w, device="cpu")
    KleeneExecutor(semiring=sr, block_size=s, leaf=leaf).run(plain)
    assert bits_equal(got.cpu(), plain.result())
    assert bits_equal(got.to(cuda_device), fw_staged(w.to(cuda_device), block_size=s, semiring=sr))
    if kind != "device":
        assert (store.h2d_bytes, store.d2h_bytes) == plan.recursive_transfer_bytes(n, s, leaf // s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int16, torch.bfloat16, torch.float16])
def test_kleene_budget_streams_lowered_storages(cuda_device, dtype):
    """``solve(hbm_budget=)`` on the card in int16, bf16 and f16: promoted,
    out of core (the result on the host), == the card's fused solve and the
    plain solve on the CPU by bits."""
    w = _graph("min_plus", (300, 300), seed=67)
    got = solve(w, dtype=dtype, block_size=64, hbm_budget=300 * 300)
    assert got.method == "recursive" and got.dist.device.type == "cpu"
    assert bits_equal(got.dist, solve(w, dtype=dtype, block_size=64).dist.cpu())
    assert bits_equal(got.dist, solve(w, dtype=dtype, block_size=64, hbm_budget=300 * 300,
                                      device="cpu").dist)


@pytest.mark.cuda
def test_kleene_engine_caches_an_out_of_core_key(cuda_device):
    """``ApspEngine(hbm_budget=)``: one out-of-core key, a warm second solve
    that builds nothing, both == fused on the card; the fw_oocore smoke
    passes on the card."""
    from repro_torch.launch import fw_oocore

    w = _graph("min_plus", (512, 512), seed=71)
    eng = ApspEngine(block_size=64, hbm_budget=512 * 512 * 4 // 2)
    r1, r2 = eng.solve(w), eng.solve(w)
    (key,) = eng._cache
    entry = eng._cache[key]
    assert key.method == "recursive" and key.oocore and eng.stats.hits == 1
    assert entry.traces == 1 and entry.executor.traces == 1
    fused = solve(w, block_size=64).dist.cpu()
    assert bits_equal(r1.dist, fused) and bits_equal(r2.dist, fused)
    assert fw_oocore.smoke(device="cuda") == 0


# ------------------------------------------------------- the LM serving path
LM_ARCHS = ["qwen1.5-0.5b", "qwen2-7b", "qwen2-72b", "minicpm-2b", "llama-3.2-vision-11b",
            "whisper-small", "deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "mamba2-780m",
            "jamba-v0.1-52b"]


@pytest.fixture
def card():
    """The card, or a skip; builds nothing: the LM path runs plain torch
    ops (the reference's LM runs no Pallas kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _lm_tolerance(want: torch.Tensor) -> tuple[float, float]:
    """rtol 2e-2 and four bf16 ulps of the largest |want|: twice the atol
    that ``chip_smoke.py:phase_lm_serve`` holds its fixed seeds to.  On
    identical inputs every op of the card is within a few bf16 ulps of the
    CPU's (its GEMMs sum in another order); carried through five layers
    those roundings moved a smoke model's logits by up to 1.23 times the
    two-ulp atol (llama-3.2-vision, weights seed 5)."""
    top = float(want.float().abs().max())
    return 2e-2, (4.0 * 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0)


def _lm_close(got: torch.Tensor, want: torch.Tensor) -> None:
    rtol, atol = _lm_tolerance(want)
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), rtol=rtol, atol=atol)


def _lm_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq),
                                                   dtype=np.int32))}
    if cfg.family == "vlm":
        out["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.n_image_tokens, cfg.d_model)) * 0.02).to(torch.bfloat16)
    if cfg.encoder is not None:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.encoder.n_frames, cfg.d_model)) * 0.02).to(torch.bfloat16)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_card_matches_cpu(card, arch):
    """The smoke model on the card == the same weights on the CPU (bf16
    rule): ``forward_train`` logits and aux loss, the prefill's logits and
    caches (k / v, MLA's c_kv / k_pe, an SSD block's conv / ssm), four
    teacher-forced decode steps; greedy ids equal where the CPU's top-2
    margin exceeds the atol.  With MoE layers the CPU replays the card's
    routes (``models.moe.routes``): a near-tied top-k that went another
    way on the card moves the outputs by far more than rounding, so every
    such route must be a near-tie (its probability mass within 2^-6,
    relative, of the CPU's own top-k's) and the rest is held to rounding.
    Building the model and its ``Engine`` on the card turns TF32 and bf16
    reduced-precision reductions off for every GEMM of the path (the
    router's and the SSD scan's f32 products, the experts' bf16 ones),
    whatever they were before."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.models.model import Model, decode_step, forward_train, init_params, prefill
    from repro_torch.serve.lm import Engine

    cfg = get_smoke_config(arch)
    flags = torch.backends.cuda.matmul
    flags.allow_tf32 = flags.allow_bf16_reduced_precision_reduction = True
    gpu = init_params(cfg, seed=5, device="cuda")
    assert not flags.allow_tf32 and not flags.allow_bf16_reduced_precision_reduction
    flags.allow_tf32 = flags.allow_bf16_reduced_precision_reduction = True
    Engine(cfg, gpu)
    assert not flags.allow_tf32 and not flags.allow_bf16_reduced_precision_reduction
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    data = _lm_batch(cfg, 2, 20, seed=6)
    head = dict(data, tokens=data["tokens"][:, :16])

    def teacher_forced(model):
        logits, aux = forward_train(cfg, model, data)
        lg, caches = prefill(cfg, model, head)
        # A copy: the decode steps update an SSD state in place.
        out = [logits, aux, lg, [{n: t.to("cpu", copy=True) for n, t in c.items()}
                                 for c in caches]]
        caches = Engine(cfg, model)._extend_caches(caches, 4)
        for t in range(4):
            lg, caches = decode_step(cfg, model, data["tokens"][:, 16 + t], 16 + t, caches)
            out.append(lg)
        return out

    with torch.inference_mode():
        with moe.routes() as log:
            fg, ag, lg, cg, *dg = teacher_forced(gpu)
        with moe.routes(log) as replayed:
            fc, ac, lc, cc, *dc = teacher_forced(cpu)
    _lm_close(fg, fc)
    _lm_close(ag, ac)  # f32, from probabilities of bf16 activations a few ulps apart
    _lm_close(lg, lc)
    for a, b in zip(cg, cc, strict=True):
        assert sorted(a) == sorted(b)
        for name in a:
            _lm_close(a[name], b[name])
    for a, b in zip(dg, dc, strict=True):
        _lm_close(a, b)
    if cfg.moe is not None:
        assert moe.replay_gap(replayed)[2] <= 2.0 ** -6

    with moe.routes() as log:
        ids_gpu = Engine(cfg, gpu).generate(head, max_new_tokens=6)
    with moe.routes(log):
        ids_cpu = Engine(cfg, cpu).generate(head, max_new_tokens=6)
    with torch.inference_mode(), moe.routes(log):
        logits, caches = prefill(cfg, cpu, head)
        caches = Engine(cfg, cpu)._extend_caches(caches, 6)
        for t in range(6):
            top2 = torch.topk(logits[:, : cfg.vocab_size], 2).values
            margin = top2[:, 0] - top2[:, 1]
            atol = _lm_tolerance(logits)[1]
            for b in range(2):
                if margin[b] > atol:
                    assert ids_gpu[b, t] == ids_cpu[b, t], (b, t)
            if (ids_gpu[:, t] != ids_cpu[:, t]).any():
                break  # a near-tie went the other way: the texts part here
            if t < 5:  # generate's own decode steps, whose routes are replayed
                logits, caches = decode_step(cfg, cpu, torch.from_numpy(ids_cpu[:, t]),
                                             16 + t, caches)


@pytest.mark.cuda
def test_lm_engine_on_the_card_is_seeded(card):
    """Greedy generation repeats; sampling repeats with its seed and stays
    within the real vocabulary."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.lm import Engine

    cfg = get_smoke_config("qwen2-7b")
    model = init_params(cfg, seed=0)
    assert model.device.type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    data = _lm_batch(cfg, 4, 12, seed=7)
    greedy = Engine(cfg, model)
    np.testing.assert_array_equal(greedy.generate(data, max_new_tokens=8),
                                  greedy.generate(data, max_new_tokens=8))
    runs = [Engine(cfg, model, temperature=0.8, seed=s).generate(data, max_new_tokens=8)
            for s in (1, 1)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < cfg.vocab_size)).all()


@pytest.mark.cuda
def test_serve_lm_example_on_the_card(card):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    res = subprocess.run([sys.executable, os.path.join(root, "examples", "serve_lm_torch.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "greedy decode deterministic" in res.stdout
