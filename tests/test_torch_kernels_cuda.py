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
from repro_torch.core.semiring import SEMIRINGS
from repro_torch.core.staged import fw_staged
from repro_torch.kernels import fw_phase1 as fph
from repro_torch.kernels import fw_phase2
from repro_torch.kernels import fw_repair as fp
from repro_torch.kernels import fw_repair_del as fd
from repro_torch.kernels import fw_round as fr
from repro_torch.kernels import minplus_matmul as fmm
from repro_torch.kernels import ref
from repro_torch.launch import fw_dist_check as fdc
from repro_torch.launch.mesh import run_grid

NAMES = sorted(SEMIRINGS)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import or collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
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
        assert torch.equal(got, want)
    assert fr.LAUNCHES["fw_round/relax"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape,s", [((256, 256), 16), ((3, 256, 256), 128)])
def test_kernel_successor_round_matches_plain(cuda_device, shape, s):
    w = torch.from_numpy(_graph("min_plus", shape, seed=s)).to(cuda_device)
    succ = _init_successors(w).contiguous()
    for b in (0, shape[-1] // s - 1):
        gd, gs = fr.fw_round_with_successors(w.clone(), succ.clone(), b, block_size=s)
        wd, ws = ref.fw_round_with_successors_ref(w, succ, b, block_size=s)
        torch.cuda.synchronize()
        assert torch.equal(gd, wd) and torch.equal(gs, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_solve_on_the_card_matches_the_plain_path(cuda_device, name):
    w = _graph(name, (2, 90, 90), seed=1)
    got = solve(w, method="fused", semiring=name, block_size=32)
    want = solve(w, method="fused", semiring=name, block_size=32, device="cpu")
    assert got.dist.is_cuda
    assert torch.equal(got.dist.cpu(), want.dist)
    if name == "min_plus":
        got = solve(w, successors=True, block_size=16)
        want = solve(w, successors=True, block_size=16, device="cpu")
        assert torch.equal(got.succ.cpu(), want.succ)


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
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
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
    assert torch.equal(gd, wd) and torch.equal(gs, ws)


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
    assert torch.equal(got.dist.cpu().isnan(), want.dist.isnan())
    assert torch.equal(torch.nan_to_num(got.dist.cpu()), torch.nan_to_num(want.dist))
    if name == "min_plus":
        r0 = eng.solve(w, successors=True)
        got = eng.repair(r0.dist, upd, succ=r0.succ)
        want = host.repair(r0.dist.cpu(), upd, succ=r0.succ.cpu())
        assert torch.equal(got.succ.cpu(), want.succ)


@pytest.mark.cuda
def test_launches_refuse_what_the_kernels_do_not_take(cuda_device):
    w = torch.zeros(128, 128, device=cuda_device)
    bands = fr.round_buffers(w, 64)
    with pytest.raises(ValueError):
        fr.fw_round_phase("relax", w, 0, bands, block_size=32)  # buffers for s=64
    with pytest.raises(ValueError):
        fr.fw_round(w.t(), 0, block_size=64)  # not contiguous
    with pytest.raises(ValueError):
        fr.fw_round(w, 0, block_size=64, semiring=SEMIRINGS["min_plus"].__class__(
            "tropical", torch.minimum, torch.add, 0.0, 0.0, torch.addcmul))
    d = torch.zeros(64, 64, device=cuda_device)
    u, v, w = fp.edge_vectors([0] * 65, [1] * 65, [1.0] * 65, 64, cuda_device)
    with pytest.raises(ValueError):  # more edges than one launch pair takes
        fp.repair_phase("stage", d, u, v, w, torch.empty(65, 64, device=cuda_device))
    with pytest.raises(ValueError):  # staged buffer of the wrong shape
        fp.repair_phase("stage", d, u[:4], v[:4], w[:4], torch.empty(3, 64, device=cuda_device))


def _same(a, b) -> bool:
    """Bitwise equal, NaN equal to NaN."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


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
    assert _same(got, want)
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
    assert torch.equal(gd, wd) and torch.equal(gs, ws)


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
    assert got.dist.is_cuda and _same(got.dist.cpu(), want.dist)
    fields = ("repair_dels", "repair_del_rows", "repair_del_fallbacks", "edges_deleted")
    assert [getattr(eng.stats, f) for f in fields] == [getattr(host.stats, f) for f in fields]
    if name == "min_plus":
        r0 = host.solve(w, successors=True)
        got = eng.repair_del(r0.dist.to(cuda_device), w1, dels, succ=r0.succ, threshold=100.0)
        want = host.repair_del(r0.dist, w1, dels, succ=r0.succ, threshold=100.0)
        assert torch.equal(got.dist.cpu(), want.dist) and torch.equal(got.succ.cpu(), want.succ)


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
    assert _same(got, want)
    assert c is None or torch.equal(c, c0)  # functional
    assert fmm.LAUNCHES["semiring_matmul"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", [(16, 16), (32, 32), (64, 64), (128, 128), (3, 128, 128)])
def test_kernel_phase1_matches_plain(cuda_device, name, shape):
    t = torch.from_numpy(_graph(name, shape, seed=shape[-1])).to(cuda_device)
    got = fph.fw_phase1(t, semiring=SEMIRINGS[name])
    want = ref.fw_phase1_ref(t, semiring=SEMIRINGS[name])
    torch.cuda.synchronize()
    assert _same(got, want)


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
    assert _same(got_r, ref.fw_phase2_row_ref(diag, row, semiring=sr))
    assert _same(got_c, ref.fw_phase2_col_ref(diag, col, semiring=sr))


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,s", [((256, 256), 16), ((256, 256), 64), ((2, 256, 256), 128)])
def test_kernel_four_dispatch_matches_plain_and_fused(cuda_device, name, shape, s):
    sr = SEMIRINGS[name]
    w = torch.from_numpy(_graph(name, shape, seed=s)).to(cuda_device)
    fph.reset_launch_counts()
    fmm.reset_launch_counts()
    got = fw_staged(w, block_size=s, semiring=sr, fused=False)
    counts = {**fph.LAUNCHES, **fmm.LAUNCHES}
    want = w
    for b in range(shape[-1] // s):
        want = ref.fw_round4_ref(want, b, block_size=s, semiring=sr)
    fused = fw_staged(w, block_size=s, semiring=sr)
    torch.cuda.synchronize()
    assert _same(got, want) and _same(got, fused)
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
        assert _same(got, want), echo
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
        assert direct["launches"] == dict.fromkeys(direct["launches"], 256 // 32)


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
