"""The Hopper kernels of ``repro_torch`` against their plain versions.

Every test here needs the card and carries the ``cuda`` marker; the
``cuda_device`` fixture skips it where no card is present (the CUDA
kernels have no CPU mode).  This file imports neither JAX nor ``repro``,
so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.apsp import ApspEngine, solve
from repro_torch.core.paths import _init_successors
from repro_torch.core.semiring import SEMIRINGS
from repro_torch.kernels import fw_repair as fp
from repro_torch.kernels import fw_round as fr
from repro_torch.kernels import ref

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
