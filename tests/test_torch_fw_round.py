"""The fused round of the port vs the JAX reference's round twins.

``repro_torch.kernels.fw_round`` on a CPU tensor runs its plain version;
it must equal ``repro.kernels.ref.fw_round_ref`` /
``fw_round_with_successors_ref`` bit for bit on the same numpy inputs, on
all five semirings, single and batched.  The same holds for the round loop
(``core.staged``) and the staged chain (``kernels.minplus_matmul``).  The
kernels themselves are held against the plain version on the card by
``tests/test_torch_kernels_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.core import paths as jpaths
from repro.core import semiring as jsr
from repro.core import staged as jstaged
from repro.kernels import minplus_matmul as jmm
from repro.kernels import ref as jref
from repro_torch.core import paths as tpaths
from repro_torch.core import semiring as tsr
from repro_torch.core import staged as tstaged
from repro_torch.kernels import fw_round as tfr
from repro_torch.kernels import minplus_matmul as tmm
from test_torch_semiring import NAMES, assert_same, semiring_graph

ROUND_CASES = [  # (shape, block_size, bk, pivot round)
    ((96, 96), 16, 32, 0),
    ((96, 96), 16, 8, 5),
    ((96, 96), 32, 32, 1),
    ((192, 192), 64, 16, 2),
    ((3, 96, 96), 32, 32, 2),
]
SUCC_CASES = [((96, 96), 16, 3), ((128, 128), 64, 0), ((3, 96, 96), 32, 1)]


def _succ_input(shape, seed):
    w = semiring_graph("min_plus", shape, seed)
    return w, np.asarray(jpaths._init_successors(jnp.asarray(w)))


# ------------------------------------------------------ plain vs reference
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,s,bk,b", ROUND_CASES)
def test_plain_round_matches_reference(name, shape, s, bk, b):
    w = semiring_graph(name, shape, seed=s + b)
    want = jref.fw_round_ref(jnp.asarray(w), b, block_size=s, bk=bk,
                             semiring=jsr.SEMIRINGS[name])
    t = torch.from_numpy(w.copy())
    got = tfr.fw_round(t, b, block_size=s, bk=bk, semiring=tsr.SEMIRINGS[name])
    assert got is t  # updated in place
    assert_same(got, want)


@pytest.mark.parametrize("shape,s,b", SUCC_CASES)
def test_plain_successor_round_matches_reference(shape, s, b):
    w, succ = _succ_input(shape, seed=s)
    wd, ws = jref.fw_round_with_successors_ref(jnp.asarray(w), jnp.asarray(succ), b,
                                               block_size=s)
    gd, gs = tfr.fw_round_with_successors(torch.from_numpy(w.copy()),
                                          torch.from_numpy(succ.copy()), b, block_size=s)
    assert gs.dtype == torch.int32
    assert_same(gd, wd)
    assert_same(gs, ws)


@pytest.mark.parametrize("shape", [(37, 37), (3, 60, 60)])
def test_init_successors_matches_reference(shape):
    w = semiring_graph("min_plus", shape, seed=1)
    assert_same(tpaths._init_successors(torch.from_numpy(w)),
                jpaths._init_successors(jnp.asarray(w)))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,s", [((96, 96), 32), ((2, 128, 128), 64)])
def test_round_loop_matches_reference(name, shape, s):
    w = semiring_graph(name, shape, seed=4)
    want = jstaged.fw_staged(jnp.asarray(w), block_size=s, semiring=jsr.SEMIRINGS[name],
                             fused="ref")
    t = torch.from_numpy(w)
    got = tstaged.fw_staged(t, block_size=s, semiring=tsr.SEMIRINGS[name])
    assert_same(got, want)
    assert_same(t, w)  # the input is left as it was


@pytest.mark.parametrize("shape,s", [((96, 96), 16), ((3, 64, 64), 32)])
def test_successor_round_loop_matches_reference(shape, s):
    w = semiring_graph("min_plus", shape, seed=6)
    wd, ws = jstaged.fw_staged_with_successors(jnp.asarray(w), block_size=s, lowering="ref")
    gd, gs = tstaged.fw_staged_with_successors(torch.from_numpy(w), block_size=s)
    assert_same(gd, wd)
    assert_same(gs, ws)


@pytest.mark.parametrize("name", NAMES)
def test_stage_compute_matches_reference(name):
    w = semiring_graph(name, (2, 24, 24), seed=2)
    a = semiring_graph(name, (2, 24, 24), seed=3)[..., :8]
    b = semiring_graph(name, (2, 24, 24), seed=4)[..., :8, :]
    sr = jsr.SEMIRINGS[name]
    want = jax.jit(lambda c, x, y: jmm._stage_compute(c, x, y, sr, "fori"))(w, a, b)
    for variant in ("fori", "unroll"):
        got = tmm._stage_compute(*(torch.from_numpy(x) for x in (w, a, b)),
                                 tsr.SEMIRINGS[name], variant)
        assert_same(got, want)


@pytest.mark.parametrize("dim,want", [(128, 32), (96, 32), (60, 30), (7, 7), (13, 13)])
def test_fit_block_matches_reference(dim, want):
    assert tmm._fit_block(dim, 32) == jmm._fit_block(dim, 32) == want


def test_broadcast_variant_is_refused():
    w = torch.zeros(32, 32)
    with pytest.raises(ValueError, match="broadcast"):
        tfr.fw_round(w, 0, block_size=16, variant="broadcast")


# ---------------------------------------------------------- wrapper checks
@pytest.mark.parametrize("kw,err", [
    (dict(block_size=8), ValueError),      # no kernel for s=8
    (dict(block_size=256), ValueError),
    (dict(block_size=64), ValueError),     # 96 % 64 != 0
    (dict(block_size=32, b=3), ValueError),  # pivot round out of range
    (dict(block_size=32, dtype=torch.float64), TypeError),
])
def test_round_wrapper_rejects(kw, err):
    dtype = kw.pop("dtype", torch.float32)
    b = kw.pop("b", 0)
    with pytest.raises(err):
        tfr.fw_round(torch.zeros(96, 96, dtype=dtype), b, **kw)


def test_round_wrappers_reject_bad_shapes_and_successors():
    with pytest.raises(ValueError):
        tfr.fw_round(torch.zeros(32, 64), 0, block_size=16)
    w = torch.zeros(64, 64)
    with pytest.raises(TypeError):
        tfr.fw_round_with_successors(w, torch.zeros(64, 64, dtype=torch.int64), 0,
                                     block_size=16)
    with pytest.raises(ValueError):
        tfr.fw_round_with_successors(w, torch.zeros(2, 64, 64, dtype=torch.int32), 0,
                                     block_size=16)


def test_cpu_tensors_never_reach_a_launch():
    w = torch.from_numpy(semiring_graph("min_plus", (64, 64), seed=0))
    bands = tfr.round_buffers(w, 16)
    before = dict(tfr.LAUNCHES)
    tfr.fw_round(w, 0, block_size=16)
    assert tfr.LAUNCHES == before  # the plain version counts no launch
    with pytest.raises(ValueError, match="CUDA"):
        tfr.fw_round_phase("diag", w, 0, bands, block_size=16)
    with pytest.raises(ValueError):
        tfr.fw_round_phase("all", w, 0, bands, block_size=16)
