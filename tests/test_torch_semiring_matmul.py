"""The port's semiring matmul vs the JAX Pallas kernel, run in interpret mode.

``repro_torch.kernels.minplus_matmul.semiring_matmul`` on CPU tensors runs
its plain version (the k-ascending chain of ``_stage_compute``); it must
equal ``repro.kernels.minplus_matmul.semiring_matmul(..., interpret=True)``
bit for bit (``bits_equal``: bits compared, -0.0 told from +0.0, NaN equal to NaN,
tolerance zero) on the
same numpy inputs: all five semirings, with and without an accumulator,
batched, at odd shapes, with ±inf among the operands; and every storage
lowering (int16 ×4, bf16 / f16 ×5, packed or_and words) and integer
storage (on the port's int32 carrier), kept in its dtype.  Mirrors the
matmul sweeps of ``tests/test_kernels.py``.  The CUDA kernel is held against the
plain version on the card by ``tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.core import semiring as jsr
from repro.kernels import minplus_matmul as jmm
from repro.kernels import ops as jops
from repro_torch.core import semiring as tsr
from repro_torch.kernels import minplus_matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
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

SHAPES = [  # (a shape, b shape, bm, bn, bk) of the reference's call
    ((64, 64), (64, 64), 32, 32, 16),
    ((37, 13), (13, 29), 256, 256, 32),
    ((1, 5), (5, 3), 256, 256, 32),
    ((3, 40, 24), (3, 24, 56), 16, 32, 8),
]


def operand(name: str, shape, seed: int, *, salt: bool = True) -> np.ndarray:
    """Values in the semiring's domain (``semiring_graph`` cut to shape),
    salted with +inf and -inf: plus_mul's 0 ⊗ inf and max_plus's
    -inf + inf give NaN, which both sides must propagate alike."""
    m = max(shape[-2:])
    x = semiring_graph(name, (*shape[:-2], m, m), seed)[..., :shape[-2], :shape[-1]].copy()
    if salt:
        rng = np.random.default_rng(seed + 1000)
        x[rng.uniform(size=x.shape) < 0.05] = np.inf
        x[rng.uniform(size=x.shape) < 0.05] = -np.inf
    return x


def _out_shape(a_shape, b_shape):
    return (*a_shape[:-1], b_shape[-1])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("a_shape,b_shape,bm,bn,bk", SHAPES)
@pytest.mark.parametrize("with_c", [False, True])
def test_semiring_matmul_matches_pallas(name, a_shape, b_shape, bm, bn, bk, with_c):
    a, b = operand(name, a_shape, 1), operand(name, b_shape, 2)
    c = operand(name, _out_shape(a_shape, b_shape), 3) if with_c else None
    want = jmm.semiring_matmul(a, b, c, semiring=jsr.SEMIRINGS[name], bm=bm, bn=bn,
                               bk=bk, interpret=True)
    tc = None if c is None else torch.from_numpy(c)
    got = tmm.semiring_matmul(torch.from_numpy(a), torch.from_numpy(b), tc,
                              semiring=tsr.SEMIRINGS[name], bm=bm, bn=bn, bk=bk)
    assert_same(got, want)
    if c is not None:
        assert_same(tc, c)  # the accumulator is left as it was


@pytest.mark.parametrize("name", NAMES)
def test_staging_depth_invariance(name):
    """The result does not depend on bk (the reference's
    ``test_staging_depth_invariance``), and equals the Pallas kernel."""
    a, b, c = (operand(name, (64, 64), seed) for seed in (17, 18, 19))
    sr = tsr.SEMIRINGS[name]
    outs = [tmm.semiring_matmul(*map(torch.from_numpy, (a, b, c)), semiring=sr, bk=bk)
            for bk in (8, 16, 32, 64, 7)]
    for o in outs[1:]:
        assert_same(o, outs[0].numpy())
    assert_same(outs[0], jmm.semiring_matmul(a, b, c, semiring=jsr.SEMIRINGS[name], bm=32,
                                             bn=32, bk=16, interpret=True))


@pytest.mark.parametrize("with_c", [False, True])
def test_minplus_matmul_wrapper_matches_pallas(with_c):
    a, b = operand("min_plus", (48, 32), 5), operand("min_plus", (32, 80), 6)
    c = operand("min_plus", (48, 80), 7) if with_c else None
    want = jops.minplus_matmul(a, b, c, bm=16, bn=16, bk=8, interpret=True)
    got = tops.minplus_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              None if c is None else torch.from_numpy(c), bm=16, bn=16, bk=8)
    assert_same(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_fw_phase3_matches_pallas(name):
    n, s = 96, 32
    w = operand(name, (n, n), 24, salt=False)
    cb, rb = operand(name, (n, s), 25, salt=False), operand(name, (s, n), 26, salt=False)
    want = jops.fw_phase3(w, cb, rb, bm=32, bn=48, bk=16, semiring=jsr.SEMIRINGS[name],
                          interpret=True)
    got = tops.fw_phase3(*map(torch.from_numpy, (w, cb, rb)), bm=32, bn=48, bk=16,
                         semiring=tsr.SEMIRINGS[name])
    assert_same(got, want)
    assert_same(tref.fw_phase3_ref(*map(torch.from_numpy, (w, cb, rb)),
                                   semiring=tsr.SEMIRINGS[name]), want)


LOWERED_SHAPES = [((37, 13), (13, 29)), ((3, 40, 24), (3, 24, 56))]


@pytest.mark.parametrize("case", REF_STORAGES, ids=storage_id)
@pytest.mark.parametrize("a_shape,b_shape", LOWERED_SHAPES)
@pytest.mark.parametrize("with_c", [False, True])
def test_lowered_semiring_matmul_matches_pallas(case, a_shape, b_shape, with_c):
    """Every storage, ragged and batched, with and without c: the port in
    the storage (an integer one on its carrier) == the Pallas kernel in the
    storage, dtype and bits."""
    storage, name = case
    a, b = storage_data(storage, name, a_shape, 1), storage_data(storage, name, b_shape, 2)
    c = storage_data(storage, name, _out_shape(a_shape, b_shape), 3) if with_c else None
    jsr_ = storage_semiring(storage, name, jsr)
    want = jmm.semiring_matmul(a, b, c, semiring=jsr_, bm=16, bn=16, bk=8, interpret=True)
    (ta, sr, dt), (tb, _, _) = to_port(a, storage_semiring(storage, name)), to_port(
        b, storage_semiring(storage, name))
    tc = None if c is None else to_port(c, storage_semiring(storage, name))[0]
    got = tmm.semiring_matmul(ta, tb, tc, semiring=sr, bk=8)
    assert got.dtype == ta.dtype
    assert_same(from_port(got, dt, storage_semiring(storage, name)), np.asarray(want))


@pytest.mark.parametrize("a_shape,b_shape", LOWERED_SHAPES)
@pytest.mark.parametrize("with_c", [False, True])
def test_f16_plus_mul_matmul_matches_pallas(a_shape, b_shape, with_c):
    """f16 plus_mul on signed operands of magnitude about 1, where the
    rounding rule shows: the port == the Pallas kernel in interpret mode,
    dtype and bits.  Each step is one f16 FMA, rounded once from the exact
    c + a*b (XLA's CPU backend on a CPU with AVX-512 FP16); a chain that
    rounds the product and the sum apart differs from both somewhere."""
    rng = np.random.default_rng(sum(a_shape) + 10 * with_c)
    a, b = ((rng.standard_normal(sh) * 0.7).astype(np.float16) for sh in (a_shape, b_shape))
    c = ((rng.standard_normal(_out_shape(a_shape, b_shape)) * 0.7).astype(np.float16)
         if with_c else None)
    want = jmm.semiring_matmul(a, b, c, semiring=jsr.PLUS_MUL, bm=16, bn=16, bk=8,
                               interpret=True)
    got = tmm.semiring_matmul(*(torch.from_numpy(x) for x in (a, b)),
                              None if c is None else torch.from_numpy(c), semiring=tsr.PLUS_MUL,
                              bk=8)
    assert got.dtype == torch.float16
    assert_same(got, np.asarray(want))
    acc = np.zeros(_out_shape(a_shape, b_shape), np.float16) if c is None else c.copy()
    for k in range(a.shape[-1]):
        prod = (a[..., :, k, None].astype(np.float32) * b[..., k, None, :]).astype(np.float16)
        acc = (acc.astype(np.float32) + prod).astype(np.float16)
    assert not np.array_equal(acc, got.numpy())


@pytest.mark.parametrize("case", [c for c in REF_STORAGES if c[0] in ("int16", "bfloat16",
                                                                      "packed")],
                         ids=storage_id)
def test_lowered_fw_phase3_matches_pallas(case):
    """``kernels.ops.fw_phase3`` with a lowering's semiring on its storage."""
    storage, name = case
    n, s = 64, 16
    w, cb, rb = (storage_data(storage, name, shape, seed)
                 for shape, seed in (((n, n), 24), ((n, s), 25), ((s, n), 26)))
    want = jops.fw_phase3(w, cb, rb, bm=32, bn=32, bk=8,
                          semiring=storage_semiring(storage, name, jsr), interpret=True)
    sr = storage_semiring(storage, name)
    got = tops.fw_phase3(*(to_port(x, sr)[0] for x in (w, cb, rb)), bk=8, semiring=sr)
    assert_same(got, np.asarray(want))


def test_plus_mul_matches_dot():
    """plus_mul is the ordinary product, to f32 rounding (the reference's
    ``test_plus_mul_matches_dot``, same tolerance)."""
    rng = np.random.default_rng(15)
    a, b = (rng.uniform(0.0, 1.0, (64, 64)).astype(np.float32) for _ in range(2))
    got = tmm.semiring_matmul(torch.from_numpy(a), torch.from_numpy(b), semiring=tsr.PLUS_MUL)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-5, atol=1e-5)


def test_semiring_matmul_refuses_what_it_does_not_take():
    a, b = torch.zeros(8, 4), torch.zeros(4, 6)
    with pytest.raises(ValueError, match="broadcast"):
        tmm.semiring_matmul(a, b, variant="broadcast")
    with pytest.raises(TypeError):
        tmm.semiring_matmul(a.double(), b.double())
    # a lowered storage runs in its own dtype, equal to its twin; mixed
    # storages and a storage that is not the semiring's are refused, never
    # converted
    half = tmm.semiring_matmul(a.bfloat16() + 1, b.bfloat16() + 2)
    assert half.dtype == torch.bfloat16
    assert_same(half, tref.semiring_matmul_ref(a.bfloat16() + 1, b.bfloat16() + 2))
    with pytest.raises(TypeError):
        tmm.semiring_matmul(a.bfloat16(), b)
    with pytest.raises(TypeError):
        tmm.semiring_matmul(a.to(torch.int16), b.to(torch.int16))  # f32 semiring
    with pytest.raises(ValueError, match="contraction"):
        tmm.semiring_matmul(a, torch.zeros(5, 6))
    with pytest.raises(ValueError, match="batched"):
        tmm.semiring_matmul(a[None], b)
    with pytest.raises(ValueError):
        tmm.semiring_matmul(a, b, torch.zeros(8, 7))
    with pytest.raises(ValueError, match="empty"):
        tmm.semiring_matmul(torch.zeros(8, 0), torch.zeros(0, 6))


# ------------------------------------------------ the kernel's staging rule
STAGING_TAGS = {None: torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
                "int16": torch.int16, "packed": torch.int32, "or_and_i32": torch.int32,
                "plus_mul_i32": torch.int32}


@pytest.mark.parametrize("tag", list(STAGING_TAGS), ids=lambda t: t or "f32")
def test_staging_rule(tag):
    """Vector staging (16-byte copies) exactly where every pointer is
    16-byte aligned and every row / batch stride spans whole 16 bytes, in
    the tag's storage; the card tests' shapes: the square and phase-3
    products and an aligned column-slice view take it, the ragged
    (1000,77)·(77,513), (1,5)·(5,3), (257,128)·(128,1031), the batched
    (3,40,70)·(3,70,130) and a view shifted by 3 columns do not."""
    dt = STAGING_TAGS[tag]
    size = torch.empty((), dtype=dt).element_size()
    epc = 16 // size  # elements a 16-byte chunk
    assert tag is None or tag in tmm.LOWERINGS
    assert tmm.staging(size, [0, 4096, 256], [8 * epc, 0, 3 * epc, 64 * epc]) == 1
    assert tmm.staging(size, [0, 4096 + size], [8 * epc]) == 0  # pointer one element off
    assert tmm.staging(size, [0, 4096], [8 * epc + 1]) == 0     # row stride
    assert tmm.staging(size, [0, 4096], [8 * epc, 5]) == 0      # batch stride

    def z(*shape):
        return torch.zeros(shape, dtype=dt)

    def name(a, b, c=None):
        out = z(*a.shape[:-1], b.shape[-1])
        return tmm.staging_name(a, b, c, out)

    assert name(z(256, 128), z(128, 384), z(256, 384)) == "vector"
    assert name(z(512, 128), z(128, 512), z(512, 512)) == "vector"  # phase 3, cut
    wide = z(200, 1040)
    assert name(wide[:, :77], z(77, 136), z(200, 136)) == "vector"  # lda != k
    assert name(wide[:, 3:80], z(77, 136)) == "scalar"
    for a_shape, b_shape in [((1000, 77), (77, 513)), ((1, 5), (5, 3)),
                             ((257, 128), (128, 1031)), ((3, 40, 70), (3, 70, 130))]:
        assert name(z(*a_shape), z(*b_shape)) == "scalar", (a_shape, b_shape)
