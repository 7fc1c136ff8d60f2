"""The port's semirings, baseline FW loops and host helpers vs the reference.

The same numpy inputs go through ``repro`` (JAX, on the CPU) and
``repro_torch`` (plain torch, ``device="cpu"``); results must be equal
bit for bit (``repro_torch.utils.bits.bits_equal``: dtype, shape and
bits, -0.0 told from +0.0, NaN equal to NaN; tolerance zero) on all five
f32 semirings.  plus_mul's ⊗-then-⊕ step is one fused
multiply-add on both sides: XLA contracts it inside ``jit``, and the port
runs ``torch.addcmul``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.core import floyd_warshall as jfw
from repro.core import graph as jgraph
from repro.core import semiring as jsr
from repro.core import staged as jstaged
from repro_torch.apsp import plan as tplan
from repro_torch.core import floyd_warshall as tfw
from repro_torch.core import graph as tgraph
from repro_torch.core import semiring as tsr
from repro_torch.kernels import ref as tref
from repro_torch.utils.bits import bits_equal
from repro_torch.utils.interop import from_numpy, to_numpy

from repro.apsp import plan as jplan

NAMES = sorted(tsr.SEMIRINGS)


def semiring_graph(name: str, shape, seed: int) -> np.ndarray:
    """An f32 matrix in the value domain of each semiring: missing edges are
    the ⊕-identity, the diagonal the ⊗-identity; plus_mul weights stay small
    enough for its closure to stay finite."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    if name == "plus_mul":
        return rng.uniform(0.0, 1.0 / n, size=shape).astype(np.float32)
    if name == "or_and":
        w = (rng.uniform(size=shape) < 0.1).astype(np.float32)
    else:
        w = rng.uniform(1.0, 10.0, size=shape).astype(np.float32)
        if name == "max_plus":  # longest paths: a DAG, or cycles grow to inf
            w[..., np.tril_indices(n, -1)[0], np.tril_indices(n, -1)[1]] = -np.inf
        w[rng.uniform(size=shape) < 0.3] = tsr.SEMIRINGS[name].zero
    idx = np.arange(n)
    w[..., idx, idx] = tsr.SEMIRINGS[name].one
    return w


# ------------------------------------------------------ storage lowerings
# Every storage of the kernels: (storage, semiring name).  int16 runs the
# name's saturating *_i16 lowering, "packed" OR_AND_PACKED on int32 words;
# the integer storages run on the port's int32 carrier.
IDEMPOTENT = ("max_min", "max_plus", "min_plus", "or_and")
HALF_DTYPES = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}
INT_STORAGES = (("bool", "or_and"), ("uint8", "or_and"), ("uint32", "or_and"),
                ("int8", "plus_mul"), ("int32", "plus_mul"), ("bool", "plus_mul"))
STORAGES = ([("int16", n) for n in IDEMPOTENT]
            + [(dt, n) for dt in HALF_DTYPES for n in NAMES]
            + [("packed", "or_and")] + list(INT_STORAGES))
# The storages held against the reference: all of them.  f16 plus_mul's
# step is one f16 FMA rounded once from the exact c + a*b, which is what
# XLA's CPU backend makes of the reference's jitted f16 c + a*b on a CPU
# with AVX-512 FP16, the machine these tests run on (the port's twin:
# ``core.semiring._plus_mul_relax``; the card: HFMA).
REF_STORAGES = STORAGES


def storage_id(case) -> str:
    return "-".join(case)


def storage_semiring(storage: str, name: str, lib=tsr):
    """The semiring of a storage case in ``lib`` (tsr or jsr)."""
    if storage == "packed":
        return lib.OR_AND_PACKED
    if storage == "int16":
        return lib.LOWERED_SEMIRINGS[name + "_i16"]
    return lib.SEMIRINGS[name]


def storage_data(storage: str, name: str, shape, seed: int) -> np.ndarray:
    """A numpy input in the storage, as the reference holds it (bf16 as
    ml_dtypes): int16 with its lowering's sentinels and near-saturation
    values ({0,1} for or_and), random packed words, ``semiring_graph`` cast
    to bf16 / f16 (16-bit plus_mul in [0.5/n, 1/n): no f16 subnormal, which
    XLA flushes), {0,1} or_and integers (uint32 or_and full-range, where
    the carrier's flipped order shows), full-range plus_mul integers."""
    rng = np.random.default_rng(seed)
    if storage == "packed":
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32).view(
            np.int32)
    if storage == "int16":
        if name == "or_and":
            return (rng.uniform(size=shape) < 0.25).astype(np.int16)
        v = rng.integers(-40, 40, size=shape).astype(np.int16)
        v[rng.uniform(size=shape) < 0.03] = 32000
        v[rng.uniform(size=shape) < 0.03] = -32000
        v[rng.uniform(size=shape) < 0.15] = np.int16(storage_semiring("int16", name).zero)
        return v
    if storage in HALF_DTYPES:
        m = max(shape[-2:])
        w = semiring_graph(name, (*shape[:-2], m, m), seed)[..., :shape[-2], :shape[-1]].copy()
        if name == "plus_mul":
            w = (rng.uniform(0.5, 1.0, size=shape) / shape[-1]).astype(np.float32)
        return np.asarray(jnp.asarray(w, HALF_DTYPES[storage]))
    dt = np.dtype(storage)
    if storage == "bool" or (name == "or_and" and storage != "uint32"):
        return (rng.uniform(size=shape) < 0.25).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, int(info.max) + 1, size=shape, dtype=np.int64).astype(dt)


def to_port(x, sr):
    """(the tensor the port's kernels take, their semiring, x's dtype): x as
    a CPU tensor, an integer or_and / plus_mul storage on its int32
    carrier."""
    t = from_numpy(x, device="cpu")
    if tsr.int_storage(t.dtype, sr):
        return tsr.to_carrier(t, sr), tsr.int_carrier(sr, t.dtype), t.dtype
    return t, sr, t.dtype


def from_port(t, dtype, sr):
    """Inverse of ``to_port`` for a result in the storage ``dtype``."""
    return tsr.from_carrier(t, dtype, sr) if tsr.int_storage(dtype, sr) else t


def assert_same(got, want):
    """Bitwise equal by bit view (``bits_equal``), -0.0 told from +0.0."""
    got = to_numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    want = to_numpy(want) if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    assert bits_equal(got, want)


def _specials(rng, shape):
    """Random f32 values salted with ±inf, NaN, ±0 and tiny/huge magnitudes.

    No subnormals: XLA's CPU backend flushes them to zero, while torch and
    the CUDA kernels keep them (IEEE), so the two packages differ there."""
    x = rng.standard_normal(shape).astype(np.float32) * 10.0
    pool = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-30, 3e38, -3e38],
                    np.float32)
    mask = rng.uniform(size=shape) < 0.2
    x[mask] = rng.choice(pool, size=int(mask.sum()))
    return x


# ------------------------------------------------------------- the algebra
@pytest.mark.parametrize("name", NAMES)
def test_semiring_names_and_identities(name):
    t, j = tsr.SEMIRINGS[name], jsr.SEMIRINGS[name]
    assert t.name == j.name == name
    assert np.float32(t.zero) == np.float32(j.zero)
    assert np.float32(t.one) == np.float32(j.one)
    assert tsr.resolve_semiring(name) is t


@pytest.mark.parametrize("name", NAMES)
def test_add_mul_relax_match_jitted_reference(name):
    rng = np.random.default_rng(3)
    acc, a, b = (_specials(rng, (64, 33)) for _ in range(3))
    t, j = tsr.SEMIRINGS[name], jsr.SEMIRINGS[name]
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, acc))
    assert_same(t.add(ta, tb), jax.jit(j.add)(a, b))
    assert_same(t.mul(ta, tb), jax.jit(j.mul)(a, b))
    relax = jax.jit(lambda c, x, y: j.add(c, j.mul(x, y)))
    assert_same(t.relax(tc, ta, tb), relax(acc, a, b))


def test_plus_mul_relax_is_one_rounding():
    """addcmul == the exactly rounded c + a*b (a*b is exact in f64), and
    differs from two roundings somewhere — the reason for the rule."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(4096).astype(np.float32) for _ in range(3))
    fused = tsr.PLUS_MUL.relax(*(torch.from_numpy(x) for x in (c, a, b))).numpy()
    exact = (a.astype(np.float64) * b + c).astype(np.float32)
    two = (c + a * b).astype(np.float32)
    assert np.array_equal(fused, exact)
    assert not np.array_equal(fused, two)


@pytest.mark.parametrize("name", sorted(jsr.LOWERED_SEMIRINGS))
def test_lowered_semirings_are_not_ported(name):
    """Each lowering resolves by name to the reference's (identities,
    storage, lanes), and its plain 4-dispatch round (``fw_round4_ref``, the
    twin of the lowered phase and matmul kernels) equals the reference's
    ``fw_staged(fused=False)`` in interpret mode, in the lowering's storage.
    (The name is the one this test had while the lowered 4-dispatch
    kernels were still to port.)"""
    t, j = tsr.resolve_semiring(name), jsr.LOWERED_SEMIRINGS[name]
    assert t is tsr.LOWERED_SEMIRINGS[name]
    assert (t.name, t.zero, t.one, t.dtype, t.lanes) == (j.name, j.zero, j.one, j.dtype, j.lanes)
    storage = "packed" if t.packed else "int16"
    w = storage_data(storage, name.removesuffix("_i16").removesuffix("_packed"), (64, 64), 5)
    want = jstaged.fw_staged(jnp.asarray(w), block_size=16, bk=8, semiring=j, fused=False,
                             interpret=True)
    got = torch.from_numpy(w)
    for b in range(4):
        got = tref.fw_round4_ref(got, b, block_size=16, bk=8, semiring=t)
    assert_same(got, np.asarray(want))


@pytest.mark.parametrize("kw", [dict(dtype="int16"), dict(dtype=torch.bfloat16),
                                dict(packed=True)])
def test_lower_semiring_refuses_narrow_storage(kw):
    """The narrow storages lower as the reference's do (or_and for packed);
    what the reference refuses, the port refuses with its ValueError."""
    sr = tsr.OR_AND if kw.get("packed") else tsr.MIN_PLUS
    jkw = {**kw, "dtype": jnp.bfloat16} if kw.get("dtype") is torch.bfloat16 else kw
    want = jsr.lower_semiring(jsr.SEMIRINGS[sr.name], **jkw)
    assert tsr.lower_semiring(sr, **kw).name == want.name
    with pytest.raises(ValueError):
        tsr.lower_semiring(tsr.PLUS_MUL if "dtype" in kw else tsr.MIN_PLUS,
                           **({"dtype": "int16"} if "dtype" in kw else kw))
    assert tsr.lower_semiring(tsr.MIN_PLUS, np.float32) is tsr.MIN_PLUS


def test_unknown_semiring_name_raises():
    with pytest.raises(ValueError):
        tsr.resolve_semiring("tropical_dreams")


# ------------------------------------------------------ baseline FW loops
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", [(37, 37), (3, 60, 60)])
def test_fw_naive_matches_reference(name, shape):
    w = semiring_graph(name, shape, seed=shape[-1])
    want = jfw.fw_naive(jnp.asarray(w), semiring=jsr.SEMIRINGS[name])
    assert_same(tfw.fw_naive(torch.from_numpy(w), semiring=tsr.SEMIRINGS[name]), want)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,s", [((96, 96), 32), ((3, 64, 64), 16)])
def test_fw_blocked_matches_reference(name, shape, s):
    w = semiring_graph(name, shape, seed=7)
    want = jfw.fw_blocked(jnp.asarray(w), block_size=s, semiring=jsr.SEMIRINGS[name])
    got = tfw.fw_blocked(torch.from_numpy(w), block_size=s, semiring=tsr.SEMIRINGS[name])
    assert_same(got, want)


def test_fw_numpy_and_negative_cycle_check_match_reference():
    w = tgraph.random_digraph(40, density=0.4, seed=5, allow_negative=True)
    assert_same(tfw.fw_numpy(w), jfw.fw_numpy(w))
    d = tfw.fw_naive(torch.from_numpy(w))
    assert bool(tfw.check_no_negative_cycles(d)) == bool(
        jfw.check_no_negative_cycles(jnp.asarray(to_numpy(d))))
    with pytest.raises(ValueError):
        tfw.fw_blocked(torch.from_numpy(w), block_size=16)  # 40 % 16 != 0


# ------------------------------------------------------------ host helpers
@pytest.mark.parametrize("kw", [dict(), dict(density=0.3, allow_negative=True)])
def test_graph_generators_match_reference(kw):
    assert_same(tgraph.random_digraph(50, seed=9, **kw), jgraph.random_digraph(50, seed=9, **kw))
    assert_same(tgraph.ring_graph(9), jgraph.ring_graph(9))
    assert_same(tgraph.grid_graph(4), jgraph.grid_graph(4))
    got, n = tgraph.pad_to_multiple(tgraph.ring_graph(9), 4)
    want, n2 = jgraph.pad_to_multiple(jgraph.ring_graph(9), 4)
    assert n == n2
    assert_same(got, want)


def test_interop_round_trip_keeps_types():
    w = tgraph.random_digraph(20, density=0.5, seed=1)
    succ = np.arange(400, dtype=np.int32).reshape(20, 20)
    tw, ts = from_numpy(w, device="cpu"), from_numpy(succ, device="cpu")
    assert tw.dtype == torch.float32 and ts.dtype == torch.int32
    assert_same(to_numpy(tw), w)
    assert_same(to_numpy(ts), succ)
    for arr, dt in ((np.asarray(jnp.asarray(w, jnp.bfloat16)), torch.bfloat16),
                    (w.astype(np.float16), torch.float16),
                    (np.clip(w, -32768, 32767).astype(np.int16), torch.int16)):
        t = from_numpy(arr, device="cpu")
        assert t.dtype == dt
        assert_same(to_numpy(t), arr)  # by bit view, never a value cast
    assert from_numpy(w.astype(np.float64), device="cpu").dtype == torch.float32
    assert from_numpy(succ.astype(np.int64), device="cpu").dtype == torch.int32


@pytest.mark.parametrize("n", [1, 37, 60, 96, 200, 255, 256, 1000])
def test_plan_arithmetic_matches_reference(n):
    assert tplan.auto_block_size(n) == jplan.auto_block_size(n)
    s = tplan.auto_block_size(n)
    assert tplan.padded_size(n, s) == jplan.padded_size(n, s)
    assert tplan.round_count(n, s) == jplan.round_count(n, s)
    assert tplan.fused_round_hbm_bytes(n, s, batch=3) == jplan.fused_round_hbm_bytes(n, s, batch=3)
    assert tplan.fused_solve_hbm_bytes(n, s) == jplan.fused_solve_hbm_bytes(n, s)
    for dt in ("float32", np.int16, "bfloat16"):
        assert tplan.word_for(dt) == jplan.word_for(dt)
    assert tplan.word_for(torch.float32) == 4


@pytest.mark.parametrize("s", [16, 32, 64, 128])
def test_every_kernel_configuration_fits_h100_shared_memory(s):
    for bk in (1, 8, s // 2, s):
        for successors in (False, True):
            for word in (4, 2):  # f32 / int32 words, the 16-bit storages
                assert tplan.round_smem_bytes(s, bk, successors=successors,
                                              word=word) <= tplan.H100_SMEM_PER_BLOCK
