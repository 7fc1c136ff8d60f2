"""The port's storage lowerings of ``solve`` vs the JAX reference, bitwise.

The same numpy inputs (made from a seed) go through ``repro`` (JAX on the
CPU: ``solve`` resolves its rounds to the XLA ``ref`` twins there) and
``repro_torch`` (plain torch, ``device="cpu"``).  Results must be equal by
bit view (``bits_equal``: dtype, shape and bits, -0.0 told from +0.0, NaN
equal to NaN; tolerance zero):

  * the saturating int16 lowerings, the bit-packed or_and words and the
    bf16 / f16 identity lowerings, round by round and through ``solve``,
    single and batched; bf16 / f16 successors;
  * the int16 and packed algebra of ``tests/test_semiring_properties.py``
    and the lowered rounds, packing and int16 solves of
    ``tests/test_fw_round.py``;
  * ±0 in the inputs of the four idempotent semirings, on every method;
  * the paths ported last (the staged and mesh engines, the distributed and
    numpy solves, the 4-dispatch kernels, the bordered round) on the
    lowerings, and the refusals the reference shares.

The CUDA kernels of the lowerings are held against these plain versions on
the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp as japsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.apsp import api as japi
from repro.core import paths as jpaths
from repro.core import semiring as jsr
from repro.core.staged import fw_staged as jfw_staged
from repro.kernels import fw_phase1 as jfw_phase1
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.apsp import ApspEngine, api as tapi, solve
from repro_torch.core import paths as tpaths
from repro_torch.core import semiring as tsr
from repro_torch.core.staged import fw_staged
from repro_torch.kernels import fw_phase1, fw_repair, fw_round, ops
from repro_torch.utils.interop import host_tensor
from test_torch_semiring import NAMES, assert_same, semiring_graph

IDEMPOTENT = ("min_plus", "max_plus", "max_min", "or_and")
HALF = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float16": (jnp.float16, torch.float16)}


def _lowered_data(sr, shape, seed):
    """A lowering's native storage (``tests/test_fw_round.py:_lowered_data``):
    int32 words for the packed closure, {0,1} int16 for or_and_i16, int16
    with ⊕-identity sentinels (and near-saturation weights) otherwise."""
    rng = np.random.default_rng(seed)
    if sr.packed:
        words = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
        return words.astype(np.uint32).view(np.int32)
    if sr.name == "or_and_i16":
        return (rng.uniform(size=shape) < 0.25).astype(np.int16)
    v = rng.integers(-40, 40, size=shape).astype(np.int16)
    v[rng.uniform(size=shape) < 0.03] = 32000
    v[rng.uniform(size=shape) < 0.03] = -32000
    v[rng.uniform(size=shape) < 0.15] = np.int16(sr.zero)
    return v


def _half(name, shape, seed, dtype):
    """semiring_graph cast to bf16 (an ml_dtypes array, as the reference
    holds it) or f16."""
    return np.asarray(jnp.asarray(semiring_graph(name, shape, seed), HALF[dtype][0]))


def _signed_zero(name, shape, seed):
    """semiring_graph with a fifth of the entries set to +0.0 or -0.0."""
    rng = np.random.default_rng(seed)
    w = semiring_graph(name, shape, seed)
    w[rng.uniform(size=shape) < 0.1] = 0.0
    w[rng.uniform(size=shape) < 0.1] = -0.0
    return w


# --------------------------------------------------- the lowered rounds
@pytest.mark.parametrize("name", sorted(jsr.LOWERED_SEMIRINGS))
@pytest.mark.parametrize("shape", [(96, 96), (3, 64, 64)])
def test_lowered_round_bitwise(name, shape):
    """Every storage lowering through the fused round loop == the
    reference's XLA ref twin, bit for bit (``test_fw_round.py:436``)."""
    w = _lowered_data(jsr.LOWERED_SEMIRINGS[name], shape, seed=13)
    kw = dict(block_size=32, bk=16)
    want = jfw_staged(jnp.asarray(w), fused="ref", semiring=jsr.LOWERED_SEMIRINGS[name], **kw)
    got = fw_staged(torch.from_numpy(w), semiring=tsr.LOWERED_SEMIRINGS[name], **kw)
    assert got.dtype == torch.from_numpy(w).dtype
    assert_same(got, np.asarray(want))


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("name", NAMES)
def test_half_round_bitwise(dtype, name):
    """bf16 / f16 through the fused round loop, all five semirings: each ⊗
    and ⊕ rounds to the storage type, as XLA computes them."""
    w = _half(name, (96, 96), 7, dtype)
    kw = dict(block_size=32, bk=16)
    want = jfw_staged(jnp.asarray(w), fused="ref", semiring=jsr.SEMIRINGS[name], **kw)
    got = fw_staged(host_tensor(w), semiring=tsr.SEMIRINGS[name], **kw)
    assert got.dtype == HALF[dtype][1]
    assert_same(got, np.asarray(want))


@pytest.mark.parametrize("dtype", sorted(HALF))
def test_dense_plus_mul_rounds_per_op(dtype):
    """A dense (64, 64) plus_mul solve in 16 bits matches the reference
    everywhere: in bf16 each ⊗ and ⊕ rounds on its own (mul-then-add), in
    f16 each step is one f16 FMA rounded once from the exact c + a·b (XLA's
    CPU backend on a CPU with AVX-512 FP16).  torch.addcmul on the 16-bit
    tensors, which rounds its f32 result to the storage, differs from it
    in more than a quarter of the elements in both."""
    rng = np.random.default_rng(1)
    x = np.asarray(jnp.asarray((rng.standard_normal((64, 64)) * 0.05).astype(np.float32),
                               HALF[dtype][0]))
    want = np.asarray(japsp.solve(x, semiring="plus_mul", method="fused", block_size=32).dist)
    got = solve(x, semiring="plus_mul", method="fused", block_size=32, device="cpu")
    assert got.dist.dtype == HALF[dtype][1]
    assert_same(got.dist, want)
    fused = tsr.Semiring("plus_mul_fma", torch.add, torch.mul, 0.0, 1.0, torch.addcmul)
    one_rounding = fw_staged(host_tensor(x), block_size=32, semiring=fused)
    assert (one_rounding.float() != got.dist.float()).sum() > 64 * 64 // 4


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("method", ["naive", "blocked", "fused"])
def test_half_successors_bitwise(dtype, method):
    w = _half("min_plus", (2, 70, 70), 3, dtype)
    j = japsp.solve(w, successors=True, method=method, block_size=16)
    t = solve(w, successors=True, method=method, block_size=16, device="cpu")
    assert t.dist.dtype == HALF[dtype][1] and t.succ.dtype == torch.int32
    assert_same(t.dist, np.asarray(j.dist))
    assert_same(t.succ, np.asarray(j.succ))


# --------------------------------------------------------- through solve
@pytest.mark.parametrize("name", IDEMPOTENT)
@pytest.mark.parametrize("method", ["naive", "blocked", "fused"])
@pytest.mark.parametrize("shape", [(60, 60), (2, 100, 100)])
def test_int16_solve_bitwise(name, method, shape):
    w = semiring_graph(name, shape, seed=5)
    if name != "or_and":
        w = np.where(np.isfinite(w), np.round(w * 7), w).astype(np.float32)
    j = japsp.solve(w, semiring=name, dtype=jnp.int16, method=method, block_size=32,
                    validate=False)
    t = solve(w, semiring=name, dtype=torch.int16, method=method, block_size=32,
              validate=False, device="cpu")
    assert t.dist.dtype == torch.int16 and t.semiring == j.semiring == f"{name}_i16"
    assert_same(t.dist, np.asarray(j.dist))


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", [(50, 50), (2, 100, 100)])
def test_half_solve_keeps_dtype_bitwise(dtype, name, shape):
    """A bf16 / f16 input is solved in its own dtype (C.2), == reference."""
    w = _half(name, shape, 9, dtype)
    j = japsp.solve(w, semiring=name, validate=False)
    t = solve(w, semiring=name, validate=False, device="cpu")
    assert t.dist.dtype == HALF[dtype][1]
    assert_same(t.dist, np.asarray(j.dist))
    cast = solve(semiring_graph(name, shape, 9), semiring=name, dtype=dtype, validate=False,
                 method="fused", device="cpu")
    assert_same(cast.dist, np.asarray(japsp.solve(
        semiring_graph(name, shape, 9), semiring=name, dtype=HALF[dtype][0], validate=False,
        method="fused").dist))


def test_float64_narrows_and_integers_widen_as_the_reference():
    w = semiring_graph("min_plus", (40, 40), 2)
    assert solve(w.astype(np.float64), device="cpu").dist.dtype == torch.float32
    ints = np.where(np.isfinite(w), np.round(w), 0).astype(np.int64)
    t, j = solve(ints, device="cpu"), japsp.solve(ints)
    assert_same(t.dist, np.asarray(j.dist))


@pytest.mark.parametrize("name", IDEMPOTENT)
@pytest.mark.parametrize("method", ["naive", "blocked", "staged", "fused"])
def test_signed_zero_matches_reference_on_every_method(name, method):
    """±0 weights: min picks -0 and max +0 between equal zeros whatever
    the operand order, as XLA does (C.1)."""
    w = _signed_zero(name, (2, 70, 70), 4)
    j = japsp.solve(w, semiring=name, method=method, block_size=16, validate=False)
    t = solve(w, semiring=name, method=method, block_size=16, validate=False, device="cpu")
    assert_same(t.dist, np.asarray(j.dist))
    if name == "min_plus":
        t = solve(w[0], method="numpy", validate=False, device="cpu")
        assert_same(t.dist, np.asarray(japsp.solve(w[0], method="numpy", validate=False).dist))


def test_int16_negative_cycle_is_detected():
    w = np.full((20, 20), np.inf, np.float32)
    np.fill_diagonal(w, 0.0)
    w[0, 1], w[1, 0] = 2.0, -5.0
    for dtype in (torch.int16, torch.bfloat16):
        with pytest.raises(tapi.NegativeCycleError):
            solve(w, dtype=dtype, device="cpu")


def test_solve_int16_dtype_end_to_end():
    """inf edges coerce to the I16_INF sentinel; distances bit-match the
    f32 solve on integer weights (``test_fw_round.py:541``)."""
    rng = np.random.default_rng(8)
    w = rng.integers(1, 50, size=(60, 60)).astype(np.float32)
    w[rng.uniform(size=(60, 60)) < 0.5] = np.inf
    np.fill_diagonal(w, 0.0)
    res = solve(w, dtype=torch.int16, method="fused", block_size=32, device="cpu")
    assert res.dist.dtype == torch.int16
    want = solve(w, method="fused", block_size=32, device="cpu").dist.numpy()
    got = res.dist.numpy().astype(np.float32)
    got[got == tsr.I16_INF] = np.inf
    assert np.array_equal(got, want)


# ------------------------------------------------------------ packed or_and
def test_pack_unpack_roundtrip_and_layout():
    rng = np.random.default_rng(9)
    for B in (1, 3, tsr.PACK_LANES, tsr.PACK_LANES + 7):
        bits = (rng.uniform(size=(B, 6, 6)) < 0.5).astype(np.float32)
        words = tapi.pack_reachability(bits)
        assert words.dtype == torch.int32 and words.shape == (-(-B // 32), 6, 6)
        assert_same(words, np.asarray(japi.pack_reachability(bits)))
        assert_same(tapi.unpack_reachability(words, count=B), bits)
    bits = (rng.uniform(size=(3, 6, 6)) < 0.5).astype(np.float32)
    w0 = tapi.pack_reachability(bits)[0].numpy()
    for g in range(3):  # LSB-first: graph g at word g // 32, bit g % 32
        assert np.array_equal(((w0 >> g) & 1).astype(np.float32), bits[g])


def test_packed_solve_matches_unpacked_all_counts():
    """pack → solve(packed=True) → unpack == the unpacked or_and solve and
    == the reference's, bitwise, for every graph count B in 1..32."""
    n = 24
    rng = np.random.default_rng(5)
    pool = (rng.uniform(size=(tsr.PACK_LANES, n, n)) < 0.12).astype(np.float32)
    for g in range(tsr.PACK_LANES):
        np.fill_diagonal(pool[g], 1.0)
    want = solve(pool, semiring="or_and", method="fused", block_size=16, device="cpu").dist
    for B in range(1, tsr.PACK_LANES + 1):
        res = solve(pool[:B], semiring="or_and", packed=True, method="fused", block_size=16,
                    device="cpu")
        assert res.dist.shape == (B, n, n)
        assert_same(res.dist, want[:B])
    j = japsp.solve(pool[:5], semiring="or_and", packed=True, method="fused", block_size=16)
    assert_same(solve(pool[:5], semiring="or_and", packed=True, method="fused", block_size=16,
                      device="cpu").dist, np.asarray(j.dist))


def test_packed_solve_single_graph_2d_and_words():
    rng = np.random.default_rng(6)
    w = (rng.uniform(size=(40, 40)) < 0.15).astype(np.float32)
    np.fill_diagonal(w, 1.0)
    res = solve(w, semiring="or_and", packed=True, method="fused", block_size=32, device="cpu")
    ref = solve(w, semiring="or_and", method="fused", block_size=32, device="cpu")
    assert res.dist.shape == (40, 40)
    assert_same(res.dist, ref.dist)
    words = _lowered_data(jsr.OR_AND_PACKED, (40, 40), 2)
    for arr in (words, words.view(np.uint32)):  # uint32 is a bit view, not a value cast
        t = solve(arr, semiring="or_and_packed", method="fused", block_size=32, device="cpu")
        assert_same(t.dist, np.asarray(japsp.solve(arr, semiring="or_and_packed",
                                                   method="fused", block_size=32).dist))


def test_packed_solve_rejects_successors_and_other_semirings():
    w = (np.random.default_rng(1).uniform(size=(16, 16)) < 0.2).astype(np.float32)
    with pytest.raises(ValueError):
        solve(w, semiring="or_and", packed=True, successors=True, device="cpu")
    with pytest.raises(ValueError):
        solve(w, semiring="min_plus", packed=True, device="cpu")
    with pytest.raises(ValueError):  # packed words are int32
        solve(w, semiring="or_and", packed=True, dtype=torch.int16, device="cpu")
    with pytest.raises(ValueError):  # float input to the packed lowering
        solve(w, semiring="or_and_packed", device="cpu")


# --------------------------------------------------- the lowered algebra
@pytest.mark.parametrize("name,dom", [("min_plus_i16", tsr.I16_INF),
                                      ("max_plus_i16", tsr.I16_NINF)])
def test_i16_identities_and_sentinel_absorption(name, dom):
    sr = tsr.LOWERED_SEMIRINGS[name]
    vals = torch.tensor([tsr.I16_NINF, tsr.I16_NINF + 1, -100, -1, 0, 1, 100,
                         tsr.I16_INF - 1, tsr.I16_INF], dtype=torch.int16)
    zero, one = (torch.full_like(vals, x) for x in (sr.zero, sr.one))
    assert torch.equal(sr.add(vals, zero), vals) and torch.equal(sr.mul(vals, one), vals)
    assert torch.equal(sr.mul(vals, zero), torch.full_like(vals, dom))
    assert torch.equal(sr.mul(zero, vals), torch.full_like(vals, dom))


def test_i16_mul_grid_matches_reference():
    """All pairs of a boundary-heavy grid: the saturating ⊗ == the
    reference's == the widened sum clamped, sentinels overriding."""
    rng = np.random.default_rng(4)
    grid = np.unique(np.concatenate([
        np.asarray([tsr.I16_NINF, tsr.I16_NINF + 1, -32000, -1, 0, 1, 32000,
                    tsr.I16_INF - 1, tsr.I16_INF]),
        rng.integers(tsr.I16_NINF, tsr.I16_INF + 1, size=50)])).astype(np.int16)
    a, b = np.repeat(grid, grid.size), np.tile(grid, grid.size)
    for name, dom, oth in (("min_plus_i16", tsr.I16_INF, tsr.I16_NINF),
                           ("max_plus_i16", tsr.I16_NINF, tsr.I16_INF)):
        want = np.clip(a.astype(np.int64) + b, tsr.I16_NINF, tsr.I16_INF)
        want = np.where((a == oth) | (b == oth), oth, want)
        want = np.where((a == dom) | (b == dom), dom, want).astype(np.int16)
        got = tsr.LOWERED_SEMIRINGS[name].mul(torch.from_numpy(a), torch.from_numpy(b))
        assert_same(got, want)
        assert_same(got, np.asarray(jsr.LOWERED_SEMIRINGS[name].mul(a, b)))


@pytest.mark.parametrize("name", ["min_plus_i16", "max_plus_i16", "max_min_i16", "or_and_i16"])
def test_i16_distributivity_on_a_grid(name):
    """a ⊗ (b ⊕ c) == (a ⊗ b) ⊕ (a ⊗ c) exactly under saturation."""
    rng = np.random.default_rng(7)
    hi = 2 if name == "or_and_i16" else tsr.I16_INF + 1
    lo = 0 if name == "or_and_i16" else tsr.I16_NINF
    a, b, c = (torch.from_numpy(rng.integers(lo, hi, 4000).astype(np.int16)) for _ in range(3))
    sr = tsr.LOWERED_SEMIRINGS[name]
    assert torch.equal(sr.mul(a, sr.add(b, c)), sr.add(sr.mul(a, b), sr.mul(a, c)))
    assert torch.equal(sr.relax(a, b, c), sr.add(a, sr.mul(b, c)))


def test_packed_identities_and_laws():
    a, b, c = (torch.from_numpy(_lowered_data(jsr.OR_AND_PACKED, (7,), s)) for s in (1, 2, 3))
    sr = tsr.OR_AND_PACKED
    zero, one = torch.zeros_like(a), torch.full_like(a, -1)
    assert torch.equal(sr.add(a, zero), a) and torch.equal(sr.mul(a, one), a)
    assert torch.equal(sr.mul(a, zero), zero)
    assert torch.equal(sr.mul(a, sr.add(b, c)), sr.add(sr.mul(a, b), sr.mul(a, c)))


def test_lower_semiring_identity_stable_and_rejections():
    assert tsr.lower_semiring(tsr.MIN_PLUS, torch.int16) is tsr.MIN_PLUS_I16
    assert tsr.lower_semiring(tsr.MIN_PLUS, np.int16) is tsr.lower_semiring(tsr.MIN_PLUS, "int16")
    assert tsr.lower_semiring(tsr.OR_AND, packed=True) is tsr.OR_AND_PACKED
    assert tsr.lower_semiring(tsr.OR_AND_PACKED, packed=True) is tsr.OR_AND_PACKED
    assert tsr.lower_semiring(tsr.MIN_PLUS, torch.bfloat16) is tsr.MIN_PLUS
    assert tsr.lower_semiring(tsr.MIN_PLUS_I16, torch.int16) is tsr.MIN_PLUS_I16
    for sr, kw in ((tsr.PLUS_MUL, dict(dtype=torch.int16)), (tsr.MIN_PLUS, dict(dtype=torch.int8)),
                   (tsr.MIN_PLUS, dict(packed=True)),
                   (tsr.OR_AND, dict(dtype=torch.int16, packed=True))):
        with pytest.raises(ValueError):
            tsr.lower_semiring(sr, **kw)


# ------------------------------------------------------------- the walks
def test_lift_distances_matches_reference():
    w = semiring_graph("min_plus", (30, 30), 1)
    w = np.where(np.isfinite(w), np.round(w), w).astype(np.float32)
    i16 = np.asarray(japsp.solve(w, dtype=jnp.int16, method="fused", block_size=16).dist)
    bf = np.asarray(japsp.solve(np.asarray(jnp.asarray(w, jnp.bfloat16))).dist)
    for table in (i16, bf, w.astype(np.float16), w):
        assert_same(tpaths._lift_distances(table), jpaths._lift_distances(table))
    assert_same(tpaths._lift_distances(host_tensor(bf)), jpaths._lift_distances(bf))
    assert tpaths.extract_path_from_dist(w, i16, 0, 7) == jpaths.extract_path_from_dist(
        w, i16, 0, 7)


# ------------------------------------------- the last ported paths
def _mesh_1x1():
    """A one-rank grid in this process: every broadcast is a no-op, so the
    distributed solve runs its bordered rounds on the whole matrix."""
    return types.SimpleNamespace(
        R=1, C=1, rank=0, my_r=0, my_c=0, row_group=None, col_group=None,
        device=torch.device("cpu"), signature=("grid", 1, 1, "cpu"),
        rank_of=lambda r, c: 0, group_size=lambda group: 1)


def test_f32_only_paths_refuse_lowerings_without_widening():
    """The paths that were f32 only until their lowered kernels came (the
    staged engine, the mesh engine and the distributed solve, the numpy
    solve, the 4-dispatch kernels and ``kernels.ops``, the bordered round)
    now run every lowering in its storage and match the reference; what
    the reference refuses there (numpy on int16 / packed words, next hops
    on a mesh), the port refuses with the reference's words.  (The name is
    the one this test had while those paths refused.)"""
    w = torch.from_numpy(semiring_graph("min_plus", (64, 64), 1))
    half = w.to(torch.bfloat16)
    wn, hn = w.numpy(), np.asarray(jnp.asarray(w.numpy(), jnp.bfloat16))
    words = np.asarray(japi.pack_reachability(
        (np.random.default_rng(1).uniform(size=(64, 64)) < 0.1).astype(np.float32)))
    mesh = _mesh_1x1()
    engines = [  # (port engine kwargs, reference engine kwargs, input)
        (dict(dtype=torch.bfloat16), dict(dtype=jnp.bfloat16), wn),
        (dict(semiring="min_plus_i16"), dict(semiring="min_plus_i16"), wn),
        (dict(semiring="or_and", packed=True), dict(semiring="or_and", packed=True), words),
        ({}, {}, hn),
    ]
    for tk, jk, x in engines:
        je = japsp.ApspEngine(method="fused", **jk)
        want = np.asarray(je.solve(x).dist)
        for method, extra in (("staged", {}), ("distributed", dict(mesh=mesh))):
            te = ApspEngine(method=method, device="cpu", **extra, **tk)
            assert te.semiring.name == je.semiring.name
            t = te.solve(x)
            assert_same(t.dist, want)
            assert te.repair(t.dist, [(0, 1, 1)]).dist.dtype == t.dist.dtype
    key = ApspEngine(method="staged", device="cpu").plan_for(64, dtype=torch.float16).key
    assert key.dtype == japsp.ApspEngine().plan_for(64, dtype=jnp.float16).key.dtype
    assert_same(fw_repair.fw_repair(half, [0], [1], [1.0], block_size=32),
                np.asarray(jref.fw_repair_ref(hn, np.array([0], np.int32),
                                              np.array([1], np.int32),
                                              np.ones(1, jnp.bfloat16))))
    i16 = np.asarray(japsp.solve(wn, dtype=jnp.int16, method="fused", block_size=32).dist)
    for got, want in (
        (solve(half, method="distributed", mesh=mesh, device="cpu").dist,
         np.asarray(japsp.solve(hn, method="fused").dist)),
        (solve(w, dtype=torch.int16, method="distributed", mesh=mesh, block_size=32,
               device="cpu").dist, i16),
        (solve(half, method="numpy", device="cpu").dist,
         np.asarray(japsp.solve(hn, method="numpy").dist)),
        (fw_staged(half, block_size=32, fused=False),
         np.asarray(jfw_staged(jnp.asarray(hn), block_size=32, fused=False, interpret=True))),
        (ops.minplus_matmul(half, half),
         np.asarray(jops.minplus_matmul(hn, hn, interpret=True))),
        (fw_phase1.fw_phase1(half[:32, :32]),
         np.asarray(jfw_phase1.fw_phase1(hn[:32, :32], interpret=True))),
        (fw_round.fw_round_bordered(half.clone(), 1, -1, block_size=32),
         np.asarray(jref.fw_round_bordered_ref(jnp.asarray(hn), 1, -1, block_size=32))),
    ):
        assert_same(got, want)
    t16 = torch.from_numpy(_lowered_data(tsr.MIN_PLUS_I16, (64, 64), 3))
    assert_same(ops.fw_phase3(t16, t16[:, :16].contiguous(), t16[:16].contiguous(),
                              semiring=tsr.MIN_PLUS_I16),
                np.asarray(jops.fw_phase3(t16.numpy(), t16.numpy()[:, :16], t16.numpy()[:16],
                                          semiring=jsr.MIN_PLUS_I16, interpret=True)))
    refusals = [  # (port call, reference call, the reference's words)
        (lambda: solve(wn, dtype=torch.int16, method="numpy", device="cpu"),
         lambda: japsp.solve(wn, dtype=jnp.int16, method="numpy"),
         "method='numpy' implements min_plus only"),
        (lambda: solve(words, semiring="or_and_packed", method="numpy", device="cpu"),
         lambda: japsp.solve(words, semiring="or_and_packed", method="numpy"),
         "method='numpy' implements min_plus only"),
        (lambda: solve(half, method="distributed", mesh=mesh, successors=True, device="cpu"),
         lambda: japsp.solve(hn, method="distributed", successors=True),
         "successors=True supports methods"),
    ]
    for port, reference, words_ in refusals:
        for call in (port, reference):
            with pytest.raises(ValueError, match=re.escape(words_)):
                call()
    with pytest.raises(ValueError, match="distance-only"):
        ApspEngine(method="distributed", mesh=mesh, dtype=torch.bfloat16,
                   device="cpu").repair(half, [(0, 1, 1.0)], succ=torch.zeros(64, 64,
                                                                            dtype=torch.int32))
