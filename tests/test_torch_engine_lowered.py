"""``ApspEngine`` on the storage lowerings vs the JAX reference, bitwise.

The same numpy inputs (made from a seed) go through ``repro.apsp.ApspEngine``
(JAX on the CPU, where the engine runs the XLA twins of its kernels) and
``repro_torch.apsp.ApspEngine(device="cpu")`` (the plain torch versions of
the CUDA kernels).  Results must be equal by bit view (``bits_equal``:
dtype, shape and bits; tolerance zero):

  * engine ``solve`` / ``solve_many`` / ``repair`` / ``repair_del`` on every
    lowering: int16 with the four ``*_i16`` semirings, bf16 and f16 with
    all five, the packed or_and word plane (mirrors
    ``tests/test_apsp_engine.py:55``, ``tests/test_fw_repair.py:125``,
    ``tests/test_fw_repair_del.py:122, 155``); bf16 / f16 successor
    ``repair`` and ``repair_del``;
  * the integer storages of or_and and plus_mul (bool, int8, uint8, int16,
    int32, int64, uint32): dtype and bits of ``solve``, and the engine's
    repair paths on them;
  * a bf16 successor repair whose weight is not a bf16 value: the step
    rounds in bf16, as the reference's ``jnp.asarray(w, d.dtype)`` does;
  * the per-launch plain twins (``repair_stage_ref`` + ``repair_apply_ref``,
    the sweep's per-round phases) == the direct twins == the reference's,
    and the marking (per lane for packed), on each lowering.

The CUDA kernels are held against these plain versions on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp as japsp
from repro.apsp import pack_reachability
from repro.core import semiring as jsr
from repro.kernels import fw_repair_del as jd
from repro.kernels import ref as jref
from repro.launch.fw_serve import pick_deletions
from repro_torch.apsp import ApspEngine, solve
from repro_torch.core import semiring as tsr
from repro_torch.kernels import fw_repair as tfr
from repro_torch.kernels import fw_repair_del as tfd
from repro_torch.kernels import ref as tref
from repro_torch.utils.interop import host_tensor
from test_torch_semiring import NAMES, assert_same

IDEMPOTENT = ("min_plus", "max_plus", "max_min", "or_and")
LOWERINGS = ([("int16", name) for name in IDEMPOTENT]
             + [(dt, name) for dt in ("bfloat16", "float16") for name in NAMES]
             + [("packed", "or_and")])
HALF = ("bfloat16", "float16")
INTS = (np.bool_, np.int8, np.uint8, np.int16, np.int32, np.int64, np.uint32)


def _ids(case):
    return "-".join(case)


def _engines(storage, name, **kw):
    """(port engine on the CPU, reference engine), both pinned to the
    lowering, method "fused" with s = 16."""
    if storage == "packed":
        tk = jk = dict(semiring="or_and", packed=True)
    else:
        tk = dict(semiring=name, dtype=getattr(torch, storage))
        jk = dict(semiring=name, dtype=getattr(jnp, storage))
    common = dict(method="fused", block_size=16, validate=False, **kw)
    return ApspEngine(device="cpu", **common, **tk), japsp.ApspEngine(**common, **jk)


def _graph(name, n, seed):
    """Integer weights in the semiring's value domain (missing edges the
    ⊕-identity, diagonal the ⊗-identity): path sums stay exact in bf16,
    f16 and int16."""
    rng = np.random.default_rng(seed)
    sr = jsr.SEMIRINGS[name]
    if name == "or_and":
        w = (rng.uniform(size=(n, n)) < 0.08).astype(np.float32)
    elif name == "plus_mul":  # a DAG of 0/1 weights: path counts
        w = np.triu((rng.uniform(size=(n, n)) < 0.1).astype(np.float32), 1)
    else:
        w = rng.integers(1, 9, (n, n)).astype(np.float32)
        w[rng.uniform(size=(n, n)) > 0.35] = sr.zero
        if name == "max_plus":  # longest paths need a DAG
            w[np.tril_indices(n, -1)] = -np.inf
    np.fill_diagonal(w, sr.one)
    return w


def _packed_planes(n, seed, count=2):
    rng = np.random.default_rng(seed)
    bs = rng.uniform(size=(count, n, n)) < 0.06
    bs[:, np.arange(n), np.arange(n)] = True
    return bs


def _pack(bs):
    return np.asarray(pack_reachability(bs.astype(np.float32)))


def _updates(name, n):
    """⊕-improving updates of ``_graph``: (u, v, w)."""
    return {
        "min_plus": [(3, 7, 1.0), (n // 2, 2, 2.0), (1, n - 2, 1.0)],
        "max_plus": [(3, 7, 20.0), (2, n // 2, 15.0), (1, n - 2, 30.0)],
        "max_min": [(3, 7, 9.0), (n // 2, 2, 8.0), (1, n - 2, 9.0)],
        "or_and": [(3, 7, 1.0), (n // 2, 2, 1.0), (1, n - 2, 1.0)],
        "plus_mul": [(3, 7, 1.0), (2, n // 2, 1.0), (1, n - 2, 1.0)],
    }[name]


# ------------------------------------------------------- solve / solve_many
@pytest.mark.parametrize("case", LOWERINGS, ids=_ids)
def test_engine_solve_and_solve_many_match_reference(case):
    storage, name = case
    te, je = _engines(storage, name)
    if storage == "packed":
        graphs = [_pack(_packed_planes(n, n)) for n in (40, 70)]
        ragged = [g[0] for g in graphs] + [graphs[0][0]]
    else:
        graphs = [_graph(name, n, n) for n in (40, 70)]
        ragged = graphs + [graphs[0]]
    for g in graphs:
        t, j = te.solve(g), je.solve(g)
        assert t.semiring == j.semiring and t.method == j.method
        assert_same(t.dist, np.asarray(j.dist))
    for t, j in zip(te.solve_many(ragged), je.solve_many(ragged)):
        assert t.n == j.n
        assert_same(t.dist, np.asarray(j.dist))
    key = next(iter(te._cache))
    assert key.dtype == ("int32" if storage == "packed" else storage)
    assert key.semiring == te.semiring.name == je.semiring.name


@pytest.mark.parametrize("storage", HALF)
def test_engine_solve_many_successors_half_match_reference(storage):
    te, je = _engines(storage, "min_plus")
    graphs = [_graph("min_plus", n, n + 1) for n in (30, 50, 30)]
    for t, j in zip(te.solve_many(graphs, successors=True),
                    je.solve_many(graphs, successors=True)):
        assert_same(t.dist, np.asarray(j.dist))
        assert_same(t.succ, np.asarray(j.succ))


# ------------------------------------------------------------------ repair
@pytest.mark.parametrize("case", LOWERINGS, ids=_ids)
def test_engine_repair_matches_reference(case):
    storage, name = case
    n = 48
    te, je = _engines(storage, name)
    if storage == "packed":
        g = _pack(_packed_planes(n, 1))
        upd = [(3, 7, 1 << 0), (40, 9, 0b11), (5, 6, -1)]
    else:
        g = _graph(name, n, 3)
        upd = _updates(name, n)
    t0, j0 = te.solve(g), je.solve(g)
    t, j = te.repair(t0.dist, upd), je.repair(j0.dist, upd)
    assert t.dist.shape == tuple(np.asarray(j.dist).shape)
    assert_same(t.dist, np.asarray(j.dist))
    assert (t.method, t.semiring, t.padded_n) == (j.method, j.semiring, j.padded_n)
    assert te.stats.repairs == je.stats.repairs == 1
    # a longer batch: several launch pairs' worth of edges
    many = [(i % n, (7 * i + 1) % n, upd[i % len(upd)][2]) for i in range(37)]
    if name == "plus_mul":  # stay a DAG
        many = [(min(u, v), max(u, v), w) for u, v, w in many if u != v]
    assert_same(te.repair(t0.dist, many).dist, np.asarray(je.repair(j0.dist, many).dist))


def _edges(triples, count, dtype, fill):
    """The engine's padded edge batch: no-op edges (0, 0, ⊕-identity)."""
    u, v = np.zeros(count, np.int32), np.zeros(count, np.int32)
    w = np.array(jnp.full(count, fill, dtype))
    for i, (a, b, x) in enumerate(triples):
        u[i], v[i], w[i] = a, b, x
    return u, v, w


@pytest.mark.parametrize("storage", HALF)
def test_engine_successor_repair_half_matches_reference(storage):
    """f16 against the reference engine; bf16 against its twin
    ``fw_repair_with_successors_ref`` (the reference engine refuses a bf16
    successor repair: it tests ``dtype.kind == "f"``, which ml_dtypes'
    bfloat16 is not)."""
    te, je = _engines(storage, "min_plus")
    n = 48  # a multiple of s: no padding
    g = _graph("min_plus", n, 4)
    t0, j0 = te.solve(g, successors=True), je.solve(g, successors=True)
    assert_same(t0.succ, np.asarray(j0.succ))
    upd = _updates("min_plus", n)
    t = te.repair(t0.dist, upd, succ=t0.succ)
    if storage == "float16":
        j = je.repair(j0.dist, upd, succ=np.asarray(j0.succ))
        jd_, js = j.dist, j.succ
    else:
        u, v, w = _edges(upd, 4, jnp.bfloat16, np.inf)
        jd_, js = jref.fw_repair_with_successors_ref(j0.dist, j0.succ, u, v, w)
    assert_same(t.dist, np.asarray(jd_))
    assert_same(t.succ, np.asarray(js))


def test_engine_repair_equals_resolve_on_lowerings():
    """The repair contract where the arithmetic is exact: == a re-solve of
    the updated graph (``tests/test_fw_repair.py:125``)."""
    n = 48
    for storage in ("int16", "bfloat16", "float16"):
        te, _ = _engines(storage, "min_plus")
        g = _graph("min_plus", n, 6)
        upd = _updates("min_plus", n)
        g1 = g.copy()
        for u, v, w in upd:
            g1[u, v] = min(g1[u, v], w)
        assert_same(te.repair(te.solve(g).dist, upd).dist, te.solve(g1).dist)
    te, _ = _engines("packed", "or_and")
    bs = _packed_planes(n, 2)
    b1 = bs.copy()
    b1[0, 3, 7] = True
    b1[:, 40, 9] = True
    rep = te.repair(te.solve(_pack(bs)).dist, [(3, 7, 1), (40, 9, 0b11)])
    assert_same(rep.dist, te.solve(_pack(b1)).dist)


def test_engine_repair_refuses_what_the_storage_cannot_hold():
    te, _ = _engines("int16", "min_plus")
    d = te.solve(_graph("min_plus", 32, 1)).dist
    with pytest.raises(ValueError, match="does not fit"):
        te.repair(d, [(0, 1, 40000)])
    with pytest.raises(ValueError, match="float distance table"):
        te.repair(d, [(0, 1, 3)], succ=torch.zeros((32, 32), dtype=torch.int32))


# -------------------------------------------------------------- repair_del
@pytest.mark.parametrize("case", LOWERINGS, ids=_ids)
def test_engine_repair_del_matches_reference(case):
    storage, name = case
    n = 48
    te, je = _engines(storage, name)
    if storage == "packed":
        bs = _packed_planes(n, 9)
        bs[0, 3, 7] = True
        bs[:, 40, 9] = True
        g = _pack(bs)
        b1 = bs.copy()
        b1[0, 3, 7] = False
        b1[:, 40, 9] = False
        g1 = _pack(b1)
        dels = [(3, 7, 1 << 0), (40, 9, 0b11)]
    elif name == "plus_mul":  # re-solved in every storage: any edge will do
        g = _graph(name, n, 5)
        u, v = np.argwhere(g == 1)[0]
        dels, g1 = [(int(u), int(v), 1.0)], g.copy()
        g1[u, v] = 0.0
    else:
        g = _graph(name, n, 5)
        j0 = je.solve(g)
        dels, g1 = pick_deletions(g, np.asarray(j0.dist).astype(np.float32), name)
        assert dels
    t0, j0 = te.solve(g), je.solve(g)
    t = te.repair_del(t0.dist, g1, dels, threshold=100.0)
    j = je.repair_del(j0.dist, g1, dels, threshold=100.0)
    assert_same(t.dist, np.asarray(j.dist))
    for field in ("repair_dels", "repair_del_fallbacks", "repair_del_noops", "repair_del_rows"):
        assert getattr(te.stats, field) == getattr(je.stats, field), field
    if name == "plus_mul":
        assert te.stats.repair_del_fallbacks == 1 and te.stats.repair_dels == 0
    else:
        assert te.stats.repair_dels == 1
        assert_same(t.dist, te.solve(g1).dist)  # == re-solve: exact weights
    # the default policy decides as the reference's
    t = te.repair_del(t0.dist, g1, dels)
    j = je.repair_del(j0.dist, g1, dels)
    assert_same(t.dist, np.asarray(j.dist))
    assert te.stats.repair_del_fallbacks == je.stats.repair_del_fallbacks


@pytest.mark.parametrize("storage", HALF)
@pytest.mark.parametrize("threshold", [100.0, 0.0])
def test_engine_successor_repair_del_half_matches_reference(storage, threshold):
    """f16 against the reference engine; bf16 (which the reference engine
    refuses, as for ``repair``) against the reference's marking and sweep
    twins composed as its engine composes them, and its re-solve."""
    te, je = _engines(storage, "min_plus")
    n, s = 48, 16
    g = _graph("min_plus", n, 7)
    t0, j0 = te.solve(g, successors=True), je.solve(g, successors=True)
    dels, g1 = pick_deletions(g, np.asarray(j0.dist).astype(np.float32), "min_plus")
    t = te.repair_del(t0.dist, g1, dels, succ=t0.succ, threshold=threshold)
    assert te.stats.repair_dels == (threshold > 0)
    if storage == "float16":
        j = je.repair_del(j0.dist, g1, dels, succ=np.asarray(j0.succ), threshold=threshold)
        jd_, js = j.dist, j.succ
        assert te.stats.repair_dels == je.stats.repair_dels
    elif threshold == 0:
        j = je.solve(g1, successors=True)
        jd_, js = j.dist, j.succ
    else:
        u, v, wold = _edges(dels, 4, jnp.bfloat16, np.inf)
        w1 = jnp.asarray(g1, jnp.bfloat16)
        d_init, s_init, mask, _ = jd.mark_affected_with_successors(
            j0.dist, j0.succ, w1, jnp.asarray(u), jnp.asarray(v), jnp.asarray(wold), len(dels))
        rows = np.flatnonzero(np.asarray(mask))
        a_pad = min(max(8, 1 << (rows.size - 1).bit_length()), n)
        rows = np.concatenate([rows, np.full(a_pad - rows.size, n)]).astype(np.int32)
        jd_, js = jd.fw_repair_del_sweep_with_successors_ref(d_init, s_init, jnp.asarray(rows),
                                                             block_size=s)
    assert_same(t.dist, np.asarray(jd_))
    assert_same(t.succ, np.asarray(js))


def test_engine_repair_del_int16_infinite_old_weight_is_inert():
    """A non-finite old weight in an integer lowering names an edge the
    lowering never held: its witness stays the ⊕-identity
    (``src/repro/apsp/engine.py:756-765``)."""
    te, je = _engines("int16", "min_plus")
    g = _graph("min_plus", 40, 8)
    t0, j0 = te.solve(g), je.solve(g)
    dels = [(0, 1, float("inf"))]
    t = te.repair_del(t0.dist, g, dels, threshold=100.0)
    j = je.repair_del(j0.dist, g, dels, threshold=100.0)
    assert_same(t.dist, np.asarray(j.dist))
    assert te.stats.repair_del_noops == je.stats.repair_del_noops == 1


# --------------------------------------------------------- integer storage
@pytest.mark.parametrize("name", ["or_and", "plus_mul"])
@pytest.mark.parametrize("dt", INTS, ids=lambda d: np.dtype(d).name)
def test_integer_storage_keeps_reference_dtype_and_bits(dt, name):
    """The reference keeps an integer input's dtype for or_and / plus_mul
    (int64 arrives as int32); plus_mul wraps where the integers overflow."""
    rng = np.random.default_rng(11)
    n = 40
    if dt is np.bool_:
        w = rng.uniform(size=(n, n)) < 0.1
    elif name == "or_and":
        w = rng.integers(0, 120, (n, n)).astype(dt)
        if dt is np.uint32:  # bit 31 set: unsigned order differs from signed
            w[rng.uniform(size=(n, n)) < 0.3] = np.uint32(4_000_000_000)
    else:
        w = ((rng.uniform(size=(n, n)) < 0.1) * 3).astype(dt)
    for method, kw in (("auto", {}), ("fused", dict(block_size=16))):
        j = japsp.solve(w, semiring=name, method=method, validate=False, **kw)
        t = solve(w, semiring=name, method=method, validate=False, device="cpu", **kw)
        assert t.semiring == name
        assert_same(t.dist, np.asarray(j.dist))
    eng = ApspEngine(semiring=name, method="fused", block_size=16, device="cpu")
    assert_same(eng.solve(w).dist, np.asarray(j.dist))


@pytest.mark.parametrize("dt", [np.uint8, np.uint32, np.int32, np.bool_],
                         ids=lambda d: np.dtype(d).name)
def test_integer_storage_engine_repairs_match_reference(dt):
    """or_and in integer storage: repair, repair_del on the int32 carrier
    (uint32 flipped); plus_mul int32: the lifted repair, the counted
    re-solve of repair_del."""
    n = 48
    bs = _packed_planes(n, 12, count=1)[0]
    w = bs.astype(dt)
    te = ApspEngine(semiring="or_and", method="fused", block_size=16, device="cpu")
    je = japsp.ApspEngine(semiring="or_and", method="fused", block_size=16)
    t0, j0 = te.solve(w), je.solve(w)
    assert_same(t0.dist, np.asarray(j0.dist))
    upd = [(3, 7, 1), (n // 2, 2, 1)]
    assert_same(te.repair(t0.dist, upd).dist, np.asarray(je.repair(j0.dist, upd).dist))
    dels, w1 = pick_deletions(w.astype(np.float32), np.asarray(j0.dist).astype(np.float32),
                              "or_and")
    w1 = w1.astype(dt)
    dels = [(u, v, 1) for u, v, _ in dels]
    t = te.repair_del(t0.dist, w1, dels, threshold=100.0)
    j = je.repair_del(j0.dist, w1, dels, threshold=100.0)
    assert_same(t.dist, np.asarray(j.dist))
    assert te.stats.repair_dels == je.stats.repair_dels
    if dt is np.int32:  # plus_mul on a DAG of path counts
        g = _graph("plus_mul", n, 13).astype(np.int32)
        te = ApspEngine(semiring="plus_mul", method="naive", device="cpu")
        je = japsp.ApspEngine(semiring="plus_mul", method="naive")
        t0, j0 = te.solve(g), je.solve(g)
        up = [(2, 9, 5), (1, n - 2, 3)]
        assert_same(te.repair(t0.dist, up).dist, np.asarray(je.repair(j0.dist, up).dist))
        t = te.repair_del(t0.dist, g, [(2, 9, 1)])
        assert_same(t.dist, np.asarray(je.repair_del(j0.dist, g, [(2, 9, 1)]).dist))
        assert te.stats.repair_del_fallbacks == 1


# -------------------------------------------------------------- R3: weights
def test_bf16_successor_repair_rounds_its_weight_in_bf16():
    """The twins carry the weights in d's dtype, as the reference's
    ``jnp.asarray(w, d.dtype)``: a weight that is no bf16 value rounds to
    bf16 before ``(d[:, u] + w) + d[v, :]`` (each add rounded in bf16), and
    an int16 or lane-mask weight stays an integer — carried in f32, an
    int16 or_and / max_min repair came out f32 and a packed one raised."""
    rng = np.random.default_rng(14)
    n = 32
    # Even distances in [256, 512), where a bf16 ulp is 2: d + 1 is a tie
    # (to even), d + 1.001 is not.
    d = (2 * rng.integers(128, 256, (n, n))).astype(np.float32)
    np.fill_diagonal(d, 0)
    db = np.asarray(jnp.asarray(d, jnp.bfloat16))
    succ = np.tile(np.arange(n, dtype=np.int32), (n, 1))
    u, v = np.array([3, 10], np.int32), np.array([7, 2], np.int32)
    w = np.array([1.001, 3.001], np.float32)  # not bf16 values: 1.0 and 3.0 there
    jd_, js = jref.fw_repair_with_successors_ref(db, succ, u, v, w)
    td, ts = tfr.fw_repair_with_successors(host_tensor(db), torch.from_numpy(succ), u, v, w,
                                           block_size=16)
    assert_same(td, np.asarray(jd_))
    assert_same(ts, np.asarray(js))
    d16 = np.random.default_rng(15).integers(0, 2, (n, n)).astype(np.int16)
    for name in ("or_and", "max_min"):
        sr = tsr.lower_semiring(tsr.SEMIRINGS[name], torch.int16)
        got = tref.fw_repair_ref(torch.from_numpy(d16), u, v, [1.0, 1.0], semiring=sr)
        want = jref.fw_repair_ref(d16, u, v, np.ones(2, np.int16),
                                  semiring=jsr.lower_semiring(jsr.SEMIRINGS[name], jnp.int16))
        assert_same(got, np.asarray(want))
    words = np.random.default_rng(16).integers(-(1 << 31), 1 << 31, (n, n)).astype(np.int32)
    got = tref.fw_repair_ref(torch.from_numpy(words), u, v, [5, -1], semiring=tsr.OR_AND_PACKED)
    want = jref.fw_repair_ref(words, u, v, np.array([5, -1], np.int32),
                              semiring=jsr.OR_AND_PACKED)
    assert_same(got, np.asarray(want))


# ------------------------------------------------ plain twins, per lowering
def _twin_data(storage, name, n, seed):
    """(torch tensor, numpy array, torch semiring, jax semiring) of a
    matrix in the lowering's storage: no closure structure needed."""
    rng = np.random.default_rng(seed)
    if storage == "packed":
        words = rng.integers(0, 1 << 32, size=(n, n), dtype=np.uint64)
        a = words.astype(np.uint32).view(np.int32)
        return host_tensor(a), a, tsr.OR_AND_PACKED, jsr.OR_AND_PACKED
    w = _graph(name, n, seed)
    if storage == "int16":
        tsr_, jsr_ = tsr.lower_semiring(tsr.SEMIRINGS[name], torch.int16), \
            jsr.lower_semiring(jsr.SEMIRINGS[name], jnp.int16)
        a = np.clip(w, -32768, 32767).astype(np.int16)
        return host_tensor(a), a, tsr_, jsr_
    a = np.asarray(jnp.asarray(w, getattr(jnp, storage)))
    return host_tensor(a), a, tsr.SEMIRINGS[name], jsr.SEMIRINGS[name]


def _twin_edges(storage, name, n, E, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, E).astype(np.int32)
    v = rng.integers(0, n, E).astype(np.int32)
    if storage == "packed":
        w = rng.integers(-(1 << 31), 1 << 31, E).astype(np.int32)
    elif storage == "int16":
        w = rng.integers(-5, 30, E).astype(np.int16)
    else:
        w = np.asarray(jnp.asarray(rng.integers(1, 9, E).astype(np.float32),
                                   getattr(jnp, storage)))
    return u, v, w


@pytest.mark.parametrize("case", LOWERINGS, ids=_ids)
def test_repair_twins_per_launch_match_direct_and_reference(case):
    storage, name = case
    n, E = 48, 7
    d, dn, tsr_, jsr_ = _twin_data(storage, name, n, 21)
    u, v, w = _twin_edges(storage, name, n, E, 22)
    wt = host_tensor(w)
    direct = tref.fw_repair_ref(d, u, v, wt, semiring=tsr_)
    staged = tref.repair_stage_ref(d, u, v, wt, semiring=tsr_)
    assert_same(tref.repair_apply_ref(d, staged, u, wt, semiring=tsr_), direct)
    assert_same(direct, np.asarray(jref.fw_repair_ref(dn, u, v, w, semiring=jsr_)))
    assert_same(tfr.fw_repair(d, u, v, wt, block_size=16, semiring=tsr_), direct)
    if storage in HALF and name == "min_plus":
        succ = np.random.default_rng(23).integers(-1, n, (n, n)).astype(np.int32)
        sd, ss = tref.fw_repair_with_successors_ref(d, torch.from_numpy(succ), u, v, wt)
        st = tref.repair_stage_ref(d, u, v, wt, strict=True)
        ad, as_ = tref.repair_apply_succ_ref(d, torch.from_numpy(succ), st, u, v, wt)
        jd_, js = jref.fw_repair_with_successors_ref(dn, succ, u, v, w)
        for got, want in ((ad, sd), (as_, ss)):
            assert_same(got, want)
        assert_same(sd, np.asarray(jd_))
        assert_same(ss, np.asarray(js))


@pytest.mark.parametrize("case", [c for c in LOWERINGS if c[1] != "plus_mul"], ids=_ids)
def test_sweep_and_mark_twins_match_reference(case):
    storage, name = case
    n, s = 64, 16
    d, dn, tsr_, jsr_ = _twin_data(storage, name, n, 31)
    w1, w1n, _, _ = _twin_data(storage, name, n, 32)
    u, v, wold = _twin_edges(storage, name, n, 4, 33)
    ecount = 3  # the last edge is padding
    got = tfd.mark_affected(d, w1, u, v, host_tensor(wold), ecount, semiring=tsr_)
    want = jd.mark_affected(dn, w1n, jnp.asarray(u), jnp.asarray(v), jnp.asarray(wold), ecount,
                            semiring=jsr_)
    for g, wnt in zip(got, want):
        assert_same(g, np.asarray(wnt))
    rows = np.array([1, 5, 17, 18, 40, 63, n, n], np.int32)
    direct = tref.fw_repair_del_sweep_ref(d, rows, block_size=s, bk=8, semiring=tsr_)
    assert_same(direct, np.asarray(jd.fw_repair_del_sweep_ref(
        jnp.asarray(dn), jnp.asarray(rows), block_size=s, bk=8, semiring=jsr_)))
    # the per-launch twins (diag, panels, relax a round) compose to it
    r = torch.from_numpy(rows.astype(np.int64))
    strip = tref._gather_strip(d, r)
    for b in range(n // s):
        diag = tref.sweep_diag_ref(d, strip, r, b, block_size=s, semiring=tsr_)
        band, acol = tref.sweep_panels_ref(d, strip, r, diag, b, semiring=tsr_)
        strip = tref.sweep_relax_ref(strip, r, band, acol, b, bk=8, semiring=tsr_)
    assert_same(tref._scatter_strip(d, r, strip), direct)
    assert_same(tfd.fw_repair_del_sweep(d, rows, block_size=s, bk=8, semiring=tsr_), direct)
    if storage in HALF and name == "min_plus":
        succ = np.random.default_rng(34).integers(-1, n, (n, n)).astype(np.int32)
        sd, ss = tfd.fw_repair_del_sweep_with_successors(d, torch.from_numpy(succ), rows,
                                                         block_size=s)
        jd_, js = jd.fw_repair_del_sweep_with_successors_ref(
            jnp.asarray(dn), jnp.asarray(succ), jnp.asarray(rows), block_size=s)
        assert_same(sd, np.asarray(jd_))
        assert_same(ss, np.asarray(js))


# ----------------------------------------------------- policy and interop
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int16", "int32"])
def test_policies_decide_as_the_reference_in_each_storage_word(dtype):
    """should_repair / should_repair_del weigh the storage's word (2 B for
    int16 / bf16 / f16, 4 B a packed or int32 word) and decide as the
    reference's engine and planner do."""
    from repro.apsp import plan as jplan
    from repro_torch.apsp import plan as tplan

    te, je = ApspEngine(device="cpu"), japsp.ApspEngine()
    word = tplan.word_for(dtype)
    assert word == jnp.dtype(dtype).itemsize
    for n, k in ((512, 1), (2048, 7), (8192, 64), (8192, 5000)):
        assert te.should_repair(n, k, dtype=dtype) == je.should_repair(n, k, dtype=dtype)
        for a in (1, 40, n // 3):
            assert tplan.should_repair_del(n, a, word=word, edges=k) == \
                jplan.should_repair_del(n, a, word=word, edges=k)
            assert tplan.repair_del_hbm_bytes(n, 128, affected_rows=a, word=word) == \
                jplan.repair_del_hbm_bytes(n, 128, affected_rows=a, word=word)
        assert tplan.repair_hbm_bytes(n, 128, word=word, edges=k) == \
            jplan.repair_hbm_bytes(n, 128, word=word, edges=k)


@pytest.mark.parametrize("dt", INTS + (np.uint64, np.float64), ids=lambda d: np.dtype(d).name)
def test_interop_carries_integer_storages_as_the_reference_sees_them(dt):
    """numpy arrays cross into the port in the dtype JAX gives them: the
    integer storages keep theirs, 64-bit types narrow to 32 bits."""
    from repro_torch.utils.interop import from_numpy, to_numpy

    a = (np.arange(12).reshape(3, 4) % 5).astype(dt)
    t = from_numpy(a, device="cpu")
    want = np.asarray(jnp.asarray(a))
    assert to_numpy(t).dtype == want.dtype
    assert_same(t, want)
