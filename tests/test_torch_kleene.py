"""The port's recursive (R-Kleene) schedule against the JAX reference's, on
the CPU (``device="cpu"``: the plain versions of the kernels).

  * the reference's ``tests/test_kleene.py``, case by case but for the
    autotuner's (ROADMAP A.5): ``fw_kleene`` on the five semirings at
    (128, s 32, leaf 32), (160, 32, 64), (96, 32, 96) and batched,
    ``solve(method="recursive")`` at odd n and in int16 / bf16 / packed
    storage, the refusal of successors, the host store's bytes against
    ``plan.recursive_transfer_bytes``, a capped budget that streams, the
    plan's ranges and budget flip, the engine's warm cache and its budget
    promotion.  Each result is held by bits (``utils.bits.bits_equal``) to
    the reference's on the same numpy input, and to the port's fused solve;
  * the plan's dicts equal the reference's over a grid of n, s, leaf,
    budget, batch and dtype;
  * ``solve`` and ``ApspEngine`` promote (or not) as the reference's
    ``_resolve_shape`` decides, packed and successor solves included, and
    the 64-bit inputs the reference counts in 8-byte words;
  * a panel is memory of its own (a plus_mul solve through the in-core
    store equals the reference's), and ``launch.fw_oocore.smoke`` passes.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp as japsp  # before repro.kernels.ref: the import cycle (C.3)
from repro.apsp import kleene as jkleene
from repro.apsp import plan as jplan
from repro.core.semiring import SEMIRINGS as JSEMIRINGS
from repro_torch.apsp import (
    ApspEngine,
    DevicePanelStore,
    HostPanelStore,
    KleeneExecutor,
    fw_kleene,
    plan,
    solve,
)
from repro_torch.core.semiring import MIN_PLUS, SEMIRINGS
from repro_torch.core.staged import fw_staged
from repro_torch.launch import fw_oocore
from repro_torch.utils.bits import bits_equal

SR_NAMES = ("min_plus", "max_plus", "max_min", "or_and", "plus_mul")
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread while this module runs: its plain schedules are
    long chains of small elementwise ops, which the suite's parallel
    workers slow tenfold when each also spreads them over every core.  The
    bits do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graph(n, seed, sr=MIN_PLUS, batch=None):
    """The reference test's graphs (``tests/test_kleene.py:_graph``)."""
    rng = np.random.default_rng(seed)
    shape = (n, n) if batch is None else (batch, n, n)
    if sr.name == "plus_mul":
        w = rng.uniform(0.0, 0.01, size=shape).astype(np.float32)
    elif sr.name == "max_plus":
        w = rng.uniform(-10.0, -1.0, size=shape).astype(np.float32)
    else:
        w = rng.uniform(1.0, 10.0, size=shape).astype(np.float32)
    w = np.where(rng.random(shape) < 0.4, np.float32(sr.zero), w)
    if sr.name != "plus_mul":
        idx = np.arange(n)
        w[..., idx, idx] = sr.one
    if sr.name == "or_and":
        w = (w != sr.zero).astype(np.float32)
    return w


@functools.cache
def _ref_kleene(name, n, s, leaf, batch, seed, out_of_core=False):
    w = _graph(n, seed, JSEMIRINGS[name], batch)
    return np.asarray(jkleene.fw_kleene(jnp.asarray(w), semiring=JSEMIRINGS[name], block_size=s,
                                     leaf=leaf, out_of_core=out_of_core))


# ------------------------------------------------------------ core schedule
@pytest.mark.parametrize("srname", SR_NAMES)
@pytest.mark.parametrize("n,s,leaf", [(128, 32, 32), (160, 32, 64), (96, 32, 96)])
def test_fw_kleene_bitwise_vs_fused(srname, n, s, leaf):
    sr = SEMIRINGS[srname]
    w = _graph(n, seed=7, sr=sr)
    got = fw_kleene(w, semiring=sr, block_size=s, leaf=leaf, **CPU)
    assert bits_equal(got, fw_staged(torch.from_numpy(w), block_size=s, semiring=sr))
    assert bits_equal(got, _ref_kleene(srname, n, s, leaf, None, 7))
    streamed = fw_kleene(w, semiring=sr, block_size=s, leaf=leaf, out_of_core=True, **CPU)
    assert bits_equal(streamed, got)


@pytest.mark.parametrize("srname", SR_NAMES)
@pytest.mark.parametrize("out_of_core", [False, True], ids=["device_store", "host_store"])
def test_fw_kleene_batched_bitwise(srname, out_of_core):
    sr = SEMIRINGS[srname]
    w = _graph(96, seed=11, sr=sr, batch=3)
    got = fw_kleene(w, semiring=sr, block_size=32, leaf=32, out_of_core=out_of_core, **CPU)
    assert bits_equal(got, fw_staged(torch.from_numpy(w), block_size=32, semiring=sr))
    assert bits_equal(got, _ref_kleene(srname, 96, 32, 32, 3, 11))


@pytest.mark.parametrize("srname", SR_NAMES)
def test_solve_recursive_bitwise_all_semirings_odd_n(srname):
    sr = SEMIRINGS[srname]
    w = _graph(150, seed=13, sr=sr)
    rf = solve(w, method="fused", block_size=32, semiring=sr, validate=False, **CPU)
    rr = solve(w, method="recursive", block_size=32, leaf=64, semiring=sr, validate=False,
               **CPU)
    assert rr.method == "recursive" and rr.padded_n == rf.padded_n
    assert bits_equal(rf.dist, rr.dist)
    want = japsp.solve(w, method="recursive", block_size=32, leaf=64,
                       semiring=JSEMIRINGS[srname], validate=False)
    assert bits_equal(rr.dist, np.asarray(want.dist))


def _lowered_case(case):
    """(port kwargs, reference kwargs, input) of one storage lowering."""
    if case == "packed":
        rng = np.random.default_rng(19)
        wb = (rng.random((40, 96, 96)) < 0.05).astype(np.float32)
        kw = dict(semiring="or_and", packed=True)
        return kw, kw, wb
    w = _graph(100, seed=17)
    if case == "int16":
        return dict(dtype=torch.int16), dict(dtype="int16"), w
    return dict(dtype=torch.bfloat16), dict(dtype=jnp.bfloat16), w


@pytest.mark.parametrize("case", ["int16", "bf16", "packed"])
def test_solve_recursive_storage_lowerings_bitwise(case):
    kw, jkw, w = _lowered_case(case)
    rf = solve(w, method="fused", block_size=32, validate=False, **kw, **CPU)
    rr = solve(w, method="recursive", block_size=32, leaf=32, validate=False, **kw, **CPU)
    assert rr.dist.dtype == rf.dist.dtype and bits_equal(rf.dist, rr.dist)
    want = japsp.solve(w, method="recursive", block_size=32, leaf=32, validate=False, **jkw)
    assert bits_equal(rr.dist, np.asarray(want.dist))


def test_recursive_rejects_successors():
    with pytest.raises(ValueError, match="successors"):
        solve(_graph(64, seed=23), method="recursive", successors=True, **CPU)
    with pytest.raises(ValueError, match="successors"):
        japsp.solve(_graph(64, seed=23), method="recursive", successors=True)


# ----------------------------------------------------------- out of core
def test_host_store_bitwise_and_transfer_model():
    n, s, leaf = 256, 32, 64
    w = _graph(n, seed=29)
    store = HostPanelStore(w, **CPU)
    KleeneExecutor(semiring=MIN_PLUS, block_size=s, leaf=leaf).run(store)
    assert bits_equal(store.result(), fw_staged(torch.from_numpy(w), block_size=s))
    h2d, d2h = plan.recursive_transfer_bytes(n, s, leaf // s)
    assert store.h2d_bytes == h2d and store.d2h_bytes == d2h
    jstore = jkleene.HostPanelStore(w)
    jkleene.KleeneExecutor(semiring=JSEMIRINGS["min_plus"], block_size=s, leaf=leaf).run(jstore)
    assert bits_equal(store.result(), jstore.result())
    assert (store.h2d_bytes, store.d2h_bytes, store.gets, store.puts) == (
        jstore.h2d_bytes, jstore.d2h_bytes, jstore.gets, jstore.puts)
    # The in-core twin: the same computation, no transfer.
    dev = DevicePanelStore(torch.from_numpy(w))
    KleeneExecutor(semiring=MIN_PLUS, block_size=s, leaf=leaf).run(dev)
    assert bits_equal(store.result(), dev.result())
    assert dev.h2d_bytes == 0 and dev.d2h_bytes == 0


@pytest.mark.parametrize("srname", ["min_plus", "plus_mul"])
@pytest.mark.parametrize("lanes", [2, 3])
def test_sweep_lanes_bitwise(srname, lanes):
    """A device listed more than once gets a lane of its own (factors, ring,
    copy streams on a card): the sweep's tiles round-robin over the lanes,
    and the closure, bytes and copies equal the one-lane run's."""
    n, s, leaf = 192, 32, 64
    sr = SEMIRINGS[srname]
    w = _graph(n, seed=43, sr=sr)
    one, many = HostPanelStore(w, **CPU), HostPanelStore(w, **CPU)
    KleeneExecutor(semiring=sr, block_size=s, leaf=leaf).run(one)
    ex = KleeneExecutor(semiring=sr, block_size=s, leaf=leaf, devices=["cpu"] * lanes)
    ex.run(many)
    assert bits_equal(many.result(), one.result())
    assert bits_equal(many.result(), fw_staged(torch.from_numpy(w), block_size=s, semiring=sr))
    assert (many.h2d_bytes, many.d2h_bytes, many.gets, many.puts) == (
        one.h2d_bytes, one.d2h_bytes, one.gets, one.puts)


def test_capped_budget_streams_and_matches_fused():
    n, budget = 512, 600 << 10
    w = _graph(n, seed=31)
    assert n * n * 4 > budget
    rp = plan.recursive_plan(n, block_size=64, hbm_budget=budget)
    assert rp["out_of_core"]
    assert rp["hbm_resident_bytes"] <= budget < rp["matrix_bytes"]
    res = solve(w, method="fused", block_size=64, hbm_budget=budget, **CPU)
    assert res.method == "recursive" and res.dist.device.type == "cpu"
    assert bits_equal(res.dist, solve(w, method="fused", block_size=64, **CPU).dist)
    want = japsp.solve(w, method="fused", block_size=64, hbm_budget=budget)
    assert want.method == "recursive" and bits_equal(res.dist, np.asarray(want.dist))


def test_batched_transfer_model_scales():
    n, s, leaf, B = 128, 32, 32, 3
    w = _graph(n, seed=37, batch=B)
    store = HostPanelStore(w, **CPU)
    KleeneExecutor(semiring=MIN_PLUS, block_size=s, leaf=leaf).run(store)
    h2d, d2h = plan.recursive_transfer_bytes(n, s, leaf // s, batch=B)
    assert store.h2d_bytes == h2d and store.d2h_bytes == d2h
    assert bits_equal(store.result(), fw_staged(torch.from_numpy(w), block_size=s))
    assert bits_equal(store.result(), _ref_kleene("min_plus", n, s, leaf, B, 37, True))


# ------------------------------------------------------------------ plans
def test_kleene_ranges_tile_the_round_axis():
    for T in (1, 2, 3, 7, 8, 16, 33):
        for lr in (1, 2, 4):
            ranges, depth = plan.kleene_ranges(T, lr)
            assert (ranges, depth) == jplan.kleene_ranges(T, lr)
            assert ranges[0][0] == 0 and ranges[-1][1] == T
            for (a, b), (c, _) in zip(ranges, ranges[1:]):
                assert b == c and 0 < b - a <= lr
            assert 0 < ranges[-1][1] - ranges[-1][0] <= lr
            assert depth >= 1


def test_recursive_plan_budget_flip_and_leaf_fit():
    rp_in = plan.recursive_plan(1000, block_size=128)
    assert not rp_in["out_of_core"] and rp_in["transfer_bytes"] == 0
    rp_out = plan.recursive_plan(1000, block_size=128, hbm_budget=3 << 20)
    assert rp_out["out_of_core"]
    assert rp_out["hbm_resident_bytes"] <= 3 << 20
    assert rp_out["transfer_bytes"] > 0
    assert rp_out["leaf"] % rp_out["block_size"] == 0
    # The plan's step counts match a run (zeros: the launches are counted).
    ex = KleeneExecutor(semiring=MIN_PLUS, block_size=128, leaf=rp_out["leaf"])
    ex.run(HostPanelStore(np.zeros((rp_out["n_padded"],) * 2, np.float32), **CPU))
    assert ex.leaf_calls == rp_out["leaf_calls"]
    assert ex.sweep_calls == rp_out["sweep_calls"]
    assert ex.depth == rp_out["depth"]


PLAN_GRID = [
    dict(n=n, block_size=s, leaf=leaf, hbm_budget=budget, batch=batch, dtype=dtype)
    for n in (1, 100, 1000, 16384) for s in (None, 32, 128)
    for leaf in (None, 128, 512) if leaf is None or s is None or leaf % s == 0
    for budget in (None, 600 << 10, 3 << 20, 768 << 20)
    for batch in (1, 3) for dtype in ("float32", "int16", "bfloat16")
]


@pytest.mark.parametrize("kw", PLAN_GRID[::7] + PLAN_GRID[-3:], ids=str)
def test_recursive_plan_dicts_equal_the_reference(kw):
    k = dict(kw)
    n, lr = k.pop("n"), k.get("leaf")
    try:
        want = jplan.recursive_plan(n, **k)
    except ValueError as err:  # a leaf that is no multiple of the auto block size
        with pytest.raises(ValueError, match="multiple of block_size"):
            plan.recursive_plan(n, **k)
        assert "multiple" in str(err)
        return
    got = plan.recursive_plan(n, **k)
    assert got == want
    m, s = got["n_padded"], got["block_size"]
    word = plan.word_for(k["dtype"])
    for leaf_rounds in {1, got["leaf_rounds"], lr // s if lr and lr % s == 0 else 1}:
        assert plan.recursive_transfer_bytes(m, s, leaf_rounds, word=word, batch=k["batch"]) \
            == jplan.recursive_transfer_bytes(m, s, leaf_rounds, word=word, batch=k["batch"])
        for ooc in (False, True):
            assert plan.recursive_hbm_resident_bytes(
                m, s, leaf_rounds, word=word, batch=k["batch"], out_of_core=ooc
            ) == jplan.recursive_hbm_resident_bytes(
                m, s, leaf_rounds, word=word, batch=k["batch"], out_of_core=ooc)


def test_the_chip_lanes_plans():
    """The plans of the card's out-of-core lanes: leaf, panels, depth,
    sweeps, residency and bytes each way (``chip_smoke.py:phase_oocore``)."""
    lanes = [(16384, 768 << 20, "float32", 2048, 392, 587_202_560, 8_724_152_320),
             (16384, 384 << 20, "int16", 2048, 392, 293_601_280, 4_362_076_160),
             (8192, 192 << 20, "int32", 1024, 392, 146_800_640, 2_181_038_080)]
    for n, budget, dtype, leaf, sweeps, resident, each_way in lanes:
        rp = plan.recursive_plan(n, hbm_budget=budget, dtype=dtype)
        assert rp == jplan.recursive_plan(n, hbm_budget=budget, dtype=dtype)
        assert rp["out_of_core"] and rp["leaf"] == leaf and rp["panels"] == 8
        assert rp["depth"] == 4 and rp["sweep_calls"] == sweeps
        assert rp["hbm_resident_bytes"] == resident <= budget
        assert rp["h2d_bytes"] == rp["d2h_bytes"] == each_way


# -------------------------------------------------------------- promotion
# (case, port kwargs, reference kwargs, the word the reference counts)
PROMOTIONS = [
    ("f32", {}, {}, 4),
    ("f32_succ", dict(successors=True), dict(successors=True), None),
    ("f64", {}, {}, 8),
    ("f32_int16", dict(dtype=torch.int16), dict(dtype="int16"), 2),
    ("f32_bf16", dict(dtype=torch.bfloat16), dict(dtype=jnp.bfloat16), 2),
    ("int16_or_and", dict(semiring="or_and"), dict(semiring="or_and"), 2),
    ("int64_or_and", dict(semiring="or_and"), dict(semiring="or_and"), 8),
    ("int64_min_plus", {}, {}, 4),
    ("packed", dict(semiring="or_and", packed=True), dict(semiring="or_and", packed=True), None),
    ("batch3", {}, {}, 4),
]


def _promotion_input(case):
    w = _graph(100, seed=41, batch=3 if case == "batch3" else None)
    if case == "f64":
        return w.astype(np.float64)
    if case == "packed":
        return np.isfinite(w)
    if case == "int16_or_and":
        return np.isfinite(w).astype(np.int16)
    if case in ("int64_or_and", "int64_min_plus"):
        return np.where(np.isfinite(w), w, 0).astype(np.int64)
    return w


@pytest.mark.parametrize("case,kw,jkw,word", PROMOTIONS, ids=[p[0] for p in PROMOTIONS])
def test_budget_promotion_decides_as_the_reference(case, kw, jkw, word):
    """A budget one byte short of the padded matrix in the word the
    reference counts promotes ``solve`` to "recursive" (never a successor
    or packed solve), and one that fits does not, in the port as in the
    reference; promoted, the closures are equal."""
    w = _promotion_input(case)
    full = (3 if case == "batch3" else 1) * 128 * 128 * (word or 4)
    for budget, promoted in ((full - 1, word is not None), (full, False)):
        want = japsp.solve(w, method="fused", block_size=32, hbm_budget=budget, validate=False,
                           **jkw)
        got = solve(w, method="fused", block_size=32, hbm_budget=budget, validate=False,
                    **kw, **CPU)
        assert got.method == want.method == ("recursive" if promoted else "fused"), budget
        assert bits_equal(got.dist, np.asarray(want.dist)), budget


@pytest.mark.parametrize("dtype,jdtype", [(None, None), (torch.int16, "int16"),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_engine_promotion_keys_equal_the_reference(dtype, jdtype):
    """The engine decides at batch 1 in its pinned dtype's word: its plan
    keys' method / leaf / oocore equal the reference's for budgets around
    the padded matrix, on a batch of two graphs."""
    w = _graph(100, seed=43, batch=2)
    for budget in (128 * 128 * 4, 128 * 128 * 2, 128 * 128 * 2 - 1, 2 * 128 * 128 * 2):
        eng = ApspEngine(method="fused", block_size=32, hbm_budget=budget, dtype=dtype,
                         validate=False, **CPU)
        jeng = japsp.ApspEngine(method="fused", block_size=32, hbm_budget=budget,
                                dtype=jdtype, validate=False)
        got, want = eng.solve(w), jeng.solve(w)
        (key,), (jkey,) = eng._cache, jeng._cache
        assert (key.method, key.leaf, key.oocore) == (jkey.method, jkey.leaf, jkey.oocore)
        assert got.method == want.method and bits_equal(got.dist, np.asarray(want.dist))


# ----------------------------------------------------------------- engine
def test_engine_recursive_warm_cache_no_retrace():
    eng = ApspEngine(method="recursive", block_size=32, leaf=64, **CPU)
    w = _graph(200, seed=43)
    r1 = eng.solve(w)
    entry = next(iter(eng._cache.values()))
    assert entry.key.method == "recursive"
    assert entry.key.leaf == 64 and entry.key.oocore is False
    warm = entry.traces
    assert warm == 1 and entry.executor.traces == 1
    r2 = eng.solve(w)
    assert entry.traces == warm and entry.executor.traces == 1
    assert eng.stats.hits == 1
    rf = solve(w, method="fused", block_size=32, **CPU)
    assert bits_equal(r1.dist, rf.dist) and bits_equal(r2.dist, rf.dist)
    want = japsp.ApspEngine(method="recursive", block_size=32, leaf=64).solve(w)
    assert bits_equal(r1.dist, np.asarray(want.dist))


def test_engine_budget_promotes_to_streaming():
    eng = ApspEngine(method="fused", block_size=32, hbm_budget=100_000, **CPU)
    w = _graph(200, seed=47)
    res = eng.solve(w)
    key = next(iter(eng._cache))
    assert key.method == "recursive" and key.oocore is True
    assert res.method == "recursive"
    assert bits_equal(res.dist, solve(w, method="fused", block_size=32, **CPU).dist)
    entry = eng._cache[key]
    assert entry.executor.sweep_calls > 0
    want = japsp.ApspEngine(method="fused", block_size=32, hbm_budget=100_000).solve(w)
    assert bits_equal(res.dist, np.asarray(want.dist))


# ----------------------------------------------------------------- panels
def test_a_panel_is_memory_of_its_own():
    """``get`` copies: the two bands of a leaf share their (P, P) block, and
    a view would let one band's relaxation feed the other's.  plus_mul
    (whose ⊕ is not idempotent) through the in-core store equals the
    reference, and writing into a fetched panel leaves the store as it
    was."""
    sr = SEMIRINGS["plus_mul"]
    w = _graph(128, seed=53, sr=sr)
    store = DevicePanelStore(torch.from_numpy(w))
    band = store.get(0, 32, 128, 32)
    band.fill_(1.0)
    assert bits_equal(store.result(), torch.from_numpy(w))
    assert band.untyped_storage().data_ptr() != store.result().untyped_storage().data_ptr()
    KleeneExecutor(semiring=sr, block_size=32, leaf=64).run(store)
    assert bits_equal(store.result(), _ref_kleene("plus_mul", 128, 32, 64, None, 53))
    assert bits_equal(store.result(), fw_staged(torch.from_numpy(w), block_size=32,
                                                semiring=sr))


def test_stores_refuse_what_they_cannot_hold():
    with pytest.raises(ValueError, match="store needs"):
        HostPanelStore(np.zeros((4, 6), np.float32), **CPU)
    with pytest.raises(ValueError, match="multiple of block_size"):
        KleeneExecutor(block_size=32, leaf=48)
    with pytest.raises(ValueError, match="not a multiple"):
        KleeneExecutor(block_size=32, leaf=32).run(DevicePanelStore(torch.zeros(48, 48)))
    with pytest.raises(ValueError, match="does not fit"):
        DevicePanelStore(torch.zeros(64, 64)).get(0, 0, 8, 8, out=torch.zeros(8, 9))


def test_fw_oocore_smoke_on_the_cpu(capsys):
    assert fw_oocore.smoke(device="cpu") == 0
    assert "OK oocore smoke n=512" in capsys.readouterr().out


def test_fw_oocore_stream_once_matches_the_reference():
    """The launcher's metrics: the reference's keys and, but for the
    clock, its values."""
    from repro.launch import fw_oocore as jo

    got = fw_oocore.stream_once(256, budget=200_000, block_size=32, device="cpu")
    want = jo.stream_once(256, budget=200_000, block_size=32)
    for k in ("streamed_s", "device"):
        got.pop(k)
    want.pop("streamed_s")
    assert got == want and got["out_of_core"] and got["transfer_efficiency_pct"] == 100.0
