"""The port's serving stack (``repro_torch.serve``, ``launch.fw_serve``) vs
the JAX reference's, on the CPU (``device="cpu"``, the plain versions).

  * every case of ``tests/test_serve_layers.py``, the three
    ``RoutingEngine`` cases of ``tests/test_apsp_engine.py`` and
    ``test_routing_engine_query_on_lowered_tables`` of
    ``tests/test_paths_query.py``, on the port's classes;
  * the launcher's own ``repair_scenario`` / ``pick_deletions`` /
    ``_apply_updates`` give the reference's arrays; ``smoke`` passes; the
    load generator takes the reference's refresh arms on the same seed;
  * replays: one seeded operation log (adds, ``update_edge``,
    ``set_edge`` worsenings, ``fail_link``, ``remove_graph``, queries,
    ``submit`` / ``poll``, eviction under ``capacity_bytes``) through the
    reference's and the port's ``RoutingEngine`` in f32 min-plus with next
    hops, int16, bf16 and one packed word plane, methods "naive" and
    "fused": every published table equal by ``bits_equal``, every reply,
    every refresh-arm counter, ``engine.stats``, byte total and eviction;
  * mutation classification: ``update_edge`` / ``set_edge`` /
    ``fail_link`` on ±0, NaN, float64 weights, int16 sentinels, bf16,
    packed lanes (one plane and two), uint32 or_and, bool and int8
    plus_mul take the reference's result, dirty kind and pending lists;
  * without a card, ``RoutingEngine()`` and ``fw_serve --device cuda``
    raise, and no module of the port's serving stack imports ``jax``,
    ``ml_dtypes`` or the reference.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp as japsp
from repro.launch import fw_serve as jserve
from repro.serve.routing import RoutingEngine as JRouter
from repro_torch.apsp import ApspEngine
from repro_torch.core.graph import grid_graph, random_digraph
from repro_torch.core.paths import path_cost
from repro_torch.core.semiring import I16_INF
from repro_torch.launch import fw_serve
from repro_torch.serve.registry import DELTA, STRUCTURAL, GraphRegistry
from repro_torch.serve.routing import RoutingEngine
from repro_torch.serve.scheduler import MicroBatcher
from repro_torch.serve.snapshot import SnapshotStore, host_array, host_tensor
from repro_torch.utils.bits import bits_equal
from repro_torch.utils.interop import host_tensor as ref_tensor

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("min_plus", "max_plus", "max_min", "or_and", "plus_mul")


def Router(**kw):
    return RoutingEngine(device="cpu", **kw)


# ------------------------------------------ tests/test_serve_layers.py
def test_registry_dirty_classification():
    reg = GraphRegistry()
    reg.put("g", np.zeros((4, 4), np.float32))
    assert reg.dirty_kind("g") == STRUCTURAL  # new graph: full solve

    reg.clear_dirty("g")
    reg.mark_edge_delta("g", 0, 1, 2.5)
    reg.mark_edge_delta("g", 2, 3, 1.0)
    assert reg.dirty_kind("g") == DELTA
    assert [e.as_tuple() for e in reg.pending_deltas("g")] == [
        (0, 1, 2.5), (2, 3, 1.0)]

    reg.mark_structural("g")
    assert reg.dirty_kind("g") == STRUCTURAL
    assert reg.pending_deltas("g") == []
    reg.mark_edge_delta("g", 0, 1, 1.0)
    assert reg.dirty_kind("g") == STRUCTURAL and reg.pending_deltas("g") == []


def test_registry_memory_accounting_and_lru_eviction():
    reg = GraphRegistry(capacity_bytes=3 * 64 + 2 * 100)
    for gid in ("a", "b", "c"):
        reg.put(gid, np.zeros((4, 4), np.float32))  # 64 B each
        reg.clear_dirty(gid)
        reg.note_table_bytes(gid, 100)
    assert reg.graph_bytes("a") == 164 and reg.total_bytes == 3 * 164
    reg.touch("a")  # LRU order now b, c, a
    evicted = reg.evict_over_capacity()
    assert evicted == ["b"]
    assert reg.dirty_kind("b") == STRUCTURAL
    assert reg.graph_bytes("b") == 64  # weights never evicted
    reg.note_table_bytes("b", 100)
    reg.capacity_bytes = 0
    assert "c" in reg.evict_over_capacity(keep={"a", "b"})
    assert reg.evictions == 2


def test_registry_frozen_weights():
    reg = GraphRegistry()
    w = np.zeros((4, 4), np.float32)
    reg.put("g", w)
    w[0, 1] = 5.0  # caller mutation cannot reach the registry copy
    assert reg.peek("g")[0, 1] == 0.0
    with pytest.raises(ValueError):
        reg.peek("g")[0, 0] = 1.0  # read-only
    with pytest.raises(KeyError):
        reg.get("missing")


def test_snapshot_double_buffering_consistency():
    store = SnapshotStore()
    store.stage("g", np.eye(3, dtype=np.float32))
    assert store.active("g") is None  # staged ≠ visible
    first = store.publish("g")
    assert first.version == 1

    held = store.active("g")
    held_dist = held.dist.copy()
    store.stage("g", 2 * np.eye(3, dtype=np.float32))
    assert store.active("g") is held
    assert np.array_equal(held.dist, held_dist)
    second = store.publish("g")
    assert second.version == 2 and store.active("g") is second
    assert np.array_equal(held.dist, held_dist) and held.version == 1
    with pytest.raises(ValueError):
        store.active("g").dist[0, 0] = 9.0  # published tables are frozen
    with pytest.raises(KeyError):
        store.publish("g")  # nothing staged


def test_microbatcher_max_batch_flush():
    seen = []

    def flush(batch):
        seen.append(len(batch))
        return [q.src + q.dst for q in batch]

    mb = MicroBatcher(flush, max_batch=3, max_wait_s=999.0)
    t1 = mb.submit("g", 1, 2)
    t2 = mb.submit("g", 3, 4)
    assert not t1.done and mb.pending == 2
    t3 = mb.submit("g", 5, 6)  # hits max_batch → immediate flush
    assert seen == [3] and t1.done and t2.done and t3.done
    assert (t1.result(), t2.result(), t3.result()) == (3, 7, 11)


def test_microbatcher_max_wait_fake_clock():
    now = [0.0]
    flushes = []

    def flush(batch):
        flushes.append(len(batch))
        return [0] * len(batch)

    mb = MicroBatcher(flush, max_batch=100, max_wait_s=0.5, clock=lambda: now[0])
    mb.submit("g", 0, 1)
    assert not mb.poll()  # too young
    now[0] = 0.4
    mb.submit("g", 0, 2)
    assert not mb.poll()  # age is measured from the OLDEST ticket
    now[0] = 0.51
    assert mb.poll() and flushes == [2] and mb.pending == 0
    assert not mb.poll()  # empty queue is a no-op


def test_microbatcher_result_forces_flush():
    mb = MicroBatcher(lambda b: [q.dst for q in b], max_batch=10,
                      max_wait_s=999.0)
    t = mb.submit("g", 0, 7)
    assert t.result() == 7  # no blocking behind an idle queue
    assert mb.flushes == 1


def test_refresh_restricted_to_requested_dirty_set():
    router = Router(method="naive")
    for i in range(3):
        router.add_graph(f"g{i}", random_digraph(24, density=0.5, seed=i))
    assert router.dirty_count == 3
    assert router.refresh(["g1"]) == 1
    assert router.dirty_count == 2
    assert router.engine.stats.graphs_solved == 1
    assert router.snapshots.active("g0") is None  # untouched, still dirty

    router.query("g0", 0, 5)
    assert router.dirty_count == 1
    assert router.engine.stats.graphs_solved == 2
    assert router.registry.dirty_kind("g2") is not None


def test_clean_graphs_never_resolve_traces_flat():
    router = Router(method="naive")
    router.add_graph("hot", random_digraph(24, density=0.5, seed=0))
    router.add_graph("cold", random_digraph(24, density=0.5, seed=1))
    router.refresh()
    solves = router.engine.stats.solves
    traces = {k: e.traces for k, e in router.engine._cache.items()}

    router.fail_link("hot", 0, 1)  # only "hot" goes dirty
    for _ in range(3):
        router.query("cold", 2, 9)
    assert router.engine.stats.solves == solves  # cold never re-solved
    assert router.registry.dirty_kind("hot") == STRUCTURAL  # still pending
    router.query("hot", 0, 1)
    assert router.engine.stats.solves == solves + 1
    assert all(router.engine._cache[k].traces == t for k, t in traces.items())


def _tie_free(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 10**6, (n, n)).astype(np.float32)
    w[rng.uniform(size=(n, n)) > 0.4] = np.inf
    np.fill_diagonal(w, 0.0)
    return w


def test_update_edge_routes_through_repair():
    n = 48
    w = _tie_free(n, 0)
    router = Router(method="fused")
    router.add_graph("g", w)
    router.refresh()
    solves = router.engine.stats.solves

    assert router.update_edge("g", 3, 7, 5.0)
    assert router.registry.dirty_kind("g") == DELTA
    reply = router.query("g", 3, 7)
    assert router.engine.stats.solves == solves  # repaired, not re-solved
    assert router.repair_refreshes == 1 and router.engine.stats.repairs == 1
    assert reply.cost == 5.0 and reply.path == [3, 7]

    w1 = np.array(w)
    w1[3, 7] = 5.0
    full = router.engine.solve(w1, successors=True)
    snap = router.snapshots.active("g")
    assert np.array_equal(snap.dist, full.dist.numpy())
    assert np.array_equal(snap.succ, full.succ.numpy())

    assert not router.update_edge("g", 3, 7, 100.0)  # ⊕-merge is a no-op
    assert router.registry.dirty_kind("g") is None
    router.set_edge("g", 3, 7, 100.0)  # structural
    assert router.registry.dirty_kind("g") == STRUCTURAL
    router.query("g", 3, 7)
    assert router.engine.stats.solves == solves + 2  # check-solve + refresh


def test_worsening_takes_decremental_path_not_rank1_repair():
    n = 48
    w = _tie_free(n, 5)
    router = Router(method="fused")
    router.add_graph("g", w)
    router.refresh()
    repairs = router.repair_refreshes
    u, v = map(int, np.argwhere(np.isfinite(w) & ~np.eye(n, dtype=bool))[0])

    router.fail_link("g", u, v)
    assert router.registry.dirty_kind("g") == STRUCTURAL
    assert router.registry.structural_count("g") >= 1
    assert router.registry.pending_deletions("g")
    router.refresh()
    assert router.repair_refreshes == repairs      # rank-1 repair NOT taken
    assert router.repair_del_refreshes == 1        # decremental path taken
    assert router.registry.structural_count("g") == 0
    assert not router.registry.pending_deletions("g")

    ref = router.engine.solve(router.registry.peek("g"), successors=True)
    snap = router.snapshots.active("g")
    assert bits_equal(snap.dist_tensor(), ref.dist)
    assert bits_equal(snap.succ_tensor(), ref.succ)

    assert not router.engine.should_repair(n, 1, worsenings=1)
    assert router.engine.stats.repair_rejects >= 1


def test_routing_eviction_end_to_end():
    rng = np.random.default_rng(0)
    router = Router(method="naive", capacity_bytes=20_000)

    def g():
        m = np.abs(rng.standard_normal((24, 24))).astype(np.float32)
        np.fill_diagonal(m, 0)
        return m

    for i in range(4):
        router.add_graph(f"g{i}", g())
    router.refresh()   # all shielded this cycle
    router.add_graph("g4", g())
    router.refresh()   # now LRU tables evict
    assert router.registry.evictions > 0
    assert router.snapshots.active("g0") is None
    assert router.query("g0", 0, 5).cost >= 0  # re-solves on demand


def test_routing_scheduler_integration():
    router = Router(method="naive", max_batch=4)
    router.add_graph("g", random_digraph(16, density=0.6, seed=0))
    tickets = [router.submit("g", 0, d) for d in range(1, 5)]  # 4 → flush
    assert all(t.done for t in tickets)
    assert router.batcher.flushes == 1 and router.batcher.max_seen_batch == 4
    assert all(t.result().graph_id == "g" for t in tickets)


def test_serve_engine_shim_reexports():
    """The shim keeps the routing names and the LM ``Engine`` of
    ``serve/lm.py``; the reference's mesh specs wait for A.13c."""
    from repro_torch.serve import engine as shim
    from repro_torch.serve import lm, routing

    assert shim.RoutingEngine is routing.RoutingEngine
    assert shim.RouteReply is routing.RouteReply
    assert shim.Engine is lm.Engine
    assert set(shim.__all__) == {"RoutingEngine", "RouteReply", "Engine"}
    assert not hasattr(shim, "make_serve_fns")


# ------------------------------------- tests/test_apsp_engine.py:164-235
def test_routing_engine_serves_from_cached_tables():
    w = grid_graph(4)
    w_failed = w.copy()
    w_failed[5, 6] = np.inf
    w_failed[6, 5] = np.inf

    router = Router()
    router.add_graph("healthy", w)
    router.add_graph("failed", w_failed)
    router.add_graph("big", random_digraph(70, density=0.5, seed=3))
    assert router.dirty_count == 3
    assert router.refresh() == 3
    assert router.dirty_count == 0

    r = router.query("healthy", 0, 15)
    assert r.reachable and r.path[0] == 0 and r.path[-1] == 15
    assert abs(path_cost(w, r.path) - r.cost) < 1e-5

    r2 = router.query("failed", 5, 6)
    assert r2.reachable and len(r2.path) > 2  # rerouted around the cut link
    assert abs(path_cost(w_failed, r2.path) - r2.cost) < 1e-5
    assert router.refresh() == 0


def test_routing_engine_mutation_marks_dirty_and_requeries():
    router = Router()
    w = grid_graph(4)
    router.add_graph("g", w)
    before = router.query("g", 0, 15)
    router.fail_link("g", before.path[0], before.path[1])
    assert router.dirty_count == 1
    after = router.query("g", 0, 15)  # auto_refresh resolves
    assert router.dirty_count == 0
    assert after.cost >= before.cost
    assert after.path[1] != before.path[1]

    strict = Router(auto_refresh=False)
    strict.add_graph("g", w)
    with pytest.raises(RuntimeError):
        strict.query("g", 0, 1)


def test_routing_engine_batches_refresh_through_one_engine():
    router = Router()
    for i in range(4):
        router.add_graph(f"g{i}", random_digraph(40, density=0.6, seed=i))
    router.refresh()
    assert router.engine.stats.solves == 1
    assert router.engine.stats.graphs_solved == 4
    replies = router.query_many([("g0", 0, 5), ("g3", 2, 7)])
    assert len(replies) == 2 and all(r.cost >= 0 for r in replies)


# ------------------------------------------ tests/test_paths_query.py:102
def test_routing_engine_query_on_lowered_tables():
    w = np.array(
        [[0, 3, I16_INF, I16_INF],
         [I16_INF, 0, 4, I16_INF],
         [I16_INF, I16_INF, 0, 5],
         [I16_INF, I16_INF, I16_INF, 0]], dtype=np.int16)
    eng = ApspEngine(method="fused", dtype=torch.int16, validate=False, device="cpu")
    router = RoutingEngine(engine=eng)
    router.add_graph("g", w)
    router.refresh()
    snap = router.snapshots.active("g")
    assert snap.succ is None and snap.dtype == torch.int16  # distance-only
    r = router.query("g", 0, 3)
    assert r.path == [0, 1, 2, 3] and r.cost == 12.0
    assert not router.query("g", 3, 0).reachable


# -------------------------------------------------- host tables
def test_host_tables_keep_their_storage_width_and_stay_frozen():
    """bf16 tables are uint16 bits with the dtype beside them; every
    storage counts its own word; a caller's tensor or array never reaches
    the frozen copy."""
    for dt, word in ((torch.float32, 4), (torch.bfloat16, 2), (torch.float16, 2),
                     (torch.int16, 2), (torch.int32, 4)):
        t = torch.arange(16).reshape(4, 4).to(dt)
        a, got = host_array(t)
        assert got == dt and a.nbytes == 16 * word and not a.flags.writeable
        t.zero_()
        back = host_tensor(a, dt)
        assert back.dtype == dt and bits_equal(back, torch.arange(16).reshape(4, 4).to(dt))
        back.zero_()  # a copy: the frozen table is untouched
        assert bits_equal(host_tensor(a, dt), torch.arange(16).reshape(4, 4).to(dt))
    ref_bf16 = np.asarray(jnp.arange(16, dtype=jnp.bfloat16).reshape(4, 4))
    a, dt = host_array(ref_bf16)
    assert dt == torch.bfloat16 and a.dtype == np.uint16
    assert bits_equal(host_tensor(a, dt), ref_tensor(ref_bf16))
    reg = GraphRegistry()
    reg.put("g", ref_bf16)
    assert reg.total_bytes == 32 and reg.storage_dtype("g") == torch.bfloat16


# ------------------------------------------------- launcher helpers
@pytest.mark.parametrize("name", NAMES)
def test_launcher_scenarios_match_reference(name):
    w, upd, base = fw_serve.repair_scenario(name, 48, seed=3)
    jw, jupd, jbase = jserve.repair_scenario(name, 48, seed=3)
    assert bits_equal(w, jw) and upd == jupd and base == jbase
    d = np.asarray(japsp.solve(jw, method=jbase, semiring=name, validate=False).dist)
    dels, w1 = fw_serve.pick_deletions(w, d, name)
    jdels, jw1 = jserve.pick_deletions(jw, d, name)
    assert dels == jdels and bits_equal(w1, jw1)
    assert bits_equal(fw_serve._apply_updates(w, upd, name),
                      jserve._apply_updates(jw, jupd, name))


def test_fw_serve_smoke_passes_on_the_cpu(capsys):
    assert fw_serve.smoke(device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("smoke:") == 10 and "BENCH" not in out


def test_load_generator_takes_the_reference_arms():
    """Same seed, same mix: the port's load takes the reference's refresh
    arms, flushes and engine calls."""
    kw = dict(graphs=3, n=40, queries=300, update_every=25, max_batch=8, seed=1)
    got = fw_serve.run_load(device="cpu", **kw)
    want = jserve.run_load(**kw)
    # The batcher's max-wait flushes follow the wall clock, and with them
    # how many updates a repair absorbs: those counts are bounded, not equal.
    counts = ("queries", "updates", "solve_refreshes", "engine_solves")
    assert {k: got[k] for k in counts} == {k: want[k] for k in counts}
    for m in (got, want):
        assert 0 < m["repair_refreshes"] == m["engine_repairs"] <= m["updates"]
    assert set(got) == set(want) and got["p50_us"] > 0 and got["qps"] > 0


# --------------------------------------------------- without a card
@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_no_card_refusals():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RoutingEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fw_serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fw_serve.main(["--graphs", "1", "--n", "16", "--queries", "4"])


def test_serving_modules_import_no_jax_ml_dtypes_or_reference():
    mods = ["repro_torch.serve", "repro_torch.serve.scheduler", "repro_torch.serve.snapshot",
            "repro_torch.serve.registry", "repro_torch.serve.routing",
            "repro_torch.serve.engine", "repro_torch.launch.fw_serve"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'ml_dtypes', 'repro')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         check=True)
    assert out.stdout.strip() == "[]"
    for path in list((ROOT / "src/repro_torch/serve").glob("*.py")) + [
            ROOT / "src/repro_torch/launch/fw_serve.py"]:
        text = path.read_text()
        assert "import jax" not in text and "ml_dtypes" not in text.replace(
            "``ml_dtypes``", "")
        assert "from repro." not in text and "import repro." not in text


# ------------------------------------------------------------- replays
N = 40  # not a multiple of any block size: every solve pads


def _min_plus_graph(rng, hi):
    w = rng.integers(1, hi + 1, (N, N)).astype(np.float32)
    w[rng.uniform(size=(N, N)) > 0.35] = np.inf
    np.fill_diagonal(w, 0.0)
    return w


def _config(kind):
    """(engine kwargs, graph maker, update maker, worsening maker) of a
    replay storage; the makers take (rng, current weights as values)."""
    if kind == "f32":
        def upd(rng, w):
            return float(rng.integers(1, 10**6))

        def worse(rng, w, u, v):
            return float(w[u, v]) + float(rng.integers(1, 1000))

        return {}, lambda rng: _tie_free(N, int(rng.integers(1 << 30))), upd, worse
    if kind == "int16":
        def upd(rng, w):
            return float(rng.integers(1, 17))

        def worse(rng, w, u, v):
            return float(w[u, v]) + float(rng.integers(1, 8))

        return dict(dtype="int16"), lambda rng: _min_plus_graph(rng, 16), upd, worse
    if kind == "bf16":  # widest paths: the reference serves bf16 min-plus
        # next hops but refuses their repairs (ROADMAP C.3), so the bf16 log
        # runs max_min, distance-only, through every refresh arm.
        def graph(rng):
            w = rng.integers(1, 100, (N, N)).astype(np.float32)
            w[rng.uniform(size=(N, N)) > 0.4] = -np.inf
            np.fill_diagonal(w, np.inf)
            return np.asarray(jnp.asarray(w, jnp.bfloat16))

        def upd(rng, w):
            return float(rng.integers(1, 200))

        def worse(rng, w, u, v):
            return float(w[u, v]) - float(rng.integers(1, 50))

        return dict(semiring="max_min", dtype="bfloat16"), graph, upd, worse
    if kind == "packed":  # one (n, n) word plane of 32 graphs
        def graph(rng):
            words = rng.integers(-(1 << 31), 1 << 31, (N, N), dtype=np.int64)
            words &= rng.integers(-(1 << 31), 1 << 31, (N, N), dtype=np.int64)
            words &= rng.integers(-(1 << 31), 1 << 31, (N, N), dtype=np.int64)
            np.fill_diagonal(words, -1)
            return words.astype(np.int32)

        def upd(rng, w):
            return int(rng.integers(1, 1 << 31))

        def worse(rng, w, u, v):
            return int(w[u, v]) & int(rng.integers(-(1 << 31), 1 << 31))

        return dict(semiring="or_and", packed=True), graph, upd, worse
    raise ValueError(kind)


def _operation_log(kind, seed=0, ops=70):
    """A seeded log of router calls valid for the storage ``kind``; the
    values a call needs are read from the reference's registry when the
    log is replayed (``("worsen", g, u, v)`` assigns a worse weight to an
    existing edge)."""
    _, graph, upd, _ = _config(kind)
    rng = np.random.default_rng(seed)
    log = [("add", f"g{i}", graph(rng)) for i in range(4)] + [("refresh",)]
    live = ["g0", "g1", "g2", "g3"]
    for _ in range(ops):
        r = rng.uniform()
        g = live[int(rng.integers(len(live)))]
        u, v = (int(x) for x in rng.integers(N, size=2))
        if r < 0.30:
            log.append(("query", g, u, v))
        elif r < 0.45:
            log.append(("submit", g, u, v))
        elif r < 0.62:
            log.append(("update_edge", g, u, v, upd(rng, None), bool(rng.uniform() < 0.3)))
        elif r < 0.74:
            log.append(("worsen", g))
        elif r < 0.80:
            log.append(("fail_link", g, u, v))
        elif r < 0.86:
            log.append(("refresh",))
        elif r < 0.90 and len(live) > 2:
            live.remove(g)
            log.append(("remove", g))
        elif r < 0.94:
            fresh = next(f"g{i}" for i in range(8) if f"g{i}" not in live)
            live.append(fresh)
            log.append(("add", fresh, graph(rng)))
        else:
            log.append(("flush",))
    return log + [("flush",), ("refresh",)]


def _lift(a):
    """A reference host array's values (bf16 and f16 widened, exactly)."""
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype.itemsize == 2 and a.dtype.kind not in "iu" else a


def _ref_tables(router, g):
    snap = router.snapshots.active(g)
    return _lift(router.registry.peek(g)), None if snap is None else _lift(snap.dist)


def _replay(router, log, kind, *, ref: bool):
    """``fw_serve.replay`` with the storage's worsening; the published
    tables as CPU tensors (bf16 lifted from ``ml_dtypes`` on the reference
    side)."""
    *_, worse = _config(kind)
    kw = dict(tables=_ref_tables) if ref else {}
    obs, snaps, replies = fw_serve.replay(router, log, seed=11, worsen=worse, **kw)
    if ref:
        tables = [(i, g, s.version, ref_tensor(s.dist),
                   None if s.succ is None else ref_tensor(s.succ)) for i, g, s in snaps]
    else:
        tables = [(i, g, s.version, s.dist_tensor(), s.succ_tensor()) for i, g, s in snaps]
    return obs, tables, replies


def _engine_kwargs(kind, lib):
    kw, *_ = _config(kind)
    kw = dict(kw)
    if "dtype" in kw:
        kw["dtype"] = getattr(jnp if lib == "ref" else torch, kw["dtype"])
    return kw


WEIGHT_BYTES = {"f32": 4, "int16": 4, "bf16": 2, "packed": 4}
TABLE_BYTES = {"f32": 8, "int16": 2, "bf16": 2, "packed": 4}  # dist (+ succ)
# (storage, method, repair_threshold): at n = 40 a deletion touches most
# rows, so the default threshold sends repair_del to its counted re-solve
# and 100 makes it sweep.
REPLAYS = [("f32", "naive", 0.5), ("f32", "fused", 100.0), ("int16", "naive", 0.5),
           ("int16", "fused", 100.0), ("bf16", "fused", 100.0), ("packed", "fused", 100.0)]


@pytest.mark.parametrize("kind,method,threshold", REPLAYS,
                         ids=[f"{k}-{m}-{t:g}" for k, m, t in REPLAYS])
def test_router_replay_matches_reference(kind, method, threshold):
    log = _operation_log(kind, seed=7)
    # Room for the weights of four graphs and two or three tables: eviction.
    cap = N * N * (4 * WEIGHT_BYTES[kind] + 5 * TABLE_BYTES[kind] // 2)
    jeng = japsp.ApspEngine(method=method, validate=False, **_engine_kwargs(kind, "ref"))
    teng = ApspEngine(method=method, validate=False, device="cpu",
                      **_engine_kwargs(kind, "port"))
    kw = dict(capacity_bytes=cap, max_batch=4, max_wait_s=0.0025,
              repair_threshold=threshold)
    jobs, jtab, jrep = _replay(JRouter(engine=jeng, clock=fw_serve.ticks(), **kw), log, kind,
                               ref=True)
    tobs, ttab, trep = _replay(RoutingEngine(engine=teng, clock=fw_serve.ticks(), **kw), log,
                               kind, ref=False)
    for j, t in zip(jobs, tobs):
        assert t == j, (t["op"], j, t)
    assert len(tobs) == len(jobs) and trep == jrep
    assert [x[:3] for x in ttab] == [x[:3] for x in jtab]
    for (*_, jd, js), (*_, td, ts) in zip(jtab, ttab):
        assert bits_equal(td, jd)
        assert (ts is None) == (js is None) and (js is None or bits_equal(ts, js))
    last = tobs[-1]
    arms = [o["arms"] for o in tobs]
    # The log reaches every arm, the sweep or its re-solve, and eviction.
    assert last["arms"][0] > 4 and last["arms"][1] > 0 and last["arms"][2] > 0, arms[-1]
    assert last["stats"]["repair_dels" if threshold > 1 else "repair_del_fallbacks"] > 0
    assert last["bytes"][1] > 0


def test_serve_log_replays_like_the_reference():
    """``fw_serve.serve_log`` — the log the card-against-host check replays —
    gives the reference's observations and tables through a CPU router."""
    log = fw_serve.serve_log(graphs=3, n=48, ops=150, seed=2)
    kw = dict(max_batch=8, repair_threshold=100.0)
    jobs, jsnaps, jrep = fw_serve.replay(
        JRouter(method="fused", clock=fw_serve.ticks(), **kw), log, seed=4,
        tables=_ref_tables)
    tobs, tsnaps, trep = fw_serve.replay(
        Router(method="fused", clock=fw_serve.ticks(), **kw), log, seed=4)
    assert tobs == jobs and trep == jrep and len(tsnaps) == len(jsnaps)
    for (i, g, t), (j, h, r) in zip(tsnaps, jsnaps):
        assert (i, g, t.version) == (j, h, r.version)
        assert bits_equal(t.dist_tensor(), ref_tensor(r.dist))
        assert bits_equal(t.succ_tensor(), ref_tensor(r.succ))
    assert all(x > 0 for x in tobs[-1]["arms"]) and tobs[-1]["stats"]["repair_dels"] > 0


# ------------------------------------------------- mutation classification
def _tiny(dtype, fill, corner):
    """A 4 x 4 weight matrix of ``fill`` with w[0, 1] = corner."""
    w = np.full((4, 4), fill, dtype=dtype)
    w[0, 1] = corner
    return w


BF16 = np.asarray(jnp.zeros(1, jnp.bfloat16)).dtype
F32, NAN, INF = np.float32, float("nan"), float("inf")
# (engine kwargs, weights, call, value): the reference's ⊕-merge and
# np.array_equal test, per storage, where a wrong answer changes the arm.
MUTATIONS = [
    ({}, _tiny(F32, INF, 0.0), "update_edge", -0.0),   # min(+0, -0) = -0 == +0: no-op
    ({}, _tiny(F32, INF, -0.0), "update_edge", 0.0),
    ({}, _tiny(F32, INF, 5.0), "update_edge", NAN),     # NaN merges in
    ({}, _tiny(F32, INF, NAN), "update_edge", 1.0),     # NaN != NaN: changed
    ({}, _tiny(F32, INF, 5.0), "set_edge", INF),        # a deletion
    ({}, _tiny(F32, INF, 5.0), "set_edge", 2.0),        # an improvement: structural
    ({}, _tiny(F32, INF, NAN), "set_edge", NAN),        # NaN != NaN: structural
    ({}, _tiny(np.float64, np.inf, 0.1), "update_edge", 0.1),  # merged in f32
    ({}, _tiny(np.float64, np.inf, 0.1), "set_edge", 0.2),
    (dict(dtype="int16"), _tiny(np.int16, I16_INF, I16_INF), "update_edge", 7),
    (dict(dtype="int16"), _tiny(np.int16, I16_INF, 9), "set_edge", I16_INF),
    (dict(dtype="int16"), _tiny(np.int16, I16_INF, 9), "fail_link", None),  # inf: no int16
    (dict(dtype="int16"), _tiny(F32, INF, 9.0), "fail_link", None),
    (dict(dtype="bfloat16"), _tiny(F32, INF, 3.0).astype(BF16), "update_edge", 2.999),
    (dict(dtype="bfloat16"), _tiny(F32, INF, 3.0).astype(BF16), "set_edge", 4.0),
    (dict(semiring="or_and", packed=True), _tiny(np.int32, 0, 0b001), "update_edge", 0b101),
    (dict(semiring="or_and", packed=True), _tiny(np.int32, 0, 0b101), "set_edge", 0b001),
    (dict(semiring="or_and", packed=True), _tiny(np.int32, 0, 0b101), "set_edge", 0b010),
    (dict(semiring="or_and", packed=True), np.stack([_tiny(np.int32, 0, 0b101)] * 2),
     "set_edge", 0b001),                                # two planes: structural
    (dict(semiring="or_and"), _tiny(np.uint32, 0, 1 << 31), "update_edge", 5),
    (dict(semiring="or_and"), _tiny(np.uint32, 0, 0), "update_edge", 1),
    (dict(semiring="plus_mul"), _tiny(np.bool_, False, True), "update_edge", True),
    (dict(semiring="plus_mul"), _tiny(np.int8, 0, 100), "update_edge", 100),  # wraps
]


@pytest.mark.parametrize("kw,w,call,x", MUTATIONS, ids=[
    f"{i}-{m[2]}-{m[1].dtype}" for i, m in enumerate(MUTATIONS)])
def test_mutation_classification_matches_reference(kw, w, call, x):
    routers = (JRouter(engine=japsp.ApspEngine(validate=False, **_engine_kwargs_of(kw, jnp))),
               RoutingEngine(engine=ApspEngine(validate=False, device="cpu",
                                               **_engine_kwargs_of(kw, torch))))
    seen = []
    for r in routers:
        r.add_graph("g", w)
        r.registry.clear_dirty("g")
        args = ("g", 0, 1) if x is None else ("g", 0, 1, x)
        try:
            out = getattr(r, call)(*args, symmetric=False)
        except Exception as e:  # noqa: BLE001 — both must refuse alike
            out = type(e).__name__
        reg = r.registry
        seen.append((out, reg.dirty_kind("g"), [e.as_tuple() for e in reg.pending_deltas("g")],
                     [(u, v, float(y)) for u, v, y in reg.pending_deletions("g")],
                     reg.structural_count("g"), reg.total_bytes))
    assert seen[1] == seen[0]
    assert bits_equal(routers[1].registry.weights_tensor("g"),
                      ref_tensor(routers[0].registry.peek("g")))


def _engine_kwargs_of(kw, lib):
    return {k: getattr(lib, v) if k == "dtype" else v for k, v in kw.items()}
