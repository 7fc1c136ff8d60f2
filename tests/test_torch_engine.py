"""``repro_torch.apsp.ApspEngine`` (plain versions, ``device="cpu"``) vs the
JAX reference: bucketing, caching, successors, validation.

  * ``solve_many`` over ragged graph sizes == per-graph ``solve`` of the
    port == the reference's per-graph ``solve`` with the same method,
    bitwise, on all five semirings (property-tested via hypothesis when
    installed);
  * the plan cache: a repeated (n, B) key re-plans nothing and builds its
    runner once (``traces == 1``);
  * bucketing groups by padded shape and keeps input order;
  * negative cycles name the offending inputs.

Mirrors ``tests/test_apsp_engine.py`` without the serving layer
(``tests/test_torch_serve.py``); the storage lowerings (bf16 included) are
``tests/test_torch_engine_lowered.py``.
"""
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

import repro.apsp as japsp
from repro.apsp import engine as jengine
from repro_torch.apsp import ApspEngine, NegativeCycleError, negative_cycle_mask_padded, solve
from repro_torch.core.graph import random_digraph
from repro_torch.utils.bits import bits_equal
from test_torch_semiring import NAMES, assert_same


def _graph_for(name: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if name == "or_and":
        w = (rng.uniform(size=(n, n)) < 0.1).astype(np.float32)
        np.fill_diagonal(w, 1.0)
        return w
    if name == "plus_mul":
        return rng.uniform(0.0, 0.01, size=(n, n)).astype(np.float32)
    w = rng.uniform(1.0, 10.0, size=(n, n)).astype(np.float32)
    if name == "max_plus":  # longest paths: a DAG, or cycles grow to inf
        w[np.tril_indices(n, -1)] = -np.inf
    np.fill_diagonal(w, 0.0)
    return w


def _engine(**kw):
    return ApspEngine(device="cpu", **{"validate": False, **kw})


# --------------------------------------------------- ragged == per-graph
@pytest.mark.parametrize("name", NAMES)
def test_solve_many_ragged_matches_per_graph_and_reference(name):
    eng = _engine(semiring=name)
    sizes = (12, 40, 70, 40, 90)  # two graphs share a padded shape
    graphs = [_graph_for(name, n, seed=n + i) for i, n in enumerate(sizes)]
    results = eng.solve_many(graphs)
    assert [r.n for r in results] == list(sizes)
    for g, r in zip(graphs, results):
        single = solve(g, semiring=name, validate=False, device="cpu")
        assert r.method == single.method
        assert bits_equal(r.dist, single.dist)
        ref = japsp.solve(g, method=r.method, semiring=name, validate=False)
        assert_same(r.dist, ref.dist)


@settings(max_examples=5, deadline=None)
@given(st.lists(st.sampled_from([4, 9, 17, 33, 40, 66]), min_size=1, max_size=5))
def test_solve_many_property_ragged_sizes(sizes):
    """Property: any ragged size mix buckets to per-graph-identical output."""
    eng = _engine()
    graphs = [random_digraph(n, density=0.5, seed=n) for n in sizes]
    results = eng.solve_many(graphs)
    assert [r.n for r in results] == list(sizes)
    for g, r in zip(graphs, results):
        assert bits_equal(r.dist, solve(g, validate=False, device="cpu").dist)
        assert_same(r.dist, japsp.solve(g, method=r.method, validate=False).dist)


def test_solve_many_successors_match_reference():
    eng = _engine(method="fused", block_size=16)
    graphs = [random_digraph(n, density=0.5, seed=n) for n in (30, 50, 30)]
    results = eng.solve_many(graphs, successors=True)
    jeng = japsp.ApspEngine(method="fused", block_size=16, validate=False)
    jres = jeng.solve_many(graphs, successors=True)
    for g, r, j in zip(graphs, results, jres):
        assert r.succ.dtype == torch.int32
        assert_same(r.dist, j.dist)
        assert_same(r.succ, j.succ)
        ref = japsp.solve(g, method="blocked", block_size=16, successors=True,
                          validate=False)
        assert_same(r.succ, ref.succ)


def test_solve_many_takes_a_stacked_batch():
    wb = np.stack([random_digraph(40, density=0.5, seed=i) for i in range(3)])
    eng = _engine(method="fused", block_size=16)
    many = eng.solve_many(wb)
    batch = eng.solve(torch.from_numpy(wb))
    jbatch = japsp.ApspEngine(method="fused", block_size=16, validate=False).solve(wb)
    assert batch.batched and batch.dist.shape == (3, 40, 40)
    assert_same(batch.dist, jbatch.dist)
    for k, r in enumerate(many):
        assert bits_equal(r.dist, batch.dist[k])


# ----------------------------------------------------------- cache behavior
def test_cache_hit_builds_nothing_on_a_repeated_key():
    eng = _engine(method="fused", block_size=32)
    wb = np.stack([random_digraph(70, density=0.5, seed=i) for i in range(4)])
    eng.solve(wb)
    assert eng.stats.misses == 1 and eng.cache_size == 1
    entry = next(iter(eng._cache.values()))
    assert entry.traces == 1
    for _ in range(3):
        eng.solve(wb)
    assert eng.stats.misses == 1, "repeated key re-planned"
    assert entry.traces == 1, "repeated key rebuilt its runner"
    assert eng.stats.hits == 3
    eng.solve(wb[:2])  # another batch size is another plan
    assert eng.stats.misses == 2 and eng.cache_size == 2


def test_cache_key_separates_successors_and_device():
    eng = _engine(method="fused", block_size=32)
    w = random_digraph(40, density=0.5, seed=1)
    eng.solve(w)
    eng.solve(w, successors=True)
    assert eng.cache_size == 2
    assert {k.backend for k in eng._cache} == {"cpu"}
    assert {k.successors for k in eng._cache} == {False, True}


def test_plan_for_models_the_fused_round():
    eng = _engine(method="fused", block_size=32)
    entry = eng.plan_for(100, batch=16)
    assert entry.key.n_padded == 128 and entry.key.batch == 16
    assert entry.key.batch_block == 16  # the whole bucket rides one launch
    assert entry.smem_bytes and entry.hbm_bytes_per_round
    assert eng.plan_for(100, batch=16) is entry
    jentry = japsp.ApspEngine(method="fused", block_size=32).plan_for(100, batch=16)
    assert (entry.key.n_padded, entry.key.block_size, entry.key.bk) == (
        jentry.key.n_padded, jentry.key.block_size, jentry.key.bk)
    assert entry.hbm_bytes_per_round == jentry.hbm_bytes_per_round
    # a storage dtype is its own key, modelled in its word (once refused, A.4)
    i16 = eng.plan_for(100, dtype="int16")
    j16 = japsp.ApspEngine(method="fused", block_size=32).plan_for(100, dtype="int16")
    assert i16.key.dtype == j16.key.dtype == "int16"
    assert i16.hbm_bytes_per_round == j16.hbm_bytes_per_round


def test_bucketing_counts_and_order():
    eng = _engine(method="fused", block_size=32)
    sizes = (90, 40, 96, 40, 20)
    graphs = [random_digraph(n, density=0.6, seed=n + 7) for n in sizes]
    results = eng.solve_many(graphs)
    # 90 and 96 pad to 96 → one bucket; two n=40 → one; n=20 → one.
    assert eng.stats.solves == 3
    assert eng.stats.graphs_solved == 5
    assert [r.n for r in results] == list(sizes)
    assert results[0].padded_n == results[2].padded_n == 96


# ------------------------------------------------------------- validation
def test_engine_validates_negative_cycles():
    w = np.full((70, 70), np.inf, np.float32)
    np.fill_diagonal(w, 0.0)
    w[0, 1], w[1, 2], w[2, 0] = 1.0, -3.0, 1.0
    eng = ApspEngine(method="fused", block_size=32, device="cpu")
    with pytest.raises(NegativeCycleError):
        eng.solve(w)
    ok = random_digraph(70, density=0.5, seed=0)
    with pytest.raises(NegativeCycleError, match=r"graphs \[1\]"):
        eng.solve_many([ok, w])
    d = _engine(method="fused", block_size=32).solve(np.stack([ok, w])).dist
    assert negative_cycle_mask_padded(d, [70, 70]).tolist() == [False, True]
    for ns in ([70, 70], [3, 1], [1, 70]):
        assert np.array_equal(negative_cycle_mask_padded(d, ns),
                              jengine.negative_cycle_mask_padded(d.numpy(), ns))


def test_engine_rejects_bad_arguments():
    with pytest.raises(ValueError):
        ApspEngine(method="warp-drive", device="cpu")
    with pytest.raises(ValueError):
        ApspEngine(variant="broadcast", device="cpu")
    with pytest.raises(ValueError):
        _engine().solve_many([np.zeros((2, 4, 4), np.float32)])
    with pytest.raises(ValueError):  # next hops are min-plus only
        _engine(semiring="max_plus").solve(random_digraph(40, seed=0), successors=True)


def test_engine_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ApspEngine()  # the default device is the card
    assert ApspEngine(device="cpu").device.type == "cpu"
