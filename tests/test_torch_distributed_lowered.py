"""The distributed solve and the mesh engine of the port on the storage
lowerings vs the JAX reference, on the CPU.

One 2×2 gloo grid of CPU ranks (``launch.mesh.run_grid``; the ranks import
no JAX) is spawned once, in a module fixture, and runs every case:

* ``fw_distributed`` in every storage the kernels take — int16 with the
  four ``*_i16`` lowerings, bf16 and f16 with the float semirings, packed
  or_and words — and ``solve(method="distributed")`` on the input dtypes
  the reference keeps (bf16, f16, int16, ``packed=True``, the integer
  or_and / plus_mul storages on the int32 carrier), each rank's gathered
  result == the reference's single-device ``solve(method="fused")`` by
  bits and dtype, the bytes each rank counted == the model in the
  storage's word;
* the "jnp" and "pallas" backends in the lowerings == the reference's own
  per-phase lowering;
* the mesh engine's ``solve_many`` / ``repair`` / ``repair_del`` in int16,
  bf16 and packed words == the reference's single-device engine;
* ``GridMesh.broadcast`` of int16, uint32, bf16 and bool tensors over the
  world, a grid row and a grid column, by bits;
* ``launch.fw_dist_check``'s checks with ``--dtype`` / ``--packed``
  configurations, and its command line.

f16 plus_mul is held here too: its step is one f16 FMA on both sides, and
the "jnp" backend's phase 3 (``core.distributed._sum16``: f16 products,
summed in f32, rounded once) is the reference's.
"""
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.apsp import ApspEngine as JEngine
from repro.apsp import pack_reachability
from repro.apsp import solve as jsolve
from repro.core import distributed as jdist
from repro.core import semiring as jsr
from repro.launch.fw_serve import pick_deletions
from repro_torch.apsp import plan as tplan
from repro_torch.launch import fw_dist_check as chk
from repro_torch.launch.mesh import GridMesh, run_grid
from test_torch_semiring import (
    INT_STORAGES,
    assert_same,
    semiring_graph,
    storage_data,
    storage_id,
)

R, C = 2, 2
N, S = 64, 16  # 4 rounds; per-rank blocks of 2 × 2 tiles
KERNEL_STORAGES = ([("int16", n) for n in ("max_min", "max_plus", "min_plus", "or_and")]
                   + [("bfloat16", n) for n in ("max_min", "max_plus", "min_plus", "or_and",
                                                 "plus_mul")]
                   + [("float16", n) for n in ("max_min", "max_plus", "min_plus", "or_and",
                                                "plus_mul")]
                   + [("packed", "or_and")])
BACKEND_STORAGES = [("int16", "min_plus"), ("bfloat16", "plus_mul"), ("bfloat16", "max_min"),
                    ("float16", "min_plus"), ("float16", "plus_mul"), ("packed", "or_and")]
ENGINE_STORAGES = [("int16", "min_plus"), ("bfloat16", "min_plus"), ("packed", "or_and")]


def lowered_name(storage: str, name: str) -> str:
    """The semiring's name in the storage: its lowering's for int16 and
    packed words."""
    return {"int16": f"{name}_i16", "packed": "or_and_packed"}.get(storage, name)


def wire(x: np.ndarray) -> tuple[np.ndarray, str | None]:
    """(array, dtype) as a rank takes it: a bf16 array travels as f32
    (exact; numpy has no bf16) with dtype "bfloat16"."""
    if x.dtype.name == "bfloat16":
        return x.astype(np.float32), "bfloat16"
    return x, None


def widened(x) -> np.ndarray:
    """A reference result as a rank returns it: bf16 widened to f32."""
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _graph(name: str, n: int, seed: int) -> np.ndarray:
    """Integer weights whose closures are exact in every storage."""
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 9, (n, n)).astype(np.float32)
    w[rng.uniform(size=(n, n)) > 0.35] = jsr.SEMIRINGS[name].zero
    np.fill_diagonal(w, jsr.SEMIRINGS[name].one)
    return w


def _planes(n: int, seed: int, count: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bs = rng.uniform(size=(count, n, n)) < 0.06
    bs[:, np.arange(n), np.arange(n)] = True
    return bs


def _engine_kw(storage: str, lib) -> dict:
    if storage == "packed":
        return dict(semiring="or_and", packed=True)
    return dict(dtype=storage if lib is None else getattr(jnp, storage))


def _cases() -> dict:
    cases = {"imports": dict(kind="imports")}
    for storage, name in KERNEL_STORAGES:
        w = storage_data(storage, name, (N, N), seed=3)
        x, dt = wire(w)
        cases[f"direct-{storage}-{name}"] = dict(kind="direct", semiring=lowered_name(
            storage, name), bs=S, w=x, dtype=dt, ref=w)
    for storage, name in BACKEND_STORAGES:
        w = storage_data(storage, name, (N, N), seed=4)
        x, dt = wire(w)
        for backend in ("jnp", "pallas"):
            cases[f"{backend}-{storage}-{name}"] = dict(
                kind="direct", semiring=lowered_name(storage, name), bs=S, w=x, dtype=dt,
                backend=backend, ref=w)
    f32 = semiring_graph("min_plus", (40, 40), seed=5)
    for storage, name in (("bfloat16", "min_plus"), ("float16", "max_min"),
                          ("int16", "min_plus"), ("int16", "max_plus")):
        w = semiring_graph(name, (40, 40), seed=5)
        cases[f"solve-{storage}-{name}"] = dict(kind="solve", semiring=name, bs=S, w=w,
                                                dtype=storage)
    cases["solve-packed"] = dict(kind="solve", semiring="or_and", packed=True, bs=S,
                                 w=_planes(40, 6, count=37))
    cases["solve-batched-bfloat16"] = dict(
        kind="solve", semiring="min_plus", bs=S, dtype="bfloat16",
        w=np.stack([f32, semiring_graph("min_plus", (40, 40), seed=7)]))
    for storage, name in INT_STORAGES:
        cases[f"solve-{storage}-{name}"] = dict(kind="solve", semiring=name, bs=S,
                                                w=storage_data(storage, name, (40, 40), 8))
    for storage, name in ENGINE_STORAGES:
        kw = _engine_kw(storage, None)
        if storage == "packed":
            graphs = [pack_reachability(_planes(n, n).astype(np.float32))[0]
                      for n in (40, 24, 40)]
            graphs = [np.asarray(g) for g in graphs]
            bs = _planes(48, 9)
            bs[0, 3, 7] = True
            bs[:, 40, 9] = True
            b1 = bs.copy()
            b1[0, 3, 7] = False
            b1[:, 40, 9] = False
            g, g1 = (np.asarray(pack_reachability(b.astype(np.float32))) for b in (bs, b1))
            upd, dels = [(3, 7, 1 << 0), (40, 9, 0b11), (5, 6, -1)], [(3, 7, 1), (40, 9, 3)]
        else:
            graphs = [_graph(name, n, n) for n in (40, 24, 40)]
            g = _graph(name, 48, 5)
            upd = [(3, 7, 1.0), (24, 2, 2.0), (1, 46, 1.0)]
            je = JEngine(method="fused", block_size=S, validate=False,
                         **_engine_kw(storage, jnp))
            d0 = np.asarray(je.solve(g).dist).astype(np.float32)
            dels, g1 = pick_deletions(g, d0, name)
        je = JEngine(method="fused", block_size=S, validate=False, **_engine_kw(storage, jnp))
        d0 = je.solve(g).dist
        common = dict(semiring=lowered_name(storage, name) if storage == "packed" else name,
                      **({} if storage == "packed" else dict(dtype=storage)))
        cases[f"engine-{storage}"] = dict(kind="engine", bs=S, graphs=graphs, **common,
                                          ref=(je, graphs))
        cases[f"repair-{storage}"] = dict(kind="repair", dist=widened(d0), updates=upd,
                                          **common, ref=(je, d0))
        cases[f"repair_del-{storage}"] = dict(kind="repair_del", dist=widened(d0), w1=g1,
                                              deletions=dels, threshold=100.0, **common,
                                              ref=(je, d0))
    rng = np.random.default_rng(10)
    cases["broadcast"] = dict(kind="broadcast", data={
        "int16": [rng.integers(-(1 << 15), 1 << 15, (3, 5)).astype(np.int16)
                  for _ in range(R * C)],
        "uint32": [rng.integers(0, 1 << 32, (7,), dtype=np.uint64).astype(np.uint32)
                   for _ in range(R * C)],
        "bfloat16": [rng.integers(-(1 << 15), 1 << 15, (2, 4, 3)).astype(np.int16)
                     for _ in range(R * C)],
        "bool": [rng.uniform(size=(9,)) < 0.5 for _ in range(R * C)],
    })
    cases["grid_check"] = dict(kind="grid_check", cfgs=[
        dict(n=N, bs=S, semiring="min_plus", dtype="int16"),
        dict(n=N, bs=S, semiring="max_plus_i16"),
        dict(n=N, bs=S, semiring="plus_mul", dtype="bfloat16", method="solve"),
        dict(n=N, bs=S, semiring="or_and", packed=True, method="solve", batch=2),
        dict(n=N, bs=S, semiring="min_plus", dtype="float16", chunked=True,
             rounds_per_call=1, restart_at=2),
        dict(n=N, semiring="min_plus", dtype="int16", repair=True, edges=5),
        dict(n=N, semiring="min_plus", dtype="bfloat16", repair=True),
        dict(n=N, semiring="or_and", packed=True, repair=True, edges=3),
    ])
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def grid():
    """{case id: [each rank's result]} of one spawned 2×2 grid."""
    ids = list(CASES)
    sent = [{k: v for k, v in CASES[i].items() if k != "ref"} for i in ids]
    per_rank = run_grid(chk.run_cases, R, C, device="cpu", args=(sent,), timeout=600)
    return {i: [rank[k] for rank in per_rank] for k, i in enumerate(ids)}


_FUSED: dict = {}


def fused(w, name: str, bs: int = S, **kw):
    """The reference's single-device fused solve (cached)."""
    key = (name, bs, np.asarray(w).tobytes(), np.asarray(w).dtype.str, repr(sorted(kw.items())))
    if key not in _FUSED:
        _FUSED[key] = np.asarray(jsolve(w, method="fused", block_size=bs, semiring=name,
                                        validate=False, **kw).dist)
    return _FUSED[key]


def test_ranks_import_no_jax(grid):
    assert all(r == {"jax": False, "repro": False} for r in grid["imports"])


@pytest.mark.parametrize("case", KERNEL_STORAGES, ids=storage_id)
def test_fw_distributed_lowered_matches_fused(grid, case):
    storage, name = case
    c = CASES[f"direct-{storage}-{name}"]
    want = widened(fused(c["ref"], c["semiring"]))
    word = np.asarray(c["ref"]).dtype.itemsize
    model = (N // S) * tplan.dist_round_comm_bytes(N, R, C, S, word=word)
    for r in grid[f"direct-{storage}-{name}"]:
        assert_same(r["dist"], want)
        assert r["comm_bytes"] == model  # the storage's word, not f32's


def test_lowered_comm_model_halves_the_f32_bytes():
    f32 = tplan.dist_round_comm_bytes(8192, 2, 2, 128)
    assert f32 * 64 == 272_629_760
    for dt, word in (("bfloat16", 2), ("float16", 2), ("int16", 2), ("int32", 4)):
        assert tplan.word_for(dt) == word
        dp = tplan.distributed_plan(8192, 4, grid=(2, 2), block_size=128, word=word)
        assert dp["comm_bytes_per_round"] * dp["rounds"] == 272_629_760 * word // 4


def per_phase(w, name: str, backend: str, s: int = S):
    """The reference's per-phase lowering ("jnp" or "pallas") of the whole
    matrix, as on a 1×1 mesh (``test_torch_distributed.per_phase``)."""
    sr = jsr.SEMIRINGS.get(name) or jsr.LOWERED_SEMIRINGS[name]
    x = jnp.asarray(w)
    for b in range(w.shape[-1] // s):
        o = slice(b * s, (b + 1) * s)
        diag = jdist._phase1(x[o, o], sr)
        rp = jdist._phase2_row(diag, x[o, :], sr)
        cp = jdist._phase2_col(diag, x[:, o], sr)
        x = x.at[o, :].set(rp).at[:, o].set(cp)
        x = (jdist._phase3_pallas(x, cp, rp, sr, True) if backend == "pallas"
             else jdist._phase3_jnp(x, cp, rp, sr))
    return np.asarray(x)


@pytest.mark.parametrize("case", BACKEND_STORAGES, ids=storage_id)
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_per_phase_backends_lowered_match_reference(grid, backend, case):
    storage, name = case
    c = CASES[f"{backend}-{storage}-{name}"]
    want = widened(per_phase(c["ref"], c["semiring"], backend))
    for r in grid[f"{backend}-{storage}-{name}"]:
        assert_same(r["dist"], want)


SOLVES = (["bfloat16-min_plus", "float16-max_min", "int16-min_plus", "int16-max_plus",
           "packed", "batched-bfloat16"] + [storage_id(c) for c in INT_STORAGES])


@pytest.mark.parametrize("cid", SOLVES)
def test_solve_distributed_lowered_matches_fused(grid, cid):
    """``solve(method="distributed")`` keeps the input's storage (or pins
    ``dtype``) as the reference's fused solve does, padded n = 64."""
    c = CASES[f"solve-{cid}"]
    kw = {}
    if c.get("packed"):
        kw["packed"] = True
    elif c.get("dtype"):
        kw["dtype"] = getattr(jnp, c["dtype"])
    want = widened(fused(c["w"], c["semiring"], **kw))
    for r in grid[f"solve-{cid}"]:
        assert r["padded_n"] == 64 and r["block_size"] == S
        assert_same(r["dist"], want)


@pytest.mark.parametrize("storage", [s for s, _ in ENGINE_STORAGES])
def test_mesh_engine_solve_many_lowered_matches_reference(grid, storage):
    je, graphs = CASES[f"engine-{storage}"]["ref"]
    wants = [widened(je.solve(g).dist) for g in graphs]
    for r in grid[f"engine-{storage}"]:
        assert r["dtype"] == ("int32" if storage == "packed" else storage)
        assert r["traces"] == [1] * r["cache_size"]
        for d, want in zip(r["dists"], wants):
            assert_same(d, want)


@pytest.mark.parametrize("storage", [s for s, _ in ENGINE_STORAGES])
def test_mesh_repair_lowered_matches_single_device(grid, storage):
    c = CASES[f"repair-{storage}"]
    je, d0 = c["ref"]
    want = widened(je.repair(d0, c["updates"]).dist)
    for r in grid[f"repair-{storage}"]:
        assert_same(r["dist"], want)


@pytest.mark.parametrize("storage", [s for s, _ in ENGINE_STORAGES])
def test_mesh_repair_del_lowered_matches_single_device(grid, storage):
    """The local mark and sweep of the mesh engine, in the storage."""
    c = CASES[f"repair_del-{storage}"]
    je, d0 = c["ref"]
    want = widened(je.repair_del(d0, c["w1"], c["deletions"], threshold=100.0).dist)
    for r in grid[f"repair_del-{storage}"]:
        assert r["sweeps"] == 1 and r["fallbacks"] == 0
        assert_same(r["dist"], want)


@pytest.mark.parametrize("dtype", ["int16", "uint32", "bfloat16", "bool"])
def test_grid_broadcast_carries_every_dtype_by_bits(grid, dtype):
    """``GridMesh.broadcast`` moves bytes: int16 and uint32 (which gloo and
    NCCL have no type for), bf16 and bool arrive with the source's bits,
    over the world, a grid row and a grid column."""
    sent = CASES["broadcast"]["data"][dtype]
    for rank, r in enumerate(grid["broadcast"]):
        for label in ("world", "row", "col"):
            src, got = r["received"][(dtype, label)]
            assert got.dtype == sent[src].dtype and np.array_equal(got, sent[src])
        # world: 3 other ranks' worth is not counted, the bytes handed in are
        assert r["comm_bytes"] == 3 * sum(x[rank].nbytes for x in
                                          CASES["broadcast"]["data"].values())


@pytest.mark.parametrize("k", range(len(CASES["grid_check"]["cfgs"])))
def test_dist_check_lowered_configurations(grid, k):
    """``fw_dist_check.grid_check`` with the ``--dtype`` / ``--packed``
    configurations: every rank == the lowered single-device fused solve (or
    repair == single-device repair == re-solve), bytes == the model."""
    cfg = CASES["grid_check"]["cfgs"][k]
    for r in grid["grid_check"]:
        rec = r["recs"][k]
        assert rec["ok"] and rec.get("chunked_ok", True), rec
        assert rec["dtype"] == ("int32" if cfg.get("packed") else cfg.get("dtype", "int16"))
        if "model_bytes" in rec:
            assert rec["comm_bytes"] == rec["model_bytes"]


def test_grid_mesh_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``GridMesh`` defaults to the card, as every entry point does, and
    raises without one rather than running on the host."""
    assert inspect.signature(GridMesh).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GridMesh(1, 1)


def test_dist_check_cli_lowered(capsys):
    """The command line: ``--dtype int16 --bitwise --bench`` on its own
    grid prints counted bytes equal to the model in the int16 word; a
    lowered storage without --bitwise is refused before any rank starts."""
    assert chk.main(["--devices", "4", "--n", "64", "--bs", "16", "--bitwise", "--bench",
                     "--dtype", "int16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    metrics = __import__("json").loads(re.search(r"METRICS (\{.*\})", out).group(1))
    assert metrics["comm_counted_bytes"] == [metrics["comm_model_bytes"]] * 4
    assert metrics["comm_model_bytes"] == tplan.dist_round_comm_bytes(64, 2, 2, 16, word=2)
    assert "semiring=min_plus_i16 dtype=int16" in out
    with pytest.raises(SystemExit):
        chk.main(["--devices", "4", "--dtype", "bfloat16", "--device", "cpu"])
    with pytest.raises(SystemExit):
        chk.main(["--devices", "4", "--packed", "--semiring", "min_plus", "--bitwise",
                  "--device", "cpu"])
