"""``repro_torch.apsp.solve`` (plain versions, ``device="cpu"``) vs
``repro.apsp.solve`` on the same numpy inputs, bit for bit, on all five
f32 semirings: every ported method, single and batched, odd n, and
``successors=True``.  Also the refusals (bad arguments, what is not ported
yet, no card), the host-side path walks, and that the port imports neither
JAX nor ``repro``.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.apsp as japsp
from repro.core import paths as jpaths
from repro_torch.apsp import api as tapi
from repro_torch.apsp import NegativeCycleError, negative_cycle_mask, solve
from repro_torch.core import paths as tpaths
from repro_torch.core.graph import random_digraph
from test_torch_semiring import NAMES, assert_same, semiring_graph

ROOT = Path(__file__).resolve().parents[1]


def _both(w, **kw):
    return japsp.solve(w, **kw), solve(w, device="cpu", **kw)


# ------------------------------------------------------------ vs reference
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("method,n", [(m, n) for m in ("naive", "blocked", "fused")
                                      for n in (37, 60, 96, 200)
                                      if (m, n) != ("naive", 200)])
def test_solve_matches_reference(name, method, n):
    w = semiring_graph(name, (n, n), seed=n)
    j, t = _both(w, method=method, semiring=name)
    assert_same(t.dist, j.dist)
    assert (t.method, t.block_size, t.padded_n, t.n) == (j.method, j.block_size,
                                                         j.padded_n, j.n)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("method", ["naive", "blocked", "fused"])
def test_batched_solve_matches_reference(name, method):
    w = semiring_graph(name, (3, 60, 60), seed=3)
    j, t = _both(w, method=method, semiring=name, block_size=16)
    assert t.batched and t.dist.shape == (3, 60, 60)
    assert_same(t.dist, j.dist)


@pytest.mark.parametrize("n", [37, 96])
def test_numpy_method_matches_reference(n):
    w = random_digraph(n, density=0.4, seed=n)
    j, t = _both(w, method="numpy")
    assert_same(t.dist, j.dist)
    wb = np.stack([w, w.T.copy()])
    j, t = _both(wb, method="numpy")
    assert_same(t.dist, j.dist)


@pytest.mark.parametrize("method", ["naive", "blocked", "fused"])
@pytest.mark.parametrize("shape", [(37, 37), (96, 96), (200, 200), (3, 60, 60)])
def test_successor_solve_matches_reference(method, shape):
    w = semiring_graph("min_plus", shape, seed=shape[-1])
    j, t = _both(w, method=method, successors=True, block_size=32)
    assert t.succ.dtype == torch.int32
    assert_same(t.dist, j.dist)
    assert_same(t.succ, j.succ)


@pytest.mark.parametrize("variant", ["fori", "unroll"])
def test_fused_solve_with_explicit_block_size_matches_reference(variant):
    w = semiring_graph("plus_mul", (100, 100), seed=5)
    j, t = _both(w, method="fused", semiring="plus_mul", block_size=32, variant=variant)
    assert_same(t.dist, j.dist)


def test_input_types_are_coerced_like_the_reference():
    rng = np.random.default_rng(0)
    wi = rng.integers(1, 10, size=(100, 100))
    np.fill_diagonal(wi, 0)
    j, t = _both(wi, method="fused", block_size=64)  # pads 100 → 128 with +inf
    assert t.dist.dtype == torch.float32
    assert_same(t.dist, j.dist)
    w = random_digraph(30, density=0.5, seed=2)
    from_list = solve(w.tolist(), device="cpu").dist
    from_tensor = solve(torch.from_numpy(w), device="cpu").dist
    assert_same(from_list, from_tensor)


def test_auto_dispatch():
    assert solve(random_digraph(20, seed=0), device="cpu").method == "naive"
    big = solve(random_digraph(200, density=0.5, seed=1), device="cpu")
    assert (big.method, big.block_size, big.padded_n) == ("fused", 64, 256)
    s = solve(random_digraph(200, density=0.5, seed=1), successors=True, device="cpu")
    assert s.method == "fused" and s.succ is not None


# ------------------------------------------------- validation and refusals
def test_negative_cycle_raises_like_the_reference():
    w = np.full((6, 6), np.inf, np.float32)
    np.fill_diagonal(w, 0.0)
    w[0, 1], w[1, 2], w[2, 0] = 1.0, -3.0, 1.0
    for method in ("naive", "fused"):
        with pytest.raises(japsp.NegativeCycleError):
            japsp.solve(w, method=method)
        with pytest.raises(NegativeCycleError):
            solve(w, method=method, device="cpu")
    j, t = _both(w, method="fused", validate=False)
    assert_same(t.dist, j.dist)
    wb = np.stack([random_digraph(6, seed=1), w])
    assert_same(negative_cycle_mask(solve(wb, validate=False, device="cpu").dist),
                japsp.negative_cycle_mask(japsp.solve(wb, validate=False).dist))
    with pytest.raises(NegativeCycleError, match=r"graphs \[1\]"):
        solve(wb, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(method="warp-drive"),
    dict(successors=True, semiring="max_plus"),
    dict(method="numpy", successors=True),
    dict(method="numpy", semiring="or_and"),
    dict(semiring="tropical_dreams"),
    dict(variant="broadcast"),
    dict(method="fused", block_size=8),
    dict(device="tpu"),
])
def test_solve_rejects_bad_arguments(kw):
    with pytest.raises(ValueError):
        solve(random_digraph(16, seed=0), **{"device": "cpu", **kw})


def test_solve_rejects_non_square_input():
    with pytest.raises(ValueError):
        solve(random_digraph(16, seed=0)[:8, :4], device="cpu")


@pytest.mark.parametrize("kw,item", [
    (dict(method="recursive"), "A.10"),
    (dict(method="distributed"), "A.11"),
    (dict(dtype="int16"), "A.4"),
    (dict(dtype="bfloat16"), "A.4"),
    (dict(packed=True, semiring="or_and"), "A.4"),
    (dict(semiring="min_plus_i16"), "A.4"),
    (dict(mesh=object()), "A.11"),
    (dict(hbm_budget=1 << 20), "A.10"),
])
def test_not_ported_options_name_their_roadmap_item(kw, item):
    w = random_digraph(16, seed=0)
    if item == "A.4":  # ported: the storage lowerings solve as the reference's
        got = solve(w, device="cpu", **kw)
        want = japsp.solve(w, **kw)
        assert got.semiring == want.semiring
        assert_same(got.dist, np.asarray(want.dist))
        return
    if item == "A.10":  # ported: recursive solves and budgets as the reference's
        got, want = solve(w, device="cpu", **kw), japsp.solve(w, **kw)
        assert got.method == want.method
        assert_same(got.dist, np.asarray(want.dist))
        return
    if item == "A.11":  # ported: the distributed solve needs a mesh, and
        if "mesh" in kw:  # only method="distributed" reads it
            assert solve(w, device="cpu", **kw).method == "naive"
        else:
            with pytest.raises(ValueError, match="requires a mesh"):
                solve(w, device="cpu", **kw)
        return
    with pytest.raises(NotImplementedError, match=item):
        solve(w, device="cpu", **kw)


def test_solve_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = random_digraph(16, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(w)  # the default device is the card
    with pytest.raises(RuntimeError):
        solve(w, device="cuda")
    assert solve(w, device="cpu").dist.device.type == "cpu"


def test_pad_matches_reference():
    from repro.apsp import api as japi
    from repro.core.semiring import SEMIRINGS as JS
    from repro_torch.core.semiring import SEMIRINGS as TS

    w = semiring_graph("or_and", (2, 20, 20), seed=1)
    for name in NAMES:
        assert_same(tapi._pad(torch.from_numpy(w), 32, TS[name]),
                    japi._pad(np.asarray(w), 32, JS[name]))


# ------------------------------------------------------------- path walks
def test_path_walks_match_reference():
    w = random_digraph(70, density=0.1, seed=4)
    j, t = _both(w, method="fused", successors=True, block_size=16)
    jd, js = np.asarray(j.dist), np.asarray(j.succ)
    for src, dst in [(0, 5), (3, 69), (10, 10), (42, 7)]:
        p = tpaths.extract_path(t.succ, src, dst)
        assert p == jpaths.extract_path(js, src, dst)
        assert tpaths.path_cost(w, p) == jpaths.path_cost(w, p)
        q = tpaths.extract_path_from_dist(w, t.dist, src, dst)
        assert q == jpaths.extract_path_from_dist(w, jd, src, dst)
    i16 = np.asarray(japsp.solve(w, dtype=np.int16, method="fused", block_size=16).dist)
    assert tpaths.extract_path_from_dist(w, i16, 3, 69) == jpaths.extract_path_from_dist(
        w, i16, 3, 69)  # int16 tables lift, sentinels to ±inf


# -------------------------------------------------------------- isolation
def test_port_imports_neither_jax_nor_the_reference():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                  .with_suffix("").parts).replace(".__init__", "")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py")
    )
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {modules!r}:
            importlib.import_module(m.removesuffix(".__init__"))
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.") or m == "repro"
               or m.startswith("repro.")]
        assert not bad, bad
        print(len({modules!r}))
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 14
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in smoke and "from repro." not in smoke
    assert "import repro\n" not in smoke
