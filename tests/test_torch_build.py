"""``kernels._build``'s asynchronous build, on the CPU with a stand-in for
``nvcc``: ``build_async`` starts each source once and returns at once,
``load`` waits for its own build and loads what it built, and a build that
fails raises from ``load`` (the wrapper never falls back)."""
import threading
from pathlib import Path

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def fake_nvcc(monkeypatch):
    """build_all that waits for a gate, records each name it builds and
    "fails" for names starting with "bad"; CDLL that records its path."""
    gate, built, loaded = threading.Event(), [], []

    def build_all(names):
        gate.wait(timeout=30)
        (name,) = names
        built.append(name)
        if name.startswith("bad"):
            raise RuntimeError(f"nvcc failed on {name}.cu")
        return [_build.Built(name, Path(f"lib{name}.so"), 1.0, "")]

    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(_build, "_PENDING", {})
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loaded.append(path) or path)
    return gate, built, loaded


def test_build_async_returns_at_once_and_load_waits_for_its_own(fake_nvcc):
    gate, built, loaded = fake_nvcc
    futures = _build.build_async(("a", "b"))
    assert set(futures) == {"a", "b"} and not any(f.done() for f in futures.values())
    assert _build.build_async(("a",))["a"] is futures["a"]  # started once
    gate.set()
    assert _build.load("a") == "liba.so" and loaded == ["liba.so"]
    assert _build.load("a") == "liba.so" and loaded == ["liba.so"]  # cached
    futures["b"].result(timeout=30)
    assert sorted(built) == ["a", "b"]


def test_a_failed_async_build_raises_from_load(fake_nvcc):
    gate, _, loaded = fake_nvcc
    _build.build_async(("bad_lib",))
    gate.set()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load("bad_lib")
    assert loaded == []
