"""Build the CUDA sources under ``kernels/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>_<hash>.so`` at the
repository root, at first use.  The hash covers the source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited kernel is rebuilt and a
stale library is never loaded.
``build_async`` starts every build at once and returns; ``load`` of a
library still building waits for that build alone.
Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("fw_round", "fw_round_lowered", "fw_repair", "fw_repair_lowered", "fw_repair_del",
           "fw_repair_del_lowered", "fw_phase", "fw_phase_lowered", "minplus_matmul",
           "minplus_matmul_lowered", "flash_decode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    """One compiled source: its library, build seconds (0 when it was
    already built) and the compiler's output (``-Xptxas -v`` lines)."""

    name: str
    path: Path
    seconds: float
    log: str


_LIBS: dict[str, ctypes.CDLL] = {}
_PENDING: dict[str, concurrent.futures.Future] = {}  # build_async's builds, by name


@dataclasses.dataclass(frozen=True)
class KernelInfo:
    """What ``-Xptxas -v`` says of one kernel of a library: its name
    (demangled where ``c++filt`` exists), registers and spill bytes."""

    name: str
    registers: int
    spill_stores: int
    spill_loads: int


def kernel_infos(built: Built) -> list[KernelInfo]:
    """The kernels of a library built by this process, from its compiler
    output (empty for a library found already built)."""
    found, func, spill = [], None, (0, 0)
    for line in built.log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            func, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and func:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and func:
            found.append((func, int(m.group(1)), spill))
            func = None
    names = [f for f, _, _ in found]
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        names = out if len(out) == len(names) else names
    except (OSError, subprocess.SubprocessError):
        pass
    return [KernelInfo(name.replace("(anonymous namespace)::", ""), regs, *sp)
            for name, (_, regs, sp) in zip(names, found)]


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc",
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the CUDA "
        "kernels of repro_torch cannot be built"
    )


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build_all(names=SOURCES) -> list[Built]:
    """Compile every source not yet built, one ``nvcc`` each, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, done = [], []
    for name in names:
        out = _target(name)
        if out.exists():
            done.append(Built(name, out, 0.0, ""))
            continue
        # Unique temporary name, renamed into place: concurrent builders
        # never load a half-written library.
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        todo.append((name, out, tmp, proc, time.perf_counter()))

    def wait(job):  # one thread a compiler, so each build time is its own
        log, _ = job[3].communicate()
        return log, time.perf_counter() - job[4]

    with concurrent.futures.ThreadPoolExecutor(max(1, len(todo))) as pool:
        results = list(pool.map(wait, todo))
    for (name, out, tmp, proc, _), (log, seconds) in zip(todo, results):
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        os.replace(tmp, out)
        done.append(Built(name, out, seconds, log))
    return done


def build_async(names=SOURCES) -> dict[str, concurrent.futures.Future]:
    """Start the build of every source, one ``nvcc`` each, all at once, and
    return at once: {name: future of its ``Built``}.  ``load`` of a source
    still building waits for its own build only, so a caller can use the
    libraries that are done while the slow ones compile."""
    pool = concurrent.futures.ThreadPoolExecutor(max(1, len(names)))
    for name in names:
        if name not in _PENDING:
            _PENDING[name] = pool.submit(lambda n=name: build_all((n,))[0])
    pool.shutdown(wait=False)
    return {name: _PENDING[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use (or by
    the ``build_async`` already under way)."""
    lib = _LIBS.get(name)
    if lib is None:
        pending = _PENDING.get(name)
        built = pending.result() if pending is not None else build_all((name,))[0]
        lib = _LIBS[name] = ctypes.CDLL(str(built.path))
    return lib
