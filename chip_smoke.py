#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Phases, each of which raises (exit code 1) on any failure:

  1. device: the card's name and power limit; start the build of the CUDA
     kernels from ``src/repro_torch/kernels/csrc`` (one nvcc each, all at
     once: ``_build.build_async``).  The checks below run as their own
     libraries land, those that need ``fw_repair.cu``, the slowest build,
     last; before them the build report prints
     each library's build seconds, registers and spills (each instantiation
     of the redesigned kernels: matmul, relax, successor relax, decode,
     the round's diag and bands and its successor diag and bands, the
     sweep's diag and panels and its successor diag and panels, the
     sweep's relax and successor relax on the long tile and the two short
     ones, the 4-dispatch closure and bands, the repair's stage, apply and
     successor apply, one a storage's step; a diag, bands, panels,
     closure, band, sweep relax, stage or apply instantiation that spills
     fails, the successor ones included).
     signed zero: what the kernels' min.NaN / max.NaN steps do with (±0,
     ∓0) in both orders and with NaN, held to XLA's min / max; then every
     ported kernel (fused, successor and bordered rounds, semiring_matmul,
     fw_phase1/2, fw_repair and its twin, the sweep and its twin) on inputs
     salted with ±0 and NaN against its plain version, by bits.
  2. check: every kernel held bitwise (by bit view, -0.0 told from +0.0,
     NaN equal to NaN; ``repro_torch.utils.bits.bits_equal``) against its plain
     torch version on the same card tensors — the fused round on all five
     semirings at (1024,1024) s=128 and s=64, (4,512,512) batched, n=1000
     through ``solve`` (padded to 1024), n=300 (s=64), n=100 (s=32) and
     n=60 (s=16); the
     successor round at (1024,1024) and (3,512,512).  The small solves are
     also held against ``solve(device="cpu")``, the plain path the CPU
     tests hold bitwise against the JAX reference.
     The repair kernels likewise: five semirings at n=1024, E in {1, 5,
     37, 100} (padded as the engine pads them), the successor twin, and
     a successor repair at n=1000 through ``ApspEngine``; each launch
     alone (``check_repair_phases``: the stage's staged rows and row
     scalars, with next hops its hops, and the apply on both its paths,
     16-byte vectors and one element at a time) on every semiring and the
     successor twin at n = 100 and 1024, E in {1, 16, 37, 64}; an apply
     into memory it reads refused.  The sweep
     kernels of the decremental repair likewise: the four idempotent
     semirings at n=1024 with a in {1, 5, 37, 200} affected rows, each
     launch kind alone (the relax on every tile height, the short tile's
     8 and 16 rows and the mainloop's 128, from the same strip) and the
     whole sweep, the successor sweep, and
     ``repair_del`` at n=1000 through the engine.  The 4-dispatch round's
     kernels likewise, on all five semirings: ``semiring_matmul`` with and
     without c at square, batched and ragged shapes with ±inf operands,
     ``fw_phase1``, ``fw_phase2_row`` / ``fw_phase2_col`` (band lengths
     1024 and 1000), and ``fw_staged(fused=False)`` at n=1024 and
     (4,512,512) against the plain 4-dispatch loop and the fused round.
     The lowered rounds likewise: every storage lowering (int16 ×4,
     packed or_and, bf16 and f16 ×5, ±0 and NaN salted in the floats) at
     n=96 (s=32) and n=1024 (s=32, 64, 128), single and batched, the bf16 / f16
     successor round, and each lowered ``solve`` at n=90 against the plain
     path on the CPU.  The lowered repair and sweep kernels and the int32
     round likewise (``phase_check_lowered_repair``): the repair on every
     storage (int16 ×4, packed, bf16 / f16 ×5, int32 or_and / plus_mul) at
     n=96 and 1024 with E in {1, 16, 37, 64}, each launch alone at E in
     {1, 16, 32} on both apply paths, bf16 / f16 salted with ±0
     and, apart, with off-diagonal NaN; the successor repair; the sweep at
     a in {1, 37} and, at n=1024, 200 (both sides of the relax's tile
     switch), each launch kind alone, the relax on every tile height; the
     successor sweep likewise; the int32
     round; ``repair_del`` at n=1000 through lowered engines card == CPU.
     The lowered 4-dispatch kernels likewise (``phase_check_lowered_four``):
     ``semiring_matmul`` on every storage with and without c at square,
     batched and ragged shapes, ``fw_phase1`` at s = 32 / 128 single and
     batched, both bands at (32, 96) and (128, 1024), bf16 / f16 salted with
     ±0 and, apart, off-diagonal NaN; ``fw_staged(fused=False)`` at n = 96
     and 1024 (s = 32 / 128, single and batched) == plain loop == lowered
     fused.  The lowered bordered round (``phase_check_lowered_bordered``):
     every storage, s = 32 / 64 / 128, square, tall and wide rank blocks,
     the three echo forms.  The chains (``phase_check_chains``): every
     diag and bands instantiation alone against its plain phase, f32 and
     every storage, s = 16 .. 128, square (the band tiles cut into CTAs or
     whole), batched and bordered with the owner echo; every successor
     diag and bands instantiation alone against its plain phases, next
     hops included (``phase_check_succ_chains``), f32, bf16 and f16, ±0 /
     NaN salted and tie-heavy with planted diagonals, s = 16 .. 128,
     square and batched; every diag and
     panels instantiation of the restricted sweep alone against its plain
     phase (``phase_check_sweep_chains``), f32 and every sweep storage,
     s = 16 .. 128, n = 2s and 5s, strips of 8, 16 and 64 rows, ±0 / NaN
     salted, planted diagonals; every successor diag and panels
     instantiation of the sweep alone against its plain phases, next hops
     included (``phase_check_succ_sweep_chains``), f32, bf16 and f16, ±0 /
     NaN salted and tie-heavy with planted diagonals, s = 16 .. 128, n = 2s
     and 5s, strips of 8, 16 and 64 rows; every closure and band
     instantiation of the 4-dispatch round alone against its plain phase
     (``phase_check_phase_chains``), f32 and every storage, s = 16 .. 128,
     a batch of 3, band lengths 1, s - 3 and 1000, aligned, odd-strided
     and unaligned views, ±0 / NaN salted, planted diagonals.  f16 plus_mul
     (``phase_check_f16_plus_mul``): the round, bordered round, matmul,
     phase 1 and a solve, one f16 FMA a step, card == twin.  The recursive
     (R-Kleene) schedule (``phase_check_kleene``): its executor on the
     five semirings at (n, s, leaf) = (128, 32, 32), (160, 32, 64), (96,
     32, 96), a (3, 96, 96) batch and n = 1024 (s 128, leaf 256; min-plus,
     plus_mul, with ``devices=`` the card once, twice and three times, a
     lane each) through the device and the
     pinned host store, ``solve(method="recursive")`` and budget-promoted
     solves in int16 / bf16 / f16 and on 40 packed graphs; each == its
     plain run on the CPU == the card's fused solve, the host stores'
     bytes each way == ``plan.recursive_transfer_bytes``, the rise of
     peak device memory within the residency model.
  3. kernels: each launch kind alone at the main paths' shapes, against
     the plain version of its phase: max abs error, median ms, plain ms
     and the bound (the larger of operations / 67 TFLOP/s fp32 and bytes /
     3.35 TB/s, the H100 SXM's published peaks); the sweep kinds at a = 8,
     64 and 256 affected rows, the successor relax also at a = n (f32, bf16
     and f16, the long tile at the engine's strip of every row);
     ``semiring_matmul`` also in plus_mul beside ``torch.addmm`` at the
     phase-3 shape, with the fused round's relax
     timed beside both on that shape (min-plus and plus_mul), and at 4096³
     in min-plus and plus_mul, the latter beside ``torch.matmul`` (TF32
     off).
     The repair's stage and apply also as device time (``torch.profiler``),
     the f32 plus_mul apply beside ``torch.addmm(d, scalars, staged)``.
     The lowered launch kinds likewise at n=8192 (successors n=4096),
     the lowered repair (E=16) and sweep (a=8) kinds and the int32 round
     kinds included; the lowered 4-dispatch kinds (``fw_phase1[int16]``,
     ``semiring_matmul[bf16]`` …) in int16, bf16, f16 and packed words.
  4. main path: ``solve(w)`` at n=8192 (min-plus, f32, a seeded random
     digraph of density 0.5) and ``solve(w, successors=True)`` at n=4096,
     with the launch counts of that run, bitwise against the plain round
     loop, then timed (warm-up, median of 3; host clock around work that
     ends in ``synchronize()``).  The lowered main path the same way: the
     n=8192 graph with dtype=int16, in bf16 and in f16, 32 graphs of
     n=8192 through ``solve(packed=True)``, bf16 / f16 successors at
     n=4096, with device time by launch kind.  ``flash_decode`` at the
     Qwen2-7B decode shape (B 8, Hkv 4, g 7, hd 128, S 32768, kv_len
     32000) in bf16 and f32, within 2e-2 / 2e-5 of its plain versions,
     poisoned tail and kv_len=0 checked, timed beside
     ``scaled_dot_product_attention``.
  5. engine path: ``ApspEngine`` solve + 16-edge ``repair`` at n=8192,
     successor solve + repair at n=4096 and n=512, ``solve_many`` of 32
     ragged graphs with next hops, with the launch counts of that run;
     checked bitwise (repair == re-solve of the updated graph) and timed
     (repair at E = 4, 16, 64 beside the re-solve; graphs/s).
  6. repair_del path: ``ApspEngine.repair_del`` of the E = 1 and E = 16
     on-path links that affect the fewest pairs at n=8192 and of the
     median-ranked link (a typical a), with next hops at n=4096, the E = 16
     batch refused by the policy (threshold 0: the counted re-solve), a
     plus_mul deletion (re-solved) and an off-path one (a no-op), with the
     sweep and round launch counts of that run; checked bitwise against a
     re-solve of the updated graph and timed beside it, marking and sweep
     apart, with the sweep's time by launch kind (events between launches
     and device time by ``torch.profiler``) and its host time a launch.
  7. 4-dispatch path: ``fw_staged(w, fused=False)`` at n=8192 (the main
     path's input), with the launch counts of that run (4 x 64), bitwise
     against the fused solve, timed beside the fused round loop, with its
     device time by launch kind; then in int16, bf16, f16 and on one plane
     of 32 packed graphs, each == the lowered fused solve and timed beside
     it.
  8. lowered engine path: ``ApspEngine`` pinned to int16, bf16, f16 and
     one packed word plane at n=8192 (integer weights in [1, 16], exact in
     every storage): solve, ``repair`` E=16 and ``repair_del`` E=1 / E=16,
     each == a re-solve by bits and timed beside it; bf16 / f16 successor
     repair and repair_del at n=4096, with the affected rows and the
     sweep's host / device split; a bf16 plus_mul ``repair_del`` (the
     counted re-solve); ``solve_many`` of 32 ragged graphs in bf16 and
     int16.  Integer storage: int8 / uint32 / bool or_and and int32
     plus_mul solves at n=1024 card == CPU with the reference's dtype, a
     uint8 or_and engine's repair paths, or_and int32 at n=8192 timed.
  9. distributed path (``launch.mesh.run_grid`` processes sharing the one
     card over gloo, through ``launch.fw_dist_check.grid_check``): a 1×1
     grid at n=8192 (the main path's input; every round an owner round),
     timed, with its device time by launch kind; a 2×2 grid at n=8192,
     timed, with each rank's counted collective bytes against
     ``plan.dist_round_comm_bytes`` × 64, a run in chunks of 16 rounds
     restarted from the round-32 checkpoint, and a 16-link mesh ``repair``;
     a 4×2 grid at n=2048 on all five semirings and a (4,2048,2048) batch.
     The same grids in the lowered storages: the 1×1 and 2×2 grids at
     n=8192 in bf16, f16, int16 and on one plane of 32 packed graphs (2×2
     timed beside 1×1, counted bytes == the model in the storage's word:
     136,314,880 B a rank in 2-byte storages), a 16-link int16 mesh
     repair, and the 4×2 grid at n=2048 on every lowering (int16 ×4, bf16
     and f16 ×5, packed).
     Every rank holds its result against the single-device fused solve (or
     repair) on the card, bitwise, and reports its launch counts.
     The bordered kernel is also checked alone (phase 2: all five
     semirings, s = 16, 32, 64, 128, square, tall and wide bordered blocks,
     single and batched, owner echo none / (1,1) / the last tile / one of
     the two, ±inf salted in) and timed alone per launch kind at the 2×2
     rank's (4224,4224) block (phase 3), in f32 and the four lowered
     storages, and plus_mul's relax there beside ``torch.addmm``.
 10. out-of-core path (``phase_oocore``, after the serving path): the
     user's ``solve(w, hbm_budget=)`` on a host matrix bigger than the
     budget — f32 min-plus n = 16384 under 768 MiB, int16 n = 16384 under
     384 MiB, one plane of 32 packed graphs n = 8192 under 192 MiB — with
     its ``semiring_matmul`` / ``fw_phase*`` launches, wall beside the
     in-core fused solve (== by bits), rise of peak device memory (<= the
     budget), copies each way (``torch.profiler``: ms, GB/s), kernels and
     device idle time, pinning the host matrix cold and again, and the same
     schedule through an explicit ``HostPanelStore`` whose bytes each way
     == the plan's model; each launch kind of the lane alone at its shapes
     (the leaf's phases, the cross's two products, the sweep's P x P
     product on the factor views) against its plain version and beside its
     bound, a row of the record of its own with the lane's launches; an
     in-core ``solve(method="recursive", leaf=1024)`` at n = 8192 timed
     beside fused; ``ApspEngine(hbm_budget=192 MiB)`` at n = 8192 twice
     (an out-of-core key, then a cache hit).
 11. LM serving path (``phase_lm_serve``, last): ``serve.lm.Engine`` over
     ``repro_torch.models``, plain torch ops (the reference's LM runs no
     Pallas kernel; the phase requires that no kernel of the port
     launched).  Qwen2-7B at full width and depth, 7,615,616,512 bf16
     parameters drawn from a seed on the card: ``Engine.generate`` of 8
     prompts of 512 seeded tokens and 64 greedy tokens, twice with equal
     ids; finite logits; decode steps that change only their own cache
     row; prefill ms (median of 3), decode ms a step (median), generated
     tokens/s and peak memory beside the bounds derived from the datasheet
     (``launch.roofline``); a forward over the prompt and 16 generated
     tokens against the decode steps' logits, for information.  Then
     Qwen2-7B cut to 2 layers at full width and the six attention-family
     smoke configs, card == CPU on the same weights (prefill logits and
     caches, 4 teacher-forced decode steps; rtol 2e-2 and two bf16 ulps
     of the largest |value|).  Then the MoE, MLA and SSM families, the
     same generate and reports: DeepSeek-V2-Lite (16,210,324,992
     parameters, routers f32; decode steps write only their own c_kv /
     k_pe row; the share of the prefill's assignments capacity 1.25
     dropped) and Mamba2-780M (857,846,016; decode steps move every conv /
     ssm state; a 500-token prompt runs the one-chunk fallback) at full
     width and depth, Jamba v0.1 at full width over one period (8 of 32
     layers), Kimi K2 at full width over one layer (2 prompts of 128
     tokens, 8 greedy tokens); DeepSeek-V2-Lite and Mamba2-780M cut to 2
     layers and the four families' smoke configs card == CPU within four
     bf16 ulps (the card tests' rule).

Every kernel of the record must have been launched on its path; the
last lines are the ``{"kernels": [...]}`` record and then
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX or of
the ``repro`` package.
"""
from __future__ import annotations

import argparse
import collections
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_FP32_OPS = 67e12  # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SOURCES = {
    "fw_round": "src/repro_torch/kernels/csrc/fw_round.cu",
    "fw_round_with_successors": "src/repro_torch/kernels/csrc/fw_round.cu",
    "fw_repair": "src/repro_torch/kernels/csrc/fw_repair.cu",
    "fw_repair_with_successors": "src/repro_torch/kernels/csrc/fw_repair.cu",
    "fw_repair_del_sweep": "src/repro_torch/kernels/csrc/fw_repair_del.cu",
    "fw_repair_del_sweep_with_successors": "src/repro_torch/kernels/csrc/fw_repair_del.cu",
    "semiring_matmul": "src/repro_torch/kernels/csrc/minplus_matmul.cu",
    "fw_phase1": "src/repro_torch/kernels/csrc/fw_phase.cu",
    "fw_phase2_row": "src/repro_torch/kernels/csrc/fw_phase.cu",
    "fw_phase2_col": "src/repro_torch/kernels/csrc/fw_phase.cu",
    "fw_round_bordered": "src/repro_torch/kernels/csrc/fw_round.cu",
    "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
}
# The lowered launch kinds (``lowered_kinds``) are built from here.
LOWERED_SOURCES = {
    "fw_round": "src/repro_torch/kernels/csrc/fw_round_lowered.cu",
    "fw_round_with_successors": "src/repro_torch/kernels/csrc/fw_round_lowered.cu",
    "fw_repair": "src/repro_torch/kernels/csrc/fw_repair_lowered.cu",
    "fw_repair_with_successors": "src/repro_torch/kernels/csrc/fw_repair_lowered.cu",
    "fw_repair_del_sweep": "src/repro_torch/kernels/csrc/fw_repair_del_lowered.cu",
    "fw_repair_del_sweep_with_successors":
        "src/repro_torch/kernels/csrc/fw_repair_del_lowered.cu",
    "fw_round_bordered": "src/repro_torch/kernels/csrc/fw_round_lowered.cu",
    "semiring_matmul": "src/repro_torch/kernels/csrc/minplus_matmul_lowered.cu",
    "fw_phase1": "src/repro_torch/kernels/csrc/fw_phase_lowered.cu",
    "fw_phase2_row": "src/repro_torch/kernels/csrc/fw_phase_lowered.cu",
    "fw_phase2_col": "src/repro_torch/kernels/csrc/fw_phase_lowered.cu",
}
INT32_TAGS = ("or_and_i32", "plus_mul_i32")
REPLACES = {
    "fw_round": "src/repro/kernels/fw_round.py:413",
    "fw_round_with_successors": "src/repro/kernels/fw_round.py:611",
    "fw_repair": "src/repro/kernels/fw_repair.py:228",
    "fw_repair_with_successors": "src/repro/kernels/fw_repair.py:280",
    "fw_repair_del_sweep": "src/repro/kernels/fw_repair_del.py:383",
    # XLA-only in the reference (no Pallas variant): the kernel twin of it.
    "fw_repair_del_sweep_with_successors": "src/repro/kernels/fw_repair_del.py:237",
    "semiring_matmul": "src/repro/kernels/minplus_matmul.py:138",
    "fw_phase1": "src/repro/kernels/fw_phase1.py:34",
    "fw_phase2_row": "src/repro/kernels/fw_phase2.py:45",
    "fw_phase2_col": "src/repro/kernels/fw_phase2.py:91",
    "fw_round_bordered": "src/repro/kernels/fw_round.py:515",
    "flash_decode": "src/repro/kernels/flash_decode.py:68",
}


class SmokeFailure(RuntimeError):
    pass


@functools.cache
def lowered_kinds() -> frozenset:
    """The launch kinds of the storage lowerings of the square round, the
    repair and the sweep (``fw_round/relax[int16]``, ``fw_repair/apply[bf16]``,
    ``fw_repair_del_sweep/relax[packed]`` …): every kind of those wrappers
    with a tag.  The lowered bordered round and 4-dispatch kinds
    (``fw_round_bordered/relax[bf16]``, ``semiring_matmul[int16]`` …) are
    the distributed and 4-dispatch paths' own."""
    from repro_torch.kernels import fw_repair as fp
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import fw_round as fr

    return frozenset(k for k in fr.KINDS + fp.KINDS + fd.KINDS
                     if k.endswith("]") and not k.startswith("fw_round_bordered/"))


def round_lowered_kinds() -> list:
    """The lowered round kinds of the lowered main path (``solve`` in
    int16, bf16, f16 and packed words; bf16 / f16 successors)."""
    return sorted(k for k in lowered_kinds() if k.startswith("fw_round")
                  and not any(t in k for t in INT32_TAGS))


def same(a, b) -> bool:
    """Equal by bit view (``repro_torch.utils.bits.bits_equal``): dtype,
    shape and bits, -0.0 told from +0.0, every NaN equal to every NaN."""
    from repro_torch.utils.bits import bits_equal

    return bits_equal(a, b)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ------------------------------------------------------------------ inputs
def graph(name: str, shape, seed: int):
    """A matrix in the value domain of each semiring, missing edges = 0̄."""
    import numpy as np

    from repro_torch.core.semiring import SEMIRINGS

    rng = np.random.default_rng(seed)
    n = shape[-1]
    if name == "plus_mul":
        return rng.uniform(0.0, 1.0 / n, size=shape).astype(np.float32)
    if name == "or_and":
        w = (rng.uniform(size=shape) < 0.1).astype(np.float32)
    else:
        w = rng.uniform(1.0, 10.0, size=shape).astype(np.float32)
        if name == "max_plus":  # longest paths: a DAG, or cycles grow to inf
            lo = np.tril_indices(n, -1)
            w[..., lo[0], lo[1]] = -np.inf
        w[rng.uniform(size=shape) < 0.3] = SEMIRINGS[name].zero
    idx = np.arange(n)
    w[..., idx, idx] = SEMIRINGS[name].one
    return w


def repair_edges(name: str, n: int, E: int, seed: int):
    """E edge updates in each semiring's weight domain, with a repeated u
    (edges 0, 1) and u == v (edge 2), padded as the engine pads them:
    to max(4, next power of two) with no-op edges (u = v = 0, w = 0̄)."""
    import numpy as np

    from repro_torch.core.semiring import SEMIRINGS

    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, E).astype(np.int32)
    v = rng.integers(0, n, E).astype(np.int32)
    if name == "plus_mul":
        w = rng.uniform(0.0, 1.0 / n, E).astype(np.float32)
    elif name == "or_and":
        w = np.ones(E, np.float32)
    else:
        w = rng.uniform(1.0, 10.0, E).astype(np.float32)
    if E > 2:
        u[1], v[2] = u[0], u[2]
    pad = max(4, 1 << (E - 1).bit_length()) - E
    return (np.concatenate([u, np.zeros(pad, np.int32)]),
            np.concatenate([v, np.zeros(pad, np.int32)]),
            np.concatenate([w, np.full(pad, SEMIRINGS[name].zero, np.float32)]))


def launch_edges(name: str, n: int, E: int, seed: int):
    """Exactly E edges for one launch pair: ``repair_edges``' first E - 1
    and one of its padding edges (E = 1: one live edge)."""
    u, v, w = repair_edges(name, n, max(E - 1, 1), seed)
    return u[:E], v[:E], w[:E]


def plain_solve(w, *, block_size: int, semiring):
    """The plain round loop on w's device: pad, n/s plain rounds, unpad."""
    from repro_torch.apsp import api, plan
    from repro_torch.kernels import ref

    n = w.shape[-1]
    wp = api._pad(w, plan.padded_size(n, block_size), semiring)
    for b in range(wp.shape[-1] // block_size):
        wp = ref.fw_round_ref(wp, b, block_size=block_size, semiring=semiring)
    return wp[..., :n, :n]


def plain_solve_succ(w, *, block_size: int):
    from repro_torch.core.paths import _init_successors
    from repro_torch.kernels import ref

    succ = _init_successors(w)
    for b in range(w.shape[-1] // block_size):
        w, succ = ref.fw_round_with_successors_ref(w, succ, b, block_size=block_size)
    return w, succ


# ------------------------------------------------------------------ timing
def sync():
    import torch

    torch.cuda.synchronize()


def event_ms(fn, reps: int) -> float:
    """Median of ``reps`` single runs of fn, each between two CUDA events."""
    import torch

    fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn) -> float:
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


def max_abs_err(a, b) -> float:
    import torch

    eq = (a == b) | (torch.isnan(a) & torch.isnan(b))
    diff = torch.where(eq, torch.zeros_like(a), (a.double() - b.double()).abs())
    return float(torch.nan_to_num(diff, nan=float("inf")).max())


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def record_kernel(rows: dict, kind: str, err, ms, plain, ops, nbytes, *,
                  note: str = "", store: bool = True, library=None) -> None:
    """One row of the ``{"kernels": [...]}`` record (launches filled in by
    the path that launches the kind); ``store=False`` only prints it.
    ``library``: the ms of one PyTorch call computing the same function."""
    bms, by = bound(ops, nbytes)
    fn = kind.split("/")[0].split("[")[0]
    source = (LOWERED_SOURCES if kind.endswith("]") else SOURCES)[fn]
    if store:
        rows[kind] = dict(name=kind, route="cuda", source=source, replaces=REPLACES[fn],
                          launches=0, max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, library_ms=library)
    lib = "" if library is None else f", library {library:.4f} ms"
    print(f"kernel {kind}{note}: err {err}, {ms:.4f} ms (plain {plain:.3f} ms, "
          f"bound {bms:.5f} ms by {by}{lib})")


# ------------------------------------------------------------------ phases
@functools.cache
def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device():
    import torch

    from repro_torch.kernels import _build

    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {card_line()}")
    return name, _build.build_async()


def phase_build(builds: dict):
    """Wait for every library of ``phase_device``'s build and print its
    build seconds, registers and spills (each instantiation of the
    redesigned kernels); a chain or sweep relax instantiation that spills
    fails.  The checks before this phase ran as their own libraries
    landed."""
    from repro_torch.kernels import _build

    for built in (f.result() for f in builds.values()):
        infos = _build.kernel_infos(built)
        spills = [f"{k.name} {k.spill_stores}/{k.spill_loads} B" for k in infos if k.spill_stores]
        regs = max((k.registers for k in infos), default=0)
        print(f"built {built.path.name} in {built.seconds:.1f} s: {len(infos)} kernels, at most "
              f"{regs} registers, {len(spills)} spilling" + "".join(f"\n  spill {x}" for x in spills))
        shown = []  # the redesigned kernels, each instantiation
        if built.name in ("fw_repair_del", "fw_repair_del_lowered"):
            shown = [k for k in infos if re.match(
                r"(void )?((succ_)?(diag|panels)|(short_)?(succ_)?relax)_kernel<", k.name)]
        elif built.name in ("fw_phase", "fw_phase_lowered"):
            shown = [k for k in infos if re.match(r"(void )?(closure|band)_kernel<", k.name)]
        elif built.name in ("fw_repair", "fw_repair_lowered"):
            shown = [k for k in infos if re.match(r"(void )?(stage|apply|succ_apply)_kernel<",
                                                  k.name)]
        elif built.name in ("minplus_matmul", "minplus_matmul_lowered", "flash_decode",
                            "fw_round", "fw_round_lowered"):
            shown = [k for k in infos if any(x in k.name for x in (
                "matmul_kernel", "split_kernel", "relax_kernel", "diag_kernel", "bands_kernel"))]
        for k in shown:
            print(f"  {k.name}: {k.registers} registers, spill stores / loads "
                  f"{k.spill_stores} / {k.spill_loads} B")
        # the chain kernels: diag / bands, diag / panels, closure / band
        least = {"fw_round": 32, "fw_round_lowered": 32, "fw_repair_del": 32,
                 "fw_repair_del_lowered": 104, "fw_phase": 48,
                 "fw_phase_lowered": 168}.get(built.name)
        if least and built.seconds:
            succ = "(succ_)?" if built.name.startswith(("fw_round", "fw_repair_del")) else ""
            chains = [k for k in infos if re.match(
                rf"(void )?{succ}(diag|bands|panels|closure|band)_kernel<", k.name)]
            require(len(chains) >= least, f"{built.name}: {len(chains)} chain kernels")
            spilled = [k.name for k in chains if k.spill_stores or k.spill_loads]
            require(not spilled, f"the chain kernels spill: {spilled}")
        # the repair: one stage and one apply a storage's step, successors too
        counts = {"fw_repair": (5, 5), "fw_repair_lowered": (16, 16)}.get(built.name)
        if counts and built.seconds:
            stages = [k for k in shown if "stage_kernel" in k.name]
            require((len(stages), len(shown) - len(stages)) == counts,
                    f"{built.name}: {len(stages)} stage / {len(shown) - len(stages)} apply "
                    f"kernels, not {counts}")
            spilled = [k.name for k in shown if k.spill_stores or k.spill_loads]
            require(not spilled, f"the repair kernels spill: {spilled}")
        # the sweep's relax: the long and the two short tiles of every storage
        relaxes = {"fw_repair_del": 12, "fw_repair_del_lowered": 39}.get(built.name)
        if relaxes and built.seconds:
            relax = [k for k in infos if re.match(r"(void )?(short_)?(succ_)?relax_kernel<",
                                                  k.name)]
            require(len(relax) == relaxes, f"{built.name}: {len(relax)} relax kernels")
            spilled = [k.name for k in relax if k.spill_stores or k.spill_loads]
            require(not spilled, f"the sweep's relax kernels spill: {spilled}")


def phase_check():
    import torch

    from repro_torch.apsp import solve
    from repro_torch.core.semiring import SEMIRINGS
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref
    from repro_torch.core.paths import _init_successors

    dev = torch.device("cuda")
    checked = 0
    for name, sr in sorted(SEMIRINGS.items()):
        for shape, b, s in (((1024, 1024), 3, 128), ((4, 512, 512), 1, 128),
                            ((1024, 1024), 5, 64)):
            w = torch.from_numpy(graph(name, shape, 7)).to(dev)
            got = fr.fw_round(w.clone(), b, block_size=s, semiring=sr)
            want = ref.fw_round_ref(w, b, block_size=s, semiring=sr)
            sync()
            require(same(got, want), f"fw_round {name} {shape} s={s} b={b} != plain")
            checked += 1
        for n, s in ((1000, 128), (300, 64), (100, 32), (60, 16)):
            w_np = graph(name, (n, n), n)
            w = torch.from_numpy(w_np).to(dev)
            got = solve(w, method="fused", semiring=sr, block_size=s).dist
            want = plain_solve(w, block_size=s, semiring=sr)
            sync()
            require(same(got, want), f"solve {name} n={n} s={s} != plain")
            if n < 1000:
                host = solve(w_np, method="fused", semiring=sr, block_size=s,
                             device="cpu").dist
                require(same(got.cpu(), host),
                        f"solve {name} n={n} s={s}: card != plain on the CPU")
            checked += 1
    for shape, b in (((1024, 1024), 5), ((3, 512, 512), 2)):
        w = torch.from_numpy(graph("min_plus", shape, 11)).to(dev)
        succ = _init_successors(w).contiguous()
        gd, gs = fr.fw_round_with_successors(w.clone(), succ.clone(), b, block_size=128)
        wd, ws = ref.fw_round_with_successors_ref(w, succ, b, block_size=128)
        sync()
        require(same(gd, wd) and same(gs, ws),
                f"fw_round_with_successors {shape} b={b} != plain")
        checked += 1
    print(f"check: {checked} kernel-vs-plain cases bitwise equal")


def check_repair_phases(d, sr, u, v, w, succ=None) -> int:
    """Each repair launch alone on (d, u, v, w) (``edge_vectors``, at most a
    launch pair's edges), bitwise against its plain twin on the card: the
    stage's staged rows (``repair_stage_ref``) and row scalars, with
    ``succ`` also its hops (``repair_scalars_ref``); the apply on every path
    d's rows allow, 16-byte vectors and one element at a time, against
    ``repair_apply_ref`` / ``repair_apply_succ_ref`` and the stream twins on
    the stage's buffers (an unaligned out takes the element path).
    Returns the launches held."""
    import torch

    from repro_torch.kernels import fw_repair as fp
    from repro_torch.kernels import ref

    E, n = len(u), d.shape[-1]
    what = f"fw_repair{'' if succ is None else '_with_successors'}[{d.dtype}] n={n} E={E}"
    bufs = fp.repair_buffers(d, E, successors=succ is not None)
    if succ is None:
        fp.repair_phase("stage", d, u, v, w, bufs, semiring=sr)
    else:
        fp.repair_succ_phase("stage", d, succ, u, v, w, bufs)
    staged = ref.repair_stage_ref(d, u, v, w, semiring=sr, strict=succ is not None)
    scal, hops = ref.repair_scalars_ref(d, staged, u, v, w, semiring=sr, succ=succ)
    sync()
    require(same(bufs.staged, staged), f"{what}: stage's rows != plain")
    require(same(bufs.scalars, scal) and (succ is None or same(bufs.hops, hops)),
            f"{what}: stage's row scalars != plain")
    held = 1
    for out in (torch.empty_like(d), unaligned_like(d)):  # both of the apply's paths
        path = "vectors" if fp.apply_vectors(d, staged, out) else "elements"
        if succ is None:
            fp.repair_phase("apply", d, u, v, w, bufs, out, semiring=sr)
            want = ref.repair_apply_ref(d, staged, u, w, semiring=sr)
            sync()
            ok = same(out, want) and same(want, ref.repair_stream_ref(d, scal, staged,
                                                                      semiring=sr))
        else:
            sout = unaligned_like(succ) if path == "elements" else torch.empty_like(succ)
            fp.repair_succ_phase("apply", d, succ, u, v, w, bufs, out, sout)
            wd, ws = ref.repair_apply_succ_ref(d, succ, staged, u, v, w)
            sd, ss = ref.repair_stream_succ_ref(d, succ, scal, hops, staged)
            sync()
            ok = same(out, wd) and same(sout, ws) and same(sd, wd) and same(ss, ws)
        require(ok, f"{what}: apply ({path}) != plain")
        held += 1
    return held


def unaligned_like(x):
    """An empty contiguous tensor like x whose rows start one element past
    16-byte alignment: an apply writing it takes the element path."""
    import torch

    return torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view_as(x)


def phase_check_repair():
    """The repair kernels bitwise against their plain versions on the card:
    all five semirings at n=1024 and E in {1, 5, 37, 100} (padded as the
    engine pads; 100 takes two launch pairs), the successor twin likewise,
    and a successor repair at n=1000 through the engine (padded to 1024)
    against the engine's plain path on the CPU.  Then each launch alone
    (``check_repair_phases``): every semiring and the successor twin at n
    in {100, 1024} and E in {1, 16, 37, 64}, the apply on both of its paths;
    and an apply whose out is d, or overlaps it, refused before it starts."""
    import torch

    from repro_torch.apsp import ApspEngine
    from repro_torch.core.graph import random_digraph
    from repro_torch.core.paths import _init_successors
    from repro_torch.core.semiring import MIN_PLUS, SEMIRINGS
    from repro_torch.kernels import fw_repair as fp
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    n, checked = 1024, 0
    for name, sr in sorted(SEMIRINGS.items()):
        d = torch.from_numpy(graph(name, (n, n), 5)).to(dev)
        for E in (1, 5, 37, 100):
            u, v, w = repair_edges(name, n, E, seed=E)
            got = fp.fw_repair(d, u, v, w, semiring=sr)
            want = ref.fw_repair_ref(d, u, v, w, semiring=sr)
            sync()
            require(same(got, want), f"fw_repair {name} n={n} E={E} != plain")
            checked += 1
    d = torch.from_numpy(graph("min_plus", (n, n), 6)).to(dev)
    succ = _init_successors(d).contiguous()
    for E in (1, 5, 37, 100):
        u, v, w = repair_edges("min_plus", n, E, seed=E + 1)
        gd, gs = fp.fw_repair_with_successors(d, succ, u, v, w)
        wd, ws = ref.fw_repair_with_successors_ref(d, succ, u, v, w)
        sync()
        require(same(gd, wd) and same(gs, ws), f"fw_repair_with_successors E={E} != plain")
        checked += 1
    w = random_digraph(1000, density=0.5, seed=9)
    eng, host = ApspEngine(), ApspEngine(device="cpu")
    r0 = eng.solve(w, successors=True)
    upd = [(3, 7, 0.5), (500, 2, 0.25), (999, 998, 0.125), (3, 9, 0.75)]
    got = eng.repair(r0.dist, upd, succ=r0.succ)
    want = host.repair(r0.dist.cpu(), upd, succ=r0.succ.cpu())
    require(got.padded_n == 1024 and same(got.dist.cpu(), want.dist)
            and same(got.succ.cpu(), want.succ),
            "engine successor repair n=1000 on the card != plain on the CPU")
    checked += 1
    launches = 0
    for nn in (100, 1024):
        for name, sr in sorted(SEMIRINGS.items()):
            d = torch.from_numpy(graph(name, (nn, nn), nn + 7)).to(dev)
            for E in (1, 16, 37, 64):
                u, v, w = fp.edge_vectors(*launch_edges(name, nn, E, seed=E + 2), nn, dev)
                launches += check_repair_phases(d, sr, u, v, w)
        d = torch.from_numpy(graph("min_plus", (nn, nn), nn + 8)).to(dev)
        succ = _init_successors(d).contiguous()
        for E in (1, 16, 37, 64):
            u, v, w = fp.edge_vectors(*launch_edges("min_plus", nn, E, seed=E + 3), nn, dev)
            launches += check_repair_phases(d, MIN_PLUS, u, v, w, succ=succ)
    flat = torch.zeros(2 * 64 * 64, device=dev)
    d = flat[:64 * 64].view(64, 64)
    u, v, w = fp.edge_vectors([0], [1], [1.0], 64, dev)
    bufs = fp.repair_buffers(d, 1)
    fp.repair_phase("stage", d, u, v, w, bufs)
    for out in (d, flat[64:64 + 64 * 64].view(64, 64)):  # d itself, and a view over it
        try:
            fp.repair_phase("apply", d, u, v, w, bufs, out)
        except ValueError:
            continue
        require(False, "an apply into memory it reads was not refused")
    fp.repair_phase("apply", d, u, v, w, bufs, flat[64 * 64:].view(64, 64))  # beside it
    print(f"check: {checked} repair kernel-vs-plain cases bitwise equal; {launches} stage / "
          f"apply launches alone equal their twins (staged rows, row scalars, hops; the "
          f"apply by vectors and by elements); an aliased out refused")


def phase_kernels(n: int, n_succ: int, s: int = 128):
    """Each launch kind alone at the main path's shapes: error vs its plain
    phase, median ms, plain ms, bound (a relaxation 2 fp32 operations, a
    successor one 3: add, compare, select, as the lowered rows count it)."""
    import torch

    from repro_torch.core.graph import random_digraph
    from repro_torch.core.paths import _init_successors
    from repro_torch.core.semiring import MIN_PLUS
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref

    rows = {}
    dev = torch.device("cuda")
    record = functools.partial(record_kernel, rows)

    # --- fw_round at (n, n), pivot round b
    T = n // s
    b = T // 2
    o = slice(b * s, (b + 1) * s)
    w = torch.from_numpy(random_digraph(n, density=0.5, seed=1)).to(dev)
    bands = fr.round_buffers(w, s)
    kw = dict(block_size=s, semiring=MIN_PLUS)

    fr.fw_round_phase("diag", w, b, bands, **kw)
    diag = ref.close_diag(w[o, o], MIN_PLUS)
    sync()
    require(same(bands[0][0, :, o], diag) and same(bands[1][0, o, :], diag),
            "diag launch != plain close_diag")
    record("fw_round/diag", max_abs_err(bands[0][0, :, o], diag),
           event_ms(lambda: fr.fw_round_phase("diag", w, b, bands, **kw), 11),
           event_ms(lambda: ref.close_diag(w[o, o], MIN_PLUS), 3),
           2.0 * s**3, 2 * s * s * 4)

    fr.fw_round_phase("bands", w, b, bands, **kw)
    row, col = ref.close_bands(w, diag, b, MIN_PLUS)
    sync()
    require(same(bands[0][0], row) and same(bands[1][0], col),
            "bands launch != plain close_bands")
    tiles = 2 * (T - 1)
    record("fw_round/bands", max(max_abs_err(bands[0][0], row), max_abs_err(bands[1][0], col)),
           event_ms(lambda: fr.fw_round_phase("bands", w, b, bands, **kw), 11),
           event_ms(lambda: ref.close_bands(w, diag, b, MIN_PLUS), 3),
           2.0 * tiles * s**3, (s * s + 2 * tiles * s * s) * 4)

    wk = w.clone()
    fr.fw_round_phase("relax", wk, b, bands, **kw)
    want = ref.relax(w, row, col, b, semiring=MIN_PLUS)
    sync()
    require(same(wk, want), "relax launch != plain relax")
    record("fw_round/relax", max_abs_err(wk, want),
           event_ms(lambda: fr.fw_round_phase("relax", wk, b, bands, **kw), 5),
           event_ms(lambda: ref.relax(w, row, col, b, semiring=MIN_PLUS), 1),
           2.0 * n * n * s, (2 * n * n + 2 * n * s) * 4)
    del w, wk, want, bands

    # --- fw_round_with_successors at (n_succ, n_succ); words are f32 + i32
    T = n_succ // s
    b = T // 2
    o = slice(b * s, (b + 1) * s)
    w = torch.from_numpy(random_digraph(n_succ, density=0.5, seed=2)).to(dev)
    succ = _init_successors(w).contiguous()
    bands = fr.succ_round_buffers(w, s)
    fr.fw_round_with_successors_phase("diag", w, succ, b, bands, block_size=s)
    diag, dsucc = ref.close_diag_succ(w[o, o], succ[o, o])
    sync()
    require(same(bands[0][0, :, o], diag) and same(bands[2][0, :, o], dsucc)
            and same(bands[1][0, o, :], diag) and same(bands[3][0, o, :], dsucc),
            "successor diag launch != plain")
    record("fw_round_with_successors/diag", max_abs_err(bands[0][0, :, o], diag),
           event_ms(lambda: fr.fw_round_with_successors_phase(
               "diag", w, succ, b, bands, block_size=s), 11),
           event_ms(lambda: ref.close_diag_succ(w[o, o], succ[o, o]), 3),
           3.0 * s**3, 2 * s * s * 8)

    fr.fw_round_with_successors_phase("bands", w, succ, b, bands, block_size=s)
    want_b = ref.close_bands_succ(w, succ, diag, dsucc, b)
    sync()
    got_b = tuple(t[0] for t in bands)
    require(all(same(g, x) for g, x in zip(got_b, (want_b[0], want_b[2],
                                                           want_b[1], want_b[3]))),
            "successor bands launch != plain")
    tiles = 2 * (T - 1)
    record("fw_round_with_successors/bands",
           max(max_abs_err(got_b[0], want_b[0]), max_abs_err(got_b[1], want_b[2])),
           event_ms(lambda: fr.fw_round_with_successors_phase(
               "bands", w, succ, b, bands, block_size=s), 11),
           event_ms(lambda: ref.close_bands_succ(w, succ, diag, dsucc, b), 3),
           3.0 * tiles * s**3, (s * s + 2 * tiles * s * s) * 8)

    wk, sk = w.clone(), succ.clone()
    fr.fw_round_with_successors_phase("relax", wk, sk, b, bands, block_size=s)
    wd, ws = ref.relax_succ_tiles(w, succ, *want_b, b)
    sync()
    require(same(wk, wd) and same(sk, ws), "successor relax launch != plain")
    record("fw_round_with_successors/relax", max_abs_err(wk, wd),
           event_ms(lambda: fr.fw_round_with_successors_phase(
               "relax", wk, sk, b, bands, block_size=s), 5),
           event_ms(lambda: ref.relax_succ_tiles(w, succ, *want_b, b), 1),
           3.0 * n_succ * n_succ * s, (2 * n_succ * n_succ + 2 * n_succ * s) * 8)
    return rows


def phase_main(rows: dict, n: int, n_succ: int, s: int = 128):
    import torch

    from repro_torch.apsp import solve
    from repro_torch.core.graph import random_digraph
    from repro_torch.core.semiring import MIN_PLUS
    from repro_torch.kernels import fw_round as fr

    dev = torch.device("cuda")
    w = torch.from_numpy(random_digraph(n, density=0.5, seed=0)).to(dev)
    ws = torch.from_numpy(random_digraph(n_succ, density=0.5, seed=3)).to(dev)

    fr.reset_launch_counts()
    res = solve(w)
    res_s = solve(ws, successors=True)
    sync()
    counts = dict(fr.LAUNCHES)
    print(f"main path launch counts: {json.dumps(counts)}")
    for kind in fr.KINDS:
        if kind.startswith("fw_round_bordered/") or kind in lowered_kinds():
            continue  # the distributed path's (phase_dist), the lowered path's
        rows[kind]["launches"] = counts[kind]
        require(counts[kind] > 0, f"{kind} was not launched on the main path")
    require(res.method == "fused" and res.block_size == s, f"solve took {res.method}")

    d = res.dist
    require(d.shape == (n, n) and bool(torch.isfinite(d).all()), "n=8192 dist not finite")
    require(bool((torch.diagonal(d) == 0).all()) and bool((d <= w).all()),
            "n=8192 dist is not a min-plus closure of w")
    t0 = time.perf_counter()
    want = plain_solve(w, block_size=s, semiring=MIN_PLUS)
    sync()
    t_plain = (time.perf_counter() - t0) * 1e3
    require(same(d, want), f"solve n={n} != plain round loop")
    del want
    t0 = time.perf_counter()
    want_d, want_s = plain_solve_succ(ws, block_size=s)
    sync()
    t_plain_s = (time.perf_counter() - t0) * 1e3
    require(same(res_s.dist, want_d) and same(res_s.succ, want_s),
            f"solve(successors=True) n={n_succ} != plain round loop")
    del want_d, want_s

    def report(label, nn, fn, plain_ms, word):
        fn()  # warm-up
        times = [host_ms(fn) for _ in range(3)]
        ms = statistics.median(times)
        ops = 2.0 * nn**3
        nbytes = (nn // s) * 2.0 * nn * nn * word
        bms, by = bound(ops, nbytes)
        print(f"main {label}: median {ms:.2f} ms of {['%.2f' % t for t in times]}, "
              f"{nn**3 / (ms / 1e3):.4e} relaxations/s, bound {bms:.2f} ms by {by} "
              f"({100 * bms / ms:.1f}% of it), plain {plain_ms:.0f} ms")
        return ms

    report(f"solve n={n} min_plus f32", n, lambda: solve(w), t_plain, 4)
    report(f"solve n={n_succ} successors=True", n_succ,
           lambda: solve(ws, successors=True), t_plain_s, 8)
    bands = fr.round_buffers(w, s)
    wk = w.clone()
    launch_breakdown(f"main breakdown n={n}", [
        (p, functools.partial(fr.fw_round_phase, p, wk, b, bands, block_size=s))
        for b in range(n // s) for p in fr.PHASES])


def launch_breakdown(label: str, steps) -> None:
    """Where a launch sequence's device time goes: ``steps`` is [(kind,
    launch)] in order, with a CUDA event before each launch and after the
    last; the time between events is summed by kind (each share includes
    the gap after its launch)."""
    import torch

    ev = []
    sync()
    for _, launch in steps:
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()
        launch()
    ev.append(torch.cuda.Event(enable_timing=True))
    ev[-1].record()
    sync()
    per: dict[str, float] = {}
    for (kind, _), a, b in zip(steps, ev, ev[1:]):
        per[kind] = per.get(kind, 0.0) + a.elapsed_time(b)
    span = ev[0].elapsed_time(ev[-1])
    parts = ", ".join(f"{p} {t:.2f} ms ({100 * t / span:.1f}%)" for p, t in per.items())
    print(f"{label} (events between launches; each share includes the gap after "
          f"it): {parts}; span {span:.2f} ms")


def host_device_split(label: str, fn, launches: int) -> None:
    """Whether the host or the device sets the pace of ``fn`` (a sequence
    of ``launches`` launches that returns once they are queued, far fewer
    than the queue holds): its host time, from the call until it returns
    (median of 3; the device is idle at the call), a launch; its device
    time by kernel kind (diag, panels, relax, other; the sum of the
    kernels' times in a ``torch.profiler`` trace of one call); and its wall
    time to a synchronize, of which the device is idle for 1 - device /
    wall."""
    from repro_torch.launch.round_bench import device_by_kind

    fn()
    host = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        sync()
    t_host = statistics.median(host)
    t_wall = statistics.median(host_ms(fn) for _ in range(3))
    per = device_by_kind(fn)
    dev = sum(per.values())
    parts = ", ".join(f"{k} {v:.3f} ms" for k, v in per.items())
    print(f"{label}: host {t_host:.3f} ms to queue {launches} launches "
          f"({1e3 * t_host / launches:.1f} us a launch); device {dev:.3f} ms ({parts}); wall "
          f"{t_wall:.3f} ms, device idle {100 * (1 - dev / t_wall):.1f} %: "
          f"{'host' if t_host > dev else 'device'}-bound")


def repair_work(E: int, n: int, word: int, ops: float, *, apply_ops: float | None = None,
                succ: bool = False):
    """(operations, bytes) of a repair's stage and apply launches, each input
    read once and each output written once: the stage reads the E pivot
    rows and the E x E and n x E gathers and writes the staged rows and the
    row scalars (with next hops the n x E hop gathers and the hops too),
    E(E-1)/2 relaxations a column and a row; the apply reads d, the staged
    rows and the scalars (the hops, succ) and writes out (succ_out), E
    relaxations an element.  ``ops`` a relaxation (``apply_ops`` in the
    apply, where it relaxes on lifted operands: an add and a min), ``word``
    the storage's bytes."""
    hop = 4 if succ else 0
    apply_ops = ops if apply_ops is None else apply_ops
    stage = (ops * E * (E - 1) * n, (3 * E * n + E * E) * word + 2 * E * n * hop)
    apply = (apply_ops * E * n * n, 2 * n * n * (word + hop) + 2 * E * n * word + E * n * hop)
    return stage, apply


def timed_repair_errors(d, sr, u, v, w, bufs, out, succ=None, sout=None):
    """max_abs_err of the stage and the apply where the timed launches left
    their outputs: the staged rows and row scalars in ``bufs`` (with
    ``succ``, the hops too) and ``out`` (``sout``), against their plain
    twins on the same inputs; fails unless every one agrees by bits."""
    from repro_torch.kernels import ref

    strict = succ is not None
    what = f"fw_repair{'_with_successors' if strict else ''}[{d.dtype}] timed launch"
    staged = ref.repair_stage_ref(d, u, v, w, semiring=sr, strict=strict)
    scal, hops = ref.repair_scalars_ref(d, staged, u, v, w, semiring=sr, succ=succ)
    if succ is None:
        want = ref.repair_apply_ref(d, staged, u, w, semiring=sr)
    else:
        want, wsucc = ref.repair_apply_succ_ref(d, succ, staged, u, v, w)
    sync()
    require(same(bufs.staged, staged) and same(bufs.scalars, scal)
            and (succ is None or same(bufs.hops, hops)), f"{what}: stage != plain")
    require(same(out, want) and (succ is None or same(sout, wsucc)), f"{what}: apply != plain")
    return (max(max_abs_err(bufs.staged, staged), max_abs_err(bufs.scalars, scal)),
            max_abs_err(out, want))


def phase_kernels_repair(rows: dict, n: int, n_succ: int, E: int = 16):
    """Each repair launch kind alone at the engine path's shapes (E = 16
    edges; n for fw_repair, n_succ for the successor twin) against the
    plain version of its phase, events and device time
    (``round_bench.device_ms``), its error read from the timed launches'
    own outputs (``timed_repair_errors``); the plus_mul apply beside
    ``torch.addmm(d, scalars, staged)`` (TF32 off), the one PyTorch call
    computing its function.  Bound: ``repair_work``, a relaxation 2 fp32
    operations (successors 3)."""
    import torch

    from repro_torch.core.graph import random_digraph
    from repro_torch.core.paths import _init_successors
    from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
    from repro_torch.kernels import fw_repair as fp
    from repro_torch.kernels import ref
    from repro_torch.launch.round_bench import device_ms

    dev = torch.device("cuda")
    record = functools.partial(record_kernel, rows)
    d = torch.from_numpy(random_digraph(n, density=0.5, seed=4)).to(dev)
    u, v, w = fp.edge_vectors(*repair_edges("min_plus", n, E, seed=16), n, dev)
    bufs = fp.repair_buffers(d, E)
    out = torch.empty_like(d)
    stage_w, apply_w = repair_work(E, n, 4, 2.0)
    check_repair_phases(d, MIN_PLUS, u, v, w)
    stage = lambda: fp.repair_phase("stage", d, u, v, w, bufs)  # noqa: E731
    apply = lambda: fp.repair_phase("apply", d, u, v, w, bufs, out)  # noqa: E731
    stage()
    ms_s, dev_s = event_ms(stage, 11), device_ms(stage)
    ms_a, dev_a = event_ms(apply, 11), device_ms(apply)
    err_s, err_a = timed_repair_errors(d, MIN_PLUS, u, v, w, bufs, out)
    record("fw_repair/stage", err_s, ms_s,
           event_ms(lambda: ref.repair_stage_ref(d, u, v, w), 3), *stage_w,
           note=f" n={n} E={E}, device {dev_s:.4f} ms")
    record("fw_repair/apply", err_a, ms_a,
           event_ms(lambda: ref.repair_apply_ref(d, bufs.staged, u, w), 3), *apply_w,
           note=f" n={n} E={E}, device {dev_a:.4f} ms")
    # plus_mul beside torch.addmm(d, scalars, staged): the same rank-E update
    dp = torch.from_numpy(graph("plus_mul", (n, n), 5)).to(dev)
    up, vp, wp = fp.edge_vectors(*repair_edges("plus_mul", n, E, seed=17), n, dev)
    check_repair_phases(dp, PLUS_MUL, up, vp, wp)
    fp.repair_phase("stage", dp, up, vp, wp, bufs, semiring=PLUS_MUL)
    apply_pm = lambda: fp.repair_phase("apply", dp, up, vp, wp, bufs, out,  # noqa: E731
                                       semiring=PLUS_MUL)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = torch.empty_like(dp)
    addmm = lambda: torch.addmm(dp, bufs.scalars, bufs.staged, out=lib)  # noqa: E731
    lib_ms, lib_dev = event_ms(addmm, 11), device_ms(addmm)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    ms_a, dev_a = event_ms(apply_pm, 11), device_ms(apply_pm)
    _, err_a = timed_repair_errors(dp, PLUS_MUL, up, vp, wp, bufs, out)
    record("fw_repair/apply", err_a, ms_a,
           event_ms(lambda: ref.repair_apply_ref(dp, bufs.staged, up, wp, semiring=PLUS_MUL), 3),
           *apply_w, note=f" plus_mul n={n} E={E}, device {dev_a:.4f} ms; "
           f"torch.addmm device {lib_dev:.4f} ms", store=False, library=lib_ms)
    del d, dp, out, lib, bufs

    d = torch.from_numpy(random_digraph(n_succ, density=0.5, seed=5)).to(dev)
    succ = _init_successors(d).contiguous()
    u, v, w = fp.edge_vectors(*repair_edges("min_plus", n_succ, E, seed=17), n_succ, dev)
    check_repair_phases(d, MIN_PLUS, u, v, w, succ=succ)
    bufs = fp.repair_buffers(d, E, successors=True)
    out, sout = torch.empty_like(d), torch.empty_like(succ)
    stage_w, apply_w = repair_work(E, n_succ, 4, 3.0, succ=True)
    stage = lambda: fp.repair_succ_phase("stage", d, succ, u, v, w, bufs)  # noqa: E731
    apply = lambda: fp.repair_succ_phase("apply", d, succ, u, v, w, bufs, out, sout)  # noqa: E731
    stage()
    ms_s, dev_s = event_ms(stage, 11), device_ms(stage)
    ms_a, dev_a = event_ms(apply, 11), device_ms(apply)
    err_s, err_a = timed_repair_errors(d, MIN_PLUS, u, v, w, bufs, out, succ=succ, sout=sout)
    record("fw_repair_with_successors/stage", err_s, ms_s,
           event_ms(lambda: ref.repair_stage_ref(d, u, v, w, strict=True), 3), *stage_w,
           note=f" n={n_succ} E={E}, device {dev_s:.4f} ms")
    record("fw_repair_with_successors/apply", err_a, ms_a,
           event_ms(lambda: ref.repair_apply_succ_ref(d, succ, bufs.staged, u, v, w), 3),
           *apply_w, note=f" n={n_succ} E={E}, device {dev_a:.4f} ms")


def integer_graph(n: int, seed: int, *, hi: int, density: float):
    """``round_bench.integer_graph``: integer weights in [1, hi] at the
    given density, 0 diagonal."""
    from repro_torch.launch.round_bench import integer_graph as make

    return make(n, seed, hi=hi, density=density)


def improvements(dist, count: int, seed: int):
    """``round_bench.improvements``: ``count`` ⊕-improving link updates."""
    from repro_torch.launch.round_bench import improvements as make

    return make(dist, count, seed)


def updated(w, upd):
    """``round_bench.updated``: the weights a re-solve of the repair closes."""
    from repro_torch.launch.round_bench import updated as make

    return make(w, upd)


def tie_free_scenario(n: int, seed: int = 0):
    """The min-plus construction of ``launch/fw_serve.py:repair_scenario``
    (``round_bench.tie_free_graph``, a copy: this script imports nothing of
    the reference): large random integer weights make shortest paths
    unique, so next hops compare bitwise with a re-solve."""
    from repro_torch.launch.round_bench import tie_free_graph

    return tie_free_graph(n, seed), [(3, 7, 5.0), (n // 2, 2, 3.0), (1, n - 2, 17.0)]


def phase_engine(rows: dict, n: int, n_succ: int, graphs: int = 32):
    """This slice's main path: ``ApspEngine`` on the card.

    solve at n (integer weights in [1, 1e4], density 0.5), 16 improving
    link updates absorbed by ``repair``; a successor solve at n_succ and
    its successor repair; the tie-free successor repair at n = 512; and
    ``solve_many`` of ``graphs`` ragged graphs with next hops.  The launch
    counts of that run are read, then every result is checked: the repair
    bitwise against a re-solve of the updated graph, the successor repair
    against its plain version and by walking 256 sampled paths, the
    tie-free case against a re-solve (dist and next hops), each bucketed
    result against a per-graph solve.  Then timed (host clock around work
    that ends in synchronize(), median of 3 after a warm-up)."""
    import numpy as np
    import torch

    from repro_torch.apsp import ApspEngine
    from repro_torch.core.graph import random_digraph
    from repro_torch.core.paths import extract_path, path_cost
    from repro_torch.kernels import fw_repair as fp
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref

    eng = ApspEngine()
    w = integer_graph(n, 10, hi=10**4, density=0.5)
    ws = integer_graph(n_succ, 12, hi=10**4, density=0.5)
    wt, upd_t = tie_free_scenario(512)
    rng = np.random.default_rng(14)
    sizes = rng.choice([300, 500, 512, 1000, 1024], size=graphs).tolist()
    many_in = [random_digraph(m, density=0.5, seed=100 + k) for k, m in enumerate(sizes)]

    fr.reset_launch_counts()
    fp.reset_launch_counts()
    r0 = eng.solve(w)
    upd = improvements(r0.dist, 64, seed=11)
    rep = eng.repair(r0.dist, upd[:16])
    s0 = eng.solve(ws, successors=True)
    upd_s = improvements(s0.dist, 16, seed=13)
    srep = eng.repair(s0.dist, upd_s, succ=s0.succ)
    t0 = eng.solve(wt, successors=True)
    trep = eng.repair(t0.dist, upd_t, succ=t0.succ)
    many = eng.solve_many(many_in, successors=True)
    sync()
    counts = {**fr.LAUNCHES, **fp.LAUNCHES}
    print(f"engine path launch counts: {json.dumps(counts)}")
    for kind in (k for k in fp.KINDS if k not in lowered_kinds()):
        require(counts[kind] > 0, f"{kind} was not launched on the engine path")
        rows[kind]["launches"] = counts[kind]

    r1 = eng.solve(updated(w, upd[:16]))
    require(same(rep.dist, r1.dist), f"repair n={n} != re-solve of the updated graph")
    u, v, x = (np.array(c) for c in zip(*upd_s))
    wd, wsucc = ref.fw_repair_with_successors_ref(s0.dist, s0.succ, u, v, x)
    require(same(srep.dist, wd) and same(srep.succ, wsucc),
            f"successor repair n={n_succ} != plain")
    ws1 = updated(ws, upd_s)
    dist, succ = srep.dist.cpu().numpy(), srep.succ.cpu().numpy()
    walked = 0
    for i, j in rng.integers(0, n_succ, (4 * 256, 2)):
        if walked == 256 or not np.isfinite(dist[i, j]) or i == j:
            continue
        path = extract_path(succ, int(i), int(j))
        require(path and path[0] == i and path[-1] == j and path_cost(ws1, path) == dist[i, j],
                f"successor repair: the walked path {i}->{j} does not cost dist")
        walked += 1
    require(walked == 256, f"only {walked} finite pairs sampled")
    t1 = eng.solve(updated(wt, upd_t), successors=True)
    require(same(trep.dist, t1.dist) and same(trep.succ, t1.succ),
            "tie-free successor repair n=512 != re-solve")
    for g, r in zip(many_in, many):
        one = eng.solve(g, successors=True)
        require(same(r.dist, one.dist) and same(r.succ, one.succ),
                f"solve_many n={r.n} != per-graph solve")
    print(f"engine checks: repair n={n} == re-solve bitwise; successor repair "
          f"n={n_succ} == plain, {walked} walked paths cost dist; tie-free n=512 "
          f"== re-solve (dist, succ); solve_many of {graphs} == per-graph")

    def timed(fn):
        fn()
        return statistics.median(host_ms(fn) for _ in range(3))

    # The re-solve takes the updated weights already on the card, as the
    # repair takes the closure there: neither time includes a host copy.
    w1 = torch.from_numpy(updated(w, upd[:16])).cuda()
    t_solve = timed(lambda: eng.solve(w1))
    for E in (4, 16, 64):
        t = timed(lambda: eng.repair(r0.dist, upd[:E]))
        print(f"engine repair n={n} E={E}: {t:.3f} ms; re-solve {t_solve:.2f} ms "
              f"({t_solve / t:.1f}x)")
    t = timed(lambda: eng.repair(s0.dist, upd_s, succ=s0.succ))
    ws1 = torch.from_numpy(ws1).cuda()
    t_s = timed(lambda: eng.solve(ws1, successors=True))
    print(f"engine repair n={n_succ} E=16 with successors: {t:.3f} ms; re-solve "
          f"{t_s:.2f} ms ({t_s / t:.1f}x)")
    t = timed(lambda: eng.solve_many(many_in, successors=True))
    hist = {m: sizes.count(m) for m in sorted(set(sizes))}
    print(f"engine solve_many {graphs} ragged graphs {hist} with successors, from "
          f"host arrays: {t:.2f} ms, {graphs / (t / 1e3):.1f} graphs/s "
          f"({eng.stats.hits} plan hits, {eng.stats.misses} misses)")


# ------------------------------------------------------ decremental repair
IDEMPOTENT = ("min_plus", "max_plus", "max_min", "or_and")


def strip_rows(n: int, a: int, seed: int):
    """a distinct affected rows, sorted and padded as the engine pads them:
    to min(max(8, next power of two), n) rows with the padding index n."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = np.full(min(max(8, 1 << (a - 1).bit_length()), n), n, np.int32)
    rows[:a] = np.sort(rng.choice(n, a, replace=False))
    return rows


def check_sweep_phases(d, rows, b: int, s: int, *, sr=None, succ=None):
    """Each launch kind of round b alone against its plain phase on the same
    inputs, from the strip as gathered; the relax on the tile its strip
    takes (``fw_repair_del.relax_height``), then on every other tile height
    (the short tile's 8 and 16 rows, the mainloop's 128) from the same
    strip.  Returns the sweep (its buffers after the round) and each kind's
    max abs error."""
    from repro_torch.core.semiring import MIN_PLUS
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import ref

    sr = sr or MIN_PLUS
    o = slice(b * s, (b + 1) * s)
    sw = fd.sweep_buffers(d, rows, block_size=s, s_init=succ)
    fn = "fw_repair_del_sweep" + ("" if succ is None else "_with_successors")
    if succ is None:
        launch = functools.partial(fd.sweep_phase, sw=sw, b=b, semiring=sr)
        diag = lambda: (ref.sweep_diag_ref(d, sw.strip, sw.rows, b, block_size=s,  # noqa: E731
                                           semiring=sr),)
        panels = lambda x: ref.sweep_panels_ref(d, sw.strip, sw.rows, *x, b, semiring=sr)  # noqa: E731
        relax = lambda strip, x: (ref.sweep_relax_ref(*strip, sw.rows, *x, b, semiring=sr),)  # noqa: E731
        bufs = lambda: ((sw.band[:, o],), (sw.band, sw.acol), (sw.strip,))  # noqa: E731
    else:
        launch = functools.partial(fd.sweep_succ_phase, sw=sw, b=b)
        diag = lambda: ref.sweep_diag_succ_ref(d, succ, sw.strip, sw.strip_s, sw.rows, b,  # noqa: E731
                                               block_size=s)
        panels = lambda x: ref.sweep_panels_succ_ref(  # noqa: E731
            d, succ, sw.strip, sw.strip_s, sw.rows, *x, b)
        relax = lambda strip, x: ref.sweep_relax_succ_ref(*strip, sw.rows, *x, b)  # noqa: E731
        bufs = lambda: ((sw.band[:, o], sw.band_s[:, o]),  # noqa: E731
                        (sw.band, sw.band_s, sw.acol, sw.acol_s), (sw.strip, sw.strip_s))
    errs = {}

    def held(phase, want, got):
        sync()
        require(all(same(g, x) for g, x in zip(got, want)), f"{fn}/{phase} b={b} != plain")
        errs[phase] = max(max_abs_err(g.float(), x.float()) for g, x in zip(got, want))
        return want

    launch("diag")
    x = held("diag", diag(), bufs()[0])
    launch("panels")
    x = held("panels", panels(x), bufs()[1])
    strip = tuple(t.clone() for t in bufs()[2])
    launch("relax")
    want = held("relax", relax(strip, x), bufs()[2])
    for h in (*fd.SHORT_HEIGHTS, fd.LONG_HEIGHT):
        if h != fd.relax_height(*sw.strip.shape):
            for t, t0 in zip(bufs()[2], strip):
                t.copy_(t0)
            launch("relax", height=h)
            sync()
            require(all(same(g, w) for g, w in zip(bufs()[2], want)),
                    f"{fn}/relax b={b} a={sw.strip.shape[0]} height {h} != plain")
    return sw, errs


def phase_check_repair_del():
    """The sweep kernels bitwise against their plain versions on the card:
    the four idempotent semirings at n=1024 (s=128) with a in {1, 5, 37,
    200} affected rows padded as the engine pads them (n == m, so the
    padding rows gather the real row 1023), each launch kind alone in the
    round that holds the first affected row and the whole sweep; the
    successor sweep likewise; and ``ApspEngine.repair_del`` at n=1000
    (padded to 1024) on the card against the engine's plain path on the
    CPU, with and without next hops."""
    import torch

    from repro_torch.apsp import ApspEngine
    from repro_torch.core.paths import _init_successors
    from repro_torch.core.semiring import SEMIRINGS
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import ref
    from repro_torch.launch.round_bench import deletion_batch, ranked_deletions

    dev = torch.device("cuda")
    n, s, checked = 1024, 128, 0
    for name in IDEMPOTENT:
        sr = SEMIRINGS[name]
        d = torch.from_numpy(graph(name, (n, n), 21)).to(dev)
        for a in (1, 5, 37, 200):
            rows = strip_rows(n, a, seed=a)
            check_sweep_phases(d, rows, int(rows[0]) // s, s, sr=sr)
            got = fd.fw_repair_del_sweep(d, rows, block_size=s, semiring=sr)
            want = ref.fw_repair_del_sweep_ref(d, rows, block_size=s, semiring=sr)
            sync()
            require(same(got, want), f"fw_repair_del_sweep {name} n={n} a={a} != plain")
            checked += 1
    d = torch.from_numpy(graph("min_plus", (n, n), 22)).to(dev)
    succ = _init_successors(d).contiguous()
    for a in (1, 5, 37, 200):
        rows = strip_rows(n, a, seed=a + 1)
        check_sweep_phases(d, rows, int(rows[0]) // s, s, succ=succ)
        gd, gs = fd.fw_repair_del_sweep_with_successors(d, succ, rows, block_size=s)
        wd, ws = ref.fw_repair_del_sweep_with_successors_ref(d, succ, rows, block_size=s)
        sync()
        require(same(gd, wd) and same(gs, ws),
                f"fw_repair_del_sweep_with_successors n={n} a={a} != plain")
        checked += 1
    w = integer_graph(1000, 23, hi=10**4 - 1, density=0.5)
    eng, host = ApspEngine(), ApspEngine(device="cpu")
    r0 = eng.solve(w, successors=True)
    dels, w1 = deletion_batch(w, ranked_deletions(w, r0.dist, 8, seed=24))
    for succ in (None, r0.succ):
        got = eng.repair_del(r0.dist, w1, dels, succ=succ, threshold=100.0)
        want = host.repair_del(r0.dist.cpu(), w1, dels, threshold=100.0,
                               succ=None if succ is None else succ.cpu())
        require(got.padded_n == 1024 and got.method == "repair_del"
                and same(got.dist.cpu(), want.dist)
                and (succ is None or same(got.succ.cpu(), want.succ)),
                "engine repair_del n=1000 on the card != plain on the CPU")
        checked += 1
    require(eng.stats.repair_dels == host.stats.repair_dels == 2, "n=1000 repair_del did not sweep")
    print(f"check: {checked} sweep kernel-vs-plain cases bitwise equal")


def phase_kernels_repair_del(rows: dict, n: int, n_succ: int, s: int = 128):
    """Each sweep launch kind alone at the repair_del path's shapes, round
    T/2, a = 8 affected rows (the record), 64 and 256, and with next hops
    also a = n_succ (every row: the relax's long tile): checked against the
    plain version of its phase, then timed beside it.  Work: diag s³
    relaxations; panels (T-1)·s³ on the band and a·s² on the strip's pivot
    block column; relax a·n·s; 2 fp32 operations each.  Bytes: each input
    read once and each output written once (diag: the overlaid tile in and
    out; panels: the band and the strip's block column in and out, the diag
    in; relax: the strip in and out, acol and the band in); successors add
    an int32 word beside every f32 one (the relax reads the f32 band only)."""
    import torch

    from repro_torch.core.graph import random_digraph
    from repro_torch.core.paths import _init_successors
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    for nn, successors in ((n, False), (n_succ, True)):
        T, b = nn // s, nn // s // 2
        o = slice(b * s, (b + 1) * s)
        d = torch.from_numpy(random_digraph(nn, density=0.5, seed=6)).to(dev)
        succ = _init_successors(d).contiguous() if successors else None
        fn = "fw_repair_del_sweep" + ("_with_successors" if successors else "")
        word = 8 if successors else 4
        for a in (8, 64, 256) + ((nn,) if successors else ()):
            sw, errs = check_sweep_phases(d, strip_rows(nn, a, seed=30 + a), b, s, succ=succ)
            if successors:
                launch = functools.partial(fd.sweep_succ_phase, sw=sw, b=b)
                plain = {
                    "diag": lambda: ref.sweep_diag_succ_ref(
                        d, succ, sw.strip, sw.strip_s, sw.rows, b, block_size=s),
                    "panels": lambda: ref.sweep_panels_succ_ref(
                        d, succ, sw.strip, sw.strip_s, sw.rows, sw.band[:, o], sw.band_s[:, o], b),
                    "relax": lambda: ref.sweep_relax_succ_ref(
                        sw.strip, sw.strip_s, sw.rows, sw.band, sw.band_s, sw.acol, sw.acol_s, b),
                }
            else:
                launch = functools.partial(fd.sweep_phase, sw=sw, b=b)
                plain = {
                    "diag": lambda: ref.sweep_diag_ref(d, sw.strip, sw.rows, b, block_size=s),
                    "panels": lambda: ref.sweep_panels_ref(d, sw.strip, sw.rows, sw.band[:, o], b),
                    "relax": lambda: ref.sweep_relax_ref(sw.strip, sw.rows, sw.band, sw.acol, b),
                }
            work = {  # (operations, bytes)
                "diag": (2.0 * s**3, 2 * s * s * word),
                "panels": (2.0 * ((T - 1) * s**3 + a * s * s),
                           ((2 * T - 1) * s * s + 2 * a * s) * word),
                "relax": (2.0 * a * nn * s, (2 * a * nn + a * s) * word + s * nn * 4),
            }
            for phase in fd.PHASES:
                record_kernel(rows, f"{fn}/{phase}", errs[phase],
                              event_ms(lambda: launch(phase), 11), event_ms(plain[phase], 3),
                              *work[phase], note=f" n={nn} a={a}", store=a == 8)
        del d, succ, sw


def phase_engine_repair_del(rows: dict, n: int, n_succ: int):
    """This slice's path: ``ApspEngine.repair_del`` on the card.

    At n (min-plus, integer weights in [1, 1e4), density 0.5): 256 on-path
    edges ranked by the pairs they affect; E = 1 (the fewest), E = 16 (the
    16 fewest) and E = 1 of the median-ranked edge (the typical deletion,
    tens to hundreds of affected rows) deleted with threshold=100, so that
    the sweep runs; the E = 16 batch again at threshold=0, which the policy
    refuses (the counted re-solve through the round kernels).  At n_succ,
    the tie-free construction with next hops, E = 16 likewise.  A plus_mul
    deletion (its counted re-solve) and an off-path deletion (a no-op that
    builds no sweep plan).  The sweep and round launch counts of that run
    are read; then every result is checked bitwise against a re-solve of
    the updated graph on the card, and timed (host clock around work that
    ends in synchronize(), median of 3 after a warm-up) beside that
    re-solve, with the marking and the sweep also timed alone."""
    import numpy as np
    import torch

    from repro_torch.apsp import ApspEngine, plan
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import fw_round as fr
    from repro_torch.launch.round_bench import deletion_batch, marked_sweep, ranked_deletions

    eng = ApspEngine()
    w = integer_graph(n, 10, hi=10**4 - 1, density=0.5)
    r0 = eng.solve(w)
    ranked = ranked_deletions(w, r0.dist, 256, seed=15)
    batches = {"E=1": deletion_batch(w, ranked[:1]), "E=16": deletion_batch(w, ranked[:16]),
               "E=1 median": deletion_batch(w, ranked[len(ranked) // 2:][:1])}
    ws, _ = tie_free_scenario(n_succ, seed=16)
    s0 = eng.solve(ws, successors=True)
    dels_s, ws1 = deletion_batch(ws, ranked_deletions(ws, s0.dist, 16, seed=17))
    pm = ApspEngine(semiring="plus_mul")
    wp = graph("plus_mul", (512, 512), 24)
    p0 = pm.solve(wp)
    wp1 = wp.copy()
    wp1[3, 7] = 0.0
    d0 = r0.dist.cpu().numpy()
    u_off, v_off = next((int(u), int(v)) for u, v in np.argwhere(np.isfinite(w) & (w > d0))
                        if u != v)
    w_off = w.copy()
    w_off[u_off, v_off] = np.inf
    fresh = ApspEngine()

    fd.reset_launch_counts()
    fr.reset_launch_counts()
    reps = {label: eng.repair_del(r0.dist, w1, dels, threshold=100.0)
            for label, (dels, w1) in batches.items()}
    refused = eng.repair_del(r0.dist, batches["E=16"][1], batches["E=16"][0], threshold=0.0)
    srep = eng.repair_del(s0.dist, ws1, dels_s, succ=s0.succ, threshold=100.0)
    prep = pm.repair_del(p0.dist, wp1, [(3, 7, float(wp[3, 7]))])
    noop = fresh.repair_del(r0.dist, w_off, [(u_off, v_off, float(w[u_off, v_off]))])
    sync()
    counts = dict(fd.LAUNCHES)
    round_counts = {k: fr.LAUNCHES[k] for k in fr.KINDS if k.startswith("fw_round/")
                    and k not in lowered_kinds()}
    print(f"repair_del path launch counts: {json.dumps(counts)}; round launches of its "
          f"re-solves (min_plus threshold 0, plus_mul): {json.dumps(round_counts)}")
    for kind in (k for k in fd.KINDS if k not in lowered_kinds()):
        require(counts[kind] > 0, f"{kind} was not launched on the repair_del path")
        rows[kind]["launches"] = counts[kind]
    for kind, count in round_counts.items():
        require(count > 0, f"{kind} was not launched by the repair_del path's re-solves")

    for label, (dels, w1) in batches.items():
        require(same(reps[label].dist, eng.solve(w1).dist),
                f"repair_del n={n} {label} != re-solve of the updated graph")
    require(refused.method != "repair_del"
            and same(refused.dist, eng.solve(batches["E=16"][1]).dist),
            f"repair_del n={n} E=16 at threshold 0 != its re-solve")
    r1 = eng.solve(ws1, successors=True)
    require(same(srep.dist, r1.dist) and same(srep.succ, r1.succ),
            f"successor repair_del n={n_succ} != re-solve (dist, succ)")
    require(pm.stats.repair_del_fallbacks == 1 and pm.stats.repair_dels == 0
            and same(prep.dist, pm.solve(wp1).dist), "plus_mul repair_del != its counted re-solve")
    require(fresh.stats.repair_del_noops == 1 and same(noop.dist, r0.dist)
            and not any(k.method == "repair_del" for k in fresh._cache),
            "off-path repair_del was not a no-op")
    require(eng.stats.repair_dels == 4 and eng.stats.repair_del_fallbacks == 1,
            "a repair_del of the path did not take the arm its threshold sets")
    print(f"repair_del checks: n={n} E=1, E=16 and the median-ranked E=1 == re-solve "
          f"bitwise; E=16 at threshold 0 re-solved (counted); successors n={n_succ} "
          f"E=16 == re-solve (dist, succ); plus_mul re-solved (counted); off-path "
          f"deletion a no-op with no sweep plan")

    def timed(fn):
        fn()
        return statistics.median(host_ms(fn) for _ in range(3))

    def report(label, nn, dist, w1, dels, succ=None):
        # Weights and tables already on the card: no time includes a host copy.
        w1 = torch.from_numpy(w1).cuda()
        E = len(dels)
        mark, sweep, sw, cnt = marked_sweep(dist, w1, dels, succ=succ)
        a = int((sw.rows < nn).sum())
        before = dict(fd.LAUNCHES)
        if succ is None:
            rep = lambda: eng.repair_del(dist, w1, dels, threshold=100.0)  # noqa: E731
            solve = lambda: eng.solve(w1)  # noqa: E731
        else:
            rep = lambda: eng.repair_del(dist, w1, dels, succ=succ, threshold=100.0)  # noqa: E731
            solve = lambda: eng.solve(w1, successors=True)  # noqa: E731
        rep()
        sync()
        per = sum(fd.LAUNCHES[k] - before[k] for k in fd.KINDS)
        t_rep, t_solve, t_mark, t_sweep = (timed(f) for f in (rep, solve, mark, sweep))
        decide = plan.should_repair_del(nn, a, edges=E, successors=succ is not None)
        print(f"engine repair_del {label}: a={a} affected rows, {cnt} affected pairs "
              f"({cnt / nn**2:.3e} of n²), should_repair_del at the default "
              f"threshold: {decide}, {per} sweep launches; {t_rep:.3f} ms (mark "
              f"{t_mark:.3f} ms, sweep {t_sweep:.3f} ms); re-solve {t_solve:.2f} ms "
              f"({t_solve / t_rep:.1f}x)")
        phase = fd.sweep_phase if succ is None else fd.sweep_succ_phase
        launch_breakdown(f"sweep breakdown {label}", [
            (p, functools.partial(phase, p, sw, b)) for b in range(nn // 128) for p in fd.PHASES])
        host_device_split(f"sweep host / device {label}", sweep, 3 * (nn // 128))

    for label, (dels, w1) in batches.items():
        report(f"n={n} {label}", n, r0.dist, w1, dels)
    report(f"n={n_succ} E=16 with successors", n_succ, s0.dist, ws1, dels_s, succ=s0.succ)


# ------------------------------------------------------------------ serving
def profiled(fn) -> dict:
    """``round_bench.profiled``: fn() under ``torch.profiler``, its wall
    time, kernels by name, copies and device busy time."""
    from repro_torch.launch.round_bench import profiled as run

    return run(fn)


def serve_refresh(label: str, router, h2d: int, d2h) -> dict:
    """One ``router.refresh()`` under ``profiled``: its wall time, its
    kernels' device time by name, the device time of its copies to and from
    the card (the bytes are the tables and weights the arm hands across,
    ``h2d`` / ``d2h``, the latter an int or a function read after the
    refresh; index vectors and masks not counted), the rest as host time,
    and the launches by kind."""
    from repro_torch.kernels import fw_repair as fp
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import fw_round as fr

    mods = (fr, fp, fd)
    before = [dict(m.LAUNCHES) for m in mods]
    arms0 = (router.solve_refreshes, router.repair_refreshes, router.repair_del_refreshes)
    prof = profiled(router.refresh)
    wall, kernels, copies, dev = prof["wall"], prof["kernels"], prof["copies"], prof["dev"]
    arms1 = (router.solve_refreshes, router.repair_refreshes, router.repair_del_refreshes)
    d2h = d2h() if callable(d2h) else d2h
    launched = {k: m.LAUNCHES[k] - b[k] for m, b in zip(mods, before) for k in m.KINDS
                if m.LAUNCHES[k] != b[k]}
    copy_ms = sum(copies.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    rate = lambda b, ms: b / ms / 1e6 if ms else float("nan")  # noqa: E731 — GB/s
    print(f"serve refresh {label}: arms (solve, repair, repair_del) {arms0} -> {arms1}; "
          f"wall {wall:.3f} ms (profiled); device kernels {dev:.3f} ms "
          f"({', '.join(f'{n} {t:.4f} ms x{c}' for n, (t, c) in top)}); copies to the card "
          f"{h2d} B in {copies['HtoD']:.3f} ms ({rate(h2d, copies['HtoD']):.2f} GB/s), from it "
          f"{d2h} B in {copies['DtoH']:.3f} ms ({rate(d2h, copies['DtoH']):.2f} GB/s), on it "
          f"{copies['DtoD']:.3f} ms; host (the rest) {wall - dev - copy_ms:.3f} ms; "
          f"launches {json.dumps(launched)}")
    return dict(wall=wall, dev=dev, copies=copies, kernels=kernels, launched=launched,
                h2d=h2d, d2h=d2h)


def _table_bytes(router, gids) -> int:
    return sum(router.snapshots.active(g).nbytes for g in gids)


def _weight_bytes(router, gids) -> int:
    return sum(router.registry.peek(g).nbytes for g in gids)


def _walked(router, gid: str, count: int, seed: int) -> int:
    """``count`` replies of ``gid`` whose walked path, summed in f32 along
    the current weights, costs what the reply says (unreachable: no path,
    cost inf)."""
    import numpy as np

    w = router.registry.peek(gid)
    n = w.shape[-1]
    rng = np.random.default_rng(seed)
    for src, dst in rng.integers(0, n, (count, 2)):
        r = router.query(gid, int(src), int(dst))
        if not r.reachable:
            require(src != dst and np.isinf(r.cost), f"serve: {gid} {src}->{dst} no path "
                    f"but cost {r.cost}")
            continue
        require(r.path[0] == src and r.path[-1] == dst, f"serve: {gid} path {r.path} does "
                f"not join {src} to {dst}")
        c = np.float32(0)
        for a, b in zip(r.path, r.path[1:]):
            c = np.float32(c + w[a, b])
        require(c == np.float32(r.cost), f"serve: {gid} {src}->{dst} path costs {c}, the "
                f"reply {r.cost}")
    return count


def _hops_on_shortest_paths(w, dist, succ) -> bool:
    """Every next hop s = succ[i, j] of a reachable pair i != j starts a
    shortest path: w[i, s] + dist[s, j] == dist[i, j] (exact on integer
    weights whose sums stay under 2^24), and unreachable pairs have -1."""
    import torch

    n = w.shape[-1]
    fin = torch.isfinite(dist) & ~torch.eye(n, dtype=torch.bool, device=dist.device)
    s = succ.long().clamp(min=0)
    ok = (w.gather(1, s) + dist.gather(0, s) == dist) & (succ >= 0)
    return bool((ok | ~fin).all() and (succ[~torch.isfinite(dist)] == -1).all())


def phase_serve(rows: dict, n: int = 4096, graphs: int = 4, n_low: int = 8192,
                n_cmp: int = 256, n_mesh: int = 1024):
    """The serving path: ``repro_torch.serve.routing.RoutingEngine`` on the
    card, over the ported solve, repair and repair_del kernels (it adds no
    kernel; ``rows`` keeps its kernels' launches from their own paths).

    1. f32 router, method "auto" (fused), ``graphs`` tie-free graphs of n
       (``fw_serve.repair_scenario``: integer weights in [1, 1e6), 40 %
       edges): one refresh (one bucketed ``solve_many`` with next hops);
       ``fw_serve.run_load``'s mix (1000 calls, an ``update_edge`` every
       50, a quarter of the queries through ``submit`` / ``poll``,
       ``max_batch`` 16): QPS, p50 / p99 query latency; one more
       improvement's refresh (the repair arm); two ``fail_link``\\ s of
       on-path edges (the fewest-pairs one of g1, the median-ranked one of
       g2), each refreshed on the repair_del arm.  Every published dist ==
       the engine's card re-solve of the current weights by bits; 64
       walked replies a graph cost, summed in f32, what the reply says.
       The round, successor repair and successor sweep kinds each launched
       on this path (counts set to 0 before it, read after).
    2. int16 router, distance-only: one graph of n_low (integer weights in
       [1, 16], 2 % edges): refresh, 8 improvements, 1 ``fail_link``; the
       published table == the card re-solve by bits; the int16 round,
       repair and sweep kinds launched.
    3. Card against host: ``fw_serve.serve_log`` at n_cmp (4 graphs, 400
       calls) through a card router and a ``device="cpu"`` one: tables,
       replies and counters equal (``fw_serve.replay``).
    4. Mesh router: a 1×1 grid (``launch/mesh.py:run_grid``) at n_mesh,
       an improvement and a link failure refreshed: its table == the
       single-card fused solve by bits.

    Each refresh arm's wall, device, copy and host time is printed
    (``serve_refresh``), with the card's name and power limit printed by
    ``phase_device``."""
    import numpy as np
    import torch

    from repro_torch.apsp import ApspEngine
    from repro_torch.core.semiring import I16_INF
    from repro_torch.kernels import fw_repair as fp
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import fw_round as fr
    from repro_torch.launch import fw_dist_check as fdc
    from repro_torch.launch import fw_serve
    from repro_torch.launch.mesh import run_grid
    from repro_torch.launch.round_bench import integer_graph, ranked_deletions
    from repro_torch.serve.routing import RoutingEngine
    from repro_torch.serve.snapshot import host_values

    t_phase = time.perf_counter()
    gids = [f"g{i}" for i in range(graphs)]
    router = RoutingEngine(max_batch=16)
    for i, g in enumerate(gids):
        router.add_graph(g, fw_serve.repair_scenario("min_plus", n, seed=i)[0])
    for m in (fr, fp, fd):
        m.reset_launch_counts()
    arms = {"solve_many": serve_refresh(f"f32 solve_many B={graphs} n={n} with next hops",
                                        router, _weight_bytes(router, gids),
                                        lambda: _table_bytes(router, gids))}
    require(router.solve_refreshes == graphs and router.engine.stats.solves == 1,
            "serve: the first refresh was not one bucketed solve_many")
    t0 = time.perf_counter()
    load = fw_serve.run_load(router=router, graphs=graphs, n=n, queries=1000,
                             update_every=50, seed=7)
    print(f"serve load n={n}, {graphs} graphs: {json.dumps(load)} "
          f"({time.perf_counter() - t0:.1f} s)")
    print(f"serve: QPS {load['qps']:.1f}, query latency p50 {load['p50_us']:.1f} us, "
          f"p99 {load['p99_us']:.1f} us")
    require(load["repair_refreshes"] > 0, "serve: the load took no repair refresh")
    print(f"serve: f32 router set up, refreshed and loaded ({time.perf_counter() - t_phase:.1f} s)")
    router.refresh()
    u, v = 5, n - 9
    require(router.update_edge("g0", u, v, 1.0), "serve: the improvement changed nothing")
    snap_b = _table_bytes(router, ["g0"])
    arms["repair"] = serve_refresh(f"f32 repair n={n} E=1 with next hops", router,
                                   snap_b, snap_b)
    require(router.engine.stats.repairs > load["engine_repairs"], "serve: no repair ran")
    for g, pick in (("g1", 0), ("g2", None)):
        snap = router.snapshots.active(g)
        ranked = ranked_deletions(router.registry.peek(g), snap.dist, 64, seed=31)
        _, u, v = ranked[pick if pick is not None else len(ranked) // 2]
        st = router.engine.stats
        sweeps, falls, rows0 = st.repair_dels, st.repair_del_fallbacks, st.repair_del_rows
        router.fail_link(g, int(u), int(v), symmetric=False)
        b = _table_bytes(router, [g])
        arms[f"repair_del {g}"] = serve_refresh(
            f"f32 repair_del n={n} {g} ({u}, {v}) with next hops", router,
            b + _weight_bytes(router, [g]), b)
        took = ("sweep" if router.engine.stats.repair_dels > sweeps else
                "re-solve" if router.engine.stats.repair_del_fallbacks > falls else "no-op")
        print(f"serve: fail_link {g} ({u}, {v}) took the repair_del arm, engine {took} "
              f"({st.repair_del_rows - rows0} affected rows)")
    require(router.repair_del_refreshes == 2, "serve: the link failures missed repair_del")
    require(router.engine.stats.repair_dels >= 1, "serve: no link failure swept")
    counts = {k: v for m in (fr, fp, fd) for k, v in m.LAUNCHES.items() if v}
    print(f"serve path launch counts: {json.dumps(counts)}")
    for kind in ([f"fw_round_with_successors/{p}" for p in fr.PHASES]
                 + ["fw_repair_with_successors/stage", "fw_repair_with_successors/apply"]
                 + [f"fw_repair_del_sweep_with_successors/{p}" for p in fd.PHASES]):
        require(counts.get(kind, 0) > 0, f"{kind} was not launched on the serving path")
    differ = 0
    for g in gids:
        snap = router.snapshots.active(g)
        wg = router.registry.weights_tensor(g).cuda()
        full = router.engine.solve(wg, successors=True)
        require(same(snap.dist_tensor(), full.dist.cpu()),
                f"serve: published {g} != the card re-solve of its weights")
        succ = snap.succ_tensor().cuda()
        require(_hops_on_shortest_paths(wg, full.dist, succ),
                f"serve: a published next hop of {g} is off every shortest path")
        differ += int((succ != full.succ).sum())
    walked = sum(_walked(router, g, 64, seed=40 + i) for i, g in enumerate(gids))
    print(f"serve checks: {graphs} published f32 tables == card re-solve by bits; every "
          f"published next hop starts a shortest path ({differ} of {graphs * n * n} differ "
          f"from the re-solve's: equal-cost ties, broken in another order); {walked} "
          f"replies walked, each costing its f32 path sum ({time.perf_counter() - t_phase:.1f} s)")
    del router

    for m in (fr, fp, fd):
        m.reset_launch_counts()
    eng16 = ApspEngine(dtype=torch.int16)
    r16 = RoutingEngine(engine=eng16)
    r16.add_graph("big", integer_graph(n_low, 60, hi=16, density=0.02))
    arms["solve int16"] = serve_refresh(f"int16 solve n={n_low}", r16,
                                        _weight_bytes(r16, ["big"]),
                                        lambda: _table_bytes(r16, ["big"]))
    snap = r16.snapshots.active("big")
    d = snap.dist
    rng = np.random.default_rng(63)
    upd = []
    while len(upd) < 8:
        u, v = (int(x) for x in rng.integers(0, n_low, 2))
        if u != v and 2 <= int(d[u, v]) < I16_INF:
            upd.append((u, v, float(int(d[u, v]) // 2)))
    for u, v, x in upd:
        require(r16.update_edge("big", u, v, x), "serve: an int16 improvement changed nothing")
    b = _table_bytes(r16, ["big"])
    arms["repair int16"] = serve_refresh(f"int16 repair n={n_low} E=8", r16, b, b)
    snap = r16.snapshots.active("big")
    _, u, v = ranked_deletions(r16.registry.peek("big"), host_values(snap.dist, snap.dtype),
                               16, seed=64)[0]
    r16.fail_link("big", int(u), int(v), symmetric=False)
    arms["repair_del int16"] = serve_refresh(f"int16 repair_del n={n_low} ({u}, {v})", r16,
                                             b + _weight_bytes(r16, ["big"]), b)
    require((r16.solve_refreshes, r16.repair_refreshes, r16.repair_del_refreshes)
            == (1, 1, 1), "serve: the int16 router missed an arm")
    full = eng16.solve(r16.registry.weights_tensor("big"))
    require(same(r16.snapshots.active("big").dist_tensor(), full.dist.cpu()),
            "serve: the int16 table != the card re-solve")
    counts = {k: v for m in (fr, fp, fd) for k, v in m.LAUNCHES.items() if v}
    print(f"serve int16 path launch counts: {json.dumps(counts)}")
    require(eng16.stats.repair_dels == 1, "serve: the int16 link failure did not sweep")
    for kind in ([f"fw_round/{p}[int16]" for p in fr.PHASES]
                 + ["fw_repair/stage[int16]", "fw_repair/apply[int16]"]
                 + [f"fw_repair_del_sweep/{p}[int16]" for p in fd.PHASES]):
        require(counts.get(kind, 0) > 0, f"{kind} was not launched on the int16 serving path")
    print(f"serve checks: int16 n={n_low} table after 8 improvements and a link failure == "
          f"card re-solve by bits (engine {eng16.stats.repair_dels} sweeps, "
          f"{eng16.stats.repair_del_fallbacks} re-solves; {time.perf_counter() - t_phase:.1f} s)")
    del r16, full

    t0 = time.perf_counter()
    log = fw_serve.serve_log(graphs=4, n=n_cmp, ops=400, seed=3)
    card, host = (fw_serve.replay(RoutingEngine(device=dv, max_batch=16, repair_threshold=100.0,
                                                clock=fw_serve.ticks()), log, seed=5)
                  for dv in ("cuda", "cpu"))
    require(card[0] == host[0] and card[2] == host[2],
            "serve: the card router's calls, counters or replies differ from the host's")
    require([(i, g, s.version) for i, g, s in card[1]]
            == [(i, g, s.version) for i, g, s in host[1]]
            and all(same(c.dist_tensor(), h.dist_tensor())
                    and same(c.succ_tensor(), h.succ_tensor())
                    for (*_, c), (*_, h) in zip(card[1], host[1])),
            "serve: a table published on the card differs from the host's")
    last = card[0][-1]
    print(f"serve card == host: n={n_cmp}, {len(log)} calls, {len(card[1])} tables and "
          f"{len(card[2])} batched replies equal by bits; arms {last['arms']}, engine "
          f"{json.dumps(last['stats'])}, batcher {last['batcher']} "
          f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    w, upd, _ = fw_serve.repair_scenario("min_plus", n_mesh, seed=70)
    w1 = w.copy()
    w1[upd[0][0], upd[0][1]] = min(w1[upd[0][0], upd[0][1]], upd[0][2])
    single = ApspEngine()
    d1 = single.solve(w1).dist
    _, u, v = ranked_deletions(w1, d1.cpu().numpy(), 16, seed=71)[0]
    case = dict(kind="router", graphs={"g0": w}, updates=[("g0", *upd[0])],
                failures=[("g0", int(u), int(v))])
    (res,) = run_grid(fdc.run_cases, 1, 1, device="cuda", args=([case],), timeout=300)
    w1[u, v] = np.inf
    require(same(res[0]["weights"]["g0"], w1), "serve: the mesh router's weights differ")
    require(res[0]["arms"] == (1, 1, 1) and same(res[0]["dists"]["g0"], single.solve(w1).dist),
            "serve: the 1x1 mesh router's table != the single-card fused solve")
    print(f"serve mesh: 1x1 grid router n={n_mesh} (solve, repair, repair_del refreshes "
          f"{res[0]['arms']}; {res[0]['sweeps']} sweep, {res[0]['fallbacks']} re-solve) == "
          f"single-card fused solve by bits ({time.perf_counter() - t0:.1f} s, spawn included)")
    print(f"serve phase: {time.perf_counter() - t_phase:.1f} s")
    return arms


# ------------------------------------------------- recursive / out of core
def phase_check_kleene():
    """The recursive (R-Kleene) schedule on the card, each case against its
    plain run on the CPU and the card's fused solve at the same block size,
    by bits: ``fw_kleene``'s executor on the five semirings at (n, s, leaf)
    = (128, 32, 32), (160, 32, 64) and (96, 32, 96) and on a (3, 96, 96)
    batch, through the device store and the pinned host store;
    ``solve(method="recursive")`` in int16, bf16, f16 and on 40 packed
    graphs, and the int16 / bf16 / f16 solves promoted out of core by a
    budget; n = 1024 at s = 128, leaf 256 in min-plus and plus_mul on both
    stores, with ``devices=[cuda:0]``, and with the card listed twice and
    three times (lanes of their own: the sweep's tiles alternate between
    copy streams, the ordering across lanes).  Every host store moves
    exactly ``plan.recursive_transfer_bytes`` each way, and every run's
    rise of peak device memory stays within
    ``plan.recursive_hbm_resident_bytes`` plus the s x s pivot tile."""
    import numpy as np
    import torch

    from repro_torch.apsp import DevicePanelStore, HostPanelStore, KleeneExecutor, plan, solve
    from repro_torch.core.semiring import SEMIRINGS
    from repro_torch.core.staged import fw_staged

    dev = torch.device("cuda")
    checked = 0
    t_phase = time.perf_counter()

    def run(w, sr, s, leaf, kind, devices=None):
        """One executor run on the card (``kind``: "host" or "device"
        store); returns the closed matrix on the CPU."""
        store = HostPanelStore(w, device=dev) if kind == "host" else DevicePanelStore(w.to(dev))
        ex = KleeneExecutor(semiring=sr, block_size=s, leaf=leaf, devices=devices)
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ex.run(store)
        got = store.result().cpu()
        sync()
        n, lead, word = w.shape[-1], (w.shape[0] if w.ndim == 3 else 1), w.element_size()
        lr = min(leaf, n) // s
        model = plan.recursive_hbm_resident_bytes(n, s, lr, word=word, batch=lead)
        # A lane beyond the first holds its own factors and ring on the card.
        P = lr * s
        model += (len(devices or [dev]) - 1) * (2 * P * n + 3 * P * P) * word * lead
        rise = torch.cuda.max_memory_allocated() - base
        require(rise <= model + lead * s * s * word,
                f"kleene {kind} store n={n}: device memory rose {rise} B, model {model}")
        if kind == "host":
            want = plan.recursive_transfer_bytes(n, s, lr, word=word, batch=lead)
            require((store.h2d_bytes, store.d2h_bytes) == want,
                    f"kleene host store n={n}: bytes {store.h2d_bytes} / {store.d2h_bytes} "
                    f"!= model {want}")
        return got

    def hold(w, sr, s, leaf, label, kinds=(("device", None), ("host", None))):
        nonlocal checked
        cpu = HostPanelStore(w, device="cpu")
        KleeneExecutor(semiring=sr, block_size=s, leaf=leaf).run(cpu)
        fused = fw_staged(w.to(dev), block_size=s, semiring=sr).cpu()
        require(same(cpu.result(), fused), f"kleene {label}: plain on the CPU != fused")
        for kind, devices in kinds:
            got = run(w, sr, s, leaf, kind, devices)
            require(same(got, cpu.result()),
                    f"kleene {label} {kind} store (devices {devices}): card != plain")
            checked += 1

    for name, sr in sorted(SEMIRINGS.items()):
        for n, s, leaf in ((128, 32, 32), (160, 32, 64), (96, 32, 96)):
            hold(torch.from_numpy(graph(name, (n, n), 7)), sr, s, leaf, f"{name} {n}/{s}/{leaf}")
        hold(torch.from_numpy(graph(name, (3, 96, 96), 11)), sr, 32, 32, f"{name} (3,96,96)")
    on_card = [torch.device("cuda", 0)]
    for name in ("min_plus", "plus_mul"):
        w = torch.from_numpy(graph(name, (1024, 1024), 13))
        hold(w, SEMIRINGS[name], 128, 256, f"{name} 1024/128/256",
             kinds=(("device", None), ("host", None), ("host", on_card),
                    ("host", on_card * 2), ("device", on_card * 3)))

    w = graph("min_plus", (100, 100), 19)
    bits = np.random.default_rng(21).random((40, 96, 96)) < 0.05
    for label, x, kw in (("int16", w, dict(dtype=torch.int16)),
                         ("bf16", w, dict(dtype=torch.bfloat16)),
                         ("f16", w, dict(dtype=torch.float16)),
                         ("packed", bits, dict(semiring="or_and", packed=True))):
        fused = solve(torch.from_numpy(x).to(dev), method="fused", block_size=32, **kw).dist
        cpu = solve(x, method="recursive", block_size=32, leaf=32, device="cpu", **kw).dist
        lanes = {"in core": dict(method="recursive", leaf=32)}
        if label != "packed":  # a budget never reaches the packed inner solve
            lanes["out of core"] = dict(method="fused", hbm_budget=1)
        for lane, lkw in lanes.items():
            got = solve(x, block_size=32, **lkw, **kw)
            require(got.method == "recursive", f"kleene {label} {lane}: method {got.method}")
            require(same(got.dist.cpu(), cpu) and same(got.dist.cpu(), fused.cpu()),
                    f"kleene solve {label} {lane}: card != plain / fused")
            checked += 1
    print(f"check: {checked} recursive (R-Kleene) cases bitwise equal to plain and fused; "
          f"host stores' bytes == model; {time.perf_counter() - t_phase:.1f} s")


def oocore_kernels(rows: dict, tag, x, sr, s: int, P: int, counts: dict, shapes) -> None:
    """Each launch kind of an out-of-core lane alone at the lane's shapes,
    on its own matrix x (m x m, the storage the kernels run): the leaf's
    ``fw_phase1`` (s, s), ``fw_phase2_row`` (s, m) and ``fw_phase2_col``
    (m, s) into the factor buffers' views, the cross's two products (P,
    s)·(s, m) + C and (m, s)·(s, P) + C, and the sweep's (P, P)·(P, P) + C
    on the factor panels' views; each bitwise against its plain version.
    Each is a row of the record of its own (``…/oocore…``) whose launches
    are those of the lane's run (``counts``; the products told apart by
    shape, ``shapes`` = ``minplus_matmul.LAUNCH_SHAPES``)."""
    import torch

    from repro_torch.kernels import fw_phase1 as fph
    from repro_torch.kernels import fw_phase2
    from repro_torch.kernels import minplus_matmul as fmm
    from repro_torch.kernels import ref

    sfx = f"[{tag}]" if tag else ""
    ops, word = (2, 4) if tag is None else (LOWERED_OPS[tag], LOWERED_WORD[tag])
    m = x.shape[-1]
    # Round 0 of the second leaf (LO = P): its pivot tile and bands.
    colband = x[:, P:2 * P].contiguous().cuda()
    rowband = x[P:2 * P, :].contiguous().cuda()
    colf, rowf = x[:, :P].contiguous().cuda(), x[:P, :].contiguous().cuda()
    tile = rowband[:s, P:P + s].contiguous()
    diag = torch.empty_like(tile)
    row, col = rowf[:s, :], colf[:, :s]
    mm = "semiring_matmul" + sfx
    cases = (
        ("fw_phase1/oocore", counts["fw_phase1" + sfx],
         lambda: fph.fw_phase1(tile, semiring=sr, out=diag),
         lambda: ref.fw_phase1_ref(tile, semiring=sr), lambda: diag,
         ops * float(s) ** 3, 2 * s * s * word, 11, 3),
        ("fw_phase2_row/oocore", counts["fw_phase2_row" + sfx],
         lambda: fw_phase2.fw_phase2_row(diag, rowband[:s, :], semiring=sr, out=row),
         lambda: ref.fw_phase2_row_ref(diag, rowband[:s, :], semiring=sr), lambda: row,
         ops * float(s) * s * m, (s * s + 2 * s * m) * word, 11, 3),
        ("fw_phase2_col/oocore", counts["fw_phase2_col" + sfx],
         lambda: fw_phase2.fw_phase2_col(diag, colband[:, :s], semiring=sr, out=col),
         lambda: ref.fw_phase2_col_ref(diag, colband[:, :s], semiring=sr), lambda: col,
         ops * float(s) * s * m, (s * s + 2 * s * m) * word, 11, 3),
    )
    for name, launches, fn, plain, got, nops, nbytes, reps, preps in cases:
        fn()
        want = plain()
        sync()
        kind = name + sfx
        require(same(got(), want), f"{kind} at the lane's shape != plain")
        record_kernel(rows, kind, max_abs_err(got(), want), event_ms(fn, reps),
                      event_ms(plain, preps), nops, nbytes)
        rows[kind]["launches"] = launches
    row[:, P:P + s] = diag
    col[P:P + s, :] = diag
    cross = torch.empty_like(rowband), torch.empty_like(colband)
    a, b = colf[2 * P:3 * P], rowf[:, 3 * P:4 * P]
    c = x[2 * P:3 * P, 3 * P:4 * P].contiguous().cuda()
    sweep = torch.empty_like(c)
    products = (
        ("cross_row", (P, s, m), (col[P:2 * P, :], row, rowband, cross[0]),
         ops * float(P) * s * m, (P * s + s * m + 2 * P * m) * word),
        ("cross_col", (m, s, P), (col, row[:, P:2 * P], colband, cross[1]),
         ops * float(m) * s * P, (m * s + s * P + 2 * m * P) * word),
        ("sweep", (P, P, P), (a, b, c, sweep), ops * float(P) ** 3, 4 * P * P * word),
    )
    seen = 0
    for label, shape, (pa, pb, pc, out), nops, nbytes in products:
        fmm.semiring_matmul(pa, pb, pc, semiring=sr, out=out)
        want = ref.semiring_matmul_ref(pa, pb, pc, semiring=sr)
        sync()
        kind = f"semiring_matmul/oocore_{label}{sfx}"
        require(same(out, want), f"{kind} {shape} != plain")
        print(f"{kind} (m, k, n) = {shape} staging: {fmm.staging_name(pa, pb, pc, out)}")
        record_kernel(rows, kind, max_abs_err(out, want),
                      event_ms(lambda: fmm.semiring_matmul(pa, pb, pc, semiring=sr, out=out), 11),
                      event_ms(lambda: ref.semiring_matmul_ref(pa, pb, pc, semiring=sr), 1),
                      nops, nbytes)
        rows[kind]["launches"] = shapes[(mm, *shape)]
        seen += shapes[(mm, *shape)]
        del want
    require(seen == counts[mm], f"oocore {mm}: {counts[mm]} launches, {seen} at the lane's "
                                f"three shapes ({dict(shapes)})")


def oocore_lane(rows: dict, label: str, tag, call, fused, store_input, sr, budget: int):
    """One out-of-core lane.  ``call()`` is the user's ``solve`` under the
    budget on a host input, ``fused()`` the in-core fused solve of the
    same input on the card, ``store_input`` the padded host matrix in the
    storage the kernels run (``sr``, storage ``tag``).  (0) Pinning a host
    matrix of the store's size, cold and then again from the allocator's
    cache; (1) the main path: ``call()`` once, its launch counts (the
    lane's rows of the record, ``oocore_kernels``), wall and rise of peak
    device memory (<= the budget); (2) the fused solve, timed, == (1) by
    bits; (3) ``call()`` under ``torch.profiler``: copies each way (ms,
    GB/s), kernels, device busy and idle; (4) the same schedule through an
    explicit ``HostPanelStore`` (its allocation from the allocator's cache,
    queueing and run times), whose bytes each way must equal the plan's
    model exactly, == (2) by bits."""
    import torch

    from repro_torch.apsp import HostPanelStore, KleeneExecutor, plan
    from repro_torch.kernels import fw_phase1 as fph
    from repro_torch.kernels import minplus_matmul as fmm

    n = store_input.shape[-1]
    rp = plan.recursive_plan(n, hbm_budget=budget, dtype=store_input.dtype)
    require(rp["out_of_core"] and rp["matrix_bytes"] > budget >= rp["hbm_resident_bytes"],
            f"oocore {label}: plan {rp['matrix_bytes']} B matrix, budget {budget}")
    pin = []
    for _ in range(2):
        t0 = time.perf_counter()
        held = torch.empty(store_input.shape, dtype=store_input.dtype, pin_memory=True)
        pin.append((time.perf_counter() - t0) * 1e3)
        require(held.is_pinned(), f"oocore {label}: host memory not pinned")
        del held
    fph.reset_launch_counts()
    fmm.reset_launch_counts()
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = call()
    sync()
    wall = (time.perf_counter() - t0) * 1e3
    rise = torch.cuda.max_memory_allocated() - base
    counts = {k: v for k, v in {**fph.LAUNCHES, **fmm.LAUNCHES}.items() if v}
    shapes = collections.Counter(fmm.LAUNCH_SHAPES)
    require(res.method == "recursive" and res.dist.device.type == "cpu",
            f"oocore {label}: method {res.method} on {res.dist.device}")
    require(rise <= budget, f"oocore {label}: device memory rose {rise} B > budget {budget}")
    rounds = rp["rounds"]
    require(sum(c for k, c in counts.items() if k.startswith("fw_phase1")) == rounds and
            sum(c for k, c in counts.items() if k.startswith("semiring_matmul"))
            == rp["sweep_calls"] + 2 * rounds,
            f"oocore {label}: launches {counts} against {rounds} rounds, "
            f"{rp['sweep_calls']} sweeps")
    sync()
    t0 = time.perf_counter()
    want = fused()
    sync()
    fused_ms = (time.perf_counter() - t0) * 1e3
    want = want.dist  # on the card: the comparisons run there
    require(same(res.dist.cuda(), want), f"oocore {label}: streamed solve != in-core fused solve")
    del res
    prof = profiled(call)
    t0 = time.perf_counter()
    store = HostPanelStore(store_input, device="cuda")
    alloc_ms = (time.perf_counter() - t0) * 1e3
    ex = KleeneExecutor(semiring=sr, block_size=rp["block_size"], leaf=rp["leaf"])
    sync()
    t0 = time.perf_counter()
    ex.run(store)
    queued_ms = (time.perf_counter() - t0) * 1e3
    out = store.result()
    run_ms = (time.perf_counter() - t0) * 1e3
    model = (rp["h2d_bytes"], rp["d2h_bytes"])
    require((store.h2d_bytes, store.d2h_bytes) == model,
            f"oocore {label}: bytes {store.h2d_bytes} / {store.d2h_bytes} != model {model}")
    require(same(out[..., :want.shape[-2], :want.shape[-1]].cuda(), want),
            f"oocore {label}: explicit host store != fused")
    del store, out, want
    rate = lambda b, ms: b / ms / 1e6 if ms else float("nan")  # noqa: E731 — GB/s
    cp, busy = prof["copies"], prof["busy"]
    idle = "not measured" if busy is None else f"{100 * (1 - busy / prof['wall']):.1f} %"
    print(f"oocore {label}: n={n} leaf {rp['leaf']} ({rp['panels']} panels, depth {rp['depth']}, "
          f"{rp['sweep_calls']} sweeps), budget {budget} B, device memory rose {rise} B "
          f"(model {rp['hbm_resident_bytes']} B + s^2 tile); streamed solve wall {wall:.1f} ms, "
          f"in-core fused {fused_ms:.1f} ms ({wall / fused_ms:.2f}x), == by bits; "
          f"launches {json.dumps(counts)}")
    print(f"oocore {label} profiled: wall {prof['wall']:.1f} ms; copies to the card "
          f"{model[0]} B in {cp['HtoD']:.1f} ms ({rate(model[0], cp['HtoD']):.2f} GB/s), from it "
          f"{model[1]} B in {cp['DtoH']:.1f} ms ({rate(model[1], cp['DtoH']):.2f} GB/s), on it "
          f"{cp['DtoD']:.1f} ms; kernels {prof['dev']:.1f} ms; device busy "
          f"{'not measured' if busy is None else f'{busy:.1f} ms'}, idle {idle}")
    print(f"oocore {label} host store: pinning {store_input.nbytes} B cold {pin[0]:.1f} ms, "
          f"again {pin[1]:.1f} ms (the allocator's cached block, which the calls then take); "
          f"explicit store allocated and filled in {alloc_ms:.1f} ms; schedule queued in "
          f"{queued_ms:.1f} ms, ran in {run_ms:.1f} ms; bytes each way == model {model[0]}")
    oocore_kernels(rows, tag, store_input, sr, rp["block_size"], rp["leaf"], counts, shapes)
    return dict(wall=wall, fused=fused_ms, rise=rise, prof=prof, pin=pin, alloc=alloc_ms,
                queued=queued_ms, run=run_ms)


def phase_oocore(rows: dict, n: int = 16384, n_small: int = 8192):
    """The out-of-core path on the card, at sizes whose matrix the run can
    still hold in core for the bitwise check, under budgets below the
    matrix (PERF.md §2's random digraph, density 0.5, seed 0):

      lane                         matrix   budget   plan
      f32 min-plus, n = 16384      1 GiB    768 MiB  leaf 2048, 8 panels
      int16, n = 16384             512 MiB  384 MiB  leaf 2048, 8 panels
      packed, 32 graphs n = 8192   256 MiB  192 MiB  leaf 1024, 8 panels

    each through ``oocore_lane``, whose launch kinds each take a row of
    the record of their own at the lane's shapes (``oocore_kernels``: the
    leaf's phases, the cross's two products, the sweep's P x P tile ⊕=
    (P, P)·(P, P) of the factor panels' views), timed beside their bounds;
    an in-core ``solve(method="recursive", leaf=1024)``
    at n_small == fused, both timed; ``ApspEngine(hbm_budget=192 MiB)`` at
    n_small twice: the key out of core, the second solve a cache hit, both
    == fused."""
    import torch

    from repro_torch.apsp import ApspEngine, api, solve
    from repro_torch.core.graph import random_digraph
    from repro_torch.core.semiring import MIN_PLUS, MIN_PLUS_I16, OR_AND_PACKED

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    w = torch.from_numpy(random_digraph(n, density=0.5, seed=0))
    wc = w.cuda()
    oocore_lane(rows, "f32 min_plus", None, lambda: solve(w, hbm_budget=768 << 20),
                lambda: solve(wc), w, MIN_PLUS, 768 << 20)
    w16 = api._coerce(w, MIN_PLUS_I16, None, cpu)
    oocore_lane(rows, "int16", "int16",
                lambda: solve(w, dtype=torch.int16, hbm_budget=384 << 20),
                lambda: solve(wc, dtype=torch.int16), w16, MIN_PLUS_I16, 384 << 20)
    del wc
    words = api.pack_reachability(packed_graphs(32, n_small, seed=51))[0]
    words_host = words.cpu()
    oocore_lane(rows, "packed (32 graphs)", "packed",
                lambda: solve(words_host, semiring="or_and_packed", hbm_budget=192 << 20),
                lambda: solve(words, semiring="or_and_packed"), words_host, OR_AND_PACKED,
                192 << 20)
    del words, w16

    w8 = torch.from_numpy(random_digraph(n_small, density=0.5, seed=0))
    w8c = w8.cuda()
    fused = solve(w8c).dist
    rec = solve(w8c, method="recursive", leaf=1024)
    require(rec.method == "recursive" and same(rec.dist, fused),
            f"in-core recursive n={n_small} leaf 1024 != fused")
    t_rec = statistics.median(host_ms(lambda: solve(w8c, method="recursive", leaf=1024))
                              for _ in range(3))
    t_fused = statistics.median(host_ms(lambda: solve(w8c)) for _ in range(3))
    print(f"oocore in-core recursive n={n_small} leaf 1024 (8 panels, 392 sweeps): median "
          f"{t_rec:.2f} ms, fused {t_fused:.2f} ms ({t_rec / t_fused:.3f}x); == fused by bits")
    del rec, w8c
    eng, got = ApspEngine(hbm_budget=192 << 20), []
    t1 = host_ms(lambda: got.append(eng.solve(w8)))
    t2 = host_ms(lambda: got.append(eng.solve(w8)))
    (key,) = eng._cache
    require(key.method == "recursive" and key.oocore and eng.stats.hits == 1
            and eng.stats.misses == 1, f"oocore engine: key {key}, stats {eng.stats}")
    fused = fused.cpu()
    require(all(same(r.dist, fused) for r in got) and len(got) == 2,
            f"oocore engine n={n_small}: solves != fused")
    entry = eng._cache[key]
    print(f"oocore engine n={n_small} f32, hbm_budget 192 MiB: key {key.method} leaf {key.leaf} "
          f"oocore {key.oocore}; first solve {t1:.1f} ms, cached {t2:.1f} ms (hits "
          f"{eng.stats.hits}, runner builds {entry.traces}, schedules planned "
          f"{entry.executor.traces}); both == fused by bits")
    print(f"oocore phase: {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------ 4-dispatch round
FOUR_KINDS = ("fw_phase1", "fw_phase2_row", "fw_phase2_col", "semiring_matmul")


def salted(name: str, shape, seed: int):
    """Operands in each semiring's domain (``graph`` cut to shape), salted
    with +inf and -inf: plus_mul's 0 ⊗ inf and max_plus's -inf + inf give
    NaN, which kernel and plain version must propagate alike."""
    import numpy as np

    m = max(shape[-2:])
    x = graph(name, (*shape[:-2], m, m), seed)[..., :shape[-2], :shape[-1]].copy()
    rng = np.random.default_rng(seed + 1000)
    x[rng.uniform(size=x.shape) < 0.05] = np.inf
    x[rng.uniform(size=x.shape) < 0.05] = -np.inf
    return x


def plain_four(w, *, block_size: int, semiring):
    """The plain 4-dispatch round loop on w's device."""
    from repro_torch.kernels import ref

    for b in range(w.shape[-1] // block_size):
        w = ref.fw_round4_ref(w, b, block_size=block_size, semiring=semiring)
    return w


def phase_check_four():
    """The 4-dispatch round's kernels bitwise against their plain versions
    on the card, on all five semirings: ``semiring_matmul`` with and
    without c at (1024,128)·(128,1024), (4,256,96)·(4,96,384) batched,
    (1000,77)·(77,513) and (1,5)·(5,3), operands salted with ±inf;
    ``fw_phase1`` at s = 16, 32, 64, 128, single and (4,s,s); ``fw_phase2_row``
    / ``fw_phase2_col`` at (128,1024) / (1024,128) and at band length 1000,
    read as strided slices of a matrix; ``fw_staged(fused=False)`` at
    n = 1024, s = 128 and (4,512,512) against the plain 4-dispatch loop and
    the card's fused ``fw_staged``."""
    import torch

    from repro_torch.core.semiring import SEMIRINGS
    from repro_torch.core.staged import fw_staged
    from repro_torch.kernels import fw_phase1 as fph
    from repro_torch.kernels import fw_phase2
    from repro_torch.kernels import minplus_matmul as fmm
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    checked = 0
    on = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    for name, sr in sorted(SEMIRINGS.items()):
        for a_shape, b_shape in (((1024, 128), (128, 1024)), ((4, 256, 96), (4, 96, 384)),
                                 ((1000, 77), (77, 513)), ((1, 5), (5, 3))):
            a, b = on(salted(name, a_shape, 1)), on(salted(name, b_shape, 2))
            c = on(salted(name, (*a_shape[:-1], b_shape[-1]), 3))
            c0 = c.clone()
            for cc in (None, c):
                got = fmm.semiring_matmul(a, b, cc, semiring=sr)
                want = ref.semiring_matmul_ref(a, b, cc, semiring=sr)
                sync()
                require(same(got, want), f"semiring_matmul {name} {a_shape}@{b_shape} "
                        f"{'with' if cc is not None else 'without'} c != plain")
                checked += 1
            require(same(c, c0), "semiring_matmul wrote into c")
        for s in (16, 32, 64, 128):
            for shape in ((s, s), (4, s, s)):
                t = on(graph(name, shape, s))
                require(same(fph.fw_phase1(t, semiring=sr), ref.fw_phase1_ref(t, semiring=sr)),
                        f"fw_phase1 {name} {shape} != plain")
                checked += 1
        s = 128
        diag = ref.fw_phase1_ref(on(graph(name, (s, s), 4)), semiring=sr)
        for n in (1024, 1000):
            w = on(graph(name, (n + s, n + s), n))
            row, col = w[7:7 + s, 3:3 + n], w[3:3 + n, 7:7 + s]
            got_r = fw_phase2.fw_phase2_row(diag, row, semiring=sr)
            got_c = fw_phase2.fw_phase2_col(diag, col, semiring=sr)
            sync()
            require(same(got_r, ref.fw_phase2_row_ref(diag, row, semiring=sr))
                    and same(got_c, ref.fw_phase2_col_ref(diag, col, semiring=sr)),
                    f"fw_phase2_row/col {name} n={n} != plain")
            checked += 2
        for shape in ((1024, 1024), (4, 512, 512)):
            w = on(graph(name, shape, 8))
            got = fw_staged(w, block_size=s, semiring=sr, fused=False)
            want = plain_four(w, block_size=s, semiring=sr)
            fused = fw_staged(w, block_size=s, semiring=sr)
            sync()
            require(same(got, want), f"fw_staged(fused=False) {name} {shape} != plain loop")
            require(same(got, fused), f"fw_staged(fused=False) {name} {shape} != fused")
            checked += 1
    print(f"check: {checked} 4-dispatch kernel-vs-plain cases bitwise equal")


def phase_kernels_four(rows: dict, n: int, s: int = 128, sq: int = 4096):
    """Each 4-dispatch launch alone at the path's shapes (n = 8192, s =
    128, round T/2): ``fw_phase1`` (s,s), ``fw_phase2_row`` (s,n),
    ``fw_phase2_col`` (n,s), ``semiring_matmul`` at the phase-3 shape
    (n,s)·(s,n) + C (min-plus, the record) beside the fused round's relax
    launch on the same shape; then plus_mul at that shape beside
    ``torch.addmm`` and the fused round's plus_mul relax, and the
    square (sq,sq)·(sq,sq) product in min-plus and plus_mul, the latter
    beside ``torch.matmul`` (TF32 off: full f32, not bitwise, not checked).
    Work: a relaxation is 2 fp32 operations; bytes: each input read once,
    each output written once."""
    import torch

    from repro_torch.core.graph import random_digraph
    from repro_torch.core.semiring import MIN_PLUS, PLUS_MUL
    from repro_torch.kernels import fw_phase1 as fph
    from repro_torch.kernels import fw_phase2
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import minplus_matmul as fmm
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    record = functools.partial(record_kernel, rows)
    b = n // s // 2
    o = slice(b * s, (b + 1) * s)
    w = torch.from_numpy(random_digraph(n, density=0.5, seed=1)).to(dev)
    tile = w[o, o].contiguous()
    diag = torch.empty_like(tile)
    fph.fw_phase1(tile, out=diag)
    want = ref.fw_phase1_ref(tile, semiring=MIN_PLUS)
    sync()
    require(same(diag, want), "fw_phase1 launch != plain")
    record("fw_phase1", max_abs_err(diag, want),
           event_ms(lambda: fph.fw_phase1(tile, out=diag), 11),
           event_ms(lambda: ref.fw_phase1_ref(tile, semiring=MIN_PLUS), 3),
           2.0 * s**3, 2 * s * s * 4)

    band_r, band_c = w[o, :].contiguous(), w[:, o].contiguous()
    row, col = torch.empty_like(band_r), torch.empty_like(band_c)
    for kind, fn, band, out, plain in (
            ("fw_phase2_row", fw_phase2.fw_phase2_row, band_r, row, ref.fw_phase2_row_ref),
            ("fw_phase2_col", fw_phase2.fw_phase2_col, band_c, col, ref.fw_phase2_col_ref)):
        fn(diag, band, out=out)
        want = plain(diag, band, semiring=MIN_PLUS)
        sync()
        require(same(out, want), f"{kind} launch != plain")
        record(kind, max_abs_err(out, want),
               event_ms(lambda: fn(diag, band, out=out), 11),
               event_ms(lambda: plain(diag, band, semiring=MIN_PLUS), 3),
               2.0 * s * s * n, (s * s + 2 * s * n) * 4)
    row[:, o] = diag
    col[o, :] = diag

    out = torch.empty_like(w)
    for sr in (MIN_PLUS, PLUS_MUL):
        fmm.semiring_matmul(col, row, w, semiring=sr, out=out)
        want = ref.semiring_matmul_ref(col, row, w, semiring=sr)
        sync()
        require(same(out, want), f"semiring_matmul {sr.name} phase-3 shape != plain")
        err = max_abs_err(out, want)
        del want
        ms = event_ms(lambda: fmm.semiring_matmul(col, row, w, semiring=sr, out=out), 5)
        plain = event_ms(lambda: ref.semiring_matmul_ref(col, row, w, semiring=sr), 1)
        ops, nbytes = 2.0 * n * n * s, (2 * n * n + 2 * n * s) * 4
        print(f"semiring_matmul {sr.name} ({n},{s})·({s},{n}) + C staging: "
              f"{fmm.staging_name(col, row, w, out)}")
        # The fused round's relax folds the same product onto a spliced C.
        bands = fr.round_buffers(w, s)
        wk = w.clone()
        kw = dict(block_size=s, semiring=sr)
        fr.fw_round_phase("diag", wk, b, bands, **kw)
        fr.fw_round_phase("bands", wk, b, bands, **kw)
        relax = event_ms(lambda: fr.fw_round_phase("relax", wk, b, bands, **kw), 5)
        del bands, wk
        if sr is MIN_PLUS:
            record("semiring_matmul", err, ms, plain, ops, nbytes)
            print(f"fused relax min_plus at the phase-3 shape: fw_round/relax {relax:.4f} ms; "
                  f"semiring_matmul {ms:.4f} ms ({relax / ms:.3f}x)")
            continue
        lib_out = torch.empty_like(out)
        lib = event_ms(lambda: torch.addmm(w, col, row, out=lib_out), 5)
        del lib_out
        record("semiring_matmul", err, ms, plain, ops, nbytes, store=False,
               note=f" plus_mul ({n},{s})·({s},{n}) + C", library=lib)
        print(f"library plus_mul at the phase-3 shape: torch.addmm {lib:.4f} ms; "
              f"semiring_matmul {ms:.4f} ms; fw_round/relax {relax:.4f} ms "
              f"({relax / lib:.3f}x addmm)")
    del w, out

    for sr in (MIN_PLUS, PLUS_MUL):
        a = torch.from_numpy(graph(sr.name, (sq, sq), 40)).to(dev)
        bb = torch.from_numpy(graph(sr.name, (sq, sq), 41)).to(dev)
        out = fmm.semiring_matmul(a, bb, semiring=sr)
        want = ref.semiring_matmul_ref(a, bb, semiring=sr)
        sync()
        require(same(out, want), f"semiring_matmul {sr.name} {sq}^3 != plain")
        err = max_abs_err(out, want)
        print(f"semiring_matmul {sr.name} ({sq},{sq})·({sq},{sq}) staging: "
              f"{fmm.staging_name(a, bb, None, out)}")
        lib = None
        if sr is PLUS_MUL:
            lib_out = torch.empty_like(out)
            lib = event_ms(lambda: torch.matmul(a, bb, out=lib_out), 5)
            del lib_out
        record("semiring_matmul", err,
               event_ms(lambda: fmm.semiring_matmul(a, bb, semiring=sr, out=out), 5),
               event_ms(lambda: ref.semiring_matmul_ref(a, bb, semiring=sr), 1),
               2.0 * sq**3, 3 * sq * sq * 4, store=False,
               note=f" {sr.name} ({sq},{sq})·({sq},{sq})", library=lib)
        del a, bb, out, want


def phase_four(rows: dict, n: int, s: int = 128):
    """The 4-dispatch path: ``fw_staged(w, fused=False)`` at n (min-plus,
    f32, the main path's seeded density-0.5 digraph), with the launch counts
    of that run (4 kinds x n/s rounds), bitwise against the fused solve of
    the same input, timed beside the fused ``fw_staged`` (host clock around
    work that ends in synchronize(), median of 3 after a warm-up), and its
    device time by launch kind."""
    import torch

    from repro_torch.apsp import solve
    from repro_torch.core.graph import random_digraph
    from repro_torch.core.staged import fw_staged
    from repro_torch.kernels import fw_phase1 as fph
    from repro_torch.kernels import fw_phase2
    from repro_torch.kernels import minplus_matmul as fmm

    dev = torch.device("cuda")
    w = torch.from_numpy(random_digraph(n, density=0.5, seed=0)).to(dev)
    fph.reset_launch_counts()
    fmm.reset_launch_counts()
    d4 = fw_staged(w, block_size=s, fused=False)
    sync()
    counts = {**fph.LAUNCHES, **fmm.LAUNCHES}
    print(f"4-dispatch path launch counts: {json.dumps(counts)}")
    for kind in FOUR_KINDS:
        require(counts[kind] == n // s, f"{kind} launched {counts[kind]} times, not {n // s}")
        rows[kind]["launches"] = counts[kind]
    fused = solve(w).dist
    require(same(d4, fused), f"fw_staged(fused=False) n={n} != the fused solve")
    del d4
    print(f"4-dispatch check: fw_staged(fused=False) n={n} == fused solve, bitwise")

    def timed(fn):
        fn()
        times = [host_ms(fn) for _ in range(3)]
        return statistics.median(times), times

    t4, all4 = timed(lambda: fw_staged(w, block_size=s, fused=False))
    tf, allf = timed(lambda: fw_staged(w, block_size=s))
    bms, by = bound(2.0 * n**3, (n // s) * 2.0 * n * n * 4)
    print(f"4-dispatch fw_staged n={n} min_plus f32: median {t4:.2f} ms of "
          f"{['%.2f' % t for t in all4]}, {n**3 / (t4 / 1e3):.4e} relaxations/s, bound "
          f"{bms:.2f} ms by {by} ({100 * bms / t4:.1f}% of it); fused fw_staged median "
          f"{tf:.2f} ms of {['%.2f' % t for t in allf]} ({t4 / tf:.3f}x)")

    wk = w.clone()
    diag = wk.new_empty((s, s))
    row, col = wk.new_empty((s, n)), wk.new_empty((n, s))
    steps = []
    for b in range(n // s):
        o = slice(b * s, (b + 1) * s)

        def splice(o=o):
            row[:, o] = diag
            col[o, :] = diag
            wk[o, :] = row
            wk[:, o] = col

        steps += [
            ("fw_phase1", functools.partial(fph.fw_phase1, wk[o, o], out=diag)),
            ("fw_phase2_row", functools.partial(fw_phase2.fw_phase2_row, diag, wk[o, :], out=row)),
            ("fw_phase2_col", functools.partial(fw_phase2.fw_phase2_col, diag, wk[:, o], out=col)),
            ("splice copies", splice),
            ("semiring_matmul", functools.partial(fmm.semiring_matmul, col, row, wk, out=wk)),
        ]
    launch_breakdown(f"4-dispatch breakdown n={n}", steps)
    require(same(wk, fused), "the 4-dispatch breakdown's rounds != the fused solve")

# ------------------------------------------------------------- distributed
def phase_check_dist():
    """The bordered round's kernel bitwise against its plain twin on the
    card: all five semirings, s = 16, 32, 64, 128; square (s + n/2)², tall
    (s + n/2, s + n/4) and wide (s + n/4, s + n/2) bordered blocks of an
    n = 8s solve; single and (4, rows, cols) batched; owner echo none,
    (1, 1), the last tile, and only one of the two; operands salted with
    ±inf (DAG inputs for max_plus, as ``graph`` makes them)."""
    import torch

    from repro_torch.core.semiring import SEMIRINGS
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    checked = 0
    for name, sr in sorted(SEMIRINGS.items()):
        for s in (16, 32, 64, 128):
            n = 8 * s
            for rows, cols in ((s + n // 2, s + n // 2), (s + n // 2, s + n // 4),
                               (s + n // 4, s + n // 2)):
                tr, tc = rows // s, cols // s
                for lead in ((), (4,)):
                    w = torch.from_numpy(salted(name, (*lead, rows, cols), s + rows)).to(dev)
                    for echo in ((-1, -1), (1, 1), (tr - 1, tc - 1), (1, -1), (-1, tc - 1)):
                        got = fr.fw_round_bordered(w.clone(), *echo, block_size=s, semiring=sr)
                        want = ref.fw_round_bordered_ref(w, *echo, block_size=s, semiring=sr)
                        sync()
                        require(same(got, want), f"fw_round_bordered {name} s={s} "
                                f"{(*lead, rows, cols)} echo={echo} != plain")
                        checked += 1
    print(f"check: {checked} bordered-round kernel-vs-plain cases bitwise equal")


def phase_kernels_dist(rows: dict, n: int, s: int = 128, R: int = 2, C: int = 2):
    """Each bordered launch alone at the R×C grid's per-rank shape (s + n/R,
    s + n/C) (min-plus, no owner echo: every band tile runs its chain), in
    f32 and in the lowered storages of the grid path (int16, bf16, f16 from
    the same block; random packed words), against the plain version of its
    phase.  Work: a relaxation is 2 fp32 operations (``LOWERED_OPS`` in a
    lowering); bytes: each input read once, each output written once, in the
    storage's word.  Then plus_mul's f32 relax at that block beside
    ``torch.addmm`` computing the same product onto the same C."""
    import numpy as np
    import torch

    from repro_torch.apsp import api
    from repro_torch.core.graph import random_digraph
    from repro_torch.core.semiring import MIN_PLUS, MIN_PLUS_I16, OR_AND_PACKED, PLUS_MUL
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    record = functools.partial(record_kernel, rows)
    nr, nc = n // R, n // C
    w32 = torch.from_numpy(random_digraph(max(nr, nc) + s, density=0.5, seed=4)
                           [:s + nr, :s + nc].copy()).to(dev)
    words = np.random.default_rng(5).integers(0, 1 << 32, tuple(w32.shape), dtype=np.uint64)
    inputs = {
        None: (w32, MIN_PLUS),
        "int16": (api._coerce(w32, MIN_PLUS_I16, None, dev), MIN_PLUS_I16),
        "bf16": (w32.to(torch.bfloat16), MIN_PLUS),
        "f16": (w32.to(torch.float16), MIN_PLUS),
        "packed": (torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev),
                   OR_AND_PACKED),
    }
    for tag, (w, sr) in inputs.items():
        ops, word = (2, 4) if tag is None else (LOWERED_OPS[tag], LOWERED_WORD[tag])
        sfx = "" if tag is None else f"[{tag}]"
        bands = fr.bordered_round_buffers(w, s)
        launch = functools.partial(fr.fw_round_bordered_phase, owner_row=-1, owner_col=-1,
                                   bands=bands, block_size=s, semiring=sr)

        launch("diag", w)
        diag = ref.close_diag(w[:s, :s], sr)
        sync()
        require(same(bands[0][0, :, :s], diag) and same(bands[1][0, :s, :], diag),
                f"bordered diag{sfx} launch != plain close_diag")
        record(f"fw_round_bordered/diag{sfx}", max_abs_err(bands[0][0, :, :s], diag),
               event_ms(lambda: launch("diag", w), 11),
               event_ms(lambda: ref.close_diag(w[:s, :s], sr), 3),
               ops * s**3, 2 * s * s * word)

        launch("bands", w)
        row, col = ref.close_bordered_bands(w, diag, -1, -1, sr)
        sync()
        require(same(bands[0][0], row) and same(bands[1][0], col),
                f"bordered bands{sfx} launch != plain close_bordered_bands")
        tiles = (nr + nc) // s
        record(f"fw_round_bordered/bands{sfx}", max(max_abs_err(bands[0][0], row),
                                                    max_abs_err(bands[1][0], col)),
               event_ms(lambda: launch("bands", w), 11),
               event_ms(lambda: ref.close_bordered_bands(w, diag, -1, -1, sr), 3),
               ops * tiles * s**3, (s * s + 2 * tiles * s * s) * word)

        wk = w.clone()
        launch("relax", wk)
        want = ref.relax_bordered(w, row, col, -1, -1, semiring=sr)
        sync()
        require(same(wk, want), f"bordered relax{sfx} launch != plain relax_bordered")
        r, c = w.shape
        record(f"fw_round_bordered/relax{sfx}", max_abs_err(wk, want),
               event_ms(lambda: launch("relax", wk), 5),
               event_ms(lambda: ref.relax_bordered(w, row, col, -1, -1, semiring=sr), 1),
               ops * r * c * s, (2 * r * c + (r + c) * s) * word)
        del bands, wk, want, row, col

    # plus_mul's bordered relax beside torch.addmm on the same product.
    bands = fr.bordered_round_buffers(w32, s)
    kw = dict(owner_row=-1, owner_col=-1, bands=bands, block_size=s, semiring=PLUS_MUL)
    for phase in ("diag", "bands"):
        fr.fw_round_bordered_phase(phase, w32, **kw)
    wk = w32.clone()
    fr.fw_round_bordered_phase("relax", wk, **kw)
    want = ref.relax_bordered(w32, bands[0][0], bands[1][0], -1, -1, semiring=PLUS_MUL)
    sync()
    require(same(wk, want), "bordered plus_mul relax launch != plain relax_bordered")
    relax = event_ms(lambda: fr.fw_round_bordered_phase("relax", wk, **kw), 5)
    lib_out = torch.empty_like(w32)
    lib = event_ms(lambda: torch.addmm(w32, bands[1][0], bands[0][0], out=lib_out), 5)
    print(f"library plus_mul at the bordered shape {tuple(w32.shape)}: torch.addmm {lib:.4f} ms; "
          f"fw_round_bordered/relax {relax:.4f} ms ({relax / lib:.3f}x addmm)")
    del bands, wk, want, lib_out
    print(f"kernel fw_round_bordered shape: ({s + nr},{s + nc}), the {R}x{C} grid's rank "
          f"block at n={n}, s={s}")


def phase_dist(rows: dict, n: int, n_small: int, s: int = 128):
    """The distributed path: ``fw_distributed`` / ``solve(method=
    "distributed")`` on ``run_grid`` processes that share the one card over
    gloo; each rank holds its result against the single-device solve on the
    card (``launch.fw_dist_check.grid_check``), in f32 and in the lowered
    storages (bf16, f16 and int16 of the main path's graph, one plane of 32
    packed graphs).  Timed beside the fused solve of the same input in this
    process and beside the 1×1 grid."""
    import torch

    from repro_torch.apsp import plan, solve
    from repro_torch.core.graph import random_digraph
    from repro_torch.kernels import fw_round as fr
    from repro_torch.launch import fw_dist_check as fdc
    from repro_torch.launch.mesh import run_grid

    dev = torch.device("cuda")
    w = torch.from_numpy(random_digraph(n, density=0.5, seed=0)).to(dev)
    fused_ms, fused_all = fdc._median_ms(lambda: solve(w), dev, 3)
    del w
    print(f"dist: fused single-device solve n={n}: median {fused_ms:.2f} ms of "
          f"{['%.2f' % t for t in fused_all]}")
    print("dist: the grids below are processes time-sliced on this one card, their "
          "collectives gloo transfers staged through pinned host memory: not a "
          "multi-card figure")
    main = dict(n=n, bs=s, semiring="min_plus", density=0.5, seed=0, reps=3)
    lowered = {"bf16": dict(main, dtype="bfloat16"), "f16": dict(main, dtype="float16"),
               "int16": dict(main, dtype="int16"),
               "packed": dict(main, semiring="or_and", packed=True)}

    def bordered(tag=None):
        sfx = "" if tag is None else f"[{tag}]"
        return [f"fw_round_bordered/{p}{sfx}" for p in fr.PHASES]

    def run(R, C, cfgs, timeout=600):
        t0 = time.perf_counter()
        recs = run_grid(fdc.grid_check, R, C, device="cuda", args=(cfgs,), timeout=timeout)
        print(f"dist: {R}x{C} grid of {R * C} processes ran in "
              f"{time.perf_counter() - t0:.1f} s (spawn included)")
        for rank_recs in recs:
            for rec in rank_recs:
                require(rec["ok"] and rec.get("chunked_ok", True)
                        and rec.get("breakdown_ok", True), f"dist check failed: {rec}")
        return [list(x) for x in zip(*recs)]  # [check][rank]

    def report(label, per_rank, tag=None, beside=None):
        r0 = per_rank[0]
        rounds = r0["rounds"]
        counts = [r["launches"] for r in per_rank]
        require(all(c[k] == rounds for c in counts for k in bordered(tag)),
                f"{label}: bordered launches {counts}, not {rounds} of each kind a rank")
        R, C = r0["R"], r0["C"]
        ops = 2.0 if tag is None else LOWERED_OPS[tag]
        # every rank's bordered rounds, all on this one card
        bms, by = bound(ops * R * C * (s + n // R) * (s + n // C) * s * rounds, 0)
        vs = f"f32 fused single-device {fused_ms:.2f} ms ({r0['ms'] / fused_ms:.3f}x)" \
            if beside is None else f"1x1 grid {beside:.2f} ms ({r0['ms'] / beside:.3f}x)"
        print(f"dist {label}: median {r0['ms']:.2f} ms of {['%.2f' % t for t in r0['times']]} "
              f"({r0['ms'] / rounds:.3f} ms a round), {vs}; bound of all ranks' rounds on "
              f"the card {bms:.2f} ms by {by}; launches a rank "
              f"{json.dumps({k: counts[0][k] for k in bordered(tag)})}")
        return counts[0]

    # 1x1: every round an owner round; the bordered kernel at full width
    one = run(1, 1, [dict(main, breakdown=True)] + list(lowered.values()))
    report(f"1x1 n={n}", one[0])
    one_ms = {}
    for tag, per_rank in zip(lowered, one[1:]):
        report(f"1x1 n={n} [{tag}]", per_rank, tag)
        one_ms[tag] = per_rank[0]["ms"]
    per = one[0][0]["breakdown"]
    span = per.pop("span")
    print(f"dist 1x1 breakdown n={n} (events between launches; each share includes the "
          f"gap after it): " + ", ".join(f"{k} {t:.2f} ms ({100 * t / span:.1f}%)"
                                          for k, t in per.items()) + f"; span {span:.2f} ms")

    # 2x2: timed, bytes counted, chunked restart; a 16-link mesh repair; the
    # lowered storages timed with their bytes; a lowered 16-link mesh repair
    two, rep, *low, low_rep = run(2, 2, [
        dict(main, chunked=True, rounds_per_call=16, restart_at=32),
        dict(repair=True, semiring="min_plus", n=n, edges=16, reps=3),
        *lowered.values(),
        dict(repair=True, semiring="min_plus", dtype="int16", n=n, edges=16, reps=3)])
    counts = report(f"2x2 n={n}", two)
    for kind in bordered():
        rows[kind]["launches"] = counts[kind]
    model = plan.dist_round_comm_bytes(n, 2, 2, s)
    summa = plan.summa_comm_bound_bytes(n, 2, 2)
    for r in two:
        require(r["comm_bytes"] == r["model_bytes"] == model * (n // s),
                f"rank {r['rank']} counted {r['comm_bytes']} B, model {model * (n // s)}")
    print(f"dist 2x2 collective bytes a rank: {[r['comm_bytes'] for r in two]} (model "
          f"{model:.0f} B x {n // s} rounds = {model * (n // s):.0f} B; SUMMA bound "
          f"{summa:.0f} B; staged through host {[r['staged_bytes'] for r in two]} B)")
    print(f"dist 2x2 chunked: rounds_per_call=16, restarted from the round-32 checkpoint, "
          f"== fused solve on every rank")
    print(f"dist 2x2 mesh repair n={n} E={rep[0]['edges']}: median {rep[0]['ms']:.2f} ms "
          f"of {['%.2f' % t for t in rep[0]['times']]} (the full-matrix gather included), "
          f"single-device repair {rep[0]['single_ms']:.3f} ms; == single-device repair "
          f"== re-solve on every rank; {rep[0]['comm_bytes']} collective B a rank")
    for tag, per_rank in zip(lowered, low):
        counts = report(f"2x2 n={n} [{tag}]", per_rank, tag, beside=one_ms[tag])
        for kind in bordered(tag):
            rows[kind]["launches"] = counts[kind]
        want = model * (n // s) * LOWERED_WORD[tag] // 4
        for r in per_rank:
            require(r["comm_bytes"] == r["model_bytes"] == want,
                    f"[{tag}] rank {r['rank']} counted {r['comm_bytes']} B, model {want}")
        print(f"dist 2x2 [{tag}] ({per_rank[0]['dtype']}) collective bytes a rank: "
              f"{[r['comm_bytes'] for r in per_rank]} (model {want} B); every rank == the "
              f"lowered fused solve, bitwise")
    print(f"dist 2x2 mesh repair [int16] n={n} E={low_rep[0]['edges']}: median "
          f"{low_rep[0]['ms']:.2f} ms of {['%.2f' % t for t in low_rep[0]['times']]}, "
          f"single-device repair {low_rep[0]['single_ms']:.3f} ms; == single-device repair "
          f"== re-solve on every rank; {low_rep[0]['comm_bytes']} collective B a rank")

    # 4x2 at n_small: five semirings, a batch, and every lowering, through
    # solve(method="distributed")
    names = ("min_plus", "max_plus", "max_min", "or_and", "plus_mul")
    cfgs = [dict(n=n_small, semiring=name, method="solve", seed=7) for name in names]
    cfgs.append(dict(n=n_small, semiring="min_plus", method="solve", batch=4, seed=8))
    cfgs += [dict(n=n_small, semiring=name, dtype="int16", method="solve", seed=7)
             for name in IDEMPOTENT]
    cfgs += [dict(n=n_small, semiring=name, dtype=dt, method="solve", seed=7)
             for dt in ("bfloat16", "float16") for name in names]
    cfgs.append(dict(n=n_small, semiring="or_and", packed=True, method="solve", seed=7))
    four = run(4, 2, cfgs)
    for per_rank in four:
        r0 = per_rank[0]
        print(f"dist 4x2 n={n_small} {r0['semiring']} {r0['dtype']} batch={r0['batch']}: "
              f"solve(method='distributed') == fused solve on all 8 ranks (s="
              f"{r0['block_size']}, padded {r0['padded_n']}, rank block ({n_small // 4},"
              f"{n_small // 2}))")


# --------------------------------------------------- signed zero and NaN
def domain_graph(name: str, shape, seed: int):
    """A graph whose closure keeps most entries finite: min_plus weights in
    [1, 10), max_plus and max_min in [-10, -1) (so no cycle grows under
    max), 30 % 0̄; or_and 10 % ones; plus_mul [0, 1/n); the diagonal 1̄."""
    import numpy as np

    from repro_torch.core.semiring import SEMIRINGS

    if name not in ("max_plus", "max_min"):
        return graph(name, shape, seed)
    rng = np.random.default_rng(seed)
    w = rng.uniform(-10.0, -1.0, size=shape).astype(np.float32)
    w[rng.uniform(size=shape) < 0.3] = SEMIRINGS[name].zero
    idx = np.arange(shape[-1])
    w[..., idx, idx] = SEMIRINGS[name].one
    return w


def signed_zero_graph(name: str, shape, seed: int):
    """domain_graph with +0 and -0 salted in and no NaN, so a wrong sign
    shows in the output: 3 % of the entries +0 and 3 % -0.  A max keeps -0
    only where no candidate is +0, and + gives -0 only from two -0s, so
    max_plus takes 0.3 % of each, and or_and holds 1 % ones, 1 % +0 and -0
    elsewhere (its 10 % ones would close every pair).  The diagonal 1̄ of
    min_plus / max_plus is -0, the exact identity of + (+0 would turn every
    -0 it meets into +0)."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    u = rng.uniform(size=shape)
    if name == "or_and":
        w = np.where(rng.uniform(size=shape) < 0.01, 1.0, -0.0).astype(np.float32)
        w[u < 0.01] = 0.0
        idx = np.arange(shape[-1])
        w[..., idx, idx] = 1.0
        return w
    w = domain_graph(name, shape, seed)
    if name in ("min_plus", "max_plus"):
        idx = np.arange(shape[-1])
        w[..., idx, idx] = -0.0
    share = 0.003 if name == "max_plus" else 0.03
    w[u < share] = 0.0
    w[(u >= share) & (u < 2 * share)] = -0.0
    return w


def nan_salted(w, seed: int, count: int, keep_out):
    """w (numpy, copied) with ``count`` NaNs in every graph, at random
    positions outside the diagonal tiles ``keep_out`` ((lo, hi) index
    ranges): there a NaN spreads along one row or column of a round's or a
    panel's output at most, so the output stays mostly finite."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = w.copy()
    placed = 0
    while placed < count:
        i, j = (int(x) for x in rng.integers(0, w.shape[-1], 2))
        if not any(lo <= i < hi and lo <= j < hi for lo, hi in keep_out):
            w[..., i, j] = np.nan
            placed += 1
    return w


def value_shares(t) -> tuple[float, int, int, int]:
    """(finite share, +0 count, -0 count, NaN count) of a float tensor."""
    import torch

    t = t.float()
    zero = t == 0
    neg = zero & torch.signbit(t)
    return (float(torch.isfinite(t).float().mean()), int((zero & ~neg).sum()),
            int(neg.sum()), int(torch.isnan(t).sum()))


def salted_cases(name: str, w, wb, tiles, s: int):
    """(what, kernel result, plain result) of every ported kernel on one
    semiring's inputs: w (n, n), wb (2, n/2, n/2) and tiles (4, s, s), on
    the card or (for the plain side only) on the CPU.  Rounds run pivot 3
    of w and 1 of wb, the bordered round the (s + 512, s + 768) corner,
    the panels the first block row and column."""
    from repro_torch.core.paths import _init_successors
    from repro_torch.core.semiring import SEMIRINGS
    from repro_torch.kernels import fw_phase1, fw_phase2
    from repro_torch.kernels import fw_repair as fp
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import minplus_matmul as fmm
    from repro_torch.kernels import ref

    sr, n = SEMIRINGS[name], w.shape[-1]
    corner = w[:s + 512, :s + 768].contiguous()
    diag = fw_phase1.fw_phase1(tiles[0], semiring=sr)
    edges = repair_edges(name, n, 5, 43)
    cases = [
        ("fw_round", fr.fw_round(w.clone(), 3, block_size=s, semiring=sr),
         ref.fw_round_ref(w, 3, block_size=s, semiring=sr)),
        ("fw_round batched", fr.fw_round(wb.clone(), 1, block_size=64, semiring=sr),
         ref.fw_round_ref(wb, 1, block_size=64, semiring=sr)),
        ("fw_round_bordered", fr.fw_round_bordered(corner.clone(), 1, 1, block_size=s,
                                                  semiring=sr),
         ref.fw_round_bordered_ref(corner, 1, 1, block_size=s, semiring=sr)),
        ("semiring_matmul", fmm.semiring_matmul(w[:, :s], w[:s], w, semiring=sr),
         ref.semiring_matmul_ref(w[:, :s], w[:s], w, semiring=sr)),
        ("fw_phase1", fw_phase1.fw_phase1(tiles, semiring=sr),
         ref.fw_phase1_ref(tiles, semiring=sr)),
        ("fw_phase2_row", fw_phase2.fw_phase2_row(diag, w[:s], semiring=sr),
         ref.fw_phase2_row_ref(diag, w[:s], semiring=sr)),
        ("fw_phase2_col", fw_phase2.fw_phase2_col(diag, w[:, :s].contiguous(), semiring=sr),
         ref.fw_phase2_col_ref(diag, w[:, :s], semiring=sr)),
        ("fw_repair", fp.fw_repair(w, *edges, semiring=sr),
         ref.fw_repair_ref(w, *edges, semiring=sr)),
    ]
    if name in IDEMPOTENT:
        rows = strip_rows(n, 37, seed=44)
        cases.append(("fw_repair_del_sweep",
                      fd.fw_repair_del_sweep(w, rows, block_size=s, semiring=sr),
                      ref.fw_repair_del_sweep_ref(w, rows, block_size=s, semiring=sr)))
    if name == "min_plus":
        succ = _init_successors(w).contiguous()
        edges = repair_edges(name, n, 5, 45)
        rows = strip_rows(n, 37, seed=46)
        for what, got, want in (
            ("fw_round_with_successors",
             fr.fw_round_with_successors(w.clone(), succ.clone(), 2, block_size=s),
             ref.fw_round_with_successors_ref(w, succ, 2, block_size=s)),
            ("fw_repair_with_successors", fp.fw_repair_with_successors(w, succ, *edges),
             ref.fw_repair_with_successors_ref(w, succ, *edges)),
            ("fw_repair_del_sweep_with_successors",
             fd.fw_repair_del_sweep_with_successors(w, succ, rows, block_size=s),
             ref.fw_repair_del_sweep_with_successors_ref(w, succ, rows, block_size=s)),
        ):
            cases += [(what, got[0], want[0]), (what + " next hops", got[1], want[1])]
    return cases


def salted_inputs(name: str, kind: str, n: int, s: int, dev):
    """(w, wb, tiles) of salted_cases: signed-zero graphs (kind "zero"), or
    domain graphs with NaNs kept off the diagonal tiles, whose closure
    would spread them over the whole output (kind "nan"; among the
    (4, s, s) tiles only the last holds a NaN)."""
    import torch

    make = signed_zero_graph if kind == "zero" else domain_graph
    w, wb = make(name, (n, n), 41), make(name, (2, n // 2, n // 2), 42)
    tiles = make(name, (4, s, s), 43)
    if kind == "nan":
        w = nan_salted(w, 51, 16, [(b * s, b * s + s) for b in range(n // s)])
        w[s + 5, 7] = w[9, s + 11] = float("nan")  # one in each panel
        wb = nan_salted(wb, 52, 8, [(b * 64, b * 64 + 64) for b in range(n // 128)])
        tiles[3] = nan_salted(tiles[3], 53, 1, [])
    return tuple(torch.from_numpy(x).to(dev) for x in (w, wb, tiles))


def require_salt_survives(what: str, name: str, want, *, zeros: bool, nans: bool):
    """The plain output of a salted case must stay mostly finite (at least
    half its entries) and still carry its salt: zeros of both signs where
    the semiring keeps them (the four idempotent ones; plus_mul sums every
    term, so its output holds a -0 only where all of them are -0, and its
    zero case checks that ±0 factors leave the sums' bits alone), NaNs
    where NaNs went in.  Returns the output's (+0, -0, NaN) counts."""
    if not want.is_floating_point():
        return 0, 0, 0
    finite, pos, neg, nan = value_shares(want)
    require(finite >= 0.5, f"{what} {name}: only {finite:.3f} of the output is finite")
    if zeros and name in IDEMPOTENT:
        require(pos > 0 and neg > 0, f"{what} {name}: the output holds {pos} +0 and {neg} -0")
    if nans:
        require(nan > 0, f"{what} {name}: no NaN reached the output")
    return pos, neg, nan


def planted_zero_matrix(name: str, n: int = 32):
    """A (n, n) min_plus or max_plus matrix, 0̄ but for the +0 diagonal and
    four planted two-step paths whose ⊕ must choose between +0 and -0:
    cells (1, 2) and (4, 5) in round 0's pivot tile at s = 16, (17, 18) and
    (20, 21) in the block it relaxes.  In cells (1, 2) and (17, 18) the
    accumulator holds the sign min keeps last (+0 for min, -0 for max) and
    the path brings the other; in (4, 5) and (20, 21) the other way round.
    Returns (w, cells): min must leave -0 in every cell, max +0."""
    import numpy as np

    from repro_torch.core.semiring import SEMIRINGS

    z1, z2 = (0.0, -0.0) if name == "min_plus" else (-0.0, 0.0)
    w = np.full((n, n), SEMIRINGS[name].zero, np.float32)
    np.fill_diagonal(w, 0.0)
    cells = []
    for (i, j), k, acc, step in (((1, 2), 3, z1, z2), ((4, 5), 6, z2, z1),
                                 ((17, 18), 7, z1, z2), ((20, 21), 9, z2, z1)):
        w[i, j], w[i, k], w[k, j] = acc, step, step
        cells.append((i, j))
    return w, cells


def phase_signed_zero():
    """C.1 on the card.  What min.NaN / max.NaN (``csrc/semiring.cuh``) do
    with ±0 in both argument orders, through the kernels that use them: the
    f32 round and ``fw_phase1`` and the bf16 / f16 round on
    ``planted_zero_matrix`` (XLA's rule: min(±0, ∓0) = -0, max = +0).  Then
    every ported kernel against its plain version, by bits, on two inputs
    of each semiring: signed zeros without NaN, and NaNs kept where they
    cannot flood the output; each plain output must stay mostly finite and
    keep its salt (``require_salt_survives``)."""
    import torch

    from repro_torch.core.semiring import SEMIRINGS
    from repro_torch.kernels import fw_phase1
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    for name in ("min_plus", "max_plus"):
        sr = SEMIRINGS[name]
        w32, cells = planted_zero_matrix(name)
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            w = torch.from_numpy(w32).to(dev).to(dt)
            got = fr.fw_round(w.clone(), 0, block_size=16, semiring=sr)
            want = ref.fw_round_ref(w, 0, block_size=16, semiring=sr)
            results = [("fw_round", got, want)]
            if dt == torch.float32:
                results.append(("fw_phase1", fw_phase1.fw_phase1(w[:16, :16], semiring=sr),
                                ref.fw_phase1_ref(w[:16, :16], semiring=sr)))
            sync()
            for what, g, x in results:
                signs = [bool(torch.signbit(g[i, j])) for i, j in cells if i < g.shape[0]]
                print(f"signed zero {what} {name} {str(dt)[6:]}: planted cells "
                      f"{['-0' if sb else '+0' for sb in signs]}")
                require(same(g, x) and all(sb == (name == "min_plus") for sb in signs),
                        f"{what} {name} {dt}: min.NaN / max.NaN do not give XLA's sign "
                        f"for (±0, ∓0)")
    print("signed zero: min.NaN.f32 gives -0 and max.NaN.f32 +0 for (+0, -0) and (-0, +0) "
          "inside the round and phase 1 kernels, as XLA's min / max do: semiring.cuh needs "
          "no sign fix")

    n, s = 1024, 128
    for kind in ("zero", "nan"):
        checked, pos, neg, nans, least = 0, 0, 0, 0, 1.0
        for name in sorted(SEMIRINGS):
            w, wb, tiles = salted_inputs(name, kind, n, s, dev)
            cases = salted_cases(name, w, wb, tiles, s)
            sync()
            for what, got, want in cases:
                require(same(got, want), f"{what} {name} on {kind}-salted inputs != plain (bits)")
                p, q, r = require_salt_survives(what, name, want, zeros=kind == "zero",
                                                nans=kind == "nan")
                pos, neg, nans = pos + p, neg + q, nans + r
                if want.is_floating_point():
                    least = min(least, value_shares(want)[0])
                checked += 1
        print(f"check: {checked} kernel-vs-plain cases on {kind}-salted inputs equal by bits "
              f"(outputs: {pos} +0, {neg} -0, {nans} NaN; least finite share {least:.4f})")


# ------------------------------------------------------ storage lowerings
LOWERED_CASES = ([("int16", n) for n in IDEMPOTENT] + [("packed", "or_and")]
                 + [(t, n) for t in ("bf16", "f16")
                    for n in ("max_min", "max_plus", "min_plus", "or_and", "plus_mul")])
# Operations of one lowered min-plus relaxation, for the bounds, counted as
# the f32 rows count theirs (add, min = 2) and as csrc/fw_round_lowered.cu
# says: one for each arithmetic op, rounding or select made per (i, j, k).
# bf16 / f16 add, round, min; int16 add, clamp ×2, the two sentinel
# selects, min (each sentinel test looks at one operand only, so it is made
# per (i, k) or (k, j), not per triple); packed one LOP3 for 32 graphs.
LOWERED_OPS = {"bf16": 3, "f16": 3, "int16": 6, "packed": 1}
LOWERED_WORD = {"bf16": 2, "f16": 2, "int16": 2, "packed": 4}


def lowered_case(tag: str, name: str, shape, seed: int, s: int):
    """(w on the card, its semiring) of a lowered round at block size s:
    int16 weights with the ⊕-identity sentinel and near-saturation values,
    {0,1} for or_and_i16, random int32 words for the packed closure, or
    ``signed_zero_graph`` cast to bf16 / f16 with two NaNs a graph off the
    diagonal tiles (where a round cannot spread them)."""
    import numpy as np
    import torch

    from repro_torch.core.semiring import OR_AND_PACKED, SEMIRINGS, lower_semiring

    rng = np.random.default_rng(seed)
    if tag == "packed":
        words = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(words.view(np.int32)).cuda(), OR_AND_PACKED
    if tag == "int16":
        sr = lower_semiring(SEMIRINGS[name], torch.int16)
        if name == "or_and":
            return torch.from_numpy((rng.uniform(size=shape) < 0.25).astype(np.int16)).cuda(), sr
        v = rng.integers(-40, 40, size=shape).astype(np.int16)
        v[rng.uniform(size=shape) < 0.02] = 32000
        v[rng.uniform(size=shape) < 0.02] = -32000
        v[rng.uniform(size=shape) < 0.15] = sr.zero
        return torch.from_numpy(v).cuda(), sr
    dt = {"bf16": torch.bfloat16, "f16": torch.float16}[tag]
    n = shape[-1]
    w = nan_salted(signed_zero_graph(name, shape, seed), seed, 2,
                   [(b * s, b * s + s) for b in range(n // s)])
    return torch.from_numpy(w).cuda().to(dt), SEMIRINGS[name]


def phase_check_lowered():
    """The lowered round kernels bitwise against their plain versions on the
    card: every lowering (int16 ×4, packed, bf16 and f16 ×5) at n = 96 (s =
    32) and n = 1024 (s = 32, 64, 128; n = 512 batched at 64), single and
    batched, the middle round;
    the successor round on bf16 and f16 likewise; and each lowered
    ``solve`` at n = 90 (padded) on the card against the plain path on the
    CPU."""
    import numpy as np
    import torch

    from repro_torch.apsp import solve
    from repro_torch.core.paths import _init_successors
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref

    checked = 0
    shapes = [((96, 96), 32), ((3, 96, 96), 32), ((1024, 1024), 32), ((2, 1024, 1024), 32),
              ((1024, 1024), 64), ((2, 512, 512), 64), ((1024, 1024), 128),
              ((2, 1024, 1024), 128)]
    pos = neg = nans = 0
    for tag, name in LOWERED_CASES:
        for shape, s in shapes:
            w, sr = lowered_case(tag, name, shape, seed=shape[-1] + s, s=s)
            b = shape[-1] // s // 2
            got = fr.fw_round(w.clone(), b, block_size=s, semiring=sr)
            want = ref.fw_round_ref(w, b, block_size=s, semiring=sr)
            sync()
            what = f"fw_round[{tag}] {shape} s={s}"
            require(got.dtype == w.dtype and same(got, want), f"{what} {name} != plain")
            if tag in ("bf16", "f16"):
                p, q, r = require_salt_survives(what, name, want, zeros=True, nans=True)
                pos, neg, nans = pos + p, neg + q, nans + r
            checked += 1
    for dt in (torch.bfloat16, torch.float16):
        for shape, s in shapes:
            w = torch.from_numpy(signed_zero_graph("min_plus", shape, s)).cuda().to(dt)
            succ = _init_successors(w).contiguous()
            b = shape[-1] // s // 2
            gd, gs = fr.fw_round_with_successors(w.clone(), succ.clone(), b, block_size=s)
            wd, ws = ref.fw_round_with_successors_ref(w, succ, b, block_size=s)
            sync()
            require(same(gd, wd) and same(gs, ws),
                    f"fw_round_with_successors[{dt}] {shape} s={s} != plain")
            checked += 1
    rng = np.random.default_rng(47)
    w = rng.integers(1, 60, size=(2, 90, 90)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.5] = np.inf
    w[:, np.arange(90), np.arange(90)] = 0.0
    bits = (rng.uniform(size=(37, 90, 90)) < 0.04).astype(np.float32)
    solves = [dict(w=w, dtype=torch.int16), dict(w=w, dtype=torch.bfloat16),
              dict(w=w, dtype=torch.float16), dict(w=w, dtype=torch.bfloat16, successors=True),
              dict(w=w, semiring="max_min", dtype=torch.int16),
              dict(w=bits, semiring="or_and", packed=True)]
    for kw in solves:
        kw = dict(kw, method="fused", block_size=32)
        got = solve(**kw)
        want = solve(**kw, device="cpu")
        require(same(got.dist.cpu(), want.dist) and (
            want.succ is None or same(got.succ.cpu(), want.succ)),
            f"lowered solve {({k: v for k, v in kw.items() if k != 'w'})}: card != plain on the CPU")
        checked += 1
    print(f"check: {checked} lowered kernel-vs-plain cases bitwise equal (the bf16 / f16 "
          f"rounds salted with ±0 and off-diagonal NaN; their outputs: {pos} +0, {neg} -0, "
          f"{nans} NaN)")


def packed_graphs(count: int, n: int, seed: int):
    """``count`` random digraphs of n vertices as bool (count, n, n) on the
    card: edge probability 2/n (a mean out-degree of 2, so closures grow
    over many rounds), self-loops set."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = torch.empty((count, n, n), dtype=torch.bool, device="cuda")
    for g in range(count):
        out[g] = torch.rand((n, n), generator=gen, device="cuda") < 2.0 / n
    out[:, torch.arange(n), torch.arange(n)] = True
    return out


def phase_kernels_lowered(rows: dict, n: int, n_succ: int, s: int = 128):
    """Each lowered launch kind alone at the lowered main path's shapes
    (n = 8192, s = 128, round T/2; successors at n_succ) against the plain
    version of its phase: the int16 and bf16 / f16 min-plus lowerings and
    the packed or_and words.  Bound: operations (``LOWERED_OPS`` a
    relaxation) over 67 TOP/s, or bytes in the storage word over 3.35 TB/s,
    whichever is larger."""
    import numpy as np
    import torch

    from repro_torch.apsp import api
    from repro_torch.core.graph import random_digraph
    from repro_torch.core.paths import _init_successors
    from repro_torch.core.semiring import MIN_PLUS, MIN_PLUS_I16, OR_AND_PACKED
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref

    record = functools.partial(record_kernel, rows)
    T = n // s
    b = T // 2
    o = slice(b * s, (b + 1) * s)
    w32 = torch.from_numpy(random_digraph(n, density=0.5, seed=1)).cuda()
    words = np.random.default_rng(48).integers(0, 1 << 32, (n, n), dtype=np.uint64)
    inputs = {
        "int16": (api._coerce(w32, MIN_PLUS_I16, None, w32.device), MIN_PLUS_I16),
        "bf16": (w32.to(torch.bfloat16), MIN_PLUS),
        "f16": (w32.to(torch.float16), MIN_PLUS),
        "packed": (torch.from_numpy(words.astype(np.uint32).view(np.int32)).cuda(), OR_AND_PACKED),
    }
    del w32, words
    for tag, (w, sr) in inputs.items():
        ops, word = LOWERED_OPS[tag], LOWERED_WORD[tag]
        bands = fr.round_buffers(w, s)
        kw = dict(block_size=s, semiring=sr)
        fr.fw_round_phase("diag", w, b, bands, **kw)
        diag = ref.close_diag(w[o, o], sr)
        sync()
        require(same(bands[0][0, :, o], diag) and same(bands[1][0, o, :], diag),
                f"diag[{tag}] launch != plain close_diag")
        record(f"fw_round/diag[{tag}]", max_abs_err(bands[0][0, :, o], diag),
               event_ms(lambda: fr.fw_round_phase("diag", w, b, bands, **kw), 11),
               event_ms(lambda: ref.close_diag(w[o, o], sr), 3), ops * s**3, 2 * s * s * word)
        fr.fw_round_phase("bands", w, b, bands, **kw)
        row, col = ref.close_bands(w, diag, b, sr)
        sync()
        require(same(bands[0][0], row) and same(bands[1][0], col),
                f"bands[{tag}] launch != plain close_bands")
        tiles = 2 * (T - 1)
        record(f"fw_round/bands[{tag}]",
               max(max_abs_err(bands[0][0], row), max_abs_err(bands[1][0], col)),
               event_ms(lambda: fr.fw_round_phase("bands", w, b, bands, **kw), 11),
               event_ms(lambda: ref.close_bands(w, diag, b, sr), 3),
               ops * tiles * s**3, (s * s + 2 * tiles * s * s) * word)
        wk = w.clone()
        fr.fw_round_phase("relax", wk, b, bands, **kw)
        want = ref.relax(w, row, col, b, semiring=sr)
        sync()
        require(same(wk, want), f"relax[{tag}] launch != plain relax")
        record(f"fw_round/relax[{tag}]", max_abs_err(wk, want),
               event_ms(lambda: fr.fw_round_phase("relax", wk, b, bands, **kw), 5),
               event_ms(lambda: ref.relax(w, row, col, b, semiring=sr), 1),
               ops * n * n * s, (2 * n * n + 2 * n * s) * word)
        del w, wk, want, bands, row, col
    inputs.clear()

    T = n_succ // s
    b = T // 2
    o = slice(b * s, (b + 1) * s)
    w32 = torch.from_numpy(random_digraph(n_succ, density=0.5, seed=2)).cuda()
    succ = _init_successors(w32).contiguous()
    for tag, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        w = w32.to(dt)
        bands = fr.succ_round_buffers(w, s)
        word = 2 + 4  # distance + next hop
        fr.fw_round_with_successors_phase("diag", w, succ, b, bands, block_size=s)
        diag, dsucc = ref.close_diag_succ(w[o, o], succ[o, o])
        sync()
        require(same(bands[0][0, :, o], diag) and same(bands[2][0, :, o], dsucc),
                f"successor diag[{tag}] launch != plain")
        record(f"fw_round_with_successors/diag[{tag}]", max_abs_err(bands[0][0, :, o], diag),
               event_ms(lambda: fr.fw_round_with_successors_phase(
                   "diag", w, succ, b, bands, block_size=s), 11),
               event_ms(lambda: ref.close_diag_succ(w[o, o], succ[o, o]), 3),
               3.0 * s**3, 2 * s * s * word)
        fr.fw_round_with_successors_phase("bands", w, succ, b, bands, block_size=s)
        want_b = ref.close_bands_succ(w, succ, diag, dsucc, b)
        sync()
        require(all(same(g[0], x) for g, x in zip(bands, (want_b[0], want_b[2], want_b[1],
                                                            want_b[3]))),
                f"successor bands[{tag}] launch != plain")
        tiles = 2 * (T - 1)
        record(f"fw_round_with_successors/bands[{tag}]",
               max(max_abs_err(bands[0][0], want_b[0]), max_abs_err(bands[1][0], want_b[2])),
               event_ms(lambda: fr.fw_round_with_successors_phase(
                   "bands", w, succ, b, bands, block_size=s), 11),
               event_ms(lambda: ref.close_bands_succ(w, succ, diag, dsucc, b), 3),
               3.0 * tiles * s**3, (s * s + 2 * tiles * s * s) * word)
        wk, sk = w.clone(), succ.clone()
        fr.fw_round_with_successors_phase("relax", wk, sk, b, bands, block_size=s)
        wd, ws = ref.relax_succ_tiles(w, succ, *want_b, b)
        sync()
        require(same(wk, wd) and same(sk, ws), f"successor relax[{tag}] launch != plain")
        record(f"fw_round_with_successors/relax[{tag}]", max_abs_err(wk, wd),
               event_ms(lambda: fr.fw_round_with_successors_phase(
                   "relax", wk, sk, b, bands, block_size=s), 5),
               event_ms(lambda: ref.relax_succ_tiles(w, succ, *want_b, b), 1),
               3.0 * n_succ * n_succ * s, (2 * n_succ * n_succ + 2 * n_succ * s) * word)
        del w, wk, sk, bands, want_b, wd, ws


def phase_main_lowered(rows: dict, n: int, n_succ: int, s: int = 128, graphs: int = 32):
    """The lowered main path: ``solve`` of the main path's n = 8192 graph with
    dtype=int16, in bf16 and in f16; ``solve(bits, semiring="or_and",
    packed=True)`` of 32 graphs of n = 8192; ``solve(successors=True)`` of
    the n_succ graph in bf16 and in f16.  Launch counts of that run; each
    result against its plain round loop on the card by bits; median of 3
    and device time by launch kind."""
    import torch

    from repro_torch.apsp import api, solve
    from repro_torch.core.graph import random_digraph
    from repro_torch.core.semiring import MIN_PLUS, MIN_PLUS_I16, OR_AND_PACKED
    from repro_torch.kernels import fw_round as fr

    w = torch.from_numpy(random_digraph(n, density=0.5, seed=0)).cuda()
    ws = torch.from_numpy(random_digraph(n_succ, density=0.5, seed=3)).cuda()
    wb, wh = w.to(torch.bfloat16), w.to(torch.float16)
    wsb, wsh = ws.to(torch.bfloat16), ws.to(torch.float16)
    bits = packed_graphs(graphs, n, seed=49)
    del ws
    runs = {
        "int16": lambda: solve(w, dtype=torch.int16),
        "bf16": lambda: solve(wb),
        "f16": lambda: solve(wh),
        "packed": lambda: solve(bits, semiring="or_and", packed=True),
        "bf16 successors": lambda: solve(wsb, successors=True),
        "f16 successors": lambda: solve(wsh, successors=True),
    }
    fr.reset_launch_counts()
    results = {label: run() for label, run in runs.items()}
    sync()
    counts = dict(fr.LAUNCHES)
    print(f"lowered main path launch counts: {json.dumps({k: v for k, v in counts.items() if v})}")
    for kind in round_lowered_kinds():
        rows[kind]["launches"] = counts[kind]
        require(counts[kind] > 0, f"{kind} was not launched on the lowered main path")

    def check(label, got, want, plain_ms):
        require(same(got, want), f"lowered solve {label} != plain round loop")
        print(f"main lowered {label}: == plain round loop on the card by bits "
              f"(plain {plain_ms:.0f} ms)")

    plain = {}
    for label, wt, sr in (("int16", api._coerce(w, MIN_PLUS_I16, None, w.device), MIN_PLUS_I16),
                          ("bf16", wb, MIN_PLUS), ("f16", wh, MIN_PLUS)):
        t0 = time.perf_counter()
        want = plain_solve(wt, block_size=s, semiring=sr)
        sync()
        plain[label] = (time.perf_counter() - t0) * 1e3
        check(label, results[label].dist, want, plain[label])
        require(results[label].dist.dtype == wt.dtype, f"{label} solve changed the dtype")
        del want
    words = api.pack_reachability(bits)
    t0 = time.perf_counter()
    want = api.unpack_reachability(plain_solve(words, block_size=s, semiring=OR_AND_PACKED),
                                   graphs, dtype=torch.bool)
    sync()
    plain["packed"] = (time.perf_counter() - t0) * 1e3
    check("packed", results["packed"].dist, want, plain["packed"])
    reach = results["packed"].dist.sum(dim=(1, 2)).float().mean().item() / n / n
    print(f"main lowered packed: {graphs} graphs of n={n}, mean reachable share {reach:.4f}")
    del want
    for label, wt in (("bf16 successors", wsb), ("f16 successors", wsh)):
        t0 = time.perf_counter()
        want_d, want_s = plain_solve_succ(wt, block_size=s)
        sync()
        plain[label] = (time.perf_counter() - t0) * 1e3
        check(label, results[label].dist, want_d, plain[label])
        require(same(results[label].succ, want_s), f"lowered solve {label} next hops != plain")
        del want_d, want_s
    results.clear()

    for label, run in runs.items():
        run()  # warm-up
        times = [host_ms(run) for _ in range(3)]
        nn = n_succ if "successors" in label else n
        tag = label.split()[0]
        word = LOWERED_WORD[tag] + (4 if "successors" in label else 0)
        ops = (3.0 if "successors" in label else LOWERED_OPS[tag]) * nn**3
        bms, by = bound(ops, (nn // s) * 2.0 * nn * nn * word)
        extra = f", {graphs * nn**3 / (statistics.median(times) / 1e3):.4e} graph-relaxations/s" \
            if tag == "packed" else ""
        print(f"main lowered solve {label} n={nn}: median {statistics.median(times):.2f} ms of "
              f"{['%.2f' % t for t in times]}, bound {bms:.2f} ms by {by}{extra}, "
              f"plain {plain[label]:.0f} ms")
    for label, wt, sr in (("int16", api._coerce(w, MIN_PLUS_I16, None, w.device), MIN_PLUS_I16),
                          ("bf16", wb, MIN_PLUS), ("packed", api.pack_reachability(bits)[0],
                                                   OR_AND_PACKED)):
        bands = fr.round_buffers(wt, s)
        wk = wt.clone()
        launch_breakdown(f"main lowered breakdown {label} n={n}", [
            (p, functools.partial(fr.fw_round_phase, p, wk, b, bands, block_size=s, semiring=sr))
            for b in range(n // s) for p in fr.PHASES])


# ------------------------------------------- lowered repair and sweep
# Every storage of the repair kernels: the round's lowerings and the int32
# carriers of the integer or_and / plus_mul storages; the sweep takes all
# but plus_mul.
STORAGE_CASES = LOWERED_CASES + [("or_and_i32", "or_and"), ("plus_mul_i32", "plus_mul")]
SWEEP_STORAGE_CASES = [c for c in STORAGE_CASES if c[1] != "plus_mul"]
LOWERED_OPS.update({"or_and_i32": 2, "plus_mul_i32": 2})  # min, max / mul, add
# Storages whose repair apply relaxes on lifted operands (min-plus here): an
# add and a min a relaxation, the round or clamp once an element at the store.
LIFTED_APPLY = ("int16", "bf16", "f16")
LOWERED_WORD.update({"or_and_i32": 4, "plus_mul_i32": 4})


def storage_case(tag: str, name: str, shape, seed: int, s: int, salt: str = "zero"):
    """(d on the card, its semiring) in a kernel's storage: ``lowered_case``
    for int16 and packed words; bf16 / f16 salted with ±0
    (``signed_zero_graph``, salt "zero") or, separately, with NaNs off the
    diagonal tiles (``domain_graph`` + ``nan_salted``, salt "nan"; salt
    "domain": the domain graph alone, for ``nan_off_edges``); the int32
    carrier of or_and on small integers and of plus_mul on full-range ones
    (every product and sum wraps)."""
    import numpy as np
    import torch

    from repro_torch.core.semiring import SEMIRINGS

    if tag in INT32_TAGS:
        rng = np.random.default_rng(seed)
        lo, hi = (-1000, 1000) if tag == "or_and_i32" else (-(1 << 31), 1 << 31)
        return (torch.from_numpy(rng.integers(lo, hi, size=shape).astype(np.int32)).cuda(),
                SEMIRINGS[name])
    if tag not in ("bf16", "f16"):
        return lowered_case(tag, name, shape, seed, s)
    dt = {"bf16": torch.bfloat16, "f16": torch.float16}[tag]
    if salt == "zero":
        w = signed_zero_graph(name, shape, seed)
    elif salt == "nan":
        w = nan_salted(domain_graph(name, shape, seed), seed, 2,
                       [(b * s, b * s + s) for b in range(shape[-1] // s)])
    else:
        w = domain_graph(name, shape, seed)
    return torch.from_numpy(w).cuda().to(dt), SEMIRINGS[name]


def nan_off_edges(d, u, v, seed: int, count: int = 4):
    """d (copied) with ``count`` NaNs at (i, j), i != j, outside the rows v_e
    and the columns u_e of the edges (padding edges included): a repair
    reads d[i, u_e] and d[v_e, j], so a NaN there would flood whole rows
    and columns, while one elsewhere stays where it is."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = d.clone()
    rows, cols = set(int(x) for x in v), set(int(x) for x in u)
    placed = 0
    while placed < count:
        i, j = (int(x) for x in rng.integers(0, d.shape[-1], 2))
        if i != j and i not in rows and j not in cols:
            d[i, j] = float("nan")
            placed += 1
    return d


def salts(tag: str):
    return ("zero", "nan") if tag in ("bf16", "f16") else ("plain",)


def lowered_edges(d, sr, E: int, seed: int):
    """E edge updates in d's storage (a repeated u, a u == v edge), padded as
    the engine pads them with no-op edges (u = v = 0, w = 0̄): int16 weights
    in [-5, 30), random int32 lane masks (packed) or full-range int32
    integers, and floats in ``domain_graph``'s domain for bf16 / f16 (so a
    salted ±0 survives the repair)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = d.shape[-1]
    E_pad = max(4, 1 << (E - 1).bit_length())
    u = np.zeros(E_pad, np.int32)
    v = np.zeros(E_pad, np.int32)
    u[:E] = rng.integers(0, n, E)
    v[:E] = rng.integers(0, n, E)
    if E > 2:
        u[1], v[2] = u[0], u[2]
    if d.dtype == torch.int32:
        x = rng.integers(-(1 << 31), 1 << 31, E_pad).astype(np.int32)
    elif d.dtype == torch.int16:
        x = rng.integers(-5, 30, E_pad).astype(np.int16)
    elif sr.name == "plus_mul":
        x = rng.uniform(0.0, 1.0 / n, E_pad).astype(np.float32)
    elif sr.name == "or_and":
        x = np.ones(E_pad, np.float32)
    elif sr.name in ("max_plus", "max_min"):  # domain_graph's weights: no zero is beaten
        x = rng.uniform(-10.0, -1.0, E_pad).astype(np.float32)
    else:
        x = rng.uniform(1.0, 10.0, E_pad).astype(np.float32)
    w = torch.from_numpy(x).to(d.dtype)
    w[E:] = sr.zero
    return u, v, w


def strip_heights(n: int, salt: str):
    """The affected-row counts a sweep check runs: 1 and 37 (strips of 8 and
    64 rows), and 200 at n = 1024 (256 rows), each relax on every tile;
    only 1 on a NaN-salted n = 96 (a NaN reaches every strip row through
    the band's columns, so 37 rows of 96 would leave under half the output
    finite)."""
    if n < 128:
        return (1,) if salt == "nan" else (1, 37)
    return (1, 37, 200)


def nan_off_strip(d, rows, s: int, seed: int, count: int = 4):
    """d (copied) with ``count`` NaNs off the strip rows and off the diagonal
    tiles: there a NaN spreads along its column of the band, and from
    there over the strip rows only, never over the static rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = d.clone()
    strip = set(int(r) for r in rows)
    placed = 0
    while placed < count:
        i, j = (int(x) for x in rng.integers(0, d.shape[-1], 2))
        if i not in strip and i // s != j // s:
            d[i, j] = float("nan")
            placed += 1
    return d


def phase_check_lowered_repair():
    """The lowered repair and sweep kernels and the int32 round, bitwise
    against their plain versions on the card, each launch kind alone too:
    the repair on every storage (int16 ×4, packed, bf16 and f16 ×5, int32
    or_and / plus_mul) at n ∈ {96, 1024} with E ∈ {1, 16, 37, 64} (padded
    as the engine pads; 64 takes two launch pairs), bf16 / f16 salted
    with ±0 and, separately, with off-diagonal NaN, and each launch alone
    at E ∈ {1, 16, 37, 64} on both apply paths
    (``check_repair_phases``); the successor repair on bf16 / f16 likewise; the sweep on every storage but
    plus_mul at n = 96 (s = 32) and n = 1024 (s = 128) with a ∈ {1, 37}
    affected rows, each launch kind alone in the round of the first
    affected row; the successor sweep likewise; the int32 round at n = 96
    and 1024, single and batched; and ``repair_del`` at n = 1000 through
    int16, bf16, f16, packed and uint8 or_and engines (bf16 with next hops
    too) on the card against the engine's plain path on the CPU."""
    import numpy as np
    import torch

    from repro_torch.apsp import ApspEngine, api
    from repro_torch.core.paths import _init_successors
    from repro_torch.core.semiring import SEMIRINGS
    from repro_torch.kernels import fw_repair as fp
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref

    checked = 0
    pos = neg = nans = 0

    def salt_held(what, name, want, salt):
        nonlocal pos, neg, nans
        if salt in ("zero", "nan"):
            p, q, r = require_salt_survives(what, name, want, zeros=salt == "zero",
                                            nans=salt == "nan")
            pos, neg, nans = pos + p, neg + q, nans + r

    for tag, name in STORAGE_CASES:
        for n in (96, 1024):
            for salt in salts(tag):
                base, sr = storage_case(tag, name, (n, n), seed=n + 3, s=32,
                                        salt="domain" if salt == "nan" else salt)
                for E in (1, 16, 37, 64):
                    u, v, w = lowered_edges(base, sr, E, seed=E)
                    d = nan_off_edges(base, u, v, E) if salt == "nan" else base
                    got = fp.fw_repair(d, u, v, w, block_size=32, semiring=sr)
                    want = ref.fw_repair_ref(d, u, v, w, semiring=sr)
                    sync()
                    what = f"fw_repair[{tag}] {name} n={n} E={E} {salt}"
                    require(got.dtype == d.dtype and same(got, want), f"{what} != plain")
                    salt_held(what, name, want, salt)
                    checked += 1
                for E in (1, 16, 37, fp.MAX_EDGES):  # each launch alone, both paths
                    u, v, w = fp.edge_vectors(*lowered_edges(d, sr, E, seed=5), n, d.device,
                                              d.dtype)
                    checked += check_repair_phases(d, sr, u[:E], v[:E], w[:E])
    for tag in ("bf16", "f16"):
        for n in (96, 1024):
            for salt in salts(tag):
                base, sr = storage_case(tag, "min_plus", (n, n), seed=n + 4, s=32,
                                        salt="domain" if salt == "nan" else salt)
                succ = _init_successors(base).contiguous()
                for E in (1, 16, 37, 64):
                    u, v, w = lowered_edges(base, sr, E, seed=E + 1)
                    d = nan_off_edges(base, u, v, E) if salt == "nan" else base
                    gd, gs = fp.fw_repair_with_successors(d, succ, u, v, w, block_size=32)
                    wd, ws = ref.fw_repair_with_successors_ref(d, succ, u, v, w)
                    sync()
                    what = f"fw_repair_with_successors[{tag}] n={n} E={E} {salt}"
                    require(same(gd, wd) and same(gs, ws), f"{what} != plain")
                    salt_held(what, "min_plus", wd, salt)
                    checked += 1
                for E in (1, 16, 37, fp.MAX_EDGES):
                    u, v, w = fp.edge_vectors(*lowered_edges(d, sr, E, seed=6), n, d.device,
                                              d.dtype)
                    checked += check_repair_phases(d, sr, u[:E], v[:E], w[:E], succ=succ)
    for tag, name in SWEEP_STORAGE_CASES:
        for n, s in ((96, 32), (1024, 128)):
            for salt in salts(tag):
                base, sr = storage_case(tag, name, (n, n), seed=n + 5, s=s,
                                        salt="domain" if salt == "nan" else salt)
                for a in strip_heights(n, salt):
                    rows = strip_rows(n, a, seed=a + n)
                    d = nan_off_strip(base, rows, s, a) if salt == "nan" else base
                    check_sweep_phases(d, rows, int(rows[0]) // s, s, sr=sr)
                    got = fd.fw_repair_del_sweep(d, rows, block_size=s, semiring=sr)
                    want = ref.fw_repair_del_sweep_ref(d, rows, block_size=s, semiring=sr)
                    sync()
                    what = f"fw_repair_del_sweep[{tag}] {name} n={n} a={a} {salt}"
                    require(got.dtype == d.dtype and same(got, want), f"{what} != plain")
                    salt_held(what, name, want, salt)
                    checked += 4
    for tag in ("bf16", "f16"):
        for n, s in ((96, 32), (1024, 128)):
            for salt in salts(tag):
                base, _ = storage_case(tag, "min_plus", (n, n), seed=n + 6, s=s,
                                       salt="domain" if salt == "nan" else salt)
                succ = _init_successors(base).contiguous()
                for a in strip_heights(n, salt):
                    rows = strip_rows(n, a, seed=a + n + 1)
                    d = nan_off_strip(base, rows, s, a) if salt == "nan" else base
                    check_sweep_phases(d, rows, int(rows[0]) // s, s, succ=succ)
                    gd, gs = fd.fw_repair_del_sweep_with_successors(d, succ, rows, block_size=s)
                    wd, ws = ref.fw_repair_del_sweep_with_successors_ref(d, succ, rows,
                                                                         block_size=s)
                    sync()
                    require(same(gd, wd) and same(gs, ws),
                            f"fw_repair_del_sweep_with_successors[{tag}] n={n} a={a} {salt}"
                            f" != plain")
                    checked += 4
    for tag in INT32_TAGS:
        name = tag.removesuffix("_i32")
        for shape, s in (((96, 96), 32), ((2, 96, 96), 32), ((1024, 1024), 128),
                         ((2, 1024, 1024), 128)):
            w, sr = storage_case(tag, name, shape, seed=shape[-1], s=s)
            b = shape[-1] // s // 2
            got = fr.fw_round(w.clone(), b, block_size=s, semiring=sr)
            want = ref.fw_round_ref(w, b, block_size=s, semiring=sr)
            sync()
            require(same(got, want), f"fw_round[{tag}] {shape} s={s} != plain")
            checked += 1
    w = integer_graph(1000, 25, hi=8, density=0.05)
    bits = (np.random.default_rng(26).uniform(size=(32, 1000, 1000)) < 0.002)
    bits[:, np.arange(1000), np.arange(1000)] = True
    words = api.pack_reachability(torch.from_numpy(bits)).numpy()
    engines = [(dict(dtype=torch.int16), w), (dict(dtype=torch.bfloat16), w),
               (dict(dtype=torch.float16), w), (dict(semiring="or_and", packed=True), words),
               (dict(semiring="or_and"), np.isfinite(w).astype(np.uint8))]
    for kw, x in engines:
        eng, host = ApspEngine(**kw), ApspEngine(device="cpu", **kw)
        r0 = eng.solve(x)
        dels, x1 = lowered_deletions(x, r0.dist, 8, seed=27)
        got = eng.repair_del(r0.dist, x1, dels, threshold=100.0)
        want = host.repair_del(r0.dist.cpu(), x1, dels, threshold=100.0)
        require(got.padded_n == 1024 and same(got.dist.cpu(), want.dist)
                and eng.stats.repair_dels == host.stats.repair_dels == 1,
                f"engine repair_del {kw} n=1000 on the card != plain on the CPU")
        checked += 1
    eng, host = ApspEngine(dtype=torch.bfloat16), ApspEngine(dtype=torch.bfloat16, device="cpu")
    r0 = eng.solve(w, successors=True)
    dels, w1 = lowered_deletions(w, r0.dist, 8, seed=28)
    got = eng.repair_del(r0.dist, w1, dels, succ=r0.succ, threshold=100.0)
    want = host.repair_del(r0.dist.cpu(), w1, dels, succ=r0.succ.cpu(), threshold=100.0)
    require(same(got.dist.cpu(), want.dist) and same(got.succ.cpu(), want.succ),
            "engine bf16 successor repair_del n=1000 on the card != plain on the CPU")
    checked += 1
    print(f"check: {checked} lowered repair / sweep / int32 round kernel-vs-plain cases "
          f"bitwise equal (bf16 / f16 salted with ±0 and, apart, off-diagonal NaN; their "
          f"outputs: {pos} +0, {neg} -0, {nans} NaN)")


def phase_kernels_lowered_repair(rows: dict, n: int, n_succ: int, E: int = 16,
                                 s: int = 128, a: int = 8):
    """Each lowered repair, sweep and int32 round launch kind alone at the
    lowered engine path's shapes (n = 8192, E = 16, sweep a = 8 affected
    rows in round T/2, and 256 checked, whose relax takes the long tile;
    successors at n_succ, and a = n_succ) against the plain version of
    its phase: the min-plus lowerings in int16, bf16 and f16, the packed
    or_and word plane and the int32 carriers of or_and and plus_mul.
    Bound: operations (``LOWERED_OPS`` a relaxation; successors 3; the
    apply of a lifted storage, ``LIFTED_APPLY``, 2) over 67 TOP/s, or
    bytes in the storage word over 3.35 TB/s, each input read once and each
    output written once, whichever is larger.  The repair rows' errors are
    read from the timed launches' own outputs (``timed_repair_errors``)."""
    import numpy as np
    import torch

    from repro_torch.core.graph import random_digraph
    from repro_torch.core.paths import _init_successors
    from repro_torch.core.semiring import MIN_PLUS, MIN_PLUS_I16, OR_AND, OR_AND_PACKED, PLUS_MUL
    from repro_torch.apsp import api
    from repro_torch.kernels import fw_repair as fp
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref
    from repro_torch.launch.round_bench import device_ms

    record = functools.partial(record_kernel, rows)
    w32 = torch.from_numpy(random_digraph(n, density=0.5, seed=1)).cuda()
    words = np.random.default_rng(50).integers(0, 1 << 32, (n, n), dtype=np.uint64)
    carrier = np.random.default_rng(51).integers(-1000, 1000, (n, n)).astype(np.int32)
    inputs = {
        "int16": lambda: (api._coerce(w32, MIN_PLUS_I16, None, w32.device), MIN_PLUS_I16),
        "bf16": lambda: (w32.to(torch.bfloat16), MIN_PLUS),
        "f16": lambda: (w32.to(torch.float16), MIN_PLUS),
        "packed": lambda: (torch.from_numpy(words.astype(np.uint32).view(np.int32)).cuda(),
                           OR_AND_PACKED),
        "or_and_i32": lambda: (torch.from_numpy(carrier).cuda(), OR_AND),
        "plus_mul_i32": lambda: (torch.from_numpy(carrier).cuda(), PLUS_MUL),
    }
    T, b = n // s, n // s // 2
    o = slice(b * s, (b + 1) * s)
    for tag, make in inputs.items():
        d, sr = make()
        ops, word = LOWERED_OPS[tag], LOWERED_WORD[tag]
        u, v, w = fp.edge_vectors(*lowered_edges(d, sr, E, seed=52), n, d.device, d.dtype)
        check_repair_phases(d, sr, u, v, w)
        bufs, out = fp.repair_buffers(d, E), torch.empty_like(d)
        stage = lambda: fp.repair_phase("stage", d, u, v, w, bufs, semiring=sr)  # noqa: E731
        apply = lambda: fp.repair_phase("apply", d, u, v, w, bufs, out,  # noqa: E731
                                        semiring=sr)
        stage()
        stage_w, apply_w = repair_work(E, n, word, ops,
                                       apply_ops=2 if tag in LIFTED_APPLY else None)
        ms_s, dev_s = event_ms(stage, 11), device_ms(stage)
        ms_a, dev_a = event_ms(apply, 11), device_ms(apply)
        err_s, err_a = timed_repair_errors(d, sr, u, v, w, bufs, out)
        record(f"fw_repair/stage[{tag}]", err_s, ms_s,
               event_ms(lambda: ref.repair_stage_ref(d, u, v, w, semiring=sr), 3), *stage_w,
               note=f" n={n} E={E}, device {dev_s:.4f} ms")
        record(f"fw_repair/apply[{tag}]", err_a, ms_a,
               event_ms(lambda: ref.repair_apply_ref(d, bufs.staged, u, w, semiring=sr), 3),
               *apply_w, note=f" n={n} E={E}, device {dev_a:.4f} ms")
        del out, bufs
        if tag in INT32_TAGS:  # the int32 round (solve of an integer storage)
            bands = fr.round_buffers(d, s)
            kw = dict(block_size=s, semiring=sr)
            fr.fw_round_phase("diag", d, b, bands, **kw)
            diag = ref.close_diag(d[o, o], sr)
            sync()
            require(same(bands[0][0, :, o], diag), f"diag[{tag}] launch != plain close_diag")
            record(f"fw_round/diag[{tag}]", 0.0,
                   event_ms(lambda: fr.fw_round_phase("diag", d, b, bands, **kw), 11),
                   event_ms(lambda: ref.close_diag(d[o, o], sr), 3), ops * s**3,
                   2 * s * s * word)
            fr.fw_round_phase("bands", d, b, bands, **kw)
            row, col = ref.close_bands(d, diag, b, sr)
            sync()
            require(same(bands[0][0], row) and same(bands[1][0], col),
                    f"bands[{tag}] launch != plain close_bands")
            tiles = 2 * (T - 1)
            record(f"fw_round/bands[{tag}]", 0.0,
                   event_ms(lambda: fr.fw_round_phase("bands", d, b, bands, **kw), 11),
                   event_ms(lambda: ref.close_bands(d, diag, b, sr), 3),
                   ops * tiles * s**3, (s * s + 2 * tiles * s * s) * word)
            dk = d.clone()
            fr.fw_round_phase("relax", dk, b, bands, **kw)
            want = ref.relax(d, row, col, b, semiring=sr)
            sync()
            require(same(dk, want), f"relax[{tag}] launch != plain relax")
            record(f"fw_round/relax[{tag}]", 0.0,
                   event_ms(lambda: fr.fw_round_phase("relax", dk, b, bands, **kw), 5),
                   event_ms(lambda: ref.relax(d, row, col, b, semiring=sr), 1),
                   ops * n * n * s, (2 * n * n + 2 * n * s) * word)
            del dk, want, bands, row, col
        if tag == "plus_mul_i32":
            continue
        sw, errs = check_sweep_phases(d, strip_rows(n, a, seed=53), b, s, sr=sr)
        plain = {
            "diag": lambda: ref.sweep_diag_ref(d, sw.strip, sw.rows, b, block_size=s,
                                               semiring=sr),
            "panels": lambda: ref.sweep_panels_ref(d, sw.strip, sw.rows, sw.band[:, o], b,
                                                   semiring=sr),
            "relax": lambda: ref.sweep_relax_ref(sw.strip, sw.rows, sw.band, sw.acol, b,
                                                 semiring=sr),
        }
        work = {  # (operations, bytes), as phase_kernels_repair_del counts them
            "diag": (ops * s**3, 2 * s * s * word),
            "panels": (ops * ((T - 1) * s**3 + a * s * s),
                       ((2 * T - 1) * s * s + 2 * a * s) * word),
            "relax": (ops * a * n * s, (2 * a * n + a * s + s * n) * word),
        }
        for phase in fd.PHASES:
            record(f"fw_repair_del_sweep/{phase}[{tag}]", errs[phase],
                   event_ms(lambda: fd.sweep_phase(phase, sw, b, semiring=sr), 11),
                   event_ms(plain[phase], 3), *work[phase])
        # a strip of 256 rows, whose relax takes the long tile at this n
        check_sweep_phases(d, strip_rows(n, 256, seed=57), b, s, sr=sr)
        del d, sw
    inputs.clear()
    del w32

    T, b = n_succ // s, n_succ // s // 2
    o = slice(b * s, (b + 1) * s)
    w32 = torch.from_numpy(random_digraph(n_succ, density=0.5, seed=2)).cuda()
    succ = _init_successors(w32).contiguous()
    for tag, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        d = w32.to(dt)
        word = 2 + 4  # distance + next hop
        u, v, w = fp.edge_vectors(*lowered_edges(d, MIN_PLUS, E, seed=54), n_succ, d.device,
                                  d.dtype)
        check_repair_phases(d, MIN_PLUS, u, v, w, succ=succ)
        bufs = fp.repair_buffers(d, E, successors=True)
        out, sout = torch.empty_like(d), torch.empty_like(succ)
        stage = lambda: fp.repair_succ_phase("stage", d, succ, u, v, w, bufs)  # noqa: E731
        apply = lambda: fp.repair_succ_phase("apply", d, succ, u, v, w, bufs,  # noqa: E731
                                             out, sout)
        stage()
        stage_w, apply_w = repair_work(E, n_succ, 2, 3.0, succ=True)
        ms_s, dev_s = event_ms(stage, 11), device_ms(stage)
        ms_a, dev_a = event_ms(apply, 11), device_ms(apply)
        err_s, err_a = timed_repair_errors(d, MIN_PLUS, u, v, w, bufs, out, succ=succ,
                                           sout=sout)
        record(f"fw_repair_with_successors/stage[{tag}]", err_s, ms_s,
               event_ms(lambda: ref.repair_stage_ref(d, u, v, w, strict=True), 3), *stage_w,
               note=f" n={n_succ} E={E}, device {dev_s:.4f} ms")
        record(f"fw_repair_with_successors/apply[{tag}]", err_a, ms_a,
               event_ms(lambda: ref.repair_apply_succ_ref(d, succ, bufs.staged, u, v, w), 3),
               *apply_w, note=f" n={n_succ} E={E}, device {dev_a:.4f} ms")
        del out, sout, bufs
        sw, errs = check_sweep_phases(d, strip_rows(n_succ, a, seed=55), b, s, succ=succ)
        plain = {
            "diag": lambda: ref.sweep_diag_succ_ref(d, succ, sw.strip, sw.strip_s, sw.rows, b,
                                                    block_size=s),
            "panels": lambda: ref.sweep_panels_succ_ref(
                d, succ, sw.strip, sw.strip_s, sw.rows, sw.band[:, o], sw.band_s[:, o], b),
            "relax": lambda: ref.sweep_relax_succ_ref(
                sw.strip, sw.strip_s, sw.rows, sw.band, sw.band_s, sw.acol, sw.acol_s, b),
        }
        work = {
            "diag": (3.0 * s**3, 2 * s * s * word),
            "panels": (3.0 * ((T - 1) * s**3 + a * s * s),
                       ((2 * T - 1) * s * s + 2 * a * s) * word),
            "relax": (3.0 * a * n_succ * s, (2 * a * n_succ + a * s) * word + s * n_succ * 2),
        }
        for phase in fd.PHASES:
            record(f"fw_repair_del_sweep_with_successors/{phase}[{tag}]", errs[phase],
                   event_ms(lambda: fd.sweep_succ_phase(phase, sw, b), 11),
                   event_ms(plain[phase], 3), *work[phase])
        # the relax at every row (the engine path's strip of n_succ rows)
        sw, errs = check_sweep_phases(d, strip_rows(n_succ, n_succ, seed=56), b, s, succ=succ)
        record(f"fw_repair_del_sweep_with_successors/relax[{tag}]", errs["relax"],
               event_ms(lambda: fd.sweep_succ_phase("relax", sw, b), 11),
               event_ms(plain["relax"], 3), 3.0 * n_succ * n_succ * s,
               (2 * n_succ * n_succ + n_succ * s) * word + s * n_succ * 2,
               note=f" n={n_succ} a={n_succ}", store=False)
        del d, sw


def phase_engine_lowered(rows: dict, n: int, n_succ: int, graphs: int = 32):
    """The lowered engine path: ``ApspEngine`` pinned to each storage on the
    card, at the lowered main path's n.

    int16, bf16 and f16 engines on one integer graph (weights in [1, 16],
    density 0.02: path sums ≤ 256, exact in every storage, so repair and
    repair_del equal a re-solve by bits); a packed or_and engine on one
    word plane of the lowered main path's 32 graphs.  Each: solve, a
    16-edge ``repair`` (lane masks for packed), ``repair_del`` of 1 and of
    16 on-path edges at threshold 100 (the sweep).  bf16 and f16 successor
    ``repair`` and ``repair_del`` at n_succ; a bf16 plus_mul ``repair_del``
    (the counted re-solve); ``solve_many`` of ``graphs`` ragged graphs in
    bf16 and int16.  Launch counts of that run; then every result is
    checked (repairs == re-solve of the updated graph; successor repairs
    == their plain version on the card, dist == re-solve; buckets ==
    per-graph solve) and timed beside its re-solve (CUDA events, median of
    3 after a warm-up)."""
    import numpy as np
    import torch

    from repro_torch.apsp import ApspEngine, api
    from repro_torch.core.graph import random_digraph
    from repro_torch.kernels import fw_repair as fp
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref
    from repro_torch.launch.round_bench import marked_sweep

    w = integer_graph(n, 60, hi=16, density=0.02)
    ws = integer_graph(n_succ, 61, hi=16, density=0.02)
    bits = packed_graphs(graphs, n, seed=49)
    words = api.pack_reachability(bits).cpu().numpy()  # (1, n, n)
    del bits
    rng = np.random.default_rng(62)
    sizes = rng.choice([300, 500, 512, 1000, 1024], size=graphs).tolist()
    many_in = [integer_graph(m, 200 + k, hi=16, density=0.05) for k, m in enumerate(sizes)]
    storages = {"int16": dict(dtype=torch.int16), "bf16": dict(dtype=torch.bfloat16),
                "f16": dict(dtype=torch.float16),
                "packed": dict(semiring="or_and", packed=True)}
    engines = {tag: ApspEngine(**kw) for tag, kw in storages.items()}
    inputs = {tag: (words if tag == "packed" else w) for tag in storages}

    def lane_updates(x, count, seed):
        """Lane masks of edges that some lanes gain (packed ``repair``)."""
        r = np.random.default_rng(seed)
        return [(int(u), int(v), int(r.integers(1, 1 << 31)))
                for u, v in r.integers(0, x.shape[-1], (count, 2)) if u != v]

    for label in ("fw_round", "fw_repair", "fw_repair_del"):
        {"fw_round": fr, "fw_repair": fp, "fw_repair_del": fd}[label].reset_launch_counts()
    res = {}
    for tag, eng in engines.items():
        x = inputs[tag]
        r0 = eng.solve(x)
        upd = lane_updates(x, 16, 63) if tag == "packed" else improvements(
            r0.dist.float(), 16, seed=63)
        rep = eng.repair(r0.dist, upd)
        d1 = lowered_deletions(x, r0.dist, 1, seed=64)
        d16 = lowered_deletions(x, r0.dist, 16, seed=65)
        del1 = eng.repair_del(r0.dist, d1[1], d1[0], threshold=100.0)
        a1 = eng.stats.repair_del_rows
        del16 = eng.repair_del(r0.dist, d16[1], d16[0], threshold=100.0)
        require(eng.stats.repair_dels == 2, f"lowered repair_del[{tag}] did not sweep")
        print(f"lowered repair_del[{tag}] n={n}: affected rows swept: E=1 {a1}, "
              f"E=16 {eng.stats.repair_del_rows - a1}")
        res[tag] = (x, r0, upd, rep, d1, d16, del1, del16)
    succ_res = {}
    for tag in ("bf16", "f16"):
        eng = engines[tag]
        s0 = eng.solve(ws, successors=True)
        upd = improvements(s0.dist.float(), 16, seed=66)
        srep = eng.repair(s0.dist, upd, succ=s0.succ)
        dels = lowered_deletions(ws, s0.dist, 16, seed=67)
        sdel = eng.repair_del(s0.dist, dels[1], dels[0], succ=s0.succ, threshold=100.0)
        succ_res[tag] = (s0, upd, srep, dels, sdel)
    pm = ApspEngine(semiring="plus_mul", dtype=torch.bfloat16)
    wp = np.triu((np.random.default_rng(68).uniform(size=(n, n)) < 0.001)
                 .astype(np.float32), 1)
    p0 = pm.solve(wp)
    u_p, v_p = (int(x) for x in np.argwhere(wp == 1)[0])
    wp1 = wp.copy()
    wp1[u_p, v_p] = 0.0
    prep = pm.repair_del(p0.dist, wp1, [(u_p, v_p, 1.0)])
    many = {tag: engines[tag].solve_many(many_in) for tag in ("bf16", "int16")}
    sync()
    counts = {**fr.LAUNCHES, **fp.LAUNCHES, **fd.LAUNCHES}
    print(f"lowered engine path launch counts: "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    kinds = [k for k in lowered_kinds() if k.startswith(("fw_repair/", "fw_repair_with",
                                                         "fw_repair_del"))
             and not any(t in k for t in INT32_TAGS)]
    for kind in sorted(kinds):
        require(counts[kind] > 0, f"{kind} was not launched on the lowered engine path")
        rows[kind]["launches"] = counts[kind]

    for tag, (x, r0, upd, rep, d1, d16, del1, del16) in res.items():
        eng = engines[tag]
        if tag == "packed":
            x1 = x.copy()
            for u, v, lanes in upd:
                x1[0, u, v] |= lanes
        else:
            x1 = updated(x, upd)
        require(same(rep.dist, eng.solve(x1).dist),
                f"lowered repair[{tag}] n={n} != re-solve of the updated graph")
        for label, (dels, xd), got in (("E=1", d1, del1), ("E=16", d16, del16)):
            require(got.method == "repair_del" and same(got.dist, eng.solve(xd).dist),
                    f"lowered repair_del[{tag}] n={n} {label} != re-solve")
    for tag, (s0, upd, srep, (dels, ws1), sdel) in succ_res.items():
        u, v, x = (np.array(c) for c in zip(*upd))
        wd, wsucc = ref.fw_repair_with_successors_ref(s0.dist, s0.succ, u, v,
                                                      torch.tensor(x).to(s0.dist.dtype))
        require(same(srep.dist, wd) and same(srep.succ, wsucc),
                f"lowered successor repair[{tag}] n={n_succ} != plain")
        eng = engines[tag]
        require(same(srep.dist, eng.solve(updated(ws, upd)).dist),
                f"lowered successor repair[{tag}] n={n_succ}: dist != re-solve")
        r1 = eng.solve(ws1, successors=True)
        require(same(sdel.dist, r1.dist), f"lowered successor repair_del[{tag}] dist != re-solve")
        walked = walk_paths(sdel, ws1, 256, seed=69)
        require(walked == 256, f"successor repair_del[{tag}]: {walked} paths walked")
    require(pm.stats.repair_del_fallbacks == 1 and pm.stats.repair_dels == 0
            and same(prep.dist, pm.solve(wp1).dist),
            "bf16 plus_mul repair_del != its counted re-solve")
    for tag, results in many.items():
        for g, r in zip(many_in, results):
            require(same(r.dist, engines[tag].solve(g).dist),
                    f"solve_many[{tag}] n={r.n} != per-graph solve")
    print(f"lowered engine checks: int16 / bf16 / f16 / packed repair E=16 and repair_del "
          f"E=1 / E=16 at n={n} == re-solve by bits; bf16 / f16 successor repair == plain "
          f"and its dist == re-solve, successor repair_del dist == re-solve with 256 walked "
          f"paths each; bf16 plus_mul repair_del re-solved (counted); solve_many of "
          f"{graphs} in bf16 and int16 == per-graph")

    def timed(fn):
        return event_ms(fn, 3)

    for tag, (x, r0, upd, rep, d1, d16, del1, del16) in res.items():
        eng = engines[tag]
        xs = torch.as_tensor(x).cuda()
        t_solve = timed(lambda: eng.solve(xs))
        t_rep = timed(lambda: eng.repair(r0.dist, upd))
        line = [f"repair E=16 {t_rep:.3f} ms ({t_solve / t_rep:.1f}x)"]
        for label, (dels, xd) in (("E=1", d1), ("E=16", d16)):
            xd = torch.as_tensor(xd).cuda()
            t = timed(lambda: eng.repair_del(r0.dist, xd, dels, threshold=100.0))
            line.append(f"repair_del {label} {t:.3f} ms ({t_solve / t:.1f}x)")
        print(f"engine lowered {tag} n={n}: solve {t_solve:.2f} ms; " + "; ".join(line))
    for tag, (s0, upd, srep, (dels, ws1), sdel) in succ_res.items():
        eng = engines[tag]
        wst = torch.from_numpy(ws1).cuda()
        t_solve = timed(lambda: eng.solve(wst, successors=True))
        t_rep = timed(lambda: eng.repair(s0.dist, upd, succ=s0.succ))
        t_del = timed(lambda: eng.repair_del(s0.dist, wst, dels, succ=s0.succ, threshold=100.0))
        _, sweep, sw, _ = marked_sweep(s0.dist, wst.to(s0.dist.dtype), dels, succ=s0.succ)
        a = int((sw.rows < n_succ).sum())
        print(f"engine lowered {tag} successors n={n_succ}: solve {t_solve:.2f} ms; repair "
              f"E=16 {t_rep:.3f} ms ({t_solve / t_rep:.1f}x); repair_del E=16 {t_del:.3f} ms "
              f"({t_solve / t_del:.1f}x), a={a} affected rows")
        host_device_split(f"sweep host / device lowered {tag} successors n={n_succ} E=16 a={a}",
                          sweep, 3 * (n_succ // 128))
    wpt = torch.from_numpy(wp1).cuda()
    t = timed(lambda: pm.repair_del(p0.dist, wpt, [(u_p, v_p, 1.0)]))
    print(f"engine lowered bf16 plus_mul repair_del n={n} (counted re-solve): {t:.2f} ms")
    for tag in many:
        t = timed(lambda: engines[tag].solve_many(many_in))
        print(f"engine lowered {tag} solve_many of {graphs} ragged graphs from host arrays: "
              f"{t:.2f} ms, {graphs / (t / 1e3):.1f} graphs/s")


def walk_paths(res, w, count: int, seed: int) -> int:
    """Walk ``count`` sampled finite pairs of a successor result through its
    next hops; each path must start and end right and cost dist (f32
    path sums of the integer weights w)."""
    import numpy as np

    from repro_torch.core.paths import extract_path, path_cost

    dist, succ = res.dist.float().cpu().numpy(), res.succ.cpu().numpy()
    n = dist.shape[-1]
    rng = np.random.default_rng(seed)
    walked = 0
    for i, j in rng.integers(0, n, (16 * count, 2)):
        if walked == count or not np.isfinite(dist[i, j]) or i == j:
            continue
        path = extract_path(succ, int(i), int(j))
        require(path and path[0] == i and path[-1] == j and path_cost(w, path) == dist[i, j],
                f"the walked path {i}->{j} does not cost dist")
        walked += 1
    return walked


def phase_integer_storage(rows: dict, n: int = 1024, n_big: int = 8192):
    """The integer storages of or_and and plus_mul (the reference keeps the
    input's dtype): ``solve`` of int8, uint32 and bool or_and and of int32
    plus_mul (whose sums and products wrap) at n on the card against the
    plain path on the CPU, by bits and with the reference's dtype; a uint8
    or_and engine's ``repair`` and ``repair_del`` and an int32 plus_mul
    engine's ``repair`` at n likewise; or_and on int32 at n_big, timed.
    Launch counts of that run (the int32 kinds)."""
    import numpy as np
    import torch

    from repro_torch.apsp import ApspEngine, solve
    from repro_torch.kernels import fw_repair as fp
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import fw_round as fr

    rng = np.random.default_rng(70)
    edges = rng.uniform(size=(n, n)) < 0.003
    big = (rng.uniform(size=(n_big, n_big)) < 2.0 / n_big).astype(np.int32)
    np.fill_diagonal(big, 1)
    cases = [("or_and", (edges * rng.integers(1, 100, (n, n))).astype(np.int8), torch.int8),
             ("or_and", np.where(edges, np.uint32(4_000_000_000), np.uint32(7)), torch.uint32),
             ("or_and", edges, torch.bool),
             ("plus_mul", (edges * 3).astype(np.int32), torch.int32)]
    uint8 = edges.astype(np.uint8)
    np.fill_diagonal(uint8, 1)
    pm = np.triu(edges * rng.integers(1, 1000, (n, n)), 1).astype(np.int32)
    for kind in ("fw_round", "fw_repair", "fw_repair_del"):
        {"fw_round": fr, "fw_repair": fp, "fw_repair_del": fd}[kind].reset_launch_counts()
    got = [solve(x, semiring=name) for name, x, _ in cases]
    oe = ApspEngine(semiring="or_and")
    o0 = oe.solve(uint8)
    orep = oe.repair(o0.dist, [(3, 7, 1), (n // 2, 2, 1)])
    dels, u1 = lowered_deletions(uint8, o0.dist, 4, seed=71)
    odel = oe.repair_del(o0.dist, u1, dels, threshold=100.0)
    pe = ApspEngine(semiring="plus_mul", method="fused")
    q0 = pe.solve(pm)
    qrep = pe.repair(q0.dist, [(2, 9, 5), (1, n - 2, 3)])
    r_big = solve(big, semiring="or_and")
    sync()
    counts = {**fr.LAUNCHES, **fp.LAUNCHES, **fd.LAUNCHES}
    print(f"integer storage launch counts: "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    for kind in sorted(k for k in lowered_kinds() if any(t in k for t in INT32_TAGS)):
        if kind.startswith("fw_repair_del") and "plus_mul" in kind:
            continue
        require(counts.get(kind, 0) > 0, f"{kind} was not launched on the integer storage path")
        rows[kind]["launches"] = counts[kind]

    for (name, x, dt), r in zip(cases, got):
        want = solve(x, semiring=name, device="cpu")
        require(r.dist.dtype == dt and same(r.dist.cpu(), want.dist),
                f"integer storage solve {name} {dt}: card != plain on the CPU")
    host = ApspEngine(semiring="or_and", device="cpu")
    h0 = host.solve(uint8)
    require(o0.dist.dtype == torch.uint8 and same(o0.dist.cpu(), h0.dist)
            and same(orep.dist.cpu(), host.repair(h0.dist, [(3, 7, 1), (n // 2, 2, 1)]).dist)
            and same(odel.dist.cpu(), host.repair_del(h0.dist, u1, dels, threshold=100.0).dist),
            "uint8 or_and engine on the card != plain on the CPU")
    hp = ApspEngine(semiring="plus_mul", method="fused", device="cpu")
    require(same(qrep.dist.cpu(), hp.repair(hp.solve(pm).dist, [(2, 9, 5),
                                                                (1, n - 2, 3)]).dist),
            "int32 plus_mul engine repair on the card != plain on the CPU")
    require(r_big.dist.dtype == torch.int32, "or_and int32 solve changed the dtype")
    print(f"integer storage checks: int8 / uint32 / bool or_and and int32 plus_mul solves "
          f"n={n} card == CPU with the reference's dtype; uint8 or_and engine repair and "
          f"repair_del and int32 plus_mul repair card == CPU")
    bt = torch.from_numpy(big).cuda()
    t = event_ms(lambda: solve(bt, semiring="or_and"), 3)
    print(f"integer storage or_and int32 solve n={n_big}: median {t:.2f} ms")


def lowered_deletions(x, dist, count: int, seed: int):
    """(deletions, updated weights) of an engine in any storage: up to
    ``count`` edges on shortest paths (x == dist, not on the diagonal),
    drawn with a seeded rng, each removed (its weight set to the semiring's
    ⊕-identity: inf for the min-plus floats, 0 for or_and).  For one packed
    word plane (1, n, n) an edge is removed from every lane that holds it,
    and its old weight is that lane mask."""
    import numpy as np

    from repro_torch.launch.round_bench import on_path_deletions

    if x.ndim != 3:
        return on_path_deletions(x, dist, count, seed)
    # a packed word plane: closure bits == edge bits
    rng = np.random.default_rng(seed)
    x1 = x.copy()
    dels = []
    on = np.argwhere((x[0] != 0) & ~np.eye(x.shape[-1], dtype=bool))
    for u, v in on[rng.choice(len(on), size=count, replace=False)]:
        dels.append((int(u), int(v), int(x[0, u, v])))
        x1[0, u, v] = 0
    return dels, x1


# ------------------------- lowered 4-dispatch kernels and bordered round
FOUR_TAGS = ("int16", "bf16", "f16", "packed")  # the lowered paths' storages


def cut_case(tag: str, name: str, shape, seed: int, s: int, salt: str):
    """``storage_case`` of any (…, r, c) shape: cut from the square case of
    its larger side, NaNs (salt "nan") kept off diagonal tiles of at most
    half that side."""
    m = max(shape[-2:])
    x, sr = storage_case(tag, name, (*shape[:-2], m, m), seed, max(1, min(s, m // 2)), salt)
    return x[..., :shape[-2], :shape[-1]].contiguous(), sr


def phase_check_lowered_four():
    """The lowered 4-dispatch kernels bitwise against their plain versions
    on the card, on every storage (``STORAGE_CASES``: int16 ×4, packed,
    bf16 / f16 ×5, int32 or_and / plus_mul), bf16 / f16 on both salted
    inputs (±0 without NaN, NaN off the diagonal tiles):
    ``semiring_matmul`` with and without c at (1024,128)·(128,1024),
    (4,256,96)·(4,96,384), (1000,77)·(77,513) and (1,5)·(5,3);
    ``fw_phase1`` at s = 32 and 128, single and (4, s, s);
    ``fw_phase2_row`` / ``fw_phase2_col`` at (s, n) = (32, 96) and
    (128, 1024), read as strided slices, against a NaN-free closed
    diagonal; and on the ±0 input
    ``fw_staged(fused=False)`` at n = 96 (s = 32; single and (2, n, n)) and
    n = 1024 (s = 128 single, s = 32 as (2, n, n)) against the plain
    4-dispatch loop and the lowered fused round.  The (1024,128)·(128,1024)
    products with c and the n = 1024 bands keep their salt (mostly finite,
    both zero signs for the idempotent semirings, the NaNs)."""
    import torch

    from repro_torch.core.staged import fw_staged
    from repro_torch.kernels import fw_phase1 as fph
    from repro_torch.kernels import fw_phase2
    from repro_torch.kernels import minplus_matmul as fmm
    from repro_torch.kernels import ref

    checked = pos = neg = nans = 0

    def held(what, name, want, salt):
        nonlocal pos, neg, nans
        if salt in ("zero", "nan"):
            p, q, r = require_salt_survives(what, name, want, zeros=salt == "zero",
                                            nans=salt == "nan")
            pos, neg, nans = pos + p, neg + q, nans + r

    for tag, name in STORAGE_CASES:
        for salt in salts(tag):
            case = functools.partial(cut_case, tag, name, salt=salt)
            for a_shape, b_shape in (((1024, 128), (128, 1024)), ((4, 256, 96), (4, 96, 384)),
                                     ((1000, 77), (77, 513)), ((1, 5), (5, 3))):
                a, sr = case(a_shape, 1, 32)
                b, _ = case(b_shape, 2, 32)
                c, _ = case((*a_shape[:-1], b_shape[-1]), 3, 32)
                c0 = c.clone()
                for cc in (None, c):
                    got = fmm.semiring_matmul(a, b, cc, semiring=sr)
                    want = ref.semiring_matmul_ref(a, b, cc, semiring=sr)
                    sync()
                    what = f"semiring_matmul[{tag}] {name} {a_shape}@{b_shape} c={cc is not None}"
                    require(got.dtype == a.dtype and same(got, want), f"{what} {salt} != plain")
                    if a_shape == (1024, 128) and cc is not None:  # without c a
                        held(what, name, want, salt)  # fold starts from +0 or ±inf
                    checked += 1
                require(same(c, c0), f"semiring_matmul[{tag}] wrote into c")
            for sz in (32, 128):
                for shape in ((sz, sz), (4, sz, sz)):
                    t, sr = case(shape, sz, sz)
                    got = fph.fw_phase1(t, semiring=sr)
                    sync()
                    require(got.dtype == t.dtype and same(got, ref.fw_phase1_ref(t, semiring=sr)),
                            f"fw_phase1[{tag}] {name} {shape} {salt} != plain")
                    checked += 1
            for sz, n in ((32, 96), (128, 1024)):
                # the closed diagonal from NaN-free weights (a NaN in it
                # would flood every band column)
                diag, sr = cut_case(tag, name, (sz, sz), 4, sz, "zero" if salt == "zero" else
                                    "domain")
                diag = ref.fw_phase1_ref(diag, semiring=sr)
                w, _ = case((n + sz, n + sz), n, sz)
                if salt == "nan":  # one NaN in each band (it spreads along its column / row)
                    w[7 + sz // 2, 3 + n // 2] = w[3 + n // 3, 7 + sz // 3] = float("nan")
                row, col = w[7:7 + sz, 3:3 + n], w[3:3 + n, 7:7 + sz]
                got_r = fw_phase2.fw_phase2_row(diag, row, semiring=sr)
                got_c = fw_phase2.fw_phase2_col(diag, col, semiring=sr)
                want_r = ref.fw_phase2_row_ref(diag, row, semiring=sr)
                want_c = ref.fw_phase2_col_ref(diag, col, semiring=sr)
                sync()
                require(same(got_r, want_r) and same(got_c, want_c),
                        f"fw_phase2_row/col[{tag}] {name} s={sz} n={n} {salt} != plain")
                if n == 1024:
                    held(f"fw_phase2_row[{tag}]", name, want_r, salt)
                    held(f"fw_phase2_col[{tag}]", name, want_c, salt)
                checked += 2
            if salt == "nan":
                continue  # a closure spreads a NaN over the whole output
            for shape, sz in (((96, 96), 32), ((2, 96, 96), 32), ((1024, 1024), 128),
                              ((2, 1024, 1024), 32)):
                w, sr = case(shape, shape[-1] + sz, sz)
                got = fw_staged(w, block_size=sz, semiring=sr, fused=False)
                want = plain_four(w, block_size=sz, semiring=sr)
                fused = fw_staged(w, block_size=sz, semiring=sr)
                sync()
                require(got.dtype == w.dtype and same(got, want),
                        f"fw_staged(fused=False)[{tag}] {name} {shape} s={sz} != plain loop")
                require(same(got, fused),
                        f"fw_staged(fused=False)[{tag}] {name} {shape} s={sz} != fused")
                checked += 1
    print(f"check: {checked} lowered 4-dispatch kernel-vs-plain cases bitwise equal (bf16 / "
          f"f16 salted with ±0 and, apart, off-diagonal NaN; the checked outputs: {pos} +0, "
          f"{neg} -0, {nans} NaN)")


def phase_check_lowered_bordered():
    """The lowered bordered round bitwise against its plain twin on the
    card: every storage (``STORAGE_CASES``; bf16 / f16 on both salted
    inputs), s = 32, 64 and 128, the square (s + n/2)², tall (s + n/2, s + n/4)
    and wide (s + n/4, s + n/2) rank blocks of an n = 8s solve, single and
    (at s = 32) (2, rows, cols), in the three echo forms: none, both, and
    one of the two (the row echo on tall blocks, the column echo else)."""
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref

    checked = 0
    for tag, name in STORAGE_CASES:
        for salt in salts(tag):
            for s in (32, 64, 128):
                n = 8 * s
                for rows, cols in ((s + n // 2, s + n // 2), (s + n // 2, s + n // 4),
                                   (s + n // 4, s + n // 2)):
                    tr, tc = rows // s, cols // s
                    one = (tr - 1, -1) if rows > cols else (-1, tc - 1)
                    for lead in ((), (2,)) if s == 32 else ((),):
                        w, sr = cut_case(tag, name, (*lead, rows, cols), s + rows, s, salt)
                        for echo in ((-1, -1), (1, 1), one):
                            got = fr.fw_round_bordered(w.clone(), *echo, block_size=s,
                                                       semiring=sr)
                            want = ref.fw_round_bordered_ref(w, *echo, block_size=s,
                                                             semiring=sr)
                            sync()
                            require(got.dtype == w.dtype and same(got, want),
                                    f"fw_round_bordered[{tag}] {name} {salt} s={s} "
                                    f"{(*lead, rows, cols)} echo={echo} != plain")
                            checked += 1
    print(f"check: {checked} lowered bordered-round kernel-vs-plain cases bitwise equal")


def phase_check_chains():
    """Every instantiation of the fused round's diag and bands kernels
    (csrc/fw_round.cuh) alone, bitwise against its plain phase
    (``close_diag``, ``close_bands`` / ``close_bordered_bands``): the five
    semirings in f32 (salted with ±inf) and every storage
    (``STORAGE_CASES``; bf16 / f16 salted with ±0 at s = 32 and 128, with
    off-diagonal NaN at s = 16 and 64), s = 16, 32, 64 and 128; square
    n = 5s (each band
    tile cut into 2 or 4 CTAs) and at s = 128 n = 5120 (kept whole), a
    batch of 3, and a (6s, 4s) bordered block with the owner echo at both
    bands, at each alone and at none."""
    import torch

    from repro_torch.core.semiring import SEMIRINGS
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref

    cases = [(None, n) for n in sorted(SEMIRINGS)] + STORAGE_CASES
    checked = 0
    for tag, name in cases:
        for s in (16, 32, 64, 128):
            geoms = [("square", (5 * s, 5 * s), 2, (-1, -1)),
                     ("square", (3, 5 * s, 5 * s), 4, (-1, -1))]
            if s == 128:
                geoms.append(("square", (40 * s, 40 * s), 21, (-1, -1)))
            geoms += [("bordered", (6 * s, 4 * s), 0, e)
                      for e in ((-1, -1), (2, 1), (5, -1), (-1, 3))]
            for kind, shape, b, echo in geoms:
                if tag is None:
                    w = torch.from_numpy(salted(name, shape, s + b)).cuda()
                    sr = SEMIRINGS[name]
                else:
                    salt = salts(tag)[s.bit_length() % len(salts(tag))]  # NaN at 16, 64
                    w, sr = cut_case(tag, name, shape, s + b, s, salt)
                o = slice(b * s, (b + 1) * s)
                diag = ref.close_diag(w[..., o, o], sr)
                if kind == "bordered":
                    bands = fr.bordered_round_buffers(w, s)
                    for phase in ("diag", "bands"):
                        fr.fw_round_bordered_phase(phase, w, *echo, bands, block_size=s,
                                                   semiring=sr)
                    row, col = ref.close_bordered_bands(w, diag, *echo, sr)
                else:
                    bands = fr.round_buffers(w, s)
                    for phase in ("diag", "bands"):
                        fr.fw_round_phase(phase, w, b, bands, block_size=s, semiring=sr)
                    row, col = ref.close_bands(w, diag, b, sr)
                got_row, got_col = (t if w.ndim == 3 else t[0] for t in bands)
                sync()
                require(same(got_row[..., :, o], diag) and same(got_col[..., o, :], diag),
                        f"diag[{tag}] {name} s={s} {shape} != plain close_diag")
                require(same(got_row, row) and same(got_col, col),
                        f"bands[{tag}] {name} s={s} {shape} echo={echo} != plain")
                checked += 1
    print(f"check: {checked} diag / bands kernel-vs-plain cases bitwise equal (f32 and "
          f"{len(STORAGE_CASES)} storages, s = 16 .. 128, square, batched, bordered)")


def tie_heavy(shape, seed: int):
    """Integer weights in [1, 4], 30 % missing, the diagonal 0: equal
    candidates everywhere, so only the strict compare decides a hop."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = rng.integers(1, 5, size=shape).astype(np.float32)
    w[rng.uniform(size=shape) < 0.3] = np.inf
    idx = np.arange(shape[-1])
    w[..., idx, idx] = 0.0
    return w


def phase_check_succ_chains():
    """Every instantiation of the successor round's diag and bands kernels
    (csrc/fw_round.cuh ``succ_diag_kernel`` / ``succ_bands_kernel``) alone,
    distances and next hops bitwise against their plain phases
    (``close_diag_succ``, ``close_bands_succ``): f32, bf16 and f16, each
    salted with ±0 (``signed_zero_graph``) and, apart, with off-diagonal
    NaN, and on tie-heavy integer weights (only the strict compare decides
    a hop) with a negative cycle planted on the pivot block's diagonal;
    s = 16, 32, 64 and 128; square n = 5s (each band tile cut into 2 or 4
    CTAs) and at s = 128 n = 5120 (kept whole), and a batch of 3."""
    import numpy as np
    import torch

    from repro_torch.core.paths import _init_successors
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import ref

    def case(dtype, salt, shape, s, b, seed):
        if salt == "ties":
            w = tie_heavy(shape, seed)
            idx = np.arange(b * s, (b + 1) * s, 3)
            w[..., idx, idx] = -3.0
        elif salt == "zero":
            w = signed_zero_graph("min_plus", shape, seed)
        else:
            w = nan_salted(domain_graph("min_plus", shape, seed), seed, 2,
                           [(t * s, t * s + s) for t in range(shape[-1] // s)])
        return torch.from_numpy(w).cuda().to(dtype)

    checked = 0
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "[bf16]"),
                       (torch.float16, "[f16]")):
        for salt in ("zero", "nan", "ties"):
            for s in (16, 32, 64, 128):
                geoms = [((5 * s, 5 * s), 2), ((3, 5 * s, 5 * s), 4)]
                if s == 128:
                    geoms.append(((40 * s, 40 * s), 21))
                for shape, b in geoms:
                    w = case(dtype, salt, shape, s, b, s + b)
                    succ = _init_successors(w).contiguous()
                    bands = fr.succ_round_buffers(w, s)
                    for phase in ("diag", "bands"):
                        fr.fw_round_with_successors_phase(phase, w, succ, b, bands,
                                                          block_size=s)
                    o = slice(b * s, (b + 1) * s)
                    diag, dsucc = ref.close_diag_succ(w[..., o, o], succ[..., o, o])
                    want = ref.close_bands_succ(w, succ, diag, dsucc, b)
                    rw, cw, rs, cs = (t if w.ndim == 3 else t[0] for t in bands)
                    sync()
                    what = f"{tag} {salt} s={s} {shape}"
                    require(same(rw[..., :, o], diag) and same(rs[..., :, o], dsucc),
                            f"succ diag{what} != plain close_diag_succ")
                    require(all(same(g, x) for g, x in zip((rw, rs, cw, cs), want)),
                            f"succ bands{what} != plain close_bands_succ")
                    checked += 1
    print(f"check: {checked} successor diag / bands kernel-vs-plain cases bitwise equal, "
          f"distances and next hops (f32, bf16, f16; ±0 / NaN salted, tie-heavy with planted "
          f"diagonals; s = 16 .. 128, square, batched)")


def sweep_chain_rows(n: int, s: int, a_pad: int, b: int, seed: int):
    """a_pad strip rows: min(a_pad - 1, n / 2) distinct real rows, sorted,
    two of them inside pivot block b; padding rows (index n) after them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = min(a_pad - 1, n // 2)
    inside = b * s + rng.choice(s, 2, replace=False)
    rest = rng.choice(np.setdiff1d(np.arange(n), inside), a - 2, replace=False)
    rows = np.full(a_pad, n, np.int32)
    rows[:a] = np.sort(np.concatenate([inside, rest]))
    return rows


def phase_check_sweep_chains():
    """Every instantiation of the restricted sweep's diag and panels kernels
    (csrc/fw_repair_del.cuh) alone, bitwise against its plain phase
    (``sweep_diag_ref``, ``sweep_panels_ref``): the four idempotent
    semirings in f32 and bf16 / f16 (salted with ±0 and, apart, with
    off-diagonal NaN) and the other sweep storages (``SWEEP_STORAGE_CASES``),
    s = 16, 32, 64 and 128; n = 2s (one band tile, cut into CTAs by
    ``band_split``) and 5s; strips of 8, 16 and 64 rows (two inside the
    pivot block, padding rows) holding other values than d_init's rows, so
    that a read of the overlay shows; under min_plus / max_plus also planted
    non-identity diagonals (-3 / 3 on every third)."""
    import numpy as np
    import torch

    from repro_torch.core.semiring import SEMIRINGS
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import ref

    def case(tag, name, n, s, salt, seed):
        if tag is not None:
            return storage_case(tag, name, (n, n), seed, s, salt)
        w = (signed_zero_graph(name, (n, n), seed) if salt == "zero" else nan_salted(
            domain_graph(name, (n, n), seed), seed, 2, [(b * s, b * s + s) for b in range(n // s)]))
        return torch.from_numpy(w).cuda(), SEMIRINGS[name]

    def planted(x, name):
        x = x.clone()
        idx = torch.arange(0, x.shape[-1], 3, device=x.device)
        x[idx, idx] = torch.tensor(-3.0 if name == "min_plus" else 3.0).to(x.dtype)
        return x

    cases = ([(None, n, salt) for n in IDEMPOTENT for salt in ("zero", "nan")]
             + [(t, n, salt) for t, n in SWEEP_STORAGE_CASES for salt in salts(t)])
    checked = 0
    for tag, name, salt in cases:
        plants = (False, True) if name in ("min_plus", "max_plus") and tag != "packed" else (False,)
        for s in (16, 32, 64, 128):
            for n, b in ((2 * s, 1), (5 * s, 2)):
                o = slice(b * s, (b + 1) * s)
                (x, sr), (other, _) = (case(tag, name, n, s, salt, s + n + i) for i in (0, 1))
                for plant in plants:
                    d, src = (planted(x, name), planted(other, name)) if plant else (x, other)
                    for a_pad in (8, 16, 64):
                        rows = sweep_chain_rows(n, s, a_pad, b, seed=a_pad + n)
                        sw = fd.sweep_buffers(d, rows, block_size=s)
                        sw.strip.copy_(src[torch.from_numpy(np.minimum(rows, n - 1)).long().cuda()])
                        fd.sweep_phase("diag", sw, b, semiring=sr)
                        fd.sweep_phase("panels", sw, b, semiring=sr)
                        diag = ref.sweep_diag_ref(d, sw.strip, sw.rows, b, block_size=s,
                                                  semiring=sr)
                        band, acol = ref.sweep_panels_ref(d, sw.strip, sw.rows, diag, b,
                                                          semiring=sr)
                        sync()
                        what = f"[{tag}] {name} {salt} s={s} n={n} a={a_pad} planted={plant}"
                        require(same(sw.band[:, o], diag), f"sweep diag{what} != plain")
                        require(same(sw.band, band) and same(sw.acol, acol),
                                f"sweep panels{what} != plain")
                        checked += 1
    print(f"check: {checked} sweep diag / panels kernel-vs-plain cases bitwise equal (f32 and "
          f"{len(SWEEP_STORAGE_CASES)} storages, s = 16 .. 128, n = 2s / 5s, a = 8 / 16 / 64, "
          f"±0 / NaN salted, planted diagonals)")


def phase_check_succ_sweep_chains():
    """Every instantiation of the successor sweep's diag and panels kernels
    (csrc/fw_repair_del.cuh ``succ_diag_kernel`` / ``succ_panels_kernel``)
    alone, distances and next hops bitwise against their plain phases
    (``sweep_diag_succ_ref``, ``sweep_panels_succ_ref``): f32, bf16 and f16,
    each salted with ±0 (``signed_zero_graph``) and, apart, with NaN off the
    diagonal tiles, and on tie-heavy integer weights (only the strict
    compare decides a hop) with negative cycles planted on every third
    diagonal entry; s = 16, 32, 64 and 128; n = 2s (one band tile, cut into
    CTAs by ``band_split``) and 5s; strips of 8, 16 and 64 rows (two inside
    the pivot block, padding rows) whose values and hops differ from
    d_init's and s_init's rows, so that a read of the overlay shows."""
    import numpy as np
    import torch

    from repro_torch.core.paths import _init_successors
    from repro_torch.kernels import fw_repair_del as fd
    from repro_torch.kernels import ref

    def case(dtype, salt, n, s, seed):
        if salt == "ties":
            w = tie_heavy((n, n), seed)
            idx = np.arange(0, n, 3)
            w[idx, idx] = -3.0
        elif salt == "zero":
            w = signed_zero_graph("min_plus", (n, n), seed)
        else:
            w = nan_salted(domain_graph("min_plus", (n, n), seed), seed, 2,
                           [(b * s, b * s + s) for b in range(n // s)])
        d = torch.from_numpy(w).cuda().to(dtype)
        return d, _init_successors(d).contiguous()

    checked = 0
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "[bf16]"),
                       (torch.float16, "[f16]")):
        for salt in ("zero", "nan", "ties"):
            for s in (16, 32, 64, 128):
                for n, b in ((2 * s, 1), (5 * s, 2)):
                    o = slice(b * s, (b + 1) * s)
                    d, sd = case(dtype, salt, n, s, s + n)
                    other, other_s = case(dtype, salt, n, s, s + n + 1)
                    for a_pad in (8, 16, 64):
                        rows = sweep_chain_rows(n, s, a_pad, b, seed=a_pad + n)
                        sw = fd.sweep_buffers(d, rows, block_size=s, s_init=sd)
                        idx = torch.from_numpy(np.minimum(rows, n - 1)).long().cuda()
                        sw.strip.copy_(other[idx])
                        sw.strip_s.copy_(other_s[idx])
                        fd.sweep_succ_phase("diag", sw, b)
                        fd.sweep_succ_phase("panels", sw, b)
                        diag, dsucc = ref.sweep_diag_succ_ref(d, sd, sw.strip, sw.strip_s,
                                                              sw.rows, b, block_size=s)
                        want = ref.sweep_panels_succ_ref(d, sd, sw.strip, sw.strip_s, sw.rows,
                                                         diag, dsucc, b)
                        sync()
                        what = f"{tag} {salt} s={s} n={n} a={a_pad}"
                        require(same(sw.band[:, o], diag) and same(sw.band_s[:, o], dsucc),
                                f"successor sweep diag{what} != plain sweep_diag_succ_ref")
                        require(all(same(g, x) for g, x in zip(
                            (sw.band, sw.band_s, sw.acol, sw.acol_s), want)),
                            f"successor sweep panels{what} != plain sweep_panels_succ_ref")
                        checked += 1
    print(f"check: {checked} successor sweep diag / panels kernel-vs-plain cases bitwise "
          f"equal, distances and next hops (f32, bf16, f16; ±0 / NaN salted, tie-heavy with "
          f"planted diagonals; s = 16 .. 128, n = 2s / 5s, a = 8 / 16 / 64)")


def odd_strided(x):
    """x's values as a view at an odd row stride, 3 rows and 5 elements into
    its storage: no operand of it meets the 4-wide moves."""
    import torch

    B, r, c = x.shape
    v = torch.zeros((B, r + 3, c + 5 + c % 2), dtype=x.dtype, device=x.device)[:, 3:, 5:5 + c]
    v.copy_(x)
    return v


def phase_check_phase_chains():
    """Every instantiation of the 4-dispatch round's closure and band kernels
    (csrc/fw_phase.cuh: ``closure_kernel``, ``band_kernel<S, Col>``) alone,
    bitwise against its plain phase (``fw_phase1_ref``, ``fw_phase2_row_ref``
    / ``fw_phase2_col_ref``): the five semirings in f32 and bf16 / f16
    (salted with ±0 and, apart, with NaN off the diagonal tiles) and every
    other storage (``STORAGE_CASES``), s = 16, 32, 64 and 128, a batch of 3,
    band lengths 1, s - 3 and 1000, the pivot's own tile inside the band where
    it fits; the operands as aligned slices of one matrix (4-wide moves), as
    slices at an odd row stride and an unaligned base (one element at a
    time), and aligned with outputs into such slices; under min_plus /
    max_plus also planted non-identity diagonals (-3 / 3 on every third),
    aligned."""
    import torch

    from repro_torch.core.semiring import SEMIRINGS
    from repro_torch.kernels import fw_phase1 as fph
    from repro_torch.kernels import fw_phase2
    from repro_torch.kernels import ref

    def case(tag, name, m, s, salt, seed):
        if tag is not None:
            return storage_case(tag, name, (3, m, m), seed, s, salt)
        w = (signed_zero_graph(name, (3, m, m), seed) if salt == "zero" else nan_salted(
            domain_graph(name, (3, m, m), seed), seed, 2,
            [(b * s, b * s + s) for b in range(m // s)]))
        return torch.from_numpy(w).cuda(), SEMIRINGS[name]

    cases = ([(None, n, salt) for n in sorted(SEMIRINGS) for salt in ("zero", "nan")]
             + [(t, n, salt) for t, n in STORAGE_CASES for salt in salts(t)])
    checked = 0
    for tag, name, salt in cases:
        plants = (False, True) if name in ("min_plus", "max_plus") and tag != "packed" else (False,)
        for s in (16, 32, 64, 128):
            for n in (1, s - 3, 1000):
                m = max(n, 2 * s)
                o = slice(s, 2 * s) if n >= 2 * s else slice(0, s)
                x, sr = case(tag, name, m, s, salt, s + n)
                for plant in plants:
                    if plant:
                        x = x.clone()
                        idx = torch.arange(0, m, 3, device=x.device)
                        x[..., idx, idx] = torch.tensor(-3.0 if name == "min_plus" else 3.0).to(
                            x.dtype)
                    for layout in ("aligned",) if plant else ("aligned", "strided", "out"):
                        xs = odd_strided(x) if layout == "strided" else x
                        outs = {} if layout != "out" else {
                            k: odd_strided(torch.empty(shape, dtype=x.dtype, device=x.device))
                            for k, shape in (("d", (3, s, s)), ("r", (3, s, n)), ("c", (3, n, s)))}
                        tile, row, col = xs[:, o, o], xs[:, o, :n], xs[:, :n, o]
                        got_d = fph.fw_phase1(tile, semiring=sr, out=outs.get("d"))
                        diag = ref.fw_phase1_ref(tile, semiring=sr)
                        diag = odd_strided(diag) if layout == "strided" else diag
                        got_r = fw_phase2.fw_phase2_row(diag, row, semiring=sr, out=outs.get("r"))
                        got_c = fw_phase2.fw_phase2_col(diag, col, semiring=sr, out=outs.get("c"))
                        want_r = ref.fw_phase2_row_ref(diag, row, semiring=sr)
                        want_c = ref.fw_phase2_col_ref(diag, col, semiring=sr)
                        sync()
                        what = f"[{tag}] {name} {salt} s={s} n={n} planted={plant} {layout}"
                        require(got_d.dtype == x.dtype and same(got_d, diag),
                                f"fw_phase1{what} != plain")
                        require(same(got_r, want_r), f"fw_phase2_row{what} != plain")
                        require(same(got_c, want_c), f"fw_phase2_col{what} != plain")
                        checked += 1
    print(f"check: {checked} closure / band kernel-vs-plain cases bitwise equal (f32 and "
          f"{len(STORAGE_CASES)} storages, s = 16 .. 128, B = 3, n = 1 / s - 3 / 1000, aligned, "
          f"odd-strided and unaligned operands, ±0 / NaN salted, planted diagonals)")


def phase_check_f16_plus_mul():
    """f16 plus_mul's step is one f16 FMA rounded once (HFMA on the card,
    ``core.semiring._plus_mul_relax`` in the twin): the fused round, the
    bordered round, ``semiring_matmul``, ``fw_phase1`` and a solve on
    signed operands, card == twin on the card == twin on the CPU, by bits,
    where a chain that rounds the product and the sum apart differs."""
    import numpy as np
    import torch

    from repro_torch.apsp import solve
    from repro_torch.core.semiring import PLUS_MUL, Semiring
    from repro_torch.kernels import fw_phase1 as fph
    from repro_torch.kernels import fw_round as fr
    from repro_torch.kernels import minplus_matmul as fmm
    from repro_torch.kernels import ref

    per_op = Semiring("plus_mul_per_op", torch.add, torch.mul, 0.0, 1.0,
                      lambda c, a, b: c + a * b)
    checked = differ = 0
    for shape, s in (((256, 256), 32), ((2, 512, 512), 128), ((384, 384), 64)):
        rng = np.random.default_rng(shape[-1] + s)
        x = torch.from_numpy((rng.standard_normal(shape) * (0.5 / math.sqrt(shape[-1])))
                             .astype(np.float16))
        w = x.cuda()
        b = shape[-1] // s // 2
        cases = [
            ("fw_round", lambda t: fr.fw_round(t.clone(), b, block_size=s, semiring=PLUS_MUL),
             lambda t, sr: ref.fw_round_ref(t, b, block_size=s, semiring=sr)),
            ("fw_round_bordered",
             lambda t: fr.fw_round_bordered(t.clone(), 1, 1, block_size=s, semiring=PLUS_MUL),
             lambda t, sr: ref.fw_round_bordered_ref(t, 1, 1, block_size=s, semiring=sr)),
            ("semiring_matmul",
             lambda t: fmm.semiring_matmul(t[..., :, :s], t[..., :s, :], t, semiring=PLUS_MUL),
             lambda t, sr: ref.semiring_matmul_ref(t[..., :, :s], t[..., :s, :], t, semiring=sr)),
            ("fw_phase1", lambda t: fph.fw_phase1(t[..., :s, :s], semiring=PLUS_MUL),
             lambda t, sr: ref.fw_phase1_ref(t[..., :s, :s], semiring=sr)),
        ]
        for what, kernel, plain in cases:
            got, want = kernel(w), plain(w, PLUS_MUL)
            sync()
            require(same(got, want) and same(got.cpu(), plain(x, PLUS_MUL)),
                    f"f16 plus_mul {what} {shape} s={s}: card != twin")
            differ += not same(want.cpu(), plain(x, per_op))
            checked += 1
        got = solve(w, semiring="plus_mul", method="fused", block_size=s).dist
        want = solve(x, semiring="plus_mul", method="fused", block_size=s, device="cpu").dist
        require(same(got.cpu(), want), f"f16 plus_mul solve {shape} s={s}: card != CPU")
        checked += 1
    require(differ >= 8, f"f16 plus_mul: the per-op chain differs in {differ} cases only")
    print(f"check: {checked} f16 plus_mul cases (one f16 FMA a step) card == twin bitwise; "
          f"the per-op chain differs in {differ} of {checked - 3}")


def four_inputs(n: int, seed: int = 1):
    """{tag: (w, semiring)} at n on the card: the main path's kind of
    random digraph in int16 (saturating min-plus), bf16 and f16, and one
    plane of 32 ``packed_graphs`` words."""
    import torch

    from repro_torch.apsp import api
    from repro_torch.core.graph import random_digraph
    from repro_torch.core.semiring import MIN_PLUS, MIN_PLUS_I16, OR_AND_PACKED

    w32 = torch.from_numpy(random_digraph(n, density=0.5, seed=seed)).cuda()
    words = api.pack_reachability(packed_graphs(32, n, seed=seed + 50))[0]
    return {"int16": (api._coerce(w32, MIN_PLUS_I16, None, w32.device), MIN_PLUS_I16),
            "bf16": (w32.to(torch.bfloat16), MIN_PLUS),
            "f16": (w32.to(torch.float16), MIN_PLUS),
            "packed": (words, OR_AND_PACKED)}


def phase_kernels_lowered_four(rows: dict, n: int, s: int = 128):
    """Each lowered 4-dispatch launch alone at the path's shapes (n = 8192,
    s = 128, round T/2) in int16, bf16, f16 and packed words, against the
    plain version of its phase: ``fw_phase1`` (s,s), ``fw_phase2_row`` (s,n),
    ``fw_phase2_col`` (n,s), ``semiring_matmul`` at the phase-3 shape
    (n,s)·(s,n) + C.  Bound: ``LOWERED_OPS`` a relaxation over 67 TOP/s, or
    bytes in the storage word over 3.35 TB/s (each input read once, each
    output written once), whichever is larger."""
    import torch

    from repro_torch.kernels import fw_phase1 as fph
    from repro_torch.kernels import fw_phase2
    from repro_torch.kernels import minplus_matmul as fmm
    from repro_torch.kernels import ref

    record = functools.partial(record_kernel, rows)
    b = n // s // 2
    o = slice(b * s, (b + 1) * s)
    for tag, (w, sr) in four_inputs(n).items():
        ops, word = LOWERED_OPS[tag], LOWERED_WORD[tag]
        tile = w[o, o].contiguous()
        diag = torch.empty_like(tile)
        fph.fw_phase1(tile, semiring=sr, out=diag)
        want = ref.fw_phase1_ref(tile, semiring=sr)
        sync()
        require(same(diag, want), f"fw_phase1[{tag}] launch != plain")
        record(f"fw_phase1[{tag}]", max_abs_err(diag, want),
               event_ms(lambda: fph.fw_phase1(tile, semiring=sr, out=diag), 11),
               event_ms(lambda: ref.fw_phase1_ref(tile, semiring=sr), 3),
               ops * s**3, 2 * s * s * word)
        band_r, band_c = w[o, :].contiguous(), w[:, o].contiguous()
        row, col = torch.empty_like(band_r), torch.empty_like(band_c)
        for kind, fn, band, out, plain in (
                ("fw_phase2_row", fw_phase2.fw_phase2_row, band_r, row, ref.fw_phase2_row_ref),
                ("fw_phase2_col", fw_phase2.fw_phase2_col, band_c, col, ref.fw_phase2_col_ref)):
            fn(diag, band, semiring=sr, out=out)
            want = plain(diag, band, semiring=sr)
            sync()
            require(same(out, want), f"{kind}[{tag}] launch != plain")
            record(f"{kind}[{tag}]", max_abs_err(out, want),
                   event_ms(lambda: fn(diag, band, semiring=sr, out=out), 11),
                   event_ms(lambda: plain(diag, band, semiring=sr), 3),
                   ops * s * s * n, (s * s + 2 * s * n) * word)
        row[:, o] = diag
        col[o, :] = diag
        out = torch.empty_like(w)
        fmm.semiring_matmul(col, row, w, semiring=sr, out=out)
        want = ref.semiring_matmul_ref(col, row, w, semiring=sr)
        sync()
        require(same(out, want), f"semiring_matmul[{tag}] phase-3 shape != plain")
        err = max_abs_err(out, want)
        del want
        print(f"semiring_matmul[{tag}] ({n},{s})·({s},{n}) + C staging: "
              f"{fmm.staging_name(col, row, w, out)}")
        record(f"semiring_matmul[{tag}]", err,
               event_ms(lambda: fmm.semiring_matmul(col, row, w, semiring=sr, out=out), 5),
               event_ms(lambda: ref.semiring_matmul_ref(col, row, w, semiring=sr), 1),
               ops * n * n * s, (2 * n * n + 2 * n * s) * word)
        del w, out, band_r, band_c, row, col


def phase_four_lowered(rows: dict, n: int, s: int = 128):
    """The lowered 4-dispatch path: ``fw_staged(w, fused=False)`` at n =
    8192 in int16, bf16 and f16 (the main path's digraph) and on one plane
    of 32 packed graphs, with the launch counts of that run (4 kinds x n/s
    rounds a storage), each bitwise against the lowered fused solve of the
    same input and timed beside it (host clock around work that ends in
    synchronize(), median of 3 after a warm-up)."""
    from repro_torch.core.staged import fw_staged
    from repro_torch.kernels import fw_phase1 as fph
    from repro_torch.kernels import minplus_matmul as fmm

    inputs = four_inputs(n, seed=0)
    fph.reset_launch_counts()
    fmm.reset_launch_counts()
    results = {tag: fw_staged(w, block_size=s, semiring=sr, fused=False)
               for tag, (w, sr) in inputs.items()}
    sync()
    counts = {**fph.LAUNCHES, **fmm.LAUNCHES}
    print(f"lowered 4-dispatch path launch counts: "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    for tag in FOUR_TAGS:
        for kind in FOUR_KINDS:
            k = f"{kind}[{tag}]"
            require(counts[k] == n // s, f"{k} launched {counts[k]} times, not {n // s}")
            rows[k]["launches"] = counts[k]
    for tag, (w, sr) in inputs.items():
        fused = fw_staged(w, block_size=s, semiring=sr)
        require(results[tag].dtype == w.dtype and same(results[tag], fused),
                f"fw_staged(fused=False)[{tag}] n={n} != the lowered fused solve")
        del fused
    results.clear()
    print(f"lowered 4-dispatch check: fw_staged(fused=False) n={n} in {FOUR_TAGS} == the "
          f"lowered fused solve, bitwise")

    def timed(fn):
        fn()
        times = [host_ms(fn) for _ in range(3)]
        return statistics.median(times), times

    for tag, (w, sr) in inputs.items():
        t4, all4 = timed(lambda: fw_staged(w, block_size=s, semiring=sr, fused=False))
        tf, allf = timed(lambda: fw_staged(w, block_size=s, semiring=sr))
        bms, by = bound(LOWERED_OPS[tag] * float(n) ** 3,
                        (n // s) * 2.0 * n * n * LOWERED_WORD[tag])
        print(f"lowered 4-dispatch fw_staged[{tag}] n={n}: median {t4:.2f} ms of "
              f"{['%.2f' % t for t in all4]}, bound {bms:.2f} ms by {by}; lowered fused "
              f"fw_staged median {tf:.2f} ms of {['%.2f' % t for t in allf]} "
              f"({t4 / tf:.3f}x)")


# ------------------------------------------------------------ flash decode
def decode_tolerance(dtype, want) -> tuple[float, float]:
    """(rtol, atol) of ``flash_decode`` against a plain version: in f32 the
    reference's 2e-5 / 2e-5; in bf16 the reference's rtol 2e-2 with an atol
    of two bf16 ulps of the largest |output|.  The bf16 kernel rounds each
    softmax weight P to bf16 where it meets V (its MMA's A operand), which
    moves a weight by at most 2^-9 of itself, and sums in f32; the plain
    version keeps P in f32; both round the output once to bf16.  So they
    differ by about one ulp of an entry, and the limit shrinks with the
    outputs (an average over kv_len rows of v, of RMS about sqrt(e /
    kv_len))."""
    import torch

    if dtype == torch.float32:
        return 2e-5, 2e-5
    top = float(want.float().abs().max())
    return 2e-2, 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def phase_flash_decode(rows: dict, B: int = 8, Hkv: int = 4, g: int = 7, hd: int = 128,
                       S: int = 32768, kv_len: int = 32000):
    """``flash_decode`` at the decode shape of ``configs/qwen2_7b.py`` (28
    query heads over 4 KV heads, head dim 128, its 32k context; batch 8,
    kv_len 32000), in bf16 and in f32: the launch count of that call; held
    against the plain online-softmax walk and the masked softmax on the
    card (``decode_tolerance``: the reference's 2e-5 in f32; in bf16 its
    rtol 2e-2 with an atol of two bf16 ulps of the largest output); the
    poisoned tail (k / v past kv_len set to ±99, unchanged within 1e-6) and
    kv_len = 0 (the mean of v, same limit);
    timed beside one ``scaled_dot_product_attention(..., enable_gqa=True)``
    call over the same kv_len rows.  Bound: the bytes of q, of the K and V
    rows below kv_len and of the output over 3.35 TB/s (4 FLOP per (q
    row, column, position) over 67 TFLOP/s is smaller)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fdec
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(50)
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((B, Hkv, g, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
        fdec.reset_launch_counts()
        out = fdec.flash_decode(q, k, v, kl)
        sync()
        launches = fdec.LAUNCHES["flash_decode"]
        require(launches == 1, f"flash_decode launched {launches} times, not once")
        want = ref.flash_decode_online_ref(q, k, v, kl)
        masked = ref.flash_decode_ref(q, k, v, kl)
        rtol, atol = decode_tolerance(dtype, want)
        err = max_abs_err(out.float(), want.float())
        print(f"flash_decode {dtype}: max |out| {float(want.float().abs().max())}, max abs err "
              f"{err} (online) / {max_abs_err(out.float(), masked.float())} (masked); "
              f"limit atol {atol} + rtol {rtol} x |out|")
        require(torch.allclose(out.float(), want.float(), rtol=rtol, atol=atol)
                and torch.allclose(out.float(), masked.float(), rtol=rtol, atol=atol),
                f"flash_decode {dtype} != plain (max abs err {err})")
        k2, v2 = k.clone(), v.clone()
        k2[:, kv_len:] = 99.0
        v2[:, kv_len:] = -99.0
        poisoned = fdec.flash_decode(q, k2, v2, kl)
        zero = fdec.flash_decode(q, k, v, torch.zeros_like(kl))
        sync()
        require(torch.allclose(poisoned.float(), out.float(), rtol=1e-6, atol=1e-6),
                f"flash_decode {dtype}: the masked tail leaks in")
        want0 = ref.flash_decode_online_ref(q, k, v, 0)
        rtol0, atol0 = decode_tolerance(dtype, want0)
        print(f"flash_decode {dtype} kv_len=0: max |out| {float(want0.float().abs().max())}, "
              f"max abs err {max_abs_err(zero.float(), want0.float())}, limit atol {atol0}")
        require(torch.allclose(zero.float(), want0.float(), rtol=rtol0, atol=atol0),
                f"flash_decode {dtype} kv_len=0 != plain")
        del k2, v2
        qs = q.reshape(B, Hkv * g, 1, hd)
        ks = k[:, :kv_len].transpose(1, 2).contiguous()
        vs = v[:, :kv_len].transpose(1, 2).contiguous()
        lib_out = F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True)
        lib_err = max_abs_err(lib_out.reshape(q.shape).float(), want.float())
        print(f"scaled_dot_product_attention {dtype}: max abs err {lib_err} from the plain version")
        require(torch.allclose(lib_out.reshape(q.shape).float(), want.float(), rtol=rtol,
                               atol=4 * atol),
                f"scaled_dot_product_attention {dtype} disagrees with the plain version")
        word = torch.finfo(dtype).bits // 8
        nbytes = (2 * q.numel() + 2 * B * kv_len * Hkv * hd) * word
        record_kernel(rows, "flash_decode", err,
                      event_ms(lambda: fdec.flash_decode(q, k, v, kl), 21),
                      event_ms(lambda: ref.flash_decode_online_ref(q, k, v, kl), 3),
                      4.0 * B * Hkv * g * hd * kv_len, nbytes,
                      note=f" {dtype} B={B} Hkv={Hkv} g={g} hd={hd} S={S} kv_len={kv_len}",
                      store=dtype == torch.bfloat16,
                      library=event_ms(lambda: F.scaled_dot_product_attention(
                          qs, ks, vs, enable_gqa=True), 21))
        if dtype == torch.bfloat16:
            rows["flash_decode"]["launches"] = launches
        del q, k, v, ks, vs


# -------------------------------------------------------------- LM serving
LM_ARCHS = ("qwen1.5-0.5b", "qwen2-7b", "qwen2-72b", "minicpm-2b", "llama-3.2-vision-11b",
            "whisper-small")
# The architectures with MoE, MLA or SSM layers (``phase_lm_serve`` (d)–(h)).
LM_FAMILIES = ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "mamba2-780m", "jamba-v0.1-52b")
LM_F32_LEAVES = ("router", "A_log", "D", "dt_bias")  # f32 in the reference too


def kernel_launches() -> int:
    """Launches of every kernel wrapper of the port, summed."""
    from repro_torch.kernels import flash_decode, fw_phase1, fw_repair, fw_repair_del
    from repro_torch.kernels import fw_round, minplus_matmul

    return sum(sum(m.LAUNCHES.values()) for m in (flash_decode, fw_phase1, fw_repair,
                                                   fw_repair_del, fw_round, minplus_matmul))


def lm_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    """Seeded tokens within the real vocabulary [+ the bf16 modality
    stubs: image patch or audio frame embeddings], on the host."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq),
                                                   dtype=np.int32))}
    if cfg.family == "vlm":
        out["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.n_image_tokens, cfg.d_model)) * 0.02).to(torch.bfloat16)
    if cfg.encoder is not None:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.encoder.n_frames, cfg.d_model)) * 0.02).to(torch.bfloat16)
    return out


def lm_same(label: str, got, want, ulps: int = 2) -> float:
    """got (the card's) == want (the CPU's) within the bf16 rule of
    ``decode_tolerance``: rtol 2e-2 and two bf16 ulps of the largest
    |want| (``ulps`` of them: the card tests take four).  Returns the max
    abs error."""
    import torch

    got, want = got.float().cpu(), want.float().cpu()
    rtol, atol = decode_tolerance(torch.bfloat16, want)
    atol *= ulps / 2
    err = max_abs_err(got, want)
    require(bool(torch.isfinite(got).all()), f"lm {label}: non-finite values on the card")
    require(torch.allclose(got, want, rtol=rtol, atol=atol),
            f"lm {label}: card != CPU (max abs err {err}, atol {atol}, rtol {rtol})")
    return err


def lm_card_vs_cpu(label: str, cfg, card, prompt: int, steps: int, batch: int,
                   seed: int, ulps: int = 2) -> float:
    """The card's prefill (logits and caches) and ``steps`` teacher-forced
    decode steps == the CPU's on the same weights (``card``'s, copied) and
    inputs, within ``ulps`` bf16 ulps (``lm_same``).  With MoE layers the
    CPU replays the card's routes (``models.moe.routes``): a token whose
    near-tied top-k went another way on the card moves the outputs by far
    more than rounding, so the check holds the rest to rounding and
    requires every such route to be a near-tie, its probability mass
    within four bf16 ulps (2^-6, relative) of the CPU's own top-k's.
    Returns the largest error."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.model import Model, decode_step, prefill
    from repro_torch.serve.lm import Engine

    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    data = lm_batch(cfg, batch, prompt + steps, seed)
    runs, replay = [], None
    with torch.inference_mode():
        for model in (card, cpu):
            with moe.routes(replay) as log:
                logits, caches = prefill(cfg, model,
                                         dict(data, tokens=data["tokens"][:, :prompt]))
                # A copy: the decode steps update an SSD state in place.
                out = [logits, [{n: t.to("cpu", copy=True) for n, t in c.items()}
                                for c in caches]]
                caches = Engine(cfg, model)._extend_caches(caches, steps)
                for t in range(steps):
                    logits, caches = decode_step(cfg, model, data["tokens"][:, prompt + t],
                                                 prompt + t, caches)
                    out.append(logits)
            runs.append(out)
            replay = log
    if cfg.moe is not None:
        moved, tokens, gap = moe.replay_gap(log)
        print(f"lm {label}: the CPU replayed the card's routes; {moved} of {tokens} token "
              f"routings differ from the CPU's own top-k, the largest relative shortfall of "
              f"their probability mass {gap}")
        require(gap <= 2.0 ** -6, f"lm {label}: a route of the card is no near-tie on the "
                                  f"CPU (shortfall {gap})")
    (pre, caches, *dec), (pre_c, caches_c, *dec_c) = runs
    errs = [lm_same(f"{label} prefill logits", pre, pre_c, ulps)]
    for j, (c, cc) in enumerate(zip(caches, caches_c)):
        errs += [lm_same(f"{label} prefill cache {j}/{n}", c[n], cc[n], ulps) for n in c]
    errs += [lm_same(f"{label} decode step {t}", a, b, ulps)
             for t, (a, b) in enumerate(zip(dec, dec_c))]
    print(f"lm {label}: card == CPU, prefill of {batch} x {prompt} tokens and {steps} decode "
          f"steps; max abs err {max(errs)} (logits: prefill {errs[0]}, decode "
          f"{max(errs[-steps:])}; limit {ulps} bf16 ulps)")
    return max(errs)


def prefill_dropped(cfg, model, data) -> float:
    """The share of a prefill's routed assignments that the experts'
    capacity dropped, over every MoE layer (``models.moe.routes`` watching
    one untimed prefill)."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.model import prefill

    with torch.inference_mode(), moe.routes() as log:
        prefill(cfg, model, data)
    return 1.0 - sum(float(r["keep"].sum()) for r in log) / sum(r["keep"].numel() for r in log)


def lm_serve_model(label: str, cfg, *, batch: int, prompt: int, new: int,
                   n_params: int | None = None, profile: bool = False,
                   forward_info: bool = False):
    """One model of ``phase_lm_serve`` on the card: drawn from seed 0,
    ``Engine.generate`` of ``batch`` seeded prompts of ``prompt`` tokens and
    ``new`` greedy tokens twice (equal ids within the vocabulary), prefill
    ms (median of 3), the timed decode loop (finite logits; three steps
    checked: each writes only its own row of a sequence cache and moves
    every SSD state), tokens/s, peak memory, and the bounds from the
    datasheet (``launch.roofline``): the prefill's ``model_flops`` at the
    bf16 peak or its weights at the HBM rate, whichever is longer; a
    decode step's weights (all of them, every expert's included: the
    dispatch buffer runs every expert's GEMM; the embedding table but the
    rows it gathers left out), its caches and its SSD states written back
    at the HBM rate.  Returns (figures, model)."""
    import torch

    from repro_torch.launch import roofline as rl
    from repro_torch.models.model import (CACHE_SEQ, count_params, decode_step, forward_train,
                                          init_params, model_flops, prefill)
    from repro_torch.serve.lm import Engine

    counted = count_params(cfg)
    require(n_params is None or counted == n_params, f"{label} has {counted} parameters")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device="cuda")
    sync()
    init_s = time.perf_counter() - t0
    require(sum(p.numel() for p in model.parameters()) == counted, f"{label} model size")
    for name, p in model.named_parameters():
        want = torch.float32 if name.split(".")[-1] in LM_F32_LEAVES else torch.bfloat16
        require(p.dtype == want, f"{label}: {name} is {p.dtype}, not {want}")
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    data = lm_batch(cfg, batch, prompt, seed=0)
    eng = Engine(cfg, model)
    walls, ids = [], []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        ids.append(eng.generate(data, max_new_tokens=new))
        walls.append(time.perf_counter() - t0)
    require(ids[0].shape == (batch, new), f"{label}: generated ids of shape {ids[0].shape}")
    require((ids[0] == ids[1]).all(), f"{label}: two greedy runs generated different ids")
    require(((ids[0] >= 0) & (ids[0] < cfg.vocab_size)).all(),
            f"{label}: ids outside the vocabulary")

    pre_ms, dec_ms = [], []
    fig = {}
    with torch.inference_mode():
        for _ in range(3):
            pre_ms.append(host_ms(lambda: prefill(cfg, model, data)))
        logits, caches = prefill(cfg, model, data)
        require(bool(torch.isfinite(logits).all()), f"{label}: non-finite prefill logits")
        caches = eng._extend_caches(caches, new)
        fed = torch.from_numpy(ids[0]).cuda()
        step_logits, other = [], 0
        watched = (0, new // 2, new - 2) if new > 3 else tuple(range(new - 1))
        for i in range(new - 1):
            watch = i in watched
            before = [{n: t.clone() for n, t in c.items()} for c in caches] if watch else None
            sync()
            t0 = time.perf_counter()
            logits, caches = decode_step(cfg, model, fed[:, i], prompt + i, caches)
            sync()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            require(bool(torch.isfinite(logits).all()),
                    f"{label}: non-finite logits at decode step {i}")
            other += int((logits[:, : cfg.vocab_size].argmax(-1) != fed[:, i + 1]).sum())
            if forward_info and i < 16:
                step_logits.append(logits.clone())
            if watch:
                rows = [r for r in range(prompt + new) if r != prompt + i]
                for c, old in zip(caches, before):
                    for n in c:
                        if n in CACHE_SEQ:
                            ok = (torch.equal(c[n][:, rows], old[n][:, rows])
                                  and not torch.equal(c[n][:, prompt + i], old[n][:, prompt + i]))
                        elif n in ("conv", "ssm"):
                            ok = not torch.equal(c[n], old[n])
                        else:
                            ok = torch.equal(c[n], old[n])
                        require(ok, f"{label}: decode step {i} changed cache {n} other than "
                                    f"its own row, or left its own row or state unmoved")
                del before
        if profile:
            profiles = {"prefill": (profiled(lambda: prefill(cfg, model, data)), 1)}
            _, fresh = prefill(cfg, model, data)
            fresh = eng._extend_caches(fresh, 8)

            def eight_steps():
                c = fresh
                for i in range(8):
                    _, c = decode_step(cfg, model, fed[:, i], prompt + i, c)

            profiles["decode"] = (profiled(eight_steps), 8)
            del fresh
        if forward_info:
            full, _ = forward_train(cfg, model, {"tokens": torch.cat([data["tokens"].cuda(),
                                                                       fed[:, :16]], dim=1)})
            fig["forward_vs_decode_max_abs_diff"] = max_abs_err(
                full[:, prompt:prompt + 16].float(), torch.stack(step_logits, dim=1).float())
            del full, step_logits
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = sum(t.numel() * t.element_size() for c in caches for t in c.values())
    state_bytes = sum(t.numel() * t.element_size() for c in caches for n, t in c.items()
                      if n in ("conv", "ssm"))
    # A decode step reads every weight once but the untied embedding table,
    # of which it gathers one row a sequence, the whole extended cache, and
    # writes its SSD states back.
    table = 0 if cfg.tie_embeddings else (model.embed.numel() - batch * cfg.d_model) * 2
    decode_bytes = weight_bytes - table + cache_bytes + state_bytes
    prefill_bytes = weight_bytes - (0 if cfg.tie_embeddings
                                    else (model.embed.numel() - batch * prompt * cfg.d_model) * 2)
    flops = model_flops(cfg, kind="prefill", global_batch=batch, seq_len=prompt)
    fig.update(
        model=label, params=counted, weight_bytes=weight_bytes, batch=batch, prompt=prompt,
        new_tokens=new, init_s=init_s, generate_s=walls, tokens_per_s=batch * new / walls[1],
        prefill_ms=statistics.median(pre_ms), prefill_times_ms=pre_ms,
        decode_ms=statistics.median(dec_ms), decode_min_ms=min(dec_ms),
        max_memory_allocated=peak,
        prefill_bound_ms=max(flops / rl.PEAK_FLOPS_BF16, prefill_bytes / rl.HBM_BW) * 1e3,
        prefill_flops=flops, prefill_bound_bytes=prefill_bytes,
        decode_bound_ms=decode_bytes / rl.HBM_BW * 1e3, decode_bound_bytes=decode_bytes,
        timed_loop_other_ids=other, card=card_line())
    if cfg.moe is not None:
        fig["prefill_dropped_share"] = prefill_dropped(cfg, model, data)
    print(f"lm {label} [{card_line()}]: {counted} parameters ({weight_bytes} B), drawn on the "
          f"card in {init_s:.1f} s; generate {batch} x {prompt} + {new} greedy tokens: "
          f"{walls[0]:.3f} / {walls[1]:.3f} s, ids equal; prefill {fig['prefill_ms']:.2f} ms "
          f"(median of 3: {pre_ms}), decode {fig['decode_ms']:.3f} ms a step (median of "
          f"{len(dec_ms)}), {fig['tokens_per_s']:.1f} generated tokens/s, max_memory_allocated "
          f"{peak} B; the timed decode loop's greedy ids differ from generate's at {other} of "
          f"{batch * (new - 1)}")
    print(f"lm {label} bounds [{card_line()}], derived from the H100 datasheet, not measured: "
          f"prefill max({flops:.4e} FLOP / {rl.PEAK_FLOPS_BF16:.4g} FLOP/s, {prefill_bytes} B "
          f"/ {rl.HBM_BW:.4g} B/s) = {fig['prefill_bound_ms']:.2f} ms; a decode step "
          f"{decode_bytes} B (the weights but the embedding table, its {batch} gathered rows, "
          f"the cache{', the SSD states written back' if state_bytes else ''}) / "
          f"{rl.HBM_BW:.4g} B/s = {fig['decode_bound_ms']:.3f} ms")
    if "prefill_dropped_share" in fig:
        print(f"lm {label}, for information: capacity factor {cfg.moe.capacity_factor} dropped "
              f"{fig['prefill_dropped_share']:.4%} of the prefill's routed assignments")
    if forward_info:
        print(f"lm {label}, for information: forward over the prompt + 16 generated tokens vs "
              f"the decode steps' logits at those positions: max abs diff "
              f"{fig['forward_vs_decode_max_abs_diff']}")
    for what, (prof, calls) in (profiles.items() if profile else ()):
        top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1][0])[:6]
        launched = sum(c for _, c in prof["kernels"].values())
        busy = prof["busy"] or 0.0
        fig[f"{what}_profile"] = dict(wall_ms=prof["wall"] / calls, busy_ms=busy / calls,
                                      kernel_ms=prof["dev"] / calls, launches=launched / calls,
                                      idle=1 - busy / prof["wall"])
        print(f"lm {label} {what} under torch.profiler [{card_line()}], a call of {calls}: "
              f"wall {prof['wall'] / calls:.3f} ms, device busy {busy / calls:.3f} ms (idle "
              f"{1 - busy / prof['wall']:.1%}), {launched / calls:.0f} kernels; by time: "
              + ", ".join(f"{n} {t / calls:.3f} ms x{c / calls:.0f}" for n, (t, c) in top))
    return fig, model


def phase_lm_serve(batch: int = 8, prompt: int = 512, new: int = 64):
    """The LM serving path (``repro_torch.serve.lm.Engine`` over
    ``repro_torch.models``), plain torch ops throughout: the reference's LM
    runs no Pallas kernel, so no kernel of the port is launched (counted).
    Each model is freed before the next; every figure is printed beside
    the card's name and power limit.

    (a) Qwen2-7B at full width and depth (``configs/qwen2_7b.py``,
        7,615,616,512 parameters, bf16, drawn from a seeded generator on
        the card): ``Engine.generate`` of ``batch`` prompts of ``prompt``
        seeded tokens, ``new`` greedy tokens, twice with equal ids; finite
        logits; three decode steps each change only their own cache row.
        Prefill ms (median of 3), decode ms a step (median), generated
        tokens/s, peak device memory, beside the bounds derived from the
        datasheet (``lm_serve_model``), and under ``torch.profiler``.
        For information: the largest difference between a forward over
        the prompt and the first 16 generated tokens and the decode steps'
        logits at those positions.
    (b) Qwen2-7B cut to 2 layers at full width, card == CPU on the same
        weights: 2 prompts of 32 tokens, the prefill and 4 teacher-forced
        decode steps.
    (c) the smoke configs of the six attention-family architectures, card
        == CPU likewise (2 prompts of 16 tokens, 4 decode steps).
    (d) DeepSeek-V2-Lite at full width and depth (27 layers, MLA without
        q_lora, 64 routed + 2 shared experts, top-6; 16,210,324,992
        parameters, routers f32): as (a), its decode steps each writing
        only their own c_kv / k_pe row; for information, the share of the
        prefill's assignments that capacity factor 1.25 dropped.
    (e) Mamba2-780M at full width and depth (48 layers, 857,846,016
        parameters): as (a), its decode steps each moving every conv and
        ssm state; then a prompt of 500 tokens, not a multiple of the
        256-token chunk, so that the one-chunk fallback runs.
    (f) Jamba v0.1 at full width, cut to one period of its pattern (8 of
        32 layers: 7 SSD, 1 attention, 4 MoE and 4 dense FFNs; the 52B
        model does not fit one card): as (a).
    (g) Kimi K2 at full width, cut to one layer (MLA with q_lora 1536, 384
        experts, top-8): 2 prompts of 128 tokens and 8 greedy tokens twice
        with equal ids, finite logits; its times for information.
    (h) card == CPU within four bf16 ulps (the card tests' rule):
        DeepSeek-V2-Lite and Mamba2-780M each cut to 2 layers at full
        width, and the smoke configs of the four families; 2 prompts of 32
        tokens, the prefill and 4 teacher-forced decode steps.
    """
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.models.model import init_params, prefill

    launches = kernel_launches()
    cfg = get_config("qwen2-7b")
    fig, model = lm_serve_model("qwen2-7b", cfg, batch=batch, prompt=prompt, new=new,
                                n_params=7_615_616_512, profile=True, forward_info=True)
    del model
    torch.cuda.empty_cache()

    two = dataclasses.replace(cfg, n_layers=2)
    card = init_params(two, seed=1, device="cuda")
    fig["two_layer_max_abs_err"] = lm_card_vs_cpu("qwen2-7b, 2 layers", two, card, 32, 4, 2, 1)
    del card
    torch.cuda.empty_cache()
    for arch in LM_ARCHS:
        scfg = get_smoke_config(arch)
        fig[f"smoke_{arch}_max_abs_err"] = lm_card_vs_cpu(
            scfg.name, scfg, init_params(scfg, seed=2, device="cuda"), 16, 4, 2, 2)

    families = fig["families"] = {}
    for arch, n_params in (("deepseek-v2-lite-16b", 16_210_324_992),
                           ("mamba2-780m", 857_846_016)):
        fcfg = get_config(arch)
        families[arch], model = lm_serve_model(arch, fcfg, batch=batch, prompt=prompt,
                                               new=new, n_params=n_params, profile=True)
        if fcfg.ssm is not None:
            odd = prompt - 12
            require(odd % fcfg.ssm.chunk_size, "the fallback prompt is a multiple of the chunk")
            data = lm_batch(fcfg, batch, odd, seed=3)
            with torch.inference_mode():
                odd_ms = host_ms(lambda: prefill(fcfg, model, data))
                logits, caches = prefill(fcfg, model, data)
            require(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits at {odd}")
            families[arch]["one_chunk_prefill"] = dict(prompt=odd, ms=odd_ms)
            print(f"lm {arch} [{card_line()}]: a prompt of {odd} tokens (not a multiple of the "
                  f"{fcfg.ssm.chunk_size}-token chunk: one chunk), prefill {odd_ms:.2f} ms, "
                  f"finite logits")
            del logits, caches
        del model
        torch.cuda.empty_cache()

    jamba = get_config("jamba-v0.1-52b")
    period = dataclasses.replace(jamba, n_layers=len(jamba.layer_pattern))
    families["jamba-v0.1-52b"], model = lm_serve_model(
        "jamba-v0.1-52b, one period", period, batch=batch, prompt=prompt, new=new,
        profile=True)
    families["jamba-v0.1-52b"]["reduced"] = (
        f"n_layers {jamba.n_layers} -> {period.n_layers} (one period of the pattern): the "
        f"52B model does not fit one card")
    del model
    torch.cuda.empty_cache()

    kimi = get_config("kimi-k2-1t-a32b")
    one = dataclasses.replace(kimi, n_layers=1)
    families["kimi-k2-1t-a32b"], model = lm_serve_model(
        "kimi-k2-1t-a32b, one layer", one, batch=2, prompt=128, new=8)
    families["kimi-k2-1t-a32b"]["reduced"] = (
        f"n_layers {kimi.n_layers} -> 1: the 1.04T model does not fit one card")
    del model
    torch.cuda.empty_cache()

    for arch in ("deepseek-v2-lite-16b", "mamba2-780m"):
        two = dataclasses.replace(get_config(arch), n_layers=2)
        card = init_params(two, seed=1, device="cuda")
        families[arch]["two_layer_max_abs_err"] = lm_card_vs_cpu(
            f"{arch}, 2 layers", two, card, 32, 4, 2, 1, ulps=4)
        del card
        torch.cuda.empty_cache()
    for arch in LM_FAMILIES:
        scfg = get_smoke_config(arch)
        families[arch]["smoke_max_abs_err"] = lm_card_vs_cpu(
            scfg.name, scfg, init_params(scfg, seed=2, device="cuda"), 32, 4, 2, 2, ulps=4)
    launched = kernel_launches() - launches
    require(launched == 0, f"the LM path launched {launched} kernels of the port")
    print("lm_serve " + json.dumps(fig))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and run the kernel-vs-plain checks only")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_run = time.perf_counter()

    def run(phase, *args):
        """A phase, and how long it took (the run must stay within its
        time limit as phases are added)."""
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"phase {phase.__name__}: {time.perf_counter() - t0:.1f} s "
              f"({time.perf_counter() - t_run:.1f} s into the run)", flush=True)
        return out

    name, builds = run(phase_device)
    # The checks run while the slowest library (fw_repair.cu) still
    # compiles: each waits for its own libraries only, in about the order
    # they land; those that need fw_repair come after the build report.
    for check in (phase_check, phase_check_repair_del, phase_check_four, phase_check_dist,
                  phase_check_phase_chains, phase_check_sweep_chains,
                  phase_check_succ_sweep_chains, phase_check_lowered, phase_check_chains,
                  phase_check_succ_chains, phase_check_lowered_repair,
                  phase_check_lowered_four, phase_check_lowered_bordered,
                  phase_check_f16_plus_mul, phase_check_kleene):
        run(check)
    run(phase_build, builds)
    run(phase_signed_zero)
    run(phase_check_repair)
    if not args.quick:
        rows = run(phase_kernels, 8192, 4096)
        run(phase_kernels_repair, rows, 8192, 4096)
        run(phase_kernels_repair_del, rows, 8192, 4096)
        run(phase_kernels_four, rows, 8192)
        run(phase_kernels_lowered_four, rows, 8192)
        run(phase_kernels_lowered, rows, 8192, 4096)
        run(phase_kernels_lowered_repair, rows, 8192, 4096)
        run(phase_main, rows, 8192, 4096)
        run(phase_main_lowered, rows, 8192, 4096)
        run(phase_engine_lowered, rows, 8192, 4096)
        run(phase_integer_storage, rows)
        run(phase_flash_decode, rows)
        run(phase_engine, rows, 8192, 4096)
        run(phase_engine_repair_del, rows, 8192, 4096)
        run(phase_serve, rows)
        run(phase_oocore, rows)
        run(phase_four, rows, 8192)
        run(phase_four_lowered, rows, 8192)
        run(phase_kernels_dist, rows, 8192)
        run(phase_dist, rows, 8192, 2048)
        run(phase_lm_serve)
        idle = [k for k, r in rows.items() if r["launches"] < 1]
        require(not idle, f"kernels of the record launched no time on their paths: {idle}")
        print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
