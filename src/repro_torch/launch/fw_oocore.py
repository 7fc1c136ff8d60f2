"""Out-of-core recursive (R-Kleene) solve launcher and its smoke check.

Usage: PYTHONPATH=src python -m repro_torch.launch.fw_oocore [--n 1024]
           [--budget BYTES] [--leaf L] [--block-size S] [--semiring min_plus]
           [--seed 0] [--no-check] [--device cuda]
       PYTHONPATH=src python -m repro_torch.launch.fw_oocore --smoke [--device cpu]

Counterpart of ``repro.launch.fw_oocore``.  The default mode runs one
streamed solve under a capped ``hbm_budget`` (panels of a pinned host
matrix through ``apsp.kleene.HostPanelStore``) and, unless ``--no-check``,
the in-core fused solve of the same padded input; holds them equal by
bits, holds the measured bytes each way to the ``plan.recursive_plan``
model, and prints a ``METRICS {json}`` line.  Folding that line into a
bench file waits for the port's bench runner (ROADMAP A.2).

``--smoke``: at n = 512, s = 64, under a budget of 60 % of the matrix, in
f32 min-plus, saturating int16 and packed or_and words: the plan goes out
of core with its modelled residency inside the budget, panels cross both
ways, the bytes each way equal the model exactly, and the streamed closure
equals the fused solve by bits.  ``--device cpu`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

SMOKE_LOWERINGS = ("min_plus", "min_plus_i16", "or_and_packed")


def _inputs(n: int, sr, seed: int):
    """The reference's seeded input of ``stream_once`` (the same draws)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if sr.packed:
        w = rng.integers(0, 2**31 - 1, size=(n, n), dtype=np.int32)
        np.fill_diagonal(w, -1)
    elif sr.dtype == "int16":
        w = rng.integers(-5, 1000, (n, n)).astype(np.int16)
        np.fill_diagonal(w, 0)
    else:
        w = rng.uniform(1.0, 10.0, (n, n)).astype(np.float32)
        w[rng.uniform(size=(n, n)) > 0.6] = np.float32(sr.zero)
        np.fill_diagonal(w, np.float32(sr.one))
    return w


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def stream_once(
    n: int,
    *,
    budget: int | None,
    block_size: int | None = None,
    leaf: int | None = None,
    semiring="min_plus",
    seed: int = 0,
    check: bool = True,
    device="cuda",
) -> dict:
    """One streamed solve and its model comparison; returns a metrics
    dict (the reference's keys, plus ``device``)."""
    from repro_torch.apsp import plan, solve
    from repro_torch.apsp.api import _pad, _resolve_device
    from repro_torch.apsp.kleene import HostPanelStore, KleeneExecutor
    from repro_torch.core.semiring import resolve_semiring
    from repro_torch.utils.bits import bits_equal
    from repro_torch.utils.interop import host_tensor

    dev = _resolve_device(device)
    sr = resolve_semiring(semiring)
    w = _inputs(n, sr, seed)
    rp = plan.recursive_plan(n, leaf=leaf, hbm_budget=budget, block_size=block_size,
                             dtype=w.dtype)
    m, s = rp["n_padded"], rp["block_size"]
    res = solve(w, method="recursive", semiring=sr, block_size=s, leaf=rp["leaf"],
                hbm_budget=budget, validate=False, device=dev)
    # Again through an explicit host store, whose byte counters the
    # stateless solve() does not expose (the same schedule).
    store = HostPanelStore(_pad(host_tensor(w), m, sr), device=dev)
    ex = KleeneExecutor(semiring=sr, block_size=s, leaf=rp["leaf"], variant=rp["variant"])
    _sync(dev)
    t0 = time.perf_counter()
    ex.run(store)
    streamed = store.result()
    streamed_s = time.perf_counter() - t0
    out = dict(
        n=n, n_padded=m, block_size=s, leaf=rp["leaf"], out_of_core=rp["out_of_core"],
        budget=budget, matrix_bytes=rp["matrix_bytes"],
        hbm_resident_bytes=rp["hbm_resident_bytes"],
        model_h2d_bytes=rp["h2d_bytes"], model_d2h_bytes=rp["d2h_bytes"],
        measured_h2d_bytes=store.h2d_bytes, measured_d2h_bytes=store.d2h_bytes,
        leaf_calls=ex.leaf_calls, sweep_calls=ex.sweep_calls, depth=ex.depth,
        streamed_s=streamed_s, semiring=sr.name, device=str(dev),
    )
    # Model bytes over measured bytes: 100 % is exactly what the plan
    # promised.  An in-core plan models no transfer; None then.
    model = rp["transfer_bytes"]
    measured = store.h2d_bytes + store.d2h_bytes
    out["transfer_efficiency_pct"] = 100.0 * model / measured if model and measured else None
    if check:
        ref = solve(w, method="fused", semiring=sr, block_size=s, validate=False, device=dev)
        if not bits_equal(res.dist, ref.dist):
            raise AssertionError(f"recursive != fused ({sr.name})")
        if not bits_equal(streamed[..., :n, :n], ref.dist):
            raise AssertionError(f"streamed != fused ({sr.name})")
        out["bitwise"] = True
    return out


def smoke(device="cuda") -> int:
    """The out-of-core checks at n = 512 (see the module docstring)."""
    n = 512
    failures = []
    for semiring in SMOKE_LOWERINGS:
        word = {"min_plus": 4, "min_plus_i16": 2, "or_and_packed": 4}[semiring]
        # 60 % of the matrix: one s = 64 pivot cross and its factors fit,
        # the matrix never does, so every storage has to stream.
        budget = (n * n * word) * 6 // 10
        m = stream_once(n, budget=budget, block_size=64, semiring=semiring, device=device)
        if not m["out_of_core"]:
            failures.append(f"{semiring}: plan did not go out of core")
        if m["hbm_resident_bytes"] > budget:
            failures.append(f"{semiring}: modelled residency {m['hbm_resident_bytes']} "
                            f"> budget {budget}")
        if m["measured_h2d_bytes"] <= 0 or m["measured_d2h_bytes"] <= 0:
            failures.append(f"{semiring}: panels did not cross to the host store")
        if (m["measured_h2d_bytes"], m["measured_d2h_bytes"]) != (
                m["model_h2d_bytes"], m["model_d2h_bytes"]):
            failures.append(f"{semiring}: bytes {m['measured_h2d_bytes']} / "
                            f"{m['measured_d2h_bytes']} != model {m['model_h2d_bytes']} / "
                            f"{m['model_d2h_bytes']}")
        print(f"oocore {semiring:14s} n={n} budget={budget} leaf={m['leaf']} "
              f"h2d={m['measured_h2d_bytes']} d2h={m['measured_d2h_bytes']} "
              f"eff={m['transfer_efficiency_pct']:.1f}% bitwise=True device={m['device']}")
    if failures:
        for f in failures:
            print("FAIL", f)
        return 1
    print(f"OK oocore smoke n={n}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--budget", type=int, default=None,
                    help="device-memory cap in bytes (None = in-core)")
    ap.add_argument("--leaf", type=int, default=None)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--semiring", default="min_plus")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-check", action="store_true",
                    help="skip the bitwise fused baseline (big n)")
    ap.add_argument("--smoke", action="store_true",
                    help="the out-of-core checks at n = 512")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the kernels, default) or "cpu" (their plain versions)')
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(args.device)
    metrics = stream_once(
        args.n, budget=args.budget, block_size=args.block_size, leaf=args.leaf,
        semiring=args.semiring, seed=args.seed, check=not args.no_check, device=args.device,
    )
    print("METRICS " + json.dumps(metrics))
    eff = metrics["transfer_efficiency_pct"]
    print(f"OK oocore n={args.n} leaf={metrics['leaf']} oocore={metrics['out_of_core']} "
          f"h2d={metrics['measured_h2d_bytes']} d2h={metrics['measured_d2h_bytes']} "
          f"eff={'n/a' if eff is None else f'{eff:.1f}%'} t={metrics['streamed_s']:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
