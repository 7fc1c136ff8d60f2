"""Time the square fused round of the ``repro_torch`` package on the path.

    PYTHONPATH=src python src/repro_torch/launch/round_bench.py [--n 8192]

Prints one JSON line: each ``fw_round`` launch kind (diag, bands, relax)
alone at (n, n), pivot round n/s/2 (median of 11 between CUDA events),
and ``solve`` of the seeded density-0.5 digraph at n (host clock around
work that ends in a synchronize, median of 3 after a warm-up), with the
card's name.  Run it
with PYTHONPATH pointing at two trees, in turns inside one chip call, to
compare their round kernels on one card.  Only the API both trees share
is used (``fw_round_phase``, ``round_buffers``, ``solve``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    import torch

    import repro_torch
    from repro_torch.apsp import solve
    from repro_torch.core.graph import random_digraph
    from repro_torch.kernels import fw_round as fr

    if not torch.cuda.is_available():
        print("round_bench: no CUDA device available", file=sys.stderr)
        return 1
    n, s = args.n, 128
    w = torch.from_numpy(random_digraph(n, density=0.5, seed=0)).cuda()
    b = n // s // 2
    bands = fr.round_buffers(w, s)
    wk = w.clone()
    launch = {}
    for phase in ("diag", "bands", "relax"):
        times = []
        for _ in range(12):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fr.fw_round_phase(phase, wk, b, bands, block_size=s)
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        launch[phase] = statistics.median(times[1:])
    solve(w)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(w)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps(dict(label=args.label, package=repro_torch.__file__,
                          device=torch.cuda.get_device_name(0), n=n,
                          diag_ms=launch["diag"], bands_ms=launch["bands"],
                          relax_ms=launch["relax"],
                          solve_ms=statistics.median(times), solve_all=times)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
