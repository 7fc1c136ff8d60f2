"""Quickstart on the PyTorch/CUDA port: all-pairs shortest paths through
the unified solver.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # the host

The port's copy of ``examples/quickstart.py``: builds a random weighted
digraph, solves it with ``repro_torch.apsp.solve`` — which picks a method,
pads to the tile multiple, validates, and unpads — then cross-checks it
against the naive rung of the paper's implementation ladder.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.apsp import solve
from repro_torch.core.graph import random_digraph


def main(device: str = "cuda"):
    n = 300  # any size — solve() pads to the tile multiple internally
    w = random_digraph(n, density=0.25, seed=42)
    print(f"graph: {n} vertices, {np.isfinite(w).sum() - n} edges")

    t0 = time.perf_counter()
    res = solve(w, device=device)  # method="auto": the fused round
    if device == "cuda":
        torch.cuda.synchronize()
    print(f"solve(method={res.method!r}, block_size={res.block_size}, "
          f"padded {res.n}→{res.padded_n}) on {device}: {time.perf_counter()-t0:.2f}s")

    d_naive = solve(w, method="naive", device=device).dist
    torch.testing.assert_close(res.dist, d_naive, rtol=1e-5, atol=1e-5)
    print("matches naive FW ✓")

    d = res.dist.cpu().numpy()
    reachable = np.isfinite(d).mean()
    print(f"reachable pairs: {reachable:.1%}; "
          f"diameter (finite): {d[np.isfinite(d)].max():.2f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
