"""Distributed Floyd-Warshall on the PyTorch/CUDA port: the first-class
grid path plus round-granular fault tolerance.

    PYTHONPATH=src python examples/distributed_fw_torch.py               # the card
    PYTHONPATH=src python examples/distributed_fw_torch.py --device cpu  # the host

The port's copy of ``examples/distributed_fw.py``.  ``launch.mesh.run_grid``
spawns an R×C grid of ``torch.distributed`` processes (``--devices``,
default 4: a 2×2 grid; on one card the ranks share it over gloo), and every
rank runs ``rank_main``: a distributed solve of an odd-sized graph held
bitwise to the single-device fused solve, the grid engine's ragged
``solve_many`` with no runner built twice, and a chunked solve restarted
from its round-4 checkpoint.
"""
import argparse

import torch

from repro_torch.apsp import ApspEngine, plan, solve
from repro_torch.core.distributed import fw_distributed, gather
from repro_torch.core.floyd_warshall import fw_naive
from repro_torch.core.graph import random_digraph
from repro_torch.launch.mesh import run_grid


def rank_main(mesh) -> dict:
    dev = mesh.device.type
    n, bs = 512, 64

    # --- first-class grid solve: any n (auto-pads to the grid multiple),
    # bitwise equal to the single-device fused solve.
    w_odd = random_digraph(300, density=0.2, seed=3)
    res = solve(w_odd, method="distributed", mesh=mesh, device=dev)
    single = solve(w_odd, method="fused", block_size=res.block_size, device=dev)
    assert torch.equal(res.dist, single.dist), "distributed != single-device fused"

    # --- grid-keyed engine: ragged graphs, batched, no runner built twice.
    eng = ApspEngine(method="distributed", mesh=mesh, device=dev)
    graphs = [random_digraph(m, density=0.3, seed=m) for m in (200, 300, 200)]
    eng.solve_many(graphs)
    eng.solve_many(graphs)  # warm: pure cache hits
    assert all(e.traces == 1 for e in eng._cache.values())

    # --- fault tolerance: chunked rounds + restart from a checkpoint.
    w = torch.from_numpy(random_digraph(n, density=0.2, seed=7)).to(mesh.device)
    saved = {}

    def checkpoint_cb(next_round, block):
        # Any round boundary is consistent, and re-running a round is
        # idempotent; keep the full matrix the grid holds at this boundary.
        saved[next_round] = gather(block, mesh)

    d = gather(fw_distributed(w, mesh, block_size=bs, rounds_per_call=2,
                              checkpoint_cb=checkpoint_cb), mesh)
    want = fw_naive(w)
    torch.testing.assert_close(d, want, rtol=1e-5, atol=1e-5)
    # Simulated node failure after round 4: restart from the checkpoint.
    d2 = gather(fw_distributed(saved[4], mesh, block_size=bs, start_round=4), mesh)
    torch.testing.assert_close(d2, want, rtol=1e-5, atol=1e-5)
    return dict(rank=mesh.rank, padded_n=res.padded_n, cache=eng.cache_size,
                hits=eng.stats.hits, checkpoints=sorted(saved))


def main(device: str = "cuda", devices: int = 4):
    R, C = plan.mesh_factorization(devices)
    print(f"grid: {R}x{C} ranks on {device}")
    if device == "cuda":
        from repro_torch.kernels import _build

        _build.build_all(("fw_round",))  # once, before the ranks load it
    recs = run_grid(rank_main, R, C, device=device)
    r0 = recs[0]
    print(f"solve(method='distributed') n=300 (padded {r0['padded_n']}) "
          f"== single-device fused, bitwise ✓")
    print(f"ApspEngine(mesh=...) ragged solve_many: cache={r0['cache']}, "
          f"hits={r0['hits']}, no runner built twice ✓")
    print(f"distributed FW over {R * C} ranks ✓ (checkpoints at rounds {r0['checkpoints']})")
    print("restart from round-4 checkpoint reproduces the result ✓")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--devices", type=int, default=4, help="ranks of the grid")
    args = ap.parse_args()
    main(args.device, args.devices)
