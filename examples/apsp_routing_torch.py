"""Network-routing scenario on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/apsp_routing_torch.py               # the card
    PYTHONPATH=src python examples/apsp_routing_torch.py --device cpu  # the host

The port's copy of ``examples/apsp_routing.py``: a
``repro_torch.serve.engine.RoutingEngine`` router fronts an
``ApspEngine`` pinned to the fused round kernel, several network
topologies of *different sizes* are registered (a healthy grid, the same
grid with a failed core link, and a larger ring), and one ``refresh`` call
re-solves all of them through one bucketed ``solve_many`` — ragged sizes
pad into per-bucket batches, each bucket running distances AND next-hop
successor matrices through the fused round's batch grid.  A burst of path
queries is then answered from the cached routing tables on the host
without touching the device again.  A live link failure (``fail_link``)
marks only that graph dirty; the next query triggers a one-graph
decremental refresh.

Also demonstrates the OR-AND semiring (transitive closure = reachability)
through the stateless ``apsp.solve`` front-end, padding handled internally.
"""
import argparse

import numpy as np

from repro_torch.apsp import solve
from repro_torch.core.graph import grid_graph, ring_graph
from repro_torch.serve.engine import RoutingEngine


def main(device: str = "cuda"):
    side = 6
    n = side * side
    w = grid_graph(side)

    # Scenario graphs of different sizes: ragged sizes bucket into padded
    # batches inside ApspEngine.solve_many — one launch set per bucket.
    w_failed = w.copy()
    w_failed[14, 15] = np.inf
    w_failed[15, 14] = np.inf

    router = RoutingEngine(method="fused", device=device)
    router.add_graph("grid/healthy", w)
    router.add_graph("grid/link-14-15-down", w_failed)
    router.add_graph("ring/backbone", ring_graph(50))
    refreshed = router.refresh()
    stats = router.engine.stats
    print(f"refreshed {refreshed} graphs in {stats.solves} batched solve(s) "
          f"(plan cache: {stats.misses} built, {stats.hits} hits)")

    # A query burst served entirely from the cached successor tables.
    for reply in router.query_many([
        ("grid/healthy", 12, 17),
        ("grid/link-14-15-down", 12, 17),
        ("ring/backbone", 0, 37),
    ]):
        print(f"[{reply.graph_id}] route {reply.src}→{reply.dst}: "
              f"{reply.path} (cost {reply.cost:.0f})")

    # A live mutation: failing another link dirties ONLY that graph; the
    # next query refreshes it (one-graph batch) and reroutes.
    router.fail_link("grid/healthy", 13, 14)
    reply = router.query("grid/healthy", 12, 17)
    print(f"[grid/healthy after 13-14 down] route 12→17: {reply.path} "
          f"(cost {reply.cost:.0f})")

    # Reachability via the boolean semiring on the same round kernels;
    # solve() pads the 36-vertex graph to the tile size internally.
    adj = (np.isfinite(w) & (w > 0)).astype(np.float32)
    np.fill_diagonal(adj, 1.0)
    reach = solve(adj, method="staged", semiring="or_and", device=device).dist
    print(f"transitive closure: {int(reach.sum())} reachable pairs "
          f"(expected {n*n} on a connected grid)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
