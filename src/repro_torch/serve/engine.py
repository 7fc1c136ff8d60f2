"""Back-compat shim: ``from repro_torch.serve.engine import RoutingEngine``.

Counterpart of ``repro.serve.engine``.  The serving stack is a layered
package:

    serve/registry.py   graph weights, memory accounting/LRU, dirty kinds
    serve/snapshot.py   double-buffered dist+succ snapshot store
    serve/scheduler.py  micro-batching query scheduler (max-batch/max-wait)
    serve/routing.py    public ``RoutingEngine`` (thin composition)

Import from those modules directly; this shim keeps the reference's
``serve.engine`` spelling working for the routing names.  The reference's
shim also re-exports the LM ``Engine``, ``cache_pspecs`` and
``make_serve_fns`` from ``serve/lm.py``; those come with the LM substrate
(ROADMAP A.13), which is not ported yet.
"""
from repro_torch.serve.routing import RouteReply, RoutingEngine  # noqa: F401

__all__ = [
    "RouteReply",
    "RoutingEngine",
]
