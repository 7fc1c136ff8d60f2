"""Back-compat shim: ``from repro_torch.serve.engine import RoutingEngine, Engine``.

Counterpart of ``repro.serve.engine``.  The serving stack is a layered
package:

    serve/lm.py         LM ``Engine``
    serve/registry.py   graph weights, memory accounting/LRU, dirty kinds
    serve/snapshot.py   double-buffered dist+succ snapshot store
    serve/scheduler.py  micro-batching query scheduler (max-batch/max-wait)
    serve/routing.py    public ``RoutingEngine`` (thin composition)

Import from those modules directly; this shim keeps the reference's
``serve.engine`` spelling working.  The reference's shim also re-exports
``cache_pspecs`` and ``make_serve_fns``, its mesh sharding specs; those
come with ``utils/sharding.py`` (ROADMAP A.13c).
"""
from repro_torch.serve.lm import Engine  # noqa: F401
from repro_torch.serve.routing import RouteReply, RoutingEngine  # noqa: F401

__all__ = [
    "Engine",
    "RouteReply",
    "RoutingEngine",
]
