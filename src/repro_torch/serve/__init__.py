"""repro_torch.serve — the APSP serving stack over the port's ``ApspEngine``.

    from repro_torch.serve.routing import RoutingEngine
    router = RoutingEngine()              # on the card; device="cpu" for the host
    router.add_graph("g", w)
    router.refresh()                      # one bucketed solve_many
    reply = router.query("g", 0, 5)       # a host-side walk of the snapshot

Modules: ``registry`` (weights, byte accounting, LRU, dirty kinds),
``snapshot`` (double-buffered host tables), ``scheduler`` (micro-batcher),
``routing`` (``RoutingEngine``), ``lm`` (the language models' ``Engine``:
prefill, then lockstep decode) and the ``engine`` shim.
"""
