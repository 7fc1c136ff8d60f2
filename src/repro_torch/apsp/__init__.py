"""repro_torch.apsp — the APSP solver front-end and its engine.

    from repro_torch.apsp import ApspEngine, solve
    res = solve(w)                        # any n, auto-padded, on the card
    res = solve(w_batch, method="fused")  # (B, n, n): one launch set per round
    res = solve(w, dtype=torch.int16)     # saturating int16 lowering
    res = solve(w.to(torch.bfloat16))     # solved in bf16, the input's dtype
    res = solve(graphs, semiring="or_and", packed=True)  # 32 closures a word
    eng = ApspEngine()                    # plan cache for repeated solves
    tables = eng.solve_many(graphs, successors=True)   # ragged batches
    fixed = eng.repair(res.dist, [(u, v, w_new)])      # rank-1 link repair
    fixed = eng.repair_del(res.dist, w1, [(u, v, w_old)])  # link failures
    p = distributed_plan(8192, devices=4)  # the mesh planner
    res = solve(w, hbm_budget=768 << 20)  # streams panels past the budget

``PlanKey``, ``ExecutablePlan`` and ``EngineStats`` are the engine's plan
cache keys, cached plans and counters; ``distributed_plan`` and
``recursive_plan`` are re-exported from ``plan``.  ``kleene`` holds the
recursive (R-Kleene) schedule behind method="recursive": ``fw_kleene``
(its entry point on padded matrices), ``KleeneExecutor`` and the panel
stores ``DevicePanelStore`` / ``HostPanelStore``.  The autotuner
(``autotune_fw``) of ``repro.apsp`` is not ported yet (ROADMAP A.5).
"""
from repro_torch.apsp import plan
from repro_torch.apsp.api import (
    METHODS,
    SUCCESSOR_METHODS,
    APSPResult,
    NegativeCycleError,
    negative_cycle_mask,
    pack_reachability,
    solve,
    unpack_reachability,
)
from repro_torch.apsp.engine import (
    ApspEngine,
    EngineStats,
    ExecutablePlan,
    PlanKey,
    negative_cycle_mask_padded,
)
from repro_torch.apsp.kleene import (
    DevicePanelStore,
    HostPanelStore,
    KleeneExecutor,
    fw_kleene,
)
from repro_torch.apsp.plan import distributed_plan, recursive_plan

__all__ = [
    "APSPResult",
    "ApspEngine",
    "DevicePanelStore",
    "EngineStats",
    "ExecutablePlan",
    "HostPanelStore",
    "KleeneExecutor",
    "METHODS",
    "SUCCESSOR_METHODS",
    "NegativeCycleError",
    "PlanKey",
    "distributed_plan",
    "fw_kleene",
    "negative_cycle_mask",
    "negative_cycle_mask_padded",
    "pack_reachability",
    "plan",
    "recursive_plan",
    "solve",
    "unpack_reachability",
]
