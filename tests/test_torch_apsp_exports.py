"""The port's ``repro_torch.apsp`` exports what the reference's ``repro.apsp`` does.

Every name of ``repro.apsp.__all__`` is in ``repro_torch.apsp.__all__`` and
importable from it, except the autotuner's, which is not ported yet
(ROADMAP A.5).  ``repro_torch.apsp.solver``
is the counterpart of the reference's back-compat shim ``repro.apsp.solver``:
the same names, re-exported from ``repro_torch.apsp.api``.
"""
import pytest

import repro.apsp
import repro.apsp.solver
import repro_torch.apsp
import repro_torch.apsp.api
import repro_torch.apsp.solver

# The reference's names the port does not export yet: the autotuner (A.5).
NOT_PORTED = frozenset({"autotune_fw"})


@pytest.mark.parametrize("name", sorted(repro.apsp.__all__))
def test_reference_apsp_name_is_exported(name):
    if name in NOT_PORTED:
        assert name not in repro_torch.apsp.__all__
        return
    assert name in repro_torch.apsp.__all__
    assert hasattr(repro_torch.apsp, name)


def test_port_exports_exist():
    for name in repro_torch.apsp.__all__:
        assert hasattr(repro_torch.apsp, name), name


@pytest.mark.parametrize("name", sorted(repro.apsp.solver.__all__))
def test_solver_shim_reexports_the_api(name):
    assert name in repro_torch.apsp.solver.__all__
    assert getattr(repro_torch.apsp.solver, name) is getattr(repro_torch.apsp.api, name)


def test_solver_shim_names_match_the_reference():
    assert sorted(repro_torch.apsp.solver.__all__) == sorted(repro.apsp.solver.__all__)


def test_engine_and_planner_names_are_the_engines():
    from repro_torch.apsp import engine, plan

    assert repro_torch.apsp.PlanKey is engine.PlanKey
    assert repro_torch.apsp.ExecutablePlan is engine.ExecutablePlan
    assert repro_torch.apsp.EngineStats is engine.EngineStats
    assert repro_torch.apsp.distributed_plan is plan.distributed_plan
    got = repro_torch.apsp.distributed_plan(8192, devices=4)
    assert (got["R"], got["C"], got["n_padded"]) == (2, 2, 8192)
