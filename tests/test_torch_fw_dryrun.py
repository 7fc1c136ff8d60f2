"""The rest of the port's FW tooling: the dry run / roofline
(``repro_torch.launch.fw_dryrun``) on the plan models, the ``fw_dist_check``
options ``--method engine``, ``--repair-del`` and ``--pods`` on grids of
CPU ranks, and the examples ``quickstart_torch.py`` and
``distributed_fw_torch.py`` with ``--device cpu``.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.apsp import plan as jplan
from repro_torch.apsp import plan as tplan
from repro_torch.launch import fw_dist_check as chk
from repro_torch.launch import fw_dryrun
from repro_torch.launch import roofline as rl

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n_r,n_c,s", [(512, 512, 128), (4096, 2048, 128), (96, 160, 32),
                                       (65536, 65536, 64)])
@pytest.mark.parametrize("tiles", [{}, {"bm": 128, "bn": 128}, {"bm": 64, "bn": 256}])
@pytest.mark.parametrize("word", [4, 2])
def test_staged_hbm_bytes_per_round_equals_reference(n_r, n_c, s, tiles, word):
    got = tplan.staged_hbm_bytes_per_round(n_r, n_c, s, word=word, **tiles)
    assert got == jplan.staged_hbm_bytes_per_round(n_r, n_c, s, word=word, **tiles)


@pytest.mark.parametrize("n,s,grid,pods", [(8192, 128, (16, 16), 1), (65536, 128, (32, 16), 2),
                                          (1000, 64, (2, 2), 1), (300, 128, (4, 2), 1)])
def test_dryrun_record_follows_the_plan_models(n, s, grid, pods):
    rec = fw_dryrun.run(n, s, grid=grid, pods=pods)
    R, C = grid
    dp = tplan.distributed_plan(n, R * C, grid=grid, block_size=s, pods=pods)
    m, rounds, (n_r, n_c) = dp["n_padded"], dp["rounds"], dp["tile"]
    assert (rec["R"], rec["C"], rec["pods"], rec["n_padded"], rec["rounds"]) == \
        (R, C, pods, m, rounds)
    assert rec["coll_bytes_per_chip"] == rounds * tplan.dist_round_comm_bytes(m, R, C,
                                                                              rec["block_size"])
    assert rec["summa_comm_bound_bytes"] == jplan.summa_comm_bound_bytes(m, R, C)
    assert rec["flops_per_chip"] == 2 * n_r * n_c * m
    assert rec["bytes_per_chip"] == rounds * jplan.staged_hbm_bytes_per_round(
        n_r, n_c, rec["block_size"], bm=128, bn=128)
    assert rec["t_compute_s"] == rec["flops_per_chip"] / rl.PEAK_FLOPS_F32
    assert rec["t_memory_s"] == rec["bytes_per_chip"] / rl.HBM_BW
    assert rec["t_collective_s"] == rec["coll_bytes_per_chip"] / rl.NVLINK_BW
    terms = {k: rec[f"t_{k}_s"] for k in ("compute", "memory", "collective")}
    assert rec["bottleneck"] == max(terms, key=terms.get)
    assert rec["roofline_fraction"] == pytest.approx(
        2.0 * n ** 3 / (R * C) / max(terms.values()) / rl.PEAK_FLOPS_F32)
    assert rec["comm_efficiency"] == pytest.approx(dp["comm_model_efficiency"])
    assert rec["fits_h100_80gb"] == (rec["memory_bytes_per_chip"] < 80e9)


def test_dryrun_cli_writes_one_record_a_grid(tmp_path, capsys):
    assert fw_dryrun.main(["--n", "8192", "--out", str(tmp_path)]) == 0
    assert fw_dryrun.main(["--n", "4096", "--mesh", "multi", "--block-size", "64",
                           "--out", str(tmp_path)]) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["fw_n4096_s64_32x16_pods2.json", "fw_n8192_s128_16x16.json",
                     "fw_n8192_s128_32x16_pods2.json"]
    rec = json.loads((tmp_path / "fw_n8192_s128_16x16.json").read_text())
    assert rec == json.loads(json.dumps(fw_dryrun.run(8192, 128, grid=(16, 16))))
    assert "bottleneck=memory" in capsys.readouterr().out


# ------------------------------------------------- fw_dist_check's options
def test_dist_check_engine_on_cpu_ranks(capsys):
    """``--method engine``: the grid engine's ragged ``solve_many`` == the
    single-device fused solve of each graph, in f32 and int16, with no
    runner built twice."""
    assert chk.main(["--devices", "4", "--n", "64", "--bs", "16", "--method", "engine",
                     "--device", "cpu"]) == 0
    assert chk.main(["--devices", "4", "--n", "64", "--bs", "16", "--method", "engine",
                     "--dtype", "int16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "OK engine devices=4 grid=2x2" in out and "sizes=[64, 32, 64]" in out
    assert "semiring=min_plus_i16 dtype=int16" in out


@pytest.mark.parametrize("semiring", ["min_plus", "plus_mul"])
def test_dist_check_repair_del_on_cpu_ranks(semiring, capsys):
    """``--repair-del``: the grid engine's repair_del == the single-device
    one == a re-solve (plus_mul: its fallback == the grid's re-solve)."""
    assert chk.main(["--devices", "4", "--n", "64", "--bs", "16", "--repair-del",
                     "--semiring", semiring, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"OK repair_del devices=4 grid=2x2 n=64 bs=16 semiring={semiring}" in out
    with pytest.raises(SystemExit):
        chk.main(["--devices", "4", "--repair-del", "--dtype", "int16", "--device", "cpu"])


def test_dist_check_pods_pick_the_grid(capsys):
    """``--pods``: the grid of ``plan.mesh_factorization(devices, pods)``,
    the reference's; two ranks over two pods are a 2×1 grid, not 1×2."""
    assert tplan.mesh_factorization(2, 2) == jplan.mesh_factorization(2, 2) == (2, 1)
    assert chk.main(["--devices", "2", "--pods", "2", "--n", "64", "--bs", "16", "--bitwise",
                     "--device", "cpu"]) == 0
    assert "grid=2x1" in capsys.readouterr().out


# ----------------------------------------------------------------- examples
@pytest.mark.parametrize("example", ["quickstart_torch.py", "distributed_fw_torch.py"])
def test_example_runs_on_the_cpu(example):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, str(ROOT / "examples" / example), "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "✓" in run.stdout
