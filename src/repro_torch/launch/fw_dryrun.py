"""Dry run and roofline of the distributed blocked FW on the H100.

    python -m repro_torch.launch.fw_dryrun --n 65536 --mesh both

Counterpart of ``repro.launch.fw_dryrun``.  One JSON record per (n, s,
grid, pods) under ``--out`` (default ``experiments/fw_dryrun_torch``),
computed from the port's plan models with nothing compiled or run:

    rounds                 plan.distributed_plan (n padded to the grid)
    flops a rank           2 · n_r · n_c · n_padded: a relaxation is two
                           fp32 operations (an add and a min), PERF.md §2
    HBM bytes a rank       rounds × plan.staged_hbm_bytes_per_round on the
                           rank's block, with the card's 128 × 128 relax tiles
    collective bytes       rounds × plan.dist_round_comm_bytes
    SUMMA bound            plan.summa_comm_bound_bytes of the padded n
    terms                  launch.roofline on the H100 datasheet figures, the
                           compute term at fp32's 67 TFLOP/s (min-plus cannot
                           use the tensor cores); useful ops 2·n³
    memory a rank          the bordered block, its two band buffers and the
                           round's transfer buffers (the input matrix, the
                           caller's, is not counted), against 80 GB

``--mesh single`` is the reference's one-pod 16 × 16 grid, ``multi`` its
two pods (32 × 16, pods 2).  The figures are derived from the datasheet,
not measured.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.apsp import plan
from repro_torch.launch import roofline as rl

MESHES = {"single": [((16, 16), 1)], "multi": [((32, 16), 2)],
          "both": [((16, 16), 1), ((32, 16), 2)]}
OPS_PER_RELAXATION = 2  # f32 min-plus: an add and a min
WORD = 4                # f32


def run(n: int, block_size: int = 128, *, grid: tuple[int, int] = (16, 16),
        pods: int = 1) -> dict:
    """The dry-run record of an n-vertex f32 min-plus solve on an R×C grid
    of H100s."""
    R, C = grid
    dp = plan.distributed_plan(n, R * C, grid=grid, block_size=block_size, pods=pods,
                               word=WORD)
    s, m, rounds = dp["block_size"], dp["n_padded"], dp["rounds"]
    n_r, n_c = dp["tile"]
    rows, cols = dp["bordered"]
    flops = OPS_PER_RELAXATION * n_r * n_c * m
    byts = rounds * plan.staged_hbm_bytes_per_round(n_r, n_c, s, bm=128, bn=128, word=WORD)
    coll = rounds * dp["comm_bytes_per_round"]
    terms = rl.RooflineTerms(flops=flops, bytes_hbm=byts, coll_bytes=coll, chips=R * C,
                             model_flops=OPS_PER_RELAXATION * float(n) ** 3,
                             peak_flops=rl.PEAK_FLOPS_F32)
    memory = rows * cols * WORD + dp["band_bytes"] + dp["comm_bytes_per_round"]
    bound = dp["summa_bound_bytes"]
    return {
        "workload": "distributed_fw",
        "n": n,
        "n_padded": m,
        "block_size": s,
        "backend": "fused",
        "dtype": "float32",
        "R": R,
        "C": C,
        "pods": pods,
        "mesh": f"{R}x{C}",
        "rounds": rounds,
        "tile": [n_r, n_c],
        "bordered": [rows, cols],
        **terms.to_dict(),
        "useful_ops": terms.model_flops,
        "summa_comm_bound_bytes": bound,
        "comm_efficiency": bound / coll if coll else 0.0,
        "memory_bytes_per_chip": memory,
        "fits_h100_80gb": memory < rl.HBM_BYTES,
        "source": "plan models and H100 datasheet figures; derived, not measured",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--mesh", default="both", choices=sorted(MESHES))
    ap.add_argument("--out", default="experiments/fw_dryrun_torch")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for grid, pods in MESHES[args.mesh]:
        rec = run(args.n, args.block_size, grid=grid, pods=pods)
        tag = (f"fw_n{args.n}_s{rec['block_size']}_{rec['mesh']}"
               f"{f'_pods{pods}' if pods > 1 else ''}")
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[ok] {tag} bottleneck={rec['bottleneck']} "
              f"frac={rec['roofline_fraction']:.3f} "
              f"t=(c {rec['t_compute_s']:.4f}s, m {rec['t_memory_s']:.4f}s, "
              f"x {rec['t_collective_s']:.4f}s) comm_eff={rec['comm_efficiency']:.2f} "
              f"memory={rec['memory_bytes_per_chip']} B")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
