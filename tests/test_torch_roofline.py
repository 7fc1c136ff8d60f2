"""The port's roofline (``repro_torch.launch.roofline``) and model-FLOPs
decomposition (``repro_torch.models.model``) vs the reference's.

The port's versions of ``tests/test_roofline.py:40-83``: trip-count
extrapolation, the terms' bottleneck and fraction on the H100 datasheet
figures, ``flops_param_groups`` / ``model_flops`` equal to the reference's
values exactly (the MoE configs counting their active parameters), and
Kimi K2's active FLOPs.  The reference's HLO-parser tests (``:24-38``)
have no counterpart: the port compiles no HLO.
"""
import pytest

from repro.configs.base import get_config as ref_config
from repro.models import model as jm
from repro_torch.configs.base import get_config
from repro_torch.launch import roofline as rl
from repro_torch.models.model import flops_param_groups, model_flops

ARCHS = ["qwen1.5-0.5b", "qwen2-7b", "qwen2-72b", "minicpm-2b", "llama-3.2-vision-11b",
         "whisper-small", "deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "mamba2-780m",
         "jamba-v0.1-52b"]


def test_h100_datasheet_figures():
    assert rl.PEAK_FLOPS_BF16 == 989.4e12
    assert rl.PEAK_FLOPS_F32 == 67e12
    assert rl.HBM_BW == 3.35e12
    assert rl.NVLINK_BW == 450e9
    assert rl.HBM_BYTES == 80e9


def test_extrapolate_linearity():
    # F(1)=10 (fixed 4 + body 6), F(2)=16 → F(5) = 4 + 5·6 = 34
    assert rl.extrapolate(10.0, 16.0, 5) == 34.0
    assert rl.extrapolate(10.0, 16.0, 1) == 10.0


def test_roofline_terms_bottleneck_and_fraction():
    t = rl.RooflineTerms(
        flops=rl.PEAK_FLOPS_BF16,       # 1 s compute
        bytes_hbm=rl.HBM_BW * 2,        # 2 s memory  ← dominant
        coll_bytes=rl.NVLINK_BW * 0.5,
        chips=4,
        model_flops=rl.PEAK_FLOPS_BF16 * 4,  # = counted flops (useful=1)
    )
    assert t.bottleneck == "memory"
    assert t.t_memory == pytest.approx(2.0)
    assert t.t_collective == pytest.approx(0.5)
    assert t.useful_ratio == pytest.approx(1.0)
    # perfect-useful flops but memory-bound at 2 s → frac = 0.5
    assert t.roofline_fraction == pytest.approx(0.5)
    d = t.to_dict()
    assert d["bottleneck"] == "memory" and d["t_compute_s"] == pytest.approx(1.0)


def test_roofline_terms_at_the_fp32_rate():
    """Min-plus runs outside the tensor cores: its compute term is at
    fp32's 67 TFLOP/s."""
    t = rl.RooflineTerms(flops=rl.PEAK_FLOPS_F32 * 3, bytes_hbm=rl.HBM_BW, coll_bytes=0.0,
                         chips=1, model_flops=rl.PEAK_FLOPS_F32 * 3,
                         peak_flops=rl.PEAK_FLOPS_F32)
    assert t.bottleneck == "compute"
    assert t.t_compute == pytest.approx(3.0)
    assert t.roofline_fraction == pytest.approx(1.0)


def test_flops_param_groups_decomposition():
    cfg = get_config("whisper-small")
    g = flops_param_groups(cfg)
    assert g["head"] == cfg.d_model * cfg.vocab_padded
    assert g["enc"] > 0  # whisper has an encoder stack
    assert g["body"] > g["enc"] > 0
    assert g == jm.flops_param_groups(ref_config("whisper-small"))


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_param_groups_equal_reference(arch):
    assert flops_param_groups(get_config(arch)) == jm.flops_param_groups(ref_config(arch))


def test_model_flops_kinds_ordering():
    cfg = get_config("qwen1.5-0.5b")
    train = model_flops(cfg, kind="train", global_batch=8, seq_len=128)
    prefill = model_flops(cfg, kind="prefill", global_batch=8, seq_len=128)
    decode = model_flops(cfg, kind="decode", global_batch=8, seq_len=128)
    assert train > 2.9 * prefill  # 6N·D vs 2N·D (head positions differ)
    # full sequence vs one token (head flops equal: last-position only)
    assert prefill > 50 * decode


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equal_reference(arch, kind):
    got = model_flops(get_config(arch), kind=kind, global_batch=8, seq_len=512)
    assert got == jm.model_flops(ref_config(arch), kind=kind, global_batch=8, seq_len=512)


def test_moe_active_flops_scale():
    cfg = get_config("kimi-k2-1t-a32b")
    dense_equiv = model_flops(cfg, kind="prefill", global_batch=1, seq_len=1024)
    # active ≈ 32B params → 2·32e9·1024 ≈ 6.6e13, far below total-param flops
    assert 4e13 < dense_equiv < 9e13
    assert dense_equiv == jm.model_flops(ref_config("kimi-k2-1t-a32b"), kind="prefill",
                                         global_batch=1, seq_len=1024)


def test_qwen2_7b_serving_bounds():
    """The bounds ``chip_smoke.py:phase_lm_serve`` prints beside its
    Qwen2-7B figures: the prefill of 8 × 512 tokens at the bf16 peak, a
    decode step's weights at the HBM rate."""
    cfg = get_config("qwen2-7b")
    flops = model_flops(cfg, kind="prefill", global_batch=8, seq_len=512)
    assert flops == pytest.approx(5.347e13, rel=1e-3)
    assert flops / rl.PEAK_FLOPS_BF16 * 1e3 == pytest.approx(54.0, rel=1e-2)
    assert 2 * cfg.param_count() / rl.HBM_BW * 1e3 == pytest.approx(4.55, rel=1e-2)
