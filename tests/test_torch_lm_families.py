"""The port's LM path vs the JAX reference, on the CPU, for the
architectures with MLA and MoE layers: deepseek-v2-lite (MLA without
q_lora, shared experts) and kimi-k2 (MLA with q_lora, top-3 in its smoke
config).  ``tests/test_torch_lm_ssm.py`` runs the same tests on the two
with SSM layers, mamba2 and jamba.

Each test runs the body of its namesake in ``tests/test_torch_lm_model.py``
on these configs, with its tolerances: the reference's ``init_params(key
0)`` crossed by ``lm_params_from_numpy``; ``forward_train`` logits and aux
loss, ``prefill`` logits and every cache entry (``c_kv``, ``k_pe``,
``conv``, ``ssm``, ``k``, ``v``), six teacher-forced decode steps and the
caches after them, greedy ``Engine.generate`` ids, all against the
reference compiled without XLA's excess precision at rtol 2e-2 and two
bf16 ulps of the largest |value|, and against the default compile at
``DEFAULT_ULPS`` (a route that flipped between the reference's own two
compiles aside: ``test_torch_lm_model.assert_near_default``).  The
families stand in two files so that the suite's workers (one file each)
share the load; each file parametrizes ``arch`` with its ``ARCHS``.
"""
import os
import pathlib
import subprocess
import sys

import pytest

import test_torch_lm_model as lm

ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b"]


def pytest_generate_tests(metafunc):
    if "arch" in metafunc.fixturenames:
        metafunc.parametrize("arch", ARCHS)


def test_count_params_matches_reference(arch):
    lm.test_count_params_matches_reference(arch)


def test_forward_train_matches_reference(arch):
    lm.test_forward_train_matches_reference(arch)


def test_prefill_logits_and_caches_match_reference(arch):
    lm.test_prefill_logits_and_caches_match_reference(arch)


def test_teacher_forced_decode_matches_reference(arch):
    lm.test_teacher_forced_decode_matches_reference(arch)


def test_greedy_generate_matches_reference(arch):
    lm.test_greedy_generate_matches_reference(arch)


@pytest.mark.parametrize("part", ["forward", "prefill", "decode"])
def test_matches_default_compiled_reference(part, arch):
    lm.test_matches_default_compiled_reference(part, arch)


def test_forward_shapes_no_nans(arch):
    lm.test_forward_shapes_no_nans(arch)


def test_prefill_decode_consistency(arch):
    lm.test_prefill_decode_consistency(arch)


def test_engine_generates_deterministically(arch):
    lm.test_engine_generates_deterministically(arch)


def test_init_params_draws_the_reference_scales(arch):
    """Every parameter of ``init_params`` has the reference's name, shape
    and dtype and is drawn at its scale, f32 leaves included: the router's
    normal draw, ``D`` ones, ``A_log`` = log U(1, 16) and ``dt_bias`` the
    inverse softplus of dt in [0.001, 0.1) (their ranges checked)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model as tm

    cfg = get_smoke_config(arch)
    ref = lm.reference(arch)["tree"]
    model = tm.init_params(cfg, seed=3, device="cpu")
    period = len(cfg.layer_pattern)
    for name, p in model.named_parameters():
        path = name.split(".")
        if path[0] == "layers":
            path = ["periods", f"l{int(path[1]) % period}", *path[2:]]
        leaf = ref
        for key in path:
            leaf = leaf[key]
        want = np.asarray(leaf if path[0] != "periods" else leaf[0])
        assert tuple(p.shape) == want.shape and str(p.dtype).endswith(str(want.dtype)), name
        if path[-1] == "A_log":
            assert bool(((p >= 0) & (p <= np.log(16.0))).all()), name
        elif path[-1] == "dt_bias":
            dt = torch.nn.functional.softplus(p)
            assert bool(((dt >= 0.001 * 0.999) & (dt <= 0.1 * 1.001)).all()), name
        elif want.size > 1000:  # a normal draw: the same scale
            assert abs(float(p.float().std()) / float(want.astype(np.float32).std()) - 1) < 0.1
        elif path[-1] in ("scale", "D", "conv_b"):
            assert torch.equal(p.float(), torch.from_numpy(want.astype(np.float32))), name


def test_serve_lm_example_serves_the_architecture(arch):
    """``examples/serve_lm_torch.py --arch`` serves the smoke config on the
    CPU, greedy decode repeating."""
    root = pathlib.Path(__file__).resolve().parents[1]
    run = subprocess.run(
        [sys.executable, str(root / "examples" / "serve_lm_torch.py"), "--device", "cpu",
         "--arch", arch],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root / "src")), capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert f"{arch}-smoke:" in run.stdout and "greedy decode deterministic ✓" in run.stdout
