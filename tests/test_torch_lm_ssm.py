"""The tests of ``tests/test_torch_lm_families.py`` on the architectures
with SSM layers: mamba2 (SSD blocks only) and jamba (SSD blocks, one
attention layer, MoE and dense FFNs), against the JAX reference on the
CPU with the same tolerances."""
from test_torch_lm_families import (  # noqa: F401
    test_count_params_matches_reference,
    test_forward_train_matches_reference,
    test_prefill_logits_and_caches_match_reference,
    test_teacher_forced_decode_matches_reference,
    test_greedy_generate_matches_reference,
    test_matches_default_compiled_reference,
    test_forward_shapes_no_nans,
    test_prefill_decode_consistency,
    test_engine_generates_deterministically,
    test_init_params_draws_the_reference_scales,
    test_serve_lm_example_serves_the_architecture,
)

ARCHS = ["mamba2-780m", "jamba-v0.1-52b"]


def pytest_generate_tests(metafunc):
    if "arch" in metafunc.fixturenames:
        metafunc.parametrize("arch", ARCHS)
