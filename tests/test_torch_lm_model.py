"""The port's LM path (``repro_torch.models.model`` and ``serve.lm.Engine``) vs
the JAX reference, on the CPU, for the six attention-family architectures
(the four with MoE, MLA or SSM layers run the same bodies in
``tests/test_torch_lm_families.py`` and ``tests/test_torch_lm_ssm.py``).

For each smoke config the reference's ``init_params(key 0)`` crosses into a
port ``Model`` through ``utils.interop.lm_params_from_numpy``; then
``forward_train`` logits and aux loss, ``prefill`` logits and caches, six
teacher-forced ``decode_step``s and the caches after them, and greedy
``Engine.generate`` ids are held to the reference's on the same seeded
batch.  The reference's steps are compiled
without XLA's excess precision (``exact``), so that each bf16 op rounds as
its code says; the port mirrors those casts.  Tolerance: rtol 2e-2 with an
atol of two bf16 ulps of the largest |value|
(``chip_smoke.py:decode_tolerance``): the two sides round f32-accumulated
products to bf16, and a sum the two libraries order differently, or an f32
gelu / variance one ulp apart, can round one bf16 ulp apart.  Greedy ids
must agree at every step where the reference's top-2 margin exceeds that
atol, up to the first step where a near-tie went the other way (after it
the two continue different texts).

The reference as XLA compiles it by default keeps some fused bf16 chains
in f32 and rounds once, so its logits sit further from the port's: up to
3.99 ulps of the largest |logit| beyond the rtol (llama-3.2-vision, decode
step 2, whose largest logit 0.4908 lies just under 0.5 and so halves the
ulp).  ``forward_train``, ``prefill`` and the decode steps are held to that
reference too, at six ulps (``DEFAULT_ULPS``): the measured 3.99 with the
margin the card tests keep (four ulps over a measured 2.46).

A router's top-k is discontinuous: where two routes nearly tie, the two
compiles of the reference itself can route a token to different experts
(deepseek-v2-lite smoke, row 1 token 7: its logits 48 bf16 ulps apart),
and attention and SSM state carry the change to later tokens (jamba
smoke: up to 18 ulps).  The port rounds as the exact compile does, so for
a config with MoE layers an element where the reference's two compiles
disagree by more than ``DEFAULT_ULPS`` is held no farther from the
default compile than the exact compile is, plus the two-ulp rule
(``assert_near_default``); every other element at ``DEFAULT_ULPS``.

Also: ``count_params`` (total and active) of the full configs equals the
reference's exactly, and the port's versions of
``tests/test_models_smoke.py`` (shapes, no NaN, prefill + decode == the
full forward) and ``tests/test_substrate.py:133`` (``Engine``
determinism).
"""
import dataclasses
import functools
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_full_config
from repro.configs.base import get_smoke_config as ref_config
from repro.models import model as jm
from repro.serve.lm import Engine as JEngine
from repro_torch.configs.base import get_config, get_smoke_config, list_archs
from repro_torch.models import model as tm
from repro_torch.serve.lm import Engine
from repro_torch.utils.interop import host_tensor, lm_params_from_numpy

ARCHS = ["qwen1.5-0.5b", "qwen2-7b", "qwen2-72b", "minicpm-2b", "llama-3.2-vision-11b",
         "whisper-small"]
FAMILIES = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "mamba2-780m", "jamba-v0.1-52b"]
# Parameters of the full configs (the reference's counts).
FULL_PARAMS = {"qwen2-7b": 7_615_616_512, "deepseek-v2-lite-16b": 16_210_324_992,
               "kimi-k2-1t-a32b": 1_042_970_074_112, "mamba2-780m": 857_846_016,
               "jamba-v0.1-52b": 51_485_722_112}
ACTIVE_PARAMS = {"deepseek-v2-lite-16b": 2_660_040_192}
B, S, STEPS, NEW = 2, 16, 6, 8
DEFAULT_ULPS = 6  # against the reference as XLA compiles it by default


def tolerance(want: np.ndarray, ulps: int = 2) -> tuple[float, float]:
    """rtol 2e-2 and ``ulps`` bf16 ulps of the largest |want|."""
    top = float(np.abs(want).max())
    return 2e-2, (ulps * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0)


def assert_matches(got: torch.Tensor, want, ulps: int = 2) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    rtol, atol = tolerance(want.astype(np.float32), ulps)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=rtol,
                               atol=atol)


def assert_near_default(got: torch.Tensor, want, exact_want, cfg) -> None:
    """got within ``DEFAULT_ULPS`` of the default-compiled reference
    ``want``; for a config with MoE layers, where the reference's exact
    compile ``exact_want`` lies farther from ``want`` than that, no farther
    from ``want`` than the exact compile is, plus the two-ulp rule (a
    route that flipped between the reference's two compiles)."""
    want, exact_want = np.asarray(want), np.asarray(exact_want)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    got, want = got.float().numpy(), want.astype(np.float32)
    rtol, atol = tolerance(want, DEFAULT_ULPS)
    limit = atol + rtol * np.abs(want)
    if cfg.moe is not None:
        own = np.abs(exact_want.astype(np.float32) - want) + tolerance(want)[1]
        limit = np.maximum(limit, own + rtol * np.abs(want))
    excess = np.abs(got - want) - limit
    assert (excess <= 0).all(), f"max excess {excess.max()} over the limit"


def batch_for(cfg, seq: int, seed: int = 0) -> dict:
    """tokens (B, seq) [+ image_embeds | frames, bf16] as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, seq), dtype=np.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = np.asarray(jnp.asarray(
            rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model)) * 0.02, jnp.bfloat16))
    if cfg.encoder is not None:
        out["frames"] = np.asarray(jnp.asarray(
            rng.standard_normal((B, cfg.encoder.n_frames, cfg.d_model)) * 0.02, jnp.bfloat16))
    return out


def prompt(batch: dict, seq: int) -> dict:
    return dict(batch, tokens=batch["tokens"][:, :seq])


def layer_caches(ref_caches, cfg) -> list[dict]:
    """The reference's stacked caches as one dict a layer, in layer order."""
    period = len(cfg.layer_pattern)
    return [{name: np.asarray(a)[j // period]
             for name, a in ref_caches[f"l{j % period}"].items()}
            for j in range(cfg.n_layers)]


def exact(fn, *args):
    """fn (jitted) compiled for args without XLA's excess precision: by
    default XLA may keep a fused chain of bf16 ops in f32 and round once
    (``xla_allow_excess_precision``), where the reference's code rounds
    each op to bf16, as the port does."""
    return fn.lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})


def as_compiled_by_default(fn, *args):
    """fn (jitted) as it runs: compiled with XLA's default options."""
    return fn


@functools.lru_cache(maxsize=None)
def reference(arch: str, xla_default: bool = False) -> dict:
    """The reference's weights, batch and results for one smoke config,
    each op rounded as written (``exact``), or with ``xla_default`` as XLA
    compiles it by default."""
    compiled = as_compiled_by_default if xla_default else exact
    cfg = ref_config(arch)
    params = jm.init_params(cfg, jax.random.key(0))
    batch = batch_for(cfg, S + NEW)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    eng = JEngine(cfg, params, temperature=0.0)
    forward = jax.jit(lambda p, b: jm.forward_train(cfg, p, b))
    logits, aux = compiled(forward, params, jb)(params, jb)
    pre_fn = compiled(eng._prefill, params, prompt(jb, S))
    pre_logits, caches = pre_fn(params, prompt(jb, S))
    pre = (np.asarray(pre_logits), layer_caches(caches, cfg))
    caches = eng._extend_caches(caches, NEW)
    token, pos = jb["tokens"][:, S], jnp.int32(S)
    decode_fn = compiled(eng._decode, params, token, pos, caches)
    steps = []
    for t in range(STEPS):
        step_logits, caches = decode_fn(params, jb["tokens"][:, S + t], jnp.int32(S + t),
                                        caches)
        steps.append(np.asarray(step_logits))
    decoded = layer_caches(caches, cfg)
    # Engine.generate's loop (greedy) on the same compiled steps, keeping
    # the logits behind each id.
    step_logits, caches = pre_fn(params, prompt(jb, S))
    caches = eng._extend_caches(caches, NEW)
    gen_logits, ids = [], []
    for i in range(NEW):
        if i:
            step_logits, caches = decode_fn(params, ids[-1], jnp.int32(S + i - 1), caches)
        gen_logits.append(np.asarray(step_logits))
        ids.append(eng._sample(step_logits))
    return dict(tree=jax.tree.map(np.asarray, params), batch=batch,
                forward=np.asarray(logits), aux=float(aux), prefill=pre, steps=steps,
                decoded=decoded,
                ids=np.stack([np.asarray(t) for t in ids], axis=1), gen_logits=gen_logits)


def port_model(arch: str) -> tm.Model:
    return lm_params_from_numpy(get_smoke_config(arch), reference(arch)["tree"], device="cpu")


# ------------------------------------------------------------------ counts
@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_reference(arch):
    """Total and active (routed experts scaled by top_k / n_experts) counts
    of the full and smoke configs equal the reference's."""
    cfg, jcfg = get_config(arch), ref_full_config(arch)
    assert tm.count_params(cfg) == jm.count_params(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert tm.count_params(cfg, active_only=True) == jm.count_params(jcfg, active_only=True)
    scfg, jscfg = get_smoke_config(arch), ref_config(arch)
    assert tm.count_params(scfg) == jm.count_params(jscfg)
    assert tm.count_params(scfg, active_only=True) == jm.count_params(jscfg, active_only=True)
    if arch in FULL_PARAMS:
        assert tm.count_params(cfg) == FULL_PARAMS[arch]
    if arch in ACTIVE_PARAMS:
        assert tm.count_params(cfg, active_only=True) == ACTIVE_PARAMS[arch]


def test_every_architecture_has_the_reference_config():
    """The ten architecture modules are copied as data: every field of
    every full and smoke config equals the reference's."""
    from repro.configs.base import list_archs as ref_archs

    assert list_archs() == ref_archs() == sorted(ARCHS + FAMILIES)
    for arch in list_archs():
        for port_cfg, ref_cfg in ((get_config(arch), ref_full_config(arch)),
                                  (get_smoke_config(arch), ref_config(arch))):
            assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg), arch


# -------------------------------------------------------- held to the reference
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    ref = reference(arch)
    logits, aux = tm.forward_train(get_smoke_config(arch), port_model(arch), ref["batch"])
    assert_matches(logits, ref["forward"])
    assert aux.dtype == torch.float32
    assert float(aux) == pytest.approx(ref["aux"], rel=1e-5, abs=0.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_reference(arch):
    ref = reference(arch)
    cfg = get_smoke_config(arch)
    logits, caches = tm.prefill(cfg, port_model(arch), prompt(ref["batch"], S))
    want_logits, want_caches = ref["prefill"]
    assert_matches(logits, want_logits)
    assert [sorted(c) for c in caches] == [sorted(c) for c in want_caches]
    for got, want in zip(caches, want_caches):
        for name in got:
            assert_matches(got[name], want[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference(arch):
    """Six decode steps on the batch's own next tokens, each writing only
    its own row of a sequence cache and moving an SSD block's state (in
    place), then every cache entry against the reference's."""
    ref = reference(arch)
    cfg, model = get_smoke_config(arch), port_model(arch)
    tokens = torch.from_numpy(ref["batch"]["tokens"])
    _, caches = tm.prefill(cfg, model, prompt(ref["batch"], S))
    caches = Engine(cfg, model)._extend_caches(caches, NEW)
    for t in range(STEPS):
        before = [{n: x.clone() for n, x in c.items()} for c in caches]
        logits, caches = tm.decode_step(cfg, model, tokens[:, S + t], S + t, caches)
        assert_matches(logits, ref["steps"][t])
        for c, old in zip(caches, before):
            for name, x in c.items():
                if name in ("conv", "ssm"):
                    assert not torch.equal(x, old[name]), (t, name)
                    continue
                keep = [r for r in range(x.shape[1]) if name in ("ck", "cv") or r != S + t]
                assert torch.equal(x[:, keep], old[name][:, keep]), (t, name)
    for got, want in zip(caches, ref["decoded"], strict=True):
        assert sorted(got) == sorted(want)
        for name in got:
            assert_matches(got[name], want[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    ref = reference(arch)
    cfg = get_smoke_config(arch)
    ids = Engine(cfg, port_model(arch)).generate(prompt(ref["batch"], S), max_new_tokens=NEW)
    assert ids.shape == (B, NEW) and ids.dtype == np.int32
    for b in range(B):
        for t in range(NEW):
            logits = ref["gen_logits"][t][b, : cfg.vocab_size]
            top2 = np.sort(logits)[-2:]
            margin = float(top2[1] - top2[0])
            if margin > tolerance(ref["gen_logits"][t])[1]:
                assert ids[b, t] == ref["ids"][b, t], (b, t, margin)
            elif ids[b, t] != ref["ids"][b, t]:
                break  # a near-tie went the other way: the texts part here


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("part", ["forward", "prefill", "decode"])
def test_matches_default_compiled_reference(part, arch):
    """``forward_train`` logits, ``prefill`` logits and caches and six
    teacher-forced decode steps against the reference as XLA compiles it
    by default, at ``DEFAULT_ULPS`` (``assert_near_default``); the weights
    are the same (the compile does not change ``init_params``)."""
    ref, ex = reference(arch, xla_default=True), reference(arch)
    cfg, model = get_smoke_config(arch), port_model(arch)
    if part == "forward":
        logits, aux = tm.forward_train(cfg, model, ref["batch"])
        assert_near_default(logits, ref["forward"], ex["forward"], cfg)
        # A flipped route moves the aux loss's counts as well.
        own = abs(ex["aux"] - ref["aux"]) + 1e-5 * abs(ex["aux"]) if cfg.moe else 0.0
        assert abs(float(aux) - ref["aux"]) <= max(1e-5 * abs(ref["aux"]), own)
        return
    logits, caches = tm.prefill(cfg, model, prompt(ref["batch"], S))
    if part == "prefill":
        (want_logits, want_caches), (ex_logits, ex_caches) = ref["prefill"], ex["prefill"]
        assert_near_default(logits, want_logits, ex_logits, cfg)
        for got, want, exw in zip(caches, want_caches, ex_caches, strict=True):
            for name in want:
                assert_near_default(got[name], want[name], exw[name], cfg)
        return
    tokens = torch.from_numpy(ref["batch"]["tokens"])
    caches = Engine(cfg, model)._extend_caches(caches, NEW)
    for t in range(STEPS):
        logits, caches = tm.decode_step(cfg, model, tokens[:, S + t], S + t, caches)
        assert_near_default(logits, ref["steps"][t], ex["steps"][t], cfg)


# ----------------------------------- tests/test_models_smoke.py, test_substrate.py
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_no_nans(arch):
    cfg = get_smoke_config(arch)
    model = tm.init_params(cfg, seed=0, device="cpu")
    logits, aux = tm.forward_train(cfg, model, batch_for(cfg, 32))
    assert logits.shape == (B, 32, cfg.vocab_padded)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all()), "NaN/inf in logits"
    assert bool(torch.isfinite(aux))
    if cfg.moe is not None and cfg.moe.aux_loss_coef > 0:
        assert float(aux) > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Decode after prefill reproduces the teacher-forced full forward (the
    reference's tolerances: 0.08, and 0.25 with MLA, whose absorbed decode
    reassociates the bf16 products)."""
    cfg = get_smoke_config(arch)
    model = tm.init_params(cfg, seed=2, device="cpu")
    batch = batch_for(cfg, 16, seed=2)
    tokens = torch.from_numpy(batch["tokens"])
    full, _ = tm.forward_train(cfg, model, batch)
    _, caches = tm.prefill(cfg, model, prompt(batch, 8))
    caches = Engine(cfg, model)._extend_caches(caches, 8)
    tol = 0.25 if cfg.mla is not None else 0.08
    for t in range(8, 16):
        logits, caches = tm.decode_step(cfg, model, tokens[:, t], t, caches)
        torch.testing.assert_close(logits, full[:, t], rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generates_deterministically(arch):
    cfg = get_smoke_config(arch)
    eng = Engine(cfg, tm.init_params(cfg, seed=0, device="cpu"), temperature=0.0)
    batch = prompt(batch_for(cfg, 8), 8)
    out = eng.generate(batch, max_new_tokens=6)
    assert out.shape == (B, 6)
    assert (out >= 0).all() and (out < cfg.vocab_size).all()
    np.testing.assert_array_equal(out, eng.generate(batch, max_new_tokens=6))


def test_sampling_follows_the_engines_seed():
    """Temperature sampling draws from the engine's own seeded generator:
    the same seed gives the same ids, the ids stay within the real
    vocabulary, and another seed gives others."""
    cfg = get_smoke_config("qwen2-7b")
    model = tm.init_params(cfg, seed=0, device="cpu")
    batch = prompt(batch_for(cfg, 8), 8)
    runs = [Engine(cfg, model, temperature=0.8, seed=s).generate(batch, max_new_tokens=12)
            for s in (1, 1, 2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert all(((r >= 0) & (r < cfg.vocab_size)).all() for r in runs)


# ------------------------------------------------------------------ weights
def test_init_params_draws_the_reference_scales():
    """Every parameter of ``init_params`` has the reference's name, shape
    and dtype (layer j of the port = repetition j // period of slot j %
    period), and is drawn at the reference's scale; a seed repeats."""
    arch = "llama-3.2-vision-11b"
    cfg = get_smoke_config(arch)
    ref = reference(arch)["tree"]
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
        if want.size > 1000:  # a normal draw: the same scale
            assert abs(float(p.float().std()) / float(want.astype(np.float32).std()) - 1) < 0.1
        elif path[-1] in ("scale", "bq", "bk", "bv", "gate"):
            assert torch.equal(p.float(), torch.from_numpy(want.astype(np.float32))), name
    again = tm.init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_lm_params_from_numpy_refuses_a_tree_that_does_not_fit():
    arch = "qwen2-7b"
    cfg = get_smoke_config(arch)
    tree = reference(arch)["tree"]
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    assert torch.equal(model.layers[1].mixer.wq,
                       host_tensor(tree["periods"]["l0"]["mixer"]["wq"][1]))
    extra = dict(tree, stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="stray"):
        lm_params_from_numpy(cfg, extra, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["embed"] = tree["embed"][:, :8]
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_numpy(cfg, bad, device="cpu")


def test_serve_lm_example_runs_on_the_cpu():
    root = pathlib.Path(__file__).resolve().parents[1]
    run = subprocess.run(
        [sys.executable, str(root / "examples" / "serve_lm_torch.py"), "--device", "cpu"],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root / "src")), capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "greedy decode deterministic ✓" in run.stdout
