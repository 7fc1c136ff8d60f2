"""The port's flash_decode vs the JAX reference, on the CPU.

``repro_torch.kernels.flash_decode.flash_decode`` on CPU tensors walks the
plain online softmax (``kernels.ref.flash_decode_online_ref``, bs-row
blocks as the reference's ``_decode_kernel`` walks them).  The same numpy
inputs (made from a seed) go through ``repro.kernels.ref.flash_decode_ref``
and the reference's Pallas kernel in interpret mode.  Tolerances are the
reference's own (``tests/test_flash_decode.py``): rtol = atol = 2e-5 in
f32, 2e-2 in bf16; the masked tail and the block size move nothing beyond
1e-6.  The CUDA kernel is held against the same plain walk on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apsp  # noqa: F401  (imported before repro.kernels: circular import)
from repro.kernels.flash_decode import flash_decode as jflash_decode
from repro.kernels.ref import flash_decode_ref as jflash_decode_ref
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_decode import LAUNCHES, flash_decode, split_plan
from repro_torch.utils.interop import host_tensor, to_numpy


def mk(b, s, hkv, g, hd, seed=0, dtype=jnp.float32):
    """numpy q, k, v (ml_dtypes bfloat16 for bf16) from a seed."""
    rng = np.random.default_rng(seed)
    return tuple(np.asarray(jnp.asarray(rng.standard_normal(shape), dtype))
                 for shape in ((b, hkv, g, hd), (b, s, hkv, hd), (b, s, hkv, hd)))


def port(q, k, v, kv_len, **kw) -> np.ndarray:
    out = flash_decode(*(host_tensor(x) for x in (q, k, v)), kv_len, **kw)
    return to_numpy(out)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,hkv,g,hd", [
    (2, 512, 2, 4, 64), (1, 1024, 4, 1, 128), (2, 256, 1, 8, 64), (1, 768, 4, 7, 128),
])
def test_flash_decode_full_cache(b, s, hkv, g, hd):
    q, k, v = mk(b, s, hkv, g, hd, seed=s)
    got = port(q, k, v, s, bs=128)
    assert got.shape == q.shape and got.dtype == np.float32
    close(got, jflash_decode_ref(q, k, v, jnp.int32(s)), 2e-5)
    close(got, jflash_decode(q, k, v, jnp.int32(s), bs=128, interpret=True), 2e-5)


@pytest.mark.parametrize("kv_len", [1, 100, 255, 256, 300, 511])
def test_flash_decode_masking(kv_len):
    """Positions at or past kv_len do not move the result."""
    q, k, v = mk(1, 512, 2, 2, 64, seed=kv_len)
    got = port(q, k, v, kv_len, bs=128)
    close(got, jflash_decode_ref(q, k, v, jnp.int32(kv_len)), 2e-5)
    close(got, jflash_decode(q, k, v, jnp.int32(kv_len), bs=128, interpret=True), 2e-5)
    k2, v2 = k.copy(), v.copy()
    k2[:, kv_len:] = 99.0
    v2[:, kv_len:] = -99.0
    close(port(q, k2, v2, kv_len, bs=128), got, 1e-6)


def test_flash_decode_block_size_invariance():
    q, k, v = mk(1, 512, 2, 2, 64, seed=7)
    outs = [port(q, k, v, 300, bs=bs) for bs in (64, 128, 256, 512)]
    for o in outs[1:]:
        close(o, outs[0], 1e-6)
    close(port(q, k, v, 300, bs=384), outs[0], 1e-6)  # 512 % 384 != 0: bs becomes S


def test_flash_decode_bf16():
    q, k, v = mk(1, 256, 2, 2, 64, seed=9, dtype=jnp.bfloat16)
    got = port(q, k, v, 256, bs=128)
    assert got.dtype == q.dtype  # ml_dtypes bfloat16, carried by bit view
    close(got, jflash_decode_ref(q, k, v, jnp.int32(256)), 2e-2)
    close(got, jflash_decode(q, k, v, jnp.int32(256), bs=128, interpret=True), 2e-2)


def test_flash_decode_kv_len_zero_averages_v():
    """Every position masked with -1e30 (not -inf): uniform weights, the
    mean of v, as the reference gives — no NaN."""
    q, k, v = mk(2, 256, 2, 3, 64, seed=11)
    got = port(q, k, v, 0, bs=64)
    assert np.isfinite(got).all()
    close(got, jflash_decode_ref(q, k, v, jnp.int32(0)), 2e-5)
    close(got, np.broadcast_to(v.mean(axis=1)[:, :, None, :], got.shape), 2e-5)


def test_flash_decode_plain_versions_agree_and_kv_len_may_be_a_tensor():
    q, k, v = mk(2, 512, 2, 4, 64, seed=13)
    tq, tk, tv = (host_tensor(x) for x in (q, k, v))
    kl = torch.tensor(300)
    before = LAUNCHES["flash_decode"]
    online = flash_decode(tq, tk, tv, kl, bs=64)
    assert LAUNCHES["flash_decode"] == before  # the CPU walk launches nothing
    masked = tref.flash_decode_ref(tq, tk, tv, kl)
    torch.testing.assert_close(online, masked, rtol=2e-5, atol=2e-5)
    close(to_numpy(masked), jflash_decode_ref(q, k, v, jnp.int32(300)), 2e-5)


def test_flash_decode_refuses_mismatched_inputs():
    q, k, v = (host_tensor(x) for x in mk(1, 64, 2, 2, 64))
    with pytest.raises(ValueError):
        flash_decode(q, k[:, :, :1], v, 10)
    with pytest.raises(TypeError):
        flash_decode(q.double(), k, v, 10)


# ------------------------------------------- the bf16 kernel's arithmetic
def emulate_bf16_kernel(q, k, v, kv_len: int) -> torch.Tensor:
    """Plain torch of ``csrc/flash_decode.cu``'s bf16 arithmetic: the
    splits of ``split_plan``, each CTA's 4 warps taking 16-row tiles in
    turn; f32 logits from bf16 q and k; a per-tile online softmax (f32 m,
    l); P rounded to bf16 before it meets V (the MMA's A operand), the
    products summed in f32; the warps merged, then the splits."""
    B, Hkv, g, hd = q.shape
    S = k.shape[1]
    warps, rows = 4, 16
    chunk, nsplit = split_plan(B, Hkv, S)
    L = min(kv_len, S) if kv_len >= 1 else S
    qf, scale = q.float(), hd ** -0.5
    parts = []
    for sp in range(nsplit):
        r0, r1 = sp * chunk, min(sp * chunk + chunk, L)
        merged = []
        for w in range(warps):
            m = torch.full((B, Hkv, g), NEG, dtype=torch.float32)
            l = torch.zeros((B, Hkv, g))
            acc = torch.zeros((B, Hkv, g, hd))
            for row0 in range(r0 + w * rows, r1, warps * rows):
                idx = torch.arange(row0, row0 + rows)
                ok = idx < r1
                kt = torch.zeros((B, rows, Hkv, hd), dtype=k.dtype)
                vt = torch.zeros_like(kt)
                kt[:, ok] = k[:, idx[ok]]
                vt[:, ok] = v[:, idx[ok]]
                s = torch.einsum("bhgd,bshd->bhgs", qf, kt.float())
                x = torch.where(idx < kv_len, s * scale, NEG)
                m_new = torch.maximum(m, torch.where(ok, x, NEG).amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(ok, torch.exp(x - m_new[..., None]), 0.0)
                l = l * alpha + p.sum(-1)
                m = m_new
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhgs,bshd->bhgd", p.bfloat16().float(), vt.float())
            merged.append((m, l, acc))
        parts.append(_merge(merged))
    m, l, acc = _merge(parts)
    return (acc / l[..., None]).to(q.dtype)


NEG = -1e30


def _merge(parts):
    """(m, l, acc) of several partials, weighted by exp(m_i - max m)."""
    M = torch.stack([p[0] for p in parts]).amax(0)
    wgt = [torch.exp(p[0] - M) for p in parts]
    return (M, sum(p[1] * w_ for p, w_ in zip(parts, wgt)),
            sum(p[2] * w_[..., None] for p, w_ in zip(parts, wgt)))


def _decode_case(kind: str, seed: int = 21):
    """B 1, Hkv 2, g 7, hd 128, S 4096 in bf16: uniform logits (q = 0),
    one row's logit ~20 above the rest (q = e0, k = 0 but that row's k0 =
    226, bf16-exact), or random."""
    q, k, v = mk(1, 4096, 2, 7, 128, seed=seed, dtype=jnp.bfloat16)
    if kind == "uniform":
        q = np.zeros_like(q)
    elif kind == "peak":
        q, k = np.zeros_like(q), np.zeros_like(k)
        q[..., 0] = 1.0
        k[:, 1234, :, 0] = 226.0  # logit 226 / sqrt(128) = 19.98
    return q, k, v


@pytest.mark.parametrize("kind,kv_len", [("uniform", 4096), ("peak", 4096), ("random", 0),
                                         ("random", 1), ("random", 4095)])
def test_bf16_kernel_arithmetic_fits_the_limit(kind, kv_len):
    """The bf16 kernel's rounding (P in bf16 before V, f32 sums, split
    merges) stays within ``_decode_tolerance`` of the reference's kernel
    in interpret mode and of the plain masked softmax."""
    from test_torch_kernels_cuda import _decode_tolerance

    q, k, v = _decode_case(kind)
    got = emulate_bf16_kernel(*(host_tensor(x) for x in (q, k, v)), kv_len)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    want = tref.flash_decode_ref(*(host_tensor(x) for x in (q, k, v)), kv_len)
    rtol, atol = _decode_tolerance(torch.bfloat16, want)
    assert rtol == 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    for ref_out in (jflash_decode(q, k, v, jnp.int32(kv_len), bs=256, interpret=True),
                    jflash_decode_ref(q, k, v, jnp.int32(kv_len))):
        np.testing.assert_allclose(to_numpy(got).astype(np.float32),
                                   np.asarray(ref_out, np.float32), rtol=rtol, atol=atol)
