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
from repro_torch.kernels.flash_decode import LAUNCHES, flash_decode
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
