"""Mamba-2 (SSD, state-space duality) block: chunked scan formulation.

Counterpart of ``repro.models.ssm``.  Prefill uses the SSD block
decomposition [arXiv:2405.21060 §6]: a within-chunk quadratic
(attention-like) term plus an inter-chunk state recurrence, a Python loop
over chunks of ``chunk_size`` that keeps one chunk's (B, L, L, H) f32
tensors live at a time (the reference's ``lax.scan``).  A sequence that
is not a multiple of the chunk runs as one chunk, as in the reference.
Decode is the O(1)-state recurrence, and writes its state into the cache
in place.

Numerics, cast for cast as the reference: projections bf16; the prefill's
causal depthwise conv a sum of bf16 products, each product and each add
rounded to bf16 (not ``F.conv1d``, which sums in f32); the decode's conv
one f32-accumulated dot over the window, rounded once; SSD math in f32;
softplus as ``jax.nn.softplus``, ``logaddexp(x, 0)``.

State for decode: ``conv`` (B, d_conv-1, conv_dim) in the cache dtype and
``ssm`` (B, H, N, P) f32, constant in sequence length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, norm_shapes, rms_norm


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, SSD heads, conv channels)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nheads = di // s.head_dim
    conv_dim = di + 2 * s.n_groups * s.d_state
    return di, nheads, conv_dim


def mamba_shapes(cfg: ModelConfig) -> dict:
    """The spec of an SSD block's parameters (``layers.Params``), with the
    reference's ``init_mamba`` scales and draws; ``A_log``, ``D`` and
    ``dt_bias`` are f32."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh, conv_dim = _dims(cfg)
    gn = s.n_groups * s.d_state
    sc = d ** -0.5
    return {
        "norm": norm_shapes(cfg, d),
        "wz": ((d, di), sc),
        "wx": ((d, di), sc),
        "wb": ((d, gn), sc),
        "wc": ((d, gn), sc),
        "wdt": ((d, nh), sc),
        "conv_w": ((s.d_conv, conv_dim), s.d_conv ** -0.5),
        "conv_b": ((conv_dim,), "zeros"),
        "A_log": ((nh,), "a_log", torch.float32),
        "D": ((nh,), "ones", torch.float32),
        "dt_bias": ((nh,), "dt_bias", torch.float32),
        "out_norm": norm_shapes(cfg, di),
        "out_proj": ((di, d), di ** -0.5),
    }


def init_mamba(cfg: ModelConfig, *, device="cuda") -> Params:
    """An SSD block's parameters on ``device``, not yet drawn."""
    return Params(mamba_shapes(cfg), device)


def _conv_full(u: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Causal depthwise conv over (B, S, conv_dim); returns same shape."""
    s = cfg.ssm
    pad = F.pad(u, (0, 0, s.d_conv - 1, 0))
    out = sum(pad[:, i:i + u.shape[1], :] * p["conv_w"][i][None, None, :]
              for i in range(s.d_conv))
    return F.silu((out + p["conv_b"]).float()).to(u.dtype)


def _expand_groups(t: torch.Tensor, nh: int, ng: int) -> torch.Tensor:
    """(B, ..., G, N) → (B, ..., H, N) by repeating each group H/G times."""
    return torch.repeat_interleave(t, nh // ng, dim=-2)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + eˣ) as ``logaddexp(x, 0)``, without
    ``F.softplus``'s linear branch above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _chunk_scan(da, x, b_g, c_g, dt, state, cfg: ModelConfig):
    """The SSD chunk loop: da / dt (B, S, H) f32, x (B, S, H, P), b_g / c_g
    (B, S, G, N), state (B, H, N, P) f32 → (y (B, S, H, P) f32, state)."""
    s = cfg.ssm
    bsz, sl, nh, _ = x.shape
    l = min(s.chunk_size, sl)
    if sl % l:
        l = sl  # fall back to one chunk for odd shapes
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    ys = []
    for c0 in range(0, sl, l):
        da_c, dt_c = da[:, c0:c0 + l], dt[:, c0:c0 + l]
        x_c = x[:, c0:c0 + l].float()
        b_c = _expand_groups(b_g[:, c0:c0 + l], nh, s.n_groups).float()
        c_c = _expand_groups(c_g[:, c0:c0 + l], nh, s.n_groups).float()
        cum = torch.cumsum(da_c, dim=1)  # (B,L,H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B,L,L,H) i−j
        lfac = torch.where(mask[None, :, :, None], torch.exp(seg), 0.0)
        scores = torch.einsum("bihn,bjhn->bijh", c_c, b_c) * lfac * dt_c[:, None, :, :]
        y_c = torch.einsum("bijh,bjhp->bihp", scores, x_c)
        # Off-diagonal: contribution of the state entering this chunk.
        y_c = y_c + torch.einsum("bihn,bhnp->bihp", c_c * torch.exp(cum)[..., None], state)
        # State update for the next chunk.
        decay_last = torch.exp(cum[:, -1:, :] - cum)  # (B,L,H)
        upd = torch.einsum("bjhn,bjhp->bhnp", b_c * (dt_c * decay_last)[..., None], x_c)
        state = torch.exp(cum[:, -1])[:, :, None, None] * state + upd
        ys.append(y_c)
    return torch.cat(ys, dim=1), state


def mamba_block(
    x: torch.Tensor,
    p,
    cfg: ModelConfig,
    state: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Returns (residual_delta, new_state).

    state=None → training (no state I/O).  state given with S == 1 → a
    decode step, which writes the new ``conv`` / ``ssm`` into ``state``'s
    tensors in place and returns them; otherwise a prefill, starting from
    ``state["ssm"]``, which returns new tensors of the final state.
    """
    s = cfg.ssm
    di, nh, conv_dim = _dims(cfg)
    b, sl, _ = x.shape
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    z, xin = h @ p["wz"], h @ p["wx"]
    bb, cc, dt = h @ p["wb"], h @ p["wc"], h @ p["wdt"]

    decode = state is not None and sl == 1
    conv_in = torch.cat([xin, bb, cc], dim=-1)
    if decode:
        # Roll the conv window: state holds the previous d_conv-1 inputs.
        win = torch.cat([state["conv"], conv_in], dim=1)  # (B, d_conv, C)
        u = torch.einsum("bwc,wc->bc", win.float(), p["conv_w"].float()).to(
            torch.promote_types(win.dtype, p["conv_w"].dtype))
        u = F.silu((u + p["conv_b"]).float()).to(conv_in.dtype)[:, None, :]
        new_conv = win[:, 1:]
    else:
        u = _conv_full(conv_in, p, cfg)
        new_conv = conv_in[:, max(sl - (s.d_conv - 1), 0):]
        if sl < s.d_conv - 1:  # left-pad tiny prefills
            new_conv = F.pad(new_conv, (0, 0, s.d_conv - 1 - sl, 0))

    gn = s.n_groups * s.d_state
    xin_c, bb_c, cc_c = torch.split(u, [di, gn, gn], dim=-1)
    xh = xin_c.reshape(b, sl, nh, s.head_dim)
    b_g = bb_c.reshape(b, sl, s.n_groups, s.d_state)
    c_g = cc_c.reshape(b, sl, s.n_groups, s.d_state)

    dt = _softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    a = -torch.exp(p["A_log"])  # (H,)
    da = dt * a  # (B,S,H)

    ssm_prev = (
        state["ssm"].float()
        if state is not None
        else torch.zeros((b, nh, s.d_state, s.head_dim), dtype=torch.float32, device=x.device)
    )

    if decode:
        b_h = _expand_groups(b_g, nh, s.n_groups).float()
        c_h = _expand_groups(c_g, nh, s.n_groups).float()
        xf = xh.float()
        decay = torch.exp(da[:, 0])  # (B,H)
        upd = torch.einsum("bhn,bhp->bhnp", b_h[:, 0], xf[:, 0] * dt[:, 0, :, None])
        ssm = decay[:, :, None, None] * ssm_prev + upd
        y = torch.einsum("bhn,bhnp->bhp", c_h[:, 0], ssm)[:, None]
        y = y + p["D"][None, None, :, None] * xf
    else:
        y, ssm = _chunk_scan(da, xh, b_g, c_g, dt, ssm_prev, cfg)
        y = y + p["D"][None, None, :, None] * xh.float()

    y = y.reshape(b, sl, di).to(x.dtype)
    gate = F.silu(z.float()).to(x.dtype)
    y = rms_norm(y * gate, p["out_norm"]["scale"], cfg.norm_eps)
    out = y @ p["out_proj"]

    if state is None:
        return out, None
    if decode:
        state["conv"].copy_(new_conv)
        state["ssm"].copy_(ssm)
        return out, {"conv": state["conv"], "ssm": state["ssm"]}
    # A copy of the conv window: a view would keep the whole (B, S, C) input.
    return out, {"conv": new_conv.to(state["conv"].dtype).contiguous(),
                 "ssm": ssm.to(state["ssm"].dtype)}


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
                     device="cuda") -> dict:
    """A zero decode state: ``conv`` (B, d_conv-1, conv_dim) bf16, ``ssm``
    (B, H, N, P) of ``dtype``."""
    s = cfg.ssm
    di, nh, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=torch.bfloat16,
                            device=device),
        "ssm": torch.zeros((batch, nh, s.d_state, s.head_dim), dtype=dtype, device=device),
    }
