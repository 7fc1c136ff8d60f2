"""Mixture-of-Experts FFN: top-k routing, capacity-dropping dispatch,
optional shared experts (DeepSeek / Kimi style).

Counterpart of ``repro.models.moe``.  Dispatch is sort-based (stable
argsort → within-expert rank → scatter into a (B, E, C, D) buffer), never a
(T, E, C) one-hot product.  Capacity is per batch row, C = max(int(S·k/E ·
capacity_factor + 0.999), k), copied literally from the reference (it is
not ``ceil``); assignments past it are dropped and the residual carries
their tokens unchanged.  Capacity depends on the call's sequence length,
so a prefill and the decode steps after it can drop different tokens; the
smoke configs set capacity_factor 8 (dropless).

Numerics, cast for cast as the reference: routing in f32 (router f32,
softmax, top-k with ties to the lower expert index, gates renormalised
with + 1e-9); the dispatch buffer, the expert SwiGLU (silu in f32, then
cast) and the weighting of the combine in bf16, the k weighted slots of a
token summed in f32 and rounded once to bf16 (as XLA reduces a bf16 sum);
the load-balance aux loss in f32.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, apply_norm, norm_shapes


def moe_shapes(cfg: ModelConfig) -> dict:
    """The spec of a MoE FFN's parameters (``layers.Params``), with the
    reference's ``init_moe`` scales; the router is f32."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    sc = d ** -0.5
    spec = {
        "norm": norm_shapes(cfg, d),
        "router": ((d, e), sc, torch.float32),
        "w1": ((e, d, f), sc),
        "w3": ((e, d, f), sc),
        "w2": ((e, f, d), f ** -0.5),
    }
    if m.n_shared:
        fs = f * m.n_shared
        spec["ws1"] = ((d, fs), sc)
        spec["ws3"] = ((d, fs), sc)
        spec["ws2"] = ((fs, d), fs ** -0.5)
    return spec


def init_moe(cfg: ModelConfig, *, device="cuda") -> Params:
    """A MoE FFN's parameters on ``device``, not yet drawn."""
    return Params(moe_shapes(cfg), device)


def capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per expert and batch row for a call of ``s`` tokens a row."""
    m = cfg.moe
    return max(int(s * m.top_k / m.n_experts * m.capacity_factor + 0.999), m.top_k)


def _counts(e_flat: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(e_flat, minlength=n)`` (int64) without a host sync."""
    counts = torch.zeros(n, dtype=torch.int64, device=e_flat.device)
    return counts.scatter_add_(0, e_flat.long(), torch.ones_like(e_flat, dtype=torch.int64))


def _positions_in_expert(e_flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Within-expert arrival rank for each assignment, via stable sort.

    e_flat (T,) int expert ids → pos (T,) int32: the j-th assignment routed
    to expert e gets pos j (order-preserving within expert)."""
    t = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    counts = _counts(e_flat, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(t, device=e_flat.device) - starts[e_flat[order].long()]
    return torch.zeros(t, dtype=torch.int32, device=e_flat.device).scatter_(
        0, order, ranks.to(torch.int32))


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, ties broken
    towards the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class _Watches(threading.local):
    """This thread's open ``routes`` blocks, innermost last: (log, replay)."""

    def __init__(self):
        self.open: list = []


_WATCHES = _Watches()


@contextlib.contextmanager
def routes(replay: list | None = None):
    """Watch the MoE layers' routing inside the block: yields a list that
    gets one dict a ``route`` call, in call order: ``e`` the experts the
    call chose (B, S·k), ``probs`` (B, S, E) f32, ``keep`` its assignments
    that capacity kept (B, S·k).  Given ``replay`` (such a
    list from the same calls on another device), each call routes to
    ``replay``'s experts instead, its own probabilities as their gates, and
    its dict also holds those ``forced`` experts.

    A router's top-k is discontinuous: two devices whose activations
    differ by rounding can route a near-tied token to different experts,
    and the outputs then differ by far more than rounding.  Replaying one
    run's routes on the other holds the rest of the arithmetic to rounding
    (``replay_gap`` measures how near the ties were)."""
    log: list = []
    _WATCHES.open.append((log, replay))
    try:
        yield log
    finally:
        _WATCHES.open.pop()


def replay_gap(log: list) -> tuple[int, int, float]:
    """Over a replayed ``routes`` log: (tokens whose forced experts are not
    their own top-k set, tokens, the largest relative shortfall of such a
    token's forced probability mass below its own top-k's)."""
    moved = total = 0
    worst = 0.0
    for entry in log:
        probs = entry["probs"]
        b, s, _ = probs.shape
        own = torch.gather(probs, -1, entry["e"].reshape(b, s, -1).to(probs.device)).sum(-1)
        forced = torch.gather(probs, -1, entry["forced"].reshape(b, s, -1).to(probs.device))
        forced = forced.sum(-1)
        differ = (torch.sort(entry["e"].reshape(b, s, -1), -1).values
                  != torch.sort(entry["forced"].reshape(b, s, -1).to(probs.device), -1).values
                  ).any(-1)
        moved += int(differ.sum())
        total += b * s
        if bool(differ.any()):
            worst = max(worst, float(((own - forced) / own)[differ].max()))
    return moved, total, worst


def route(h: torch.Tensor, p, cfg: ModelConfig) -> dict:
    """Routing of the normed input h (B, S, D): f32 ``probs`` (B, S, E),
    the flat assignments of each row (``e`` expert, ``gate``, ``pos`` its
    slot, ``keep`` = pos < ``cap``; (B, S·k) each), ``cap``."""
    m = cfg.moe
    b, s, _ = h.shape
    e, k = m.n_experts, m.top_k
    logits = torch.einsum("bsd,de->bse", h.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, k)
    entry = None
    if _WATCHES.open:
        log, replay = _WATCHES.open[-1]
        entry = {"e": idx.reshape(b, s * k), "probs": probs}
        if replay is not None:
            idx = replay[len(log)]["e"].reshape(b, s, k).to(idx.device)
            gates = torch.gather(probs, -1, idx)
            entry["forced"] = idx.reshape(b, s * k)
        log.append(entry)
    if m.normalize_gates:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    e_flat = idx.reshape(b, s * k)
    # Each row's ranks at once: expert ids offset by row·E sort the rows
    # apart, and within a row a stable sort keeps the row's own order.
    rows = torch.arange(b, device=h.device)[:, None]
    pos = _positions_in_expert((e_flat + rows * e).reshape(-1), b * e).reshape(b, s * k)
    cap = capacity(cfg, s)
    out = dict(probs=probs, e=e_flat, gate=gates.reshape(b, s * k), pos=pos, keep=pos < cap,
               cap=cap)
    if entry is not None:
        entry["keep"] = out["keep"]
    return out


def _swiglu(h, w1, w3, w2, spec: str):
    """``silu(h·w1) * (h·w3) · w2`` in h's dtype, silu in f32."""
    a = torch.einsum(spec[0], h, w1)
    g = torch.einsum(spec[0], h, w3)
    hid = F.silu(a.float()).to(h.dtype) * g
    return torch.einsum(spec[1], hid, w2)


def moe_ffn(x: torch.Tensor, p, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (ffn_out, aux_load_balance_loss)."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    t = s * k

    h = apply_norm(x, p["norm"], cfg)
    r = route(h, p, cfg)
    cap, keep = r["cap"], r["keep"]
    rows = torch.arange(b, device=x.device)[:, None].expand(b, t)
    tok_of = torch.arange(t, device=x.device) // k  # assignment → source token

    # --- dispatch: (B, E, C, D) buffer; a dropped assignment (its source
    # zeroed) goes to the spare slot C, cut off after the scatter.
    src = h[:, tok_of] * keep[..., None].to(h.dtype)  # (B, T, D)
    slot = torch.where(keep, r["pos"], cap).long()
    buf = torch.zeros((b, e, cap + 1, d), dtype=h.dtype, device=x.device)
    buf.index_put_((rows, r["e"], slot), src, accumulate=True)
    buf = buf[:, :, :cap]

    # --- expert SwiGLU over the buffer
    out_buf = _swiglu(buf, p["w1"], p["w3"], p["w2"], ("becd,edf->becf", "becf,efd->becd"))

    # --- combine: gather each assignment's slot, weight, sum its k slots
    vals = out_buf[rows, r["e"], torch.clamp(r["pos"], max=cap - 1).long()]  # (B, T, D)
    vals = (vals * (keep * r["gate"])[..., None].to(vals.dtype)).reshape(b, s, k, d)
    # XLA reduces a bf16 array in f32 and rounds once, its code's
    # ``.sum(axis=1)`` compiled without excess precision included.
    y = vals.float().sum(dim=2).to(x.dtype)

    # --- shared experts (dense branch, always on)
    if m.n_shared:
        y = y + _swiglu(h, p["ws1"], p["ws3"], p["ws2"], ("bsd,df->bsf", "bsf,fd->bsd"))

    # --- Switch-style load-balance aux loss
    f_e = _counts((r["e"] + rows[:, :1] * e).reshape(-1), b * e).reshape(b, e).float()
    f_e = f_e.mean(0) / t  # fraction of assignments per expert
    p_e = r["probs"].mean((0, 1))
    aux = e * torch.sum(f_e * p_e)
    return y, aux * m.aux_loss_coef
