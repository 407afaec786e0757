"""MoE block on one device — the farm skeleton with a learned load balancer.

Port of ``src/repro/models/moe.py`` (``moe_defs``, ``moe_block``) for one
device: the reference's ``tp_body`` with no collective.  The router logits
are a plain fp32 product; the routing itself — softmax, top-K,
renormalised weights and the first-come capacity positions that
``_route`` + ``_dispatch_local`` compute — is the hand-written
``router_topk`` kernel (``kernels/router_topk.py``).  Around it, plain
torch: the scatter into the (E, C, d) expert lanes, the expert GLU as
batched products, the weighted combine, and — when a caller asks for them
— the switch load-balance and router z aux losses from the probabilities.
Nothing on the path reads the card's values back to the host.

On one device ``moe_mode="ep"`` (Kimi-K2: experts sharded over the model
axis) computes what ``"tp"`` (Mixtral) computes: in the reference the two
modes differ only in the ``lax.all_to_all`` hops and the ``psum`` over the
model axis, which are the identity on one device, so one code path serves
both.  Inside a ``shard_map`` (the data-parallel train step) every rank
routes its own tokens with its own lane capacity, as the reference's
shard bodies do, and the aux losses are pmeaned over the manual axes.
Over a plan's model axis the two modes are the reference's two shard
bodies: ``tp`` (Mixtral) gathers the tokens over the sequence, routes all
of them on every rank and runs its block of each expert's FFN, its bf16
partials reduce-scattered back; ``ep`` (Kimi-K2) routes each rank's own
tokens and moves the expert lanes to the experts' ranks and back with two
``all_to_all`` hops.  The shared expert is a Megatron MLP over ``tp``.
The expert and shared-expert gates round as the reference's
``jax.nn.silu`` does in bf16 (``silu_stepwise``): with ``F.silu``'s one
rounding, a top-8 layer's output differed from the reference's by a bf16
step in several elements a token, and the reduced Kimi-K2 at E32 top-8
drifted past the model tolerance on a decode step.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import spmd
from ..core.device import expert_capacity
from ..core.plan import model_plan
from ..kernels.router_topk import router_topk
from .layers import gathered, mm
from .params import ParamDef
from .ssm import silu_stepwise


def moe_defs(cfg, layers: Optional[int] = None):
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    E, dff = cfg.n_experts, cfg.moe_d_ff
    ex_ax = "expert" if cfg.moe_mode == "ep" else None
    ff_ax = None if cfg.moe_mode == "ep" else "tp"
    d = {
        "router": ParamDef(lead + (cfg.d_model, E), la + ("fsdp", None),
                           dtype=torch.float32),
        "wi": ParamDef(lead + (E, cfg.d_model, dff), la + (ex_ax, "fsdp", ff_ax)),
        "wg": ParamDef(lead + (E, cfg.d_model, dff), la + (ex_ax, "fsdp", ff_ax)),
        "wo": ParamDef(lead + (E, dff, cfg.d_model), la + (ex_ax, ff_ax, "fsdp")),
    }
    if cfg.n_shared_experts:
        sff = cfg.moe_d_ff * cfg.n_shared_experts
        d["shared"] = {
            "wi": ParamDef(lead + (cfg.d_model, sff), la + ("fsdp", "tp")),
            "wg": ParamDef(lead + (cfg.d_model, sff), la + ("fsdp", "tp")),
            "wo": ParamDef(lead + (sff, cfg.d_model), la + ("tp", "fsdp")),
        }
    return d


def _aux_losses(logits: torch.Tensor, idx: torch.Tensor) -> dict:
    """Switch-style load-balance loss and router z-loss (``moe._route``)."""
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(0)
    flat = idx.reshape(-1).long()
    ce = logits.new_zeros(E).index_add_(0, flat, logits.new_ones(flat.shape))
    ce = ce / max(idx.numel(), 1)
    return {"moe_lb": E * torch.sum(me * ce),
            "moe_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}


def _route(x2: torch.Tensor, router: torch.Tensor, cfg, losses: bool):
    """Route the tokens ``x2`` (T, d) and scatter them into the (E, C, d)
    expert lanes (C from T, as the reference sizes each shard's lanes by
    its own tokens); returns the lanes, each (token, k) entry's slot, keep
    and weight, and the aux losses (``{}`` unless ``losses``), pmeaned
    over the manual axes (the reference pmeans its shards' over the model
    and batch axes)."""
    T, d = x2.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = x2.float() @ router.float()
    C = expert_capacity(T, E, K, cfg.capacity_factor)
    w, idx, pos, keep = router_topk(logits, K, C)
    aux = _aux_losses(logits, idx) if losses else {}
    if aux and spmd.manual_axes():
        axes = tuple(sorted(spmd.manual_axes()))
        aux = {k: spmd.pmean(v, axes) for k, v in aux.items()}
    # dispatch: each kept (token, k) entry to its lane slot; dropped entries
    # all land in one overflow row that is cut off.  The buffer is
    # (E*C + 1, d): at Kimi-K2's E 384 top-8 and a 5000-token prompt,
    # C 131, 0.72 GB of bf16
    slot = torch.where(keep, idx * C + pos, E * C).reshape(T * K).long()
    buf = x2.new_zeros(E * C + 1, d)
    buf.index_copy_(0, slot, x2.repeat_interleave(K, dim=0))
    return buf[:-1].reshape(E, C, d), slot, keep, w, aux


def _glu(h: torch.Tensor, wi, wg, wo) -> torch.Tensor:
    """The experts' GLU as batched products: h (E, C, d) -> (E, C, d)."""
    return mm(mm(h, wi) * silu_stepwise(mm(h, wg)), wo)


def _combine(y: torch.Tensor, slot, keep, w, T: int) -> torch.Tensor:
    """Each (token, k) entry's expert output, zero for the dropped ones,
    weighted and summed over k in fp32: (T, d)."""
    E, C, d = y.shape
    K = keep.shape[1]
    yflat = torch.cat([y.reshape(E * C, d), y.new_zeros(1, d)])
    got = yflat[slot].reshape(T, K, d) * keep[..., None]
    return torch.einsum("tkd,tk->td", got.float(), w.float())


def moe_block(x: torch.Tensor, p, cfg, losses: bool = True, plan=None,
              sp: bool = False):
    """x: (B, S, d). Returns (out (B, S, d), aux losses); the losses are
    ``{}`` unless ``losses`` (serving reads none).  With a plan whose model
    axis is manual, ``x`` is this rank's block of the residual
    (sequence-sharded when ``sp``) and the output its block of the update:
    :func:`_tp_body` (Mixtral) or :func:`_ep_body` (Kimi-K2)."""
    tp = model_plan(plan)
    p = _gathered(p, cfg, plan)
    if tp is not None:
        body = _ep_body if cfg.moe_mode == "ep" else _tp_body
        out, aux = body(x, p, cfg, losses, tp, sp)
        if cfg.n_shared_experts:
            xg = tp.seq_gather(x, sp)
            sh = p["shared"]
            o = mm(mm(xg, sh["wi"]) * silu_stepwise(mm(xg, sh["wg"])),
                   sh["wo"]).to(torch.bfloat16)
            out = out + tp.compose(o, sp, moe_defs(cfg)["shared"]["wo"])
        return out, aux
    B, S, d = x.shape
    T = B * S
    h, slot, keep, w, aux = _route(x.reshape(T, d), p["router"], cfg, losses)
    y = _glu(h, p["wi"], p["wg"], p["wo"])                    # (E, C, d)
    out = _combine(y, slot, keep, w, T).reshape(B, S, d).to(x.dtype)

    if cfg.n_shared_experts:
        sp_ = p["shared"]
        a = mm(x, sp_["wi"])
        g = silu_stepwise(mm(x, sp_["wg"]))
        out = out + mm(a * g, sp_["wo"]).to(torch.bfloat16)
    return out, aux


def _gathered(p, cfg, plan):
    """The block's weights whole over the data axes (``gather_fsdp`` at
    the block's entry, with the reference's axes: the router, the
    experts' bf16 weights before its ``shard_map``, the shared expert)."""
    if plan is None:
        return p
    defs = moe_defs(cfg)
    out = {n: gathered(plan, p[n], defs[n].axes)
           for n in ("router", "wi", "wg", "wo")}
    if cfg.n_shared_experts:
        out["shared"] = {n: gathered(plan, w, defs["shared"][n].axes)
                         for n, w in p["shared"].items()}
    return out


def _tp_body(x, p, cfg, losses, tp, sp):
    """``moe_mode="tp"``: the tokens gathered over the sequence, every
    rank routing the same B*S of them (``router_topk`` on each), the
    experts' FFN over this rank's block of ``moe_d_ff``, the combine of
    the bf16 partials reduce-scattered back to the sequence block (summed
    when the sequence is not sharded)."""
    xg = tp.seq_gather(x, sp)
    B, S, d = xg.shape
    h, slot, keep, w, aux = _route(xg.reshape(B * S, d), p["router"], cfg,
                                   losses)
    y = _glu(h, p["wi"], p["wg"], p["wo"])          # partial over the ff
    out = _combine(y, slot, keep, w, B * S).reshape(B, S, d).to(x.dtype)
    return tp.compose(out, sp, moe_defs(cfg)["wo"]), aux


def _ep_body(x, p, cfg, losses, tp, sp):
    """``moe_mode="ep"``: this rank routes its own tokens (its sequence
    block, or the whole sequence when that is not sharded) with lanes
    sized by them, the lanes go to the experts' ranks over the model axis
    (``all_to_all``, split 0, concat 1: the (E/tp, C*tp, d) block), the
    local experts run, and the outputs come back (split 1, concat 0) to be
    combined."""
    m = tp.model_axis()
    if cfg.n_experts % tp.mesh.shape[m]:
        raise NotImplementedError(
            f"expert parallelism needs the {cfg.n_experts} experts to divide"
            f" over the model axis of {tp.mesh.shape[m]}")
    B, S, d = x.shape
    h, slot, keep, w, aux = _route(x.reshape(B * S, d), p["router"], cfg,
                                   losses)
    h = spmd.all_to_all(h, m, 0, 1)                 # (E/tp, C*tp, d)
    y = _glu(h, p["wi"], p["wg"], p["wo"])
    y = spmd.all_to_all(y, m, 1, 0)                 # (E, C, d)
    out = _combine(y, slot, keep, w, B * S)
    return out.reshape(B, S, d).to(x.dtype), aux
