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
from ..kernels.router_topk import router_topk
from .layers import mm
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


def moe_block(x: torch.Tensor, p, cfg, losses: bool = True):
    """x: (B, S, d). Returns (out (B, S, d), aux losses); the losses are
    ``{}`` unless ``losses`` (serving reads none)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    x2 = x.reshape(T, d)
    logits = x2.float() @ p["router"].float()
    C = expert_capacity(T, E, K, cfg.capacity_factor)
    w, idx, pos, keep = router_topk(logits, K, C)
    aux = _aux_losses(logits, idx) if losses else {}
    if aux and spmd.manual_axes():
        # each rank routed its own block of the batch: the aux losses are
        # the mean over the ranks, as the reference pmeans its shards'
        axes = tuple(sorted(spmd.manual_axes()))
        aux = {k: spmd.pmean(v, axes) for k, v in aux.items()}

    # dispatch: each kept (token, k) entry to its lane slot; dropped entries
    # all land in one overflow row that is cut off.  The buffer is
    # (E*C + 1, d): at Kimi-K2's E 384 top-8 and a 5000-token prompt,
    # C 131, 0.72 GB of bf16
    slot = torch.where(keep, idx * C + pos, E * C).reshape(T * K).long()
    buf = x2.new_zeros(E * C + 1, d)
    buf.index_copy_(0, slot, x2.repeat_interleave(K, dim=0))
    h = buf[:-1].reshape(E, C, d)
    a = mm(h, p["wi"])
    g = silu_stepwise(mm(h, p["wg"]))
    y = mm(a * g, p["wo"])                                    # (E, C, d)

    # combine: gather each entry's expert output, zero the dropped ones,
    # weight and sum over k in fp32
    yflat = torch.cat([y.reshape(E * C, d), y.new_zeros(1, d)])
    got = yflat[slot].reshape(T, K, d) * keep[..., None]
    out = torch.einsum("tkd,tk->td", got.float(), w.float())
    out = out.reshape(B, S, d).to(x.dtype)

    if cfg.n_shared_experts:
        sp = p["shared"]
        a = mm(x, sp["wi"])
        g = silu_stepwise(mm(x, sp["wg"]))
        out = out + mm(a * g, sp["wo"]).to(torch.bfloat16)
    return out, aux
