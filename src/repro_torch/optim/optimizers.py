"""Optimizers: AdamW (fp32 moments) and Adafactor (factored second moment).

Port of ``src/repro/optim/optimizers.py`` (``clip_by_global_norm``,
``AdamW``, ``Adafactor``, ``make_optimizer``) on one device.  An optimizer
keeps the reference's interface, ``init(params) -> state`` and
``update(grads, state, params, lr) -> (params, state)``, and its arithmetic
step by step in the same order and types, so both packages round alike.
Where the reference returns new trees (its train step donates the old
state), ``update`` writes the new parameters and moments into the given
tensors in place, under ``torch.no_grad()``, and returns them.  The
``state_axes`` of the reference's optimizers map state onto a mesh and come
with the multi-device slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.tree import jax_leaves, tree_leaves, tree_map


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` to a global L2 norm of at most ``max_norm``; returns
    (clipped grads in their own types, the fp32 norm before clipping).  The
    squares are summed leaf by leaf in the reference's leaf order."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in jax_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _apply(p: torch.Tensor, step: torch.Tensor, lr) -> None:
    """p <- (p.f32 - lr * step) in p's type; ``step`` is consumed."""
    step.mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(step)
    else:
        p.copy_(p.float().sub_(step))


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The sum over the count, as ``jnp.mean`` divides (``torch.mean``
    multiplies by the reciprocal)."""
    if dim is None:
        return x.sum() / x.numel()
    return x.sum(dim, keepdim=keepdim) / x.shape[dim]


@dataclasses.dataclass
class Optimizer:
    init: Callable
    update: Callable          # (grads, state, params, lr) -> (params, state)


# ---------------------------------------------------------------------------
def AdamW(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        count = torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": count}

    @torch.no_grad()
    def update(grads, state, params, lr):
        c = state["count"] + 1
        cf = c.float()
        b1c = 1 - b1 ** cf
        b2c = 1 - b2 ** cf

        def upd(p, g, m, v):
            g = g.float()
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * (1 - b2) * g)
            step = (m / b1c).div_((v / b2c).sqrt_().add_(eps))
            if p.dim() >= 2:   # decoupled weight decay on matrices only
                step.add_(p.float() * weight_decay)
            _apply(p, step, lr)

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, {"m": state["m"], "v": state["v"], "count": c}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
def Adafactor(eps=1e-30, clip_threshold=1.0, decay=0.8,
              weight_decay=0.0, min_dim_factored=128) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern, 2018).  Matrices
    with both trailing dims >= min_dim_factored get row/col factored stats;
    everything else falls back to a full fp32 second moment."""

    def factored(p):
        return p.dim() >= 2 and p.shape[-1] >= min_dim_factored \
            and p.shape[-2] >= min_dim_factored

    def init(params):
        def st(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if factored(p):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        count = torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device)
        return {"s": tree_map(st, params), "count": count}

    @torch.no_grad()
    def update(grads, state, params, lr):
        c = state["count"] + 1
        beta = 1.0 - (c.float() + 1.0) ** (-decay)

        def upd(p, g, s):         # s: the parameter's state dict
            g = g.float()
            g2 = g * g + eps
            if factored(p):
                vr = s["vr"].mul_(beta).add_((1 - beta) * _mean(g2, -1))
                vc = s["vc"].mul_(beta).add_((1 - beta) * _mean(g2, -2))
                # V ~= (vr / mean(vr)) outer vc  (Shazeer & Stern eq. 4)
                vr_n = vr / torch.clamp(_mean(vr, -1, keepdim=True), min=eps)
                step = g * torch.rsqrt(vr_n + eps)[..., None] \
                    * torch.rsqrt(vc + eps)[..., None, :]
            else:
                v = s["v"].mul_(beta).add_((1 - beta) * g2)
                step = g * torch.rsqrt(v + eps)
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(_mean(step * step) + 1e-30)
            step = step / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay and p.dim() >= 2:
                step.add_(p.float() * weight_decay)
            _apply(p, step, lr)

        tree_map(upd, params, grads, state["s"])
        return params, {"s": state["s"], "count": c}

    return Optimizer(init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**kw)
    raise ValueError(name)
