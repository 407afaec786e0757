"""Optimizers: AdamW (fp32 moments) and Adafactor (factored second moment).

Port of ``src/repro/optim/optimizers.py`` (``clip_by_global_norm``,
``AdamW``, ``Adafactor``, ``make_optimizer``).  An optimizer keeps the
reference's interface, ``init(params) -> state``, ``update(grads, state,
params, lr) -> (params, state)`` and ``state_axes(param_defs)`` (each state
leaf's logical axes: it inherits its parameter's sharding, a factored
Adafactor statistic drops the reduced dim's axis), and its arithmetic step
by step in the same order and types, so both packages round alike.  Where
the reference returns new trees (its train step donates the old state),
``update`` writes the new parameters and moments into the given tensors in
place, under ``torch.no_grad()``, and returns them.

Sharded (FSDP) state: ``init`` and ``update`` take ``shards``, a tree of
:class:`Shard` beside the parameters, when each tensor is this rank's block
of the whole.  A statistic that spans a split dim — Adafactor's row and
column means and its update RMS, the clip's global norm — sums its partial
over the ranks that hold the other blocks, then divides by the whole
count, which on one rank is the one-device arithmetic bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..core.tree import jax_leaves, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Shard:
    """A tensor that is this rank's block of a whole of ``shape``, split
    along ``dims``; ``psum(x, dims=None)`` sums a partial result over the
    ranks that hold the other blocks along ``dims`` (every split dim by
    default); ``owner`` is true on one rank of those that hold the same
    block (the one that counts it once); ``total`` sums over every rank
    that holds any leaf's other blocks (the clip's norm)."""
    shape: tuple
    dims: tuple
    psum: Callable
    total: Callable
    owner: bool = True


def _sum_over(x: torch.Tensor, dim: int, shard, full_dim: int
              ) -> torch.Tensor:
    """``x.sum(dim)`` of the whole: the partial summed over the ranks when
    the whole's dim ``full_dim`` is split.  (Divided by the count after,
    as ``jnp.mean`` divides; ``torch.mean`` multiplies by the
    reciprocal.)"""
    s = x.sum(dim)
    if shard is not None and full_dim in shard.dims:
        s = shard.psum(s, (full_dim,))
    return s


def clip_by_global_norm(grads, max_norm: float, shards=None):
    """Scale ``grads`` to a global L2 norm of at most ``max_norm``; returns
    (clipped grads in their own types, the fp32 norm before clipping).  The
    squares are summed leaf by leaf in the reference's leaf order.  With
    ``shards``, a split leaf's partial and an unsplit leaf's sum (on its
    owner rank only) are summed over the ranks in one collective, so each
    block counts once."""
    sums = [torch.sum(torch.square(g.float())) for g in jax_leaves(grads)]
    if shards is not None:
        sh = jax_leaves(shards)
        part = torch.stack([s if d.owner else torch.zeros_like(s)
                            for s, d in zip(sums, sh)])
        sums = list(sh[0].total(part).unbind())
    gn = torch.sqrt(sum(sums))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _apply(p: torch.Tensor, step: torch.Tensor, lr) -> None:
    """p <- (p.f32 - lr * step) in p's type; ``step`` is consumed."""
    step.mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(step)
    else:
        p.copy_(p.float().sub_(step))


@dataclasses.dataclass
class Optimizer:
    init: Callable
    update: Callable          # (grads, state, params, lr) -> (params, state)
    state_axes: Callable      # param_defs -> state logical-axes tree


def _leaf_axes(param_defs):
    return tree_map(lambda d: tuple(d.axes), param_defs)


# ---------------------------------------------------------------------------
def AdamW(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params, shards=None):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        count = torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": count}

    @torch.no_grad()
    def update(grads, state, params, lr, shards=None):
        # elementwise: a block updates as the whole would, no collective
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

    def state_axes(param_defs):
        return {"m": _leaf_axes(param_defs), "v": _leaf_axes(param_defs),
                "count": ()}

    return Optimizer(init, update, state_axes)


# ---------------------------------------------------------------------------
def Adafactor(eps=1e-30, clip_threshold=1.0, decay=0.8,
              weight_decay=0.0, min_dim_factored=128) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern, 2018).  Matrices
    with both trailing dims >= min_dim_factored get row/col factored stats;
    everything else falls back to a full fp32 second moment."""

    def factored(shape):
        return len(shape) >= 2 and shape[-1] >= min_dim_factored \
            and shape[-2] >= min_dim_factored

    def whole(p, shard):
        return tuple(shard.shape) if shard is not None else tuple(p.shape)

    def init(params, shards=None):
        def st(p, shard=None):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if factored(whole(p, shard)):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        count = torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device)
        s = tree_map(st, params) if shards is None else \
            tree_map(st, params, shards)
        return {"s": s, "count": count}

    @torch.no_grad()
    def update(grads, state, params, lr, shards=None):
        c = state["count"] + 1
        beta = 1.0 - (c.float() + 1.0) ** (-decay)

        def upd(p, g, s, shard=None):   # s: the parameter's state dict
            full = whole(p, shard)
            n = len(full)
            g = g.float()
            g2 = g * g + eps
            if factored(full):
                vr = s["vr"].mul_(beta).add_(
                    (1 - beta) * (_sum_over(g2, -1, shard, n - 1) / full[-1]))
                vc = s["vc"].mul_(beta).add_(
                    (1 - beta) * (_sum_over(g2, -2, shard, n - 2) / full[-2]))
                # V ~= (vr / mean(vr)) outer vc  (Shazeer & Stern eq. 4)
                vr_mean = _sum_over(vr, -1, shard, n - 2)[..., None] \
                    / full[-2]
                vr_n = vr / torch.clamp(vr_mean, min=eps)
                step = g * torch.rsqrt(vr_n + eps)[..., None] \
                    * torch.rsqrt(vc + eps)[..., None, :]
            else:
                v = s["v"].mul_(beta).add_((1 - beta) * g2)
                step = g * torch.rsqrt(v + eps)
            # update clipping (RMS <= clip_threshold)
            sq = (step * step).sum()
            if shard is not None and shard.dims:
                sq = shard.psum(sq)
            rms = torch.sqrt(sq / math.prod(full) + 1e-30)
            step = step / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay and p.dim() >= 2:
                step.add_(p.float() * weight_decay)
            _apply(p, step, lr)

        if shards is None:
            tree_map(upd, params, grads, state["s"])
        else:
            tree_map(upd, params, grads, state["s"], shards)
        return params, {"s": state["s"], "count": c}

    def state_axes(param_defs):
        def st(d):
            shape, axes = d.shape, tuple(d.axes)
            if factored(shape):
                return {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
            return {"v": axes}
        return {"s": tree_map(st, param_defs), "count": ()}

    return Optimizer(init, update, state_axes)



def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**kw)
    raise ValueError(name)
