"""Step functions: train_step / prefill_step / decode_step factories.

Port of ``src/repro/runtime/steps.py`` (``make_model``, ``state_defs``,
``init_state``, ``state_shardings``, ``state_structs``,
``make_train_step``, ``make_prefill_step``, ``make_decode_step``).  Each
``jax.jit``-ed step of the reference is an eager call here.  The train step
takes the gradient of ``LM.loss`` with ``torch.autograd`` (the reference's
``jax.value_and_grad``), accumulates micro-batches in fp32, clips by the
global norm and applies the optimizer, which updates the state's tensors
in place (the reference donates the state).

Over a mesh with ranks behind it (``core/spmd.py``) the train step is the
outer farm, one process per rank, and gives what the reference's GSPMD
step gives on a ``data`` mesh, the gradient of the global batch:

  emitter   = every rank takes its block of the global batch;
  workers   = each rank runs ``LM.loss`` on its block with every mesh axis
              manual (the loss's means and the MoE aux losses are pmeaned
              over the batch axes) and takes its gradient;
  collector = the gradients summed over the batch axes: reduce-scattered to
              the shards with ``plan.fsdp_params`` (ZeRO-3: between steps
              each rank holds only its shards of the parameters and the
              optimizer state, placed by :func:`state_shardings`, and a step
              gathers the parameters first), all-reduced without it;
  feedback  = the clip (its norm summed over the ranks) and the optimizer
              update of each rank's shards.

Tensor parallelism inside the model (``tp > 1``) and the pod gradient
compression are not ported yet; the step raises on a mesh whose ``tp``
axis is larger than one.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..configs.base import Config
from ..core import spmd
from ..core.plan import P, TorchPlan, TorchSharding, spec_axes
from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..models import params as pp
from ..models.lm import LM
from ..optim import clip_by_global_norm, make_optimizer
from ..optim.optimizers import Shard


def make_model(cfg: Config) -> LM:
    return LM(cfg)


def state_defs(cfg: Config, plan=None):
    """ParamDef trees for the parameters (for dry-run structs and
    checkpoint layouts)."""
    return LM(cfg).param_defs()


def _sharded(plan) -> bool:
    """The plan's mesh has ranks behind it: state and step are SPMD."""
    return getattr(plan.mesh, "live", False)


def init_state(cfg: Config, plan, gen: torch.Generator, optimizer=None):
    """``{"params", "opt", "step"}``: parameters drawn from ``gen``, a
    generator on the plan's device, the optimizer's zero state and an int32
    step counter, all on that device.  Over a mesh with ranks every rank
    draws the same whole parameters from the same seed and keeps its
    blocks by :func:`state_shardings` (one leaf at a time), then builds the
    optimizer state of its blocks."""
    if gen.device != plan.device:
        raise ValueError(f"generator on {gen.device}, plan on {plan.device}")
    opt = optimizer or make_optimizer(cfg.optimizer)
    params = LM(cfg).init(gen)
    if not _sharded(plan):
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=plan.device)}
    sh = state_shardings(cfg, plan, opt)
    local = tree_map(lambda t, s: s.local_block(t).clone(), params,
                     sh["params"])
    del params
    shards = param_shards(cfg, plan, opt)
    return {"params": local, "opt": opt.init(local, shards),
            "step": torch.zeros((), dtype=torch.int32, device=plan.device)}


def state_shardings(cfg: Config, plan, optimizer=None):
    """Shardings for the full train state (params + opt + step): each
    parameter by its def's axes fitted to its shape, each optimizer leaf by
    its ``state_axes``, the counters replicated."""
    opt = optimizer or make_optimizer(cfg.optimizer)
    pdefs = LM(cfg).param_defs()
    rep = TorchSharding(plan.mesh, P())

    def ax_to_sh(ax):
        if ax == () or ax is None:
            return rep
        return TorchSharding(plan.mesh, plan.param_spec(ax))
    o_sh = _map_axes(ax_to_sh, opt.state_axes(pdefs))
    return {"params": pp.shardings(pdefs, plan), "opt": o_sh, "step": rep}


def _map_axes(fn, tree):
    """``fn`` over a tree whose leaves are tuples of logical axes."""
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    return fn(tree)


def state_structs(cfg: Config, plan, optimizer=None):
    """Stand-ins for the train state that allocate nothing — meta tensors
    with their shardings (``models.params.shape_structs``)."""
    opt = optimizer or make_optimizer(cfg.optimizer)
    pdefs = LM(cfg).param_defs()
    sh = state_shardings(cfg, plan, opt)

    def meta(shape, dtype, sharding):
        t = torch.empty(shape, dtype=dtype, device="meta")
        t.sharding = sharding
        return t

    o_like = opt.init(tree_map(lambda d: torch.empty(
        d.shape, dtype=d.dtype, device="meta"), pdefs))
    o_st = tree_map(lambda t, s: meta(t.shape, t.dtype, s), o_like,
                    sh["opt"])
    return {"params": pp.shape_structs(pdefs, plan), "opt": o_st,
            "step": meta((), torch.int32, sh["step"])}


def _batch_axes(plan) -> tuple:
    return tuple(a for a in spec_axes(plan.axes("batch")))


def param_shards(cfg: Config, plan, optimizer=None):
    """Per parameter, a :class:`~repro_torch.optim.optimizers.Shard`: its
    whole shape, the dims its sharding splits over the batch axes, the sum
    over the ranks that hold its other blocks, and whether this rank is
    the one that counts an unsplit leaf."""
    mesh = plan.mesh
    batch = _batch_axes(plan)
    fsdp = tuple(a for a in spec_axes(plan.axes("fsdp")) if a in batch)
    owner = all(mesh.coord(a) == 0 for a in fsdp)

    def psum(x):
        return spmd.all_sum(x, mesh, fsdp)

    def one(d, s):
        dims = tuple(i for i, axes in s.shard_dims().items()
                     if set(axes) & set(batch))
        return Shard(tuple(d.shape), dims, psum, owner)
    return tree_map(one, LM(cfg).param_defs(),
                    state_shardings(cfg, plan, optimizer)["params"])


def gather_params(params, shardings, axes):
    """The whole parameters from this rank's blocks (all-gathered over the
    ``axes`` that split each leaf)."""
    return tree_map(lambda t, s: s.gather(t, axes), params, shardings)


def reduce_grads(grads, shardings, axes):
    """The collector: each gradient summed over ``axes``, to this rank's
    block (reduce-scatter) where one of them splits the leaf, whole
    (all-reduce) where none does."""
    return tree_map(lambda g, s: s.reduce(g, axes), grads, shardings)


def make_train_step(cfg: Config, plan, lr_fn: Callable,
                    optimizer=None, n_micro: Optional[int] = None,
                    max_grad_norm: float = 1.0):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics hold
    ``loss``, ``grad_norm`` and ``lr`` (and, without micro-batches, the
    loss's own ``ce`` and MoE aux terms) as tensors on the device.  With
    ``n_micro > 1`` the batch is split along its first dimension and the
    gradients are summed in fp32 and divided by ``n_micro``.  Over a mesh
    with ranks, ``batch`` is the global batch (the same on every rank) and
    ``state`` this rank's part of the state (:func:`init_state`)."""
    model = LM(cfg)
    opt = optimizer or make_optimizer(cfg.optimizer)
    n_micro = n_micro or cfg.n_microbatches
    if _sharded(plan):
        return _spmd_train_step(cfg, plan, lr_fn, opt, n_micro,
                                max_grad_norm)

    def grads_of(params, batch):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        loss, metrics = model.loss(tree_unflatten(params, leaves), batch, plan)
        # zeros for a leaf the loss does not read (a vlm batch's embeds
        # replace the token embedding), as jax.grad gives
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            tree_unflatten(params, list(grads))

    def train_step(state, batch):
        params = state["params"]
        if n_micro > 1:
            gsum, loss_sum = None, 0.0
            for i in range(n_micro):
                mb = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                   + v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, _, grads = grads_of(params, mb)
                if gsum is None:
                    gsum = tree_map(lambda g: torch.zeros(
                        g.shape, dtype=torch.float32, device=g.device),
                        grads)
                gsum = tree_map(lambda a, g: a + g.float(), gsum, grads)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / n_micro, gsum)
            loss = loss_sum / n_micro
            metrics = {}
        else:
            loss, metrics, grads = grads_of(params, batch)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_fn(state["step"])
        params, opt_state = opt.update(grads, state["opt"], params, lr)
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm, "lr": lr})
        return {"params": params, "opt": opt_state,
                "step": state["step"] + 1}, metrics

    return train_step


def _spmd_train_step(cfg: Config, plan, lr_fn: Callable, opt, n_micro: int,
                     max_grad_norm: float):
    """The train step as one process per rank of a data mesh (see the
    module's docstring)."""
    mesh = plan.mesh
    if plan.tp > 1:
        raise NotImplementedError(
            "a train step over a model axis larger than one (tensor "
            "parallelism inside the model) is not ported yet")
    model = LM(cfg)
    batch_axes = _batch_axes(plan)
    n_ranks = mesh.size
    sh = state_shardings(cfg, plan, opt)
    shards = param_shards(cfg, plan, opt)
    if cfg.optimizer == "adamw":       # elementwise: blocks must align
        for a, b in zip(tree_leaves(sh["params"]), tree_leaves(sh["opt"]["m"])):
            if a.spec != b.spec:
                raise ValueError(f"a moment's sharding {b.spec} is not its "
                                 f"parameter's {a.spec}: a dim does not "
                                 "divide over its mesh axes")
    block = 0
    for a in batch_axes:
        block = block * mesh.shape[a] + mesh.coord(a)
    n_blocks = math.prod(mesh.shape[a] for a in batch_axes)

    def local(t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] % n_blocks:
            raise ValueError(f"a batch of {t.shape[0]} over {n_blocks} "
                             "ranks")
        n = t.shape[0] // n_blocks
        return t[block * n:(block + 1) * n]

    def grads_of(whole, batch):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(whole)]
        with spmd.manual(mesh, mesh.axis_names):
            loss, metrics = model.loss(tree_unflatten(whole, leaves), batch,
                                       plan)
        # every rank holds the same (replicated) loss: each takes 1/ranks
        # of its cotangent, and the collector sums the ranks' gradients
        seed = torch.full((), 1.0 / n_ranks, dtype=loss.dtype,
                          device=loss.device)
        grads = torch.autograd.grad(loss, leaves, seed,
                                    materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            tree_unflatten(whole, list(grads))

    def train_step(state, batch):
        whole = gather_params(state["params"], sh["params"], batch_axes)
        if n_micro > 1:
            gsum, loss_sum = None, 0.0
            for i in range(n_micro):
                mb = {k: local(v.reshape((n_micro, v.shape[0] // n_micro)
                                         + v.shape[1:])[i])
                      for k, v in batch.items()}
                loss, _, grads = grads_of(whole, mb)
                if gsum is None:
                    gsum = tree_map(lambda g: torch.zeros(
                        g.shape, dtype=torch.float32, device=g.device),
                        grads)
                gsum = tree_map(lambda a, g: a + g.float(), gsum, grads)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / n_micro, gsum)
            loss = loss_sum / n_micro
            metrics = {}
        else:
            loss, metrics, grads = grads_of(
                whole, {k: local(v) for k, v in batch.items()})
        del whole
        grads = reduce_grads(grads, sh["params"], batch_axes)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm, shards)
        lr = lr_fn(state["step"])
        params, opt_state = opt.update(grads, state["opt"], state["params"],
                                       lr, shards)
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm, "lr": lr})
        return {"params": params, "opt": opt_state,
                "step": state["step"] + 1}, metrics

    return train_step


def make_prefill_step(cfg: Config, plan: TorchPlan, cache_len: int):
    model = LM(cfg)

    def prefill_step(params, batch):
        return model.prefill(params, batch, plan, cache_len=cache_len)

    return prefill_step


def make_decode_step(cfg: Config, plan: TorchPlan, cache_len: int):
    model = LM(cfg)
    cfg.cache_len = (min(cache_len, cfg.window) if cfg.attn_kind == "swa"
                     else cache_len)

    def decode_step(params, caches, batch):
        logits, new_caches = model.decode_step(params, caches, batch, plan)
        # greedy token for the feedback loop
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, new_caches

    return decode_step
