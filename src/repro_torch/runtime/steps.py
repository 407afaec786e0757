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
              the shards with ``plan.fsdp_params``, all-reduced without it;
  feedback  = the clip (its norm summed over the ranks) and the optimizer
              update of each rank's shards.

With ``plan.fsdp_params`` (ZeRO-3) each rank holds only its shards of the
parameters and the optimizer state, placed by :func:`state_shardings`,
between steps and during them: the model gathers each weight over the data
axes where it uses it (``plan.gather_fsdp`` inside the blocks, which
training runs under activation checkpointing, so the forward keeps only
the shards and the backward's recompute gathers again, as the reference's
remat does), and the gather's backward reduce-scatters the weight's
gradient to the shard.  A rank never holds more than a block's weights
whole (``core.plan.FSDP_GATHERED`` counts them).

Over a ``model`` axis larger than one (tensor, sequence and expert
parallelism inside the model) each rank keeps its ``tp`` blocks (the
gather at the use is over the batch axes only), the model runs on the
blocks (``models/``; every mesh axis manual), and each leaf's gradient is
summed over exactly the mesh axes on which the leaf is replicated: the
batch axes, and the model axis for a leaf it does not split (a norm
weight, ``wk``/``wv`` outside the heads layout, the router, Mamba2's
``wB``/``wC``: each rank saw only its part of the work — its sequence
block, its tokens).  With the loss's cotangent seeded 1/ranks on every
rank, that sum is the gradient of the global loss.  The clip's norm sums
every block once.  ``make_prefill_step`` and ``make_decode_step`` run the
same way on the rank's blocks of the parameters and of the caches, and
return the vocab-parallel logits (this rank's block); the decode step's
greedy token is the first argmax over the whole vocabulary.  A batch's
inputs besides the tokens (Whisper's ``frames``, Qwen2-VL's ``embeds``
and ``mrope_positions``, whose batch dim is its second) are split over
the batch axes alike.  Under context-parallel attention the attention
weights are replicated over the model axis, and that same sum gives
them the gradient of every rank's sequence block.  The pod gradient
compression is not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..configs.base import Config
from ..core import spmd
from ..core.plan import P, TorchPlan, TorchSharding, mark_whole, spec_axes
from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..models import params as pp
from ..models.lm import LM, vocab_argmax
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
    draws its blocks by :func:`state_shardings` of the same numbers the
    whole draw gives (``models.params.init_blocks``: the whole is never
    held), then builds the optimizer state of its blocks."""
    if gen.device != plan.device:
        raise ValueError(f"generator on {gen.device}, plan on {plan.device}")
    opt = optimizer or make_optimizer(cfg.optimizer)
    if not _sharded(plan):
        params = LM(cfg).init(gen)
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=plan.device)}
    local = pp.init_blocks(LM(cfg).param_defs(), gen, plan)
    shards = param_shards(cfg, plan, opt)
    return {"params": local, "opt": opt.init(local, shards),
            "step": torch.zeros((), dtype=torch.int32, device=plan.device)}


def state_shardings(cfg: Config, plan, optimizer=None):
    """Shardings for the full train state (params + opt + step): each
    parameter by its def's axes fitted to its shape, each optimizer leaf by
    its ``state_axes`` fitted to its own shape (a factored Adafactor
    moment's, else its parameter's), the counters replicated.  Fitted so,
    a moment keeps whole every dim its parameter keeps whole, as the
    moments that ``opt.init`` builds from the parameters' blocks do."""
    opt = optimizer or make_optimizer(cfg.optimizer)
    pdefs = LM(cfg).param_defs()
    rep = TorchSharding(plan.mesh, P())

    def ax_to_sh(ax, like):
        if ax == () or ax is None:
            return rep
        return TorchSharding(plan.mesh, plan.param_spec(ax, like.shape))
    o_sh = _map_axes(ax_to_sh, opt.state_axes(pdefs), _opt_like(opt, pdefs))
    return {"params": pp.shardings(pdefs, plan), "opt": o_sh, "step": rep}


def _opt_like(opt, pdefs):
    """The optimizer state of the whole parameters as meta tensors (their
    shapes and types; nothing allocated)."""
    return opt.init(tree_map(lambda d: torch.empty(
        d.shape, dtype=d.dtype, device="meta"), pdefs))


def _map_axes(fn, tree, like):
    """``fn(axes, leaf)`` over a tree whose leaves are tuples of logical
    axes, beside the same tree of ``like``'s leaves."""
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v, like[k]) for k, v in tree.items()}
    return fn(tree, like)


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

    o_like = _opt_like(opt, pdefs)
    o_st = tree_map(lambda t, s: meta(t.shape, t.dtype, s), o_like,
                    sh["opt"])
    return {"params": pp.shape_structs(pdefs, plan), "opt": o_st,
            "step": meta((), torch.int32, sh["step"])}


# the batch dim of a batch input, where it is not the first
BATCH_DIM = {"mrope_positions": 1}


def _batch_axes(plan) -> tuple:
    return tuple(a for a in spec_axes(plan.axes("batch")))


def _live(plan, axes) -> tuple:
    """Those of ``axes`` with more than one rank (a collective over one
    rank is the identity, and gloo would still copy a CUDA tensor through
    host memory for it)."""
    return tuple(a for a in axes if plan.mesh.shape[a] > 1)


def _model_axes(plan) -> tuple:
    """The ``tp`` mesh axes with more than one rank."""
    return _live(plan, spec_axes(plan.axes("tp")))


def param_shards(cfg: Config, plan, optimizer=None):
    """Per parameter, a :class:`~repro_torch.optim.optimizers.Shard`: its
    whole shape, the dims its sharding splits over the fsdp and model
    axes, the sums over the ranks that hold its other blocks, and whether
    this rank is the one of those holding its block that counts it."""
    mesh = plan.mesh
    batch = _live(plan, _batch_axes(plan))
    spread = tuple(a for a in spec_axes(plan.axes("fsdp")) if a in batch) \
        + _model_axes(plan)

    def total(x):
        return spmd.all_sum(x, mesh, spread)

    def one(d, s):
        by_dim = {i: tuple(a for a in axes if a in spread)
                  for i, axes in s.shard_dims().items()}
        by_dim = {i: axes for i, axes in by_dim.items() if axes}
        split = {a for axes in by_dim.values() for a in axes}
        owner = all(mesh.coord(a) == 0 for a in spread if a not in split)

        def psum(x, dims=None):
            axes = [a for i in (by_dim if dims is None else dims)
                    for a in by_dim.get(i, ())]
            return spmd.all_sum(x, mesh, tuple(a for a in spread
                                               if a in axes))
        return Shard(tuple(d.shape), tuple(by_dim), psum, total, owner)
    return tree_map(one, LM(cfg).param_defs(),
                    state_shardings(cfg, plan, optimizer)["params"])


def marked_params(params, cfg: Config):
    """Aliases of this rank's parameter blocks, each marked with its
    whole shape (``plan.mark_whole``), by which ``plan.gather_fsdp``
    gathers it at its use."""
    shapes = tree_unflatten(params, [d.shape for d in tree_leaves(
        LM(cfg).param_defs())])
    return tree_map(lambda t, s: mark_whole(t.detach(), s), params, shapes)


def reduce_grads(grads, shardings, axes, replicated=()):
    """The collector over this rank's gradient blocks: a leaf that one of
    ``axes`` splits had its gradient reduce-scattered to the block by the
    backward of its gather at the use (``plan.gather_fsdp``); each leaf
    is summed over the others of ``axes`` (all-reduce), and over each of
    the ``replicated`` axes (the model axis) that does not split the
    leaf: each rank holds the whole leaf there, and its gradient from its
    part of the work."""
    def one(g, s):
        split = {a for names in s.shard_dims().values() for a in names}
        rest = tuple(a for a in tuple(axes) + tuple(replicated)
                     if a not in split)
        return spmd.all_sum(g, s.mesh, rest) if rest else g
    return tree_map(one, grads, shardings)


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
    model = LM(cfg)
    batch_axes = _batch_axes(plan)
    live_batch = _live(plan, batch_axes)
    model_axes = _model_axes(plan)
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

    def local(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        if t.shape[dim] % n_blocks:
            raise ValueError(f"a batch of {t.shape[dim]} over {n_blocks} "
                             "ranks")
        n = t.shape[dim] // n_blocks
        return t.narrow(dim, block * n, n)

    def grads_of(params, batch):
        leaves = [t.requires_grad_(True)
                  for t in tree_leaves(marked_params(params, cfg))]
        with spmd.manual(mesh, mesh.axis_names):
            loss, metrics = model.loss(tree_unflatten(params, leaves), batch,
                                       plan)
            # every rank holds the same (replicated) loss: each takes
            # 1/ranks of its cotangent, and the collector sums the ranks'
            # gradients.  Inside the manual region: the backward recomputes
            # the checkpointed blocks, with their collectives
            seed = torch.full((), 1.0 / n_ranks, dtype=loss.dtype,
                              device=loss.device)
            grads = torch.autograd.grad(loss, leaves, seed,
                                        materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            tree_unflatten(params, list(grads))

    def train_step(state, batch):
        params = state["params"]
        if n_micro > 1:
            gsum, loss_sum = None, 0.0
            for i in range(n_micro):
                mb = {k: local(v.reshape((n_micro, v.shape[0] // n_micro)
                                         + v.shape[1:])[i])
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
            loss, metrics, grads = grads_of(
                params, {k: local(v, BATCH_DIM.get(k, 0))
                         for k, v in batch.items()})
        grads = reduce_grads(grads, sh["params"], live_batch, model_axes)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm, shards)
        lr = lr_fn(state["step"])
        params, opt_state = opt.update(grads, state["opt"], state["params"],
                                       lr, shards)
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm, "lr": lr})
        return {"params": params, "opt": opt_state,
                "step": state["step"] + 1}, metrics

    return train_step


def _batch_block(t, plan, dim: int = 0):
    """This rank's block of a batch input along its batch dim ``dim``, as
    ``spec_for_shape`` fits it (whole where the batch does not divide: a
    one-sequence prefill is replicated over the data axes); a scalar as
    it is."""
    if not isinstance(t, torch.Tensor) or t.dim() == 0:
        return t
    spec = plan.spec_for_shape(t.shape[:dim + 1],
                               (None,) * dim + ("batch",))
    return TorchSharding(plan.mesh, spec).local_block(t)


def _spmd_call(cfg: Config, plan):
    """``call(fn, params, *args, batch)``: ``fn`` on this rank's parameter
    blocks, each gathered over the data axes at its use
    (``plan.gather_fsdp``), and this rank's block of ``batch``, every mesh
    axis manual."""
    def call(fn, params, *args):
        *rest, batch = args
        local = {k: _batch_block(v, plan, BATCH_DIM.get(k, 0))
                 for k, v in batch.items()}
        with spmd.manual(plan.mesh, plan.mesh.axis_names):
            return fn(marked_params(params, cfg), *rest, local)
    return call


def gather_logits(logits: torch.Tensor, plan, cfg: Config,
                  batch: int) -> torch.Tensor:
    """The whole batch and vocabulary of the logits (``batch``, ...,
    vocab) that a step over a mesh with ranks returns as this rank's
    block; ``logits`` itself on one device."""
    if plan is None or not _sharded(plan):
        return logits
    shape = (batch,) + tuple(logits.shape[1:-1]) + (cfg.vocab,)
    spec = plan.spec_for_shape(shape, ("batch",) + (None,) * (
        logits.dim() - 2) + ("tp",))
    return TorchSharding(plan.mesh, spec).gather(logits)


def make_prefill_step(cfg: Config, plan: TorchPlan, cache_len: int):
    """``prefill_step(params, batch) -> (logits (B, 1, V), caches)``.  Over
    a mesh with ranks, ``params`` are this rank's blocks of the state's
    parameters, ``batch`` the global batch, and the logits and caches this
    rank's blocks (the logits' vocab block, the caches' by
    ``LM.cache_shardings``)."""
    model = LM(cfg)

    def prefill_step(params, batch):
        return model.prefill(params, batch, plan, cache_len=cache_len)

    if not _sharded(plan):
        return prefill_step
    call = _spmd_call(cfg, plan)
    return lambda params, batch: call(prefill_step, params, batch)


def make_decode_step(cfg: Config, plan: TorchPlan, cache_len: int):
    """``decode_step(params, caches, batch) -> (next tokens (B, 1),
    logits, caches)``; the greedy next token of every sequence of the
    global batch, the logits and caches as :func:`make_prefill_step`
    gives them."""
    model = LM(cfg)
    cfg.cache_len = (min(cache_len, cfg.window) if cfg.attn_kind == "swa"
                     else cache_len)

    def decode_step(params, caches, batch):
        logits, new_caches = model.decode_step(params, caches, batch, plan)
        # greedy token for the feedback loop (the first argmax over the
        # whole vocabulary, which is split over the model axis)
        next_tok = vocab_argmax(logits[:, -1, :], plan).to(torch.int32)
        return next_tok[:, None], logits, new_caches

    if not _sharded(plan):
        return decode_step
    call = _spmd_call(cfg, plan)

    def spmd_decode_step(params, caches, batch):
        tok, logits, caches = call(decode_step, params, caches, batch)
        spec = plan.spec_for_shape(batch["token"].shape[:1], ("batch",))
        return TorchSharding(plan.mesh, spec).gather(tok), logits, caches
    return spmd_decode_step
