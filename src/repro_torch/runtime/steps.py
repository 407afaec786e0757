"""Step functions: train_step / prefill_step / decode_step factories.

Port of ``src/repro/runtime/steps.py`` (``make_model``, ``init_state``,
``make_train_step``, ``make_prefill_step``, ``make_decode_step``) on one
device.  Each ``jax.jit``-ed step of the reference is an eager call here.
The train step takes the gradient of ``LM.loss`` with ``torch.autograd``
(the reference's ``jax.value_and_grad``), accumulates micro-batches in
fp32, clips by the global norm and applies the optimizer, which updates the
state's tensors in place (the reference donates the state).  The
multi-device parts (state shardings, the dry run's stand-ins, the pod
gradient compression) come with the multi-device slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..configs.base import Config
from ..core.plan import TorchPlan
from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..models.lm import LM
from ..optim import clip_by_global_norm, make_optimizer


def make_model(cfg: Config) -> LM:
    return LM(cfg)


def init_state(cfg: Config, plan: TorchPlan, gen: torch.Generator,
               optimizer=None):
    """``{"params", "opt", "step"}``: parameters drawn from ``gen``, a
    generator on the plan's device, the optimizer's zero state and an int32
    step counter, all on that device."""
    if gen.device != plan.device:
        raise ValueError(f"generator on {gen.device}, plan on {plan.device}")
    opt = optimizer or make_optimizer(cfg.optimizer)
    params = LM(cfg).init(gen)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=plan.device)}


def make_train_step(cfg: Config, plan: TorchPlan, lr_fn: Callable,
                    optimizer=None, n_micro: Optional[int] = None,
                    max_grad_norm: float = 1.0):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics hold
    ``loss``, ``grad_norm`` and ``lr`` (and, without micro-batches, the
    loss's own ``ce`` and MoE aux terms) as tensors on the device.  With
    ``n_micro > 1`` the batch is split along its first dimension and the
    gradients are summed in fp32 and divided by ``n_micro``."""
    model = LM(cfg)
    opt = optimizer or make_optimizer(cfg.optimizer)
    n_micro = n_micro or cfg.n_microbatches

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
