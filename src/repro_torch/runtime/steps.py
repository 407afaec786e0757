"""Step functions: prefill_step / decode_step factories.

Port of ``src/repro/runtime/steps.py`` for serving (``make_model``,
``init_state``, ``make_prefill_step``, ``make_decode_step``).  Each
``jax.jit``-ed step of the reference is an eager call here.  The train step
and the optimizer come with the training slice.
"""

from __future__ import annotations

import torch

from ..configs.base import Config
from ..core.plan import TorchPlan
from ..models.lm import LM


def make_model(cfg: Config) -> LM:
    return LM(cfg)


def init_state(cfg: Config, plan: TorchPlan, gen: torch.Generator):
    """``{"params": ...}`` drawn from ``gen``, a generator on the plan's
    device.  The optimizer state comes with the training slice."""
    if gen.device != plan.device:
        raise ValueError(f"generator on {gen.device}, plan on {plan.device}")
    return {"params": LM(cfg).init(gen)}


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
