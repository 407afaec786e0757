#!/usr/bin/env python3
"""Why ``chip_smoke.py`` phase 5c trains Whisper-medium from a tamed draw,
and what the activations' kernels cost the accelerator's dispatcher, on
one NVIDIA GPU.

    python3 tools/probe_activations.py

1. Whisper-medium whole, the seed-0 draw and the same draw through
   ``chip_smoke.tf_tame``: one B8 x 1500-frame batch of
   ``chip_smoke.ClipSource``, the loss and every gradient leaf, with the
   gelu backward kernel and again with the plain VJP
   (``gelu_stepwise_vjp_plain``); prints the global norm the clip sees,
   the largest leaves and the two backward passes' largest difference.
2. ``chip_smoke.phase_accelerator`` (phase 7's check) run eight times, the
   Mixtral experts' silu as the kernel and as the plain version in turns
   (kernel, plain, plain, kernel, ...), each run's host offload and device
   ms; then the host time to enqueue one MoE block either way (median of
   20 after a synchronise).

About two minutes.
"""

from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from paths(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


def grads(cfg, params, batch, plan):
    """The loss, the clip's global norm and (max |g|, path) by leaf."""
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from repro_torch.models.lm import LM
    from repro_torch.optim.optimizers import clip_by_global_norm
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = LM(cfg).loss(tree_unflatten(params, leaves), batch, plan)
    gs = torch.autograd.grad(loss, leaves, materialize_grads=True)
    _, gn = clip_by_global_norm(tree_unflatten(params, list(gs)), 1.0)
    top = sorted(((float(g.float().abs().max()), p) for (p, _), g in
                  zip(paths(params), gs)), reverse=True)
    return float(loss.detach()), float(gn), top, gs


def whisper(dev, card: str) -> None:
    from repro_torch.core.plan import single_device_plan
    from repro_torch.kernels import gelu_stepwise as G
    from repro_torch.runtime.steps import init_state
    plan = single_device_plan()
    cfg, b, s = cs.train_configs()[3]
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             cs.train_source(cfg, b, s).next_batch().items()}
    for tamed in (False, True):
        params = init_state(cfg, plan, torch.Generator(device=dev)
                            .manual_seed(0))["params"]
        if tamed:
            cs.tf_tame(cfg, params)
        loss, gn, top, kernel = grads(cfg, params, batch, plan)
        bwd = G.gelu_stepwise_bwd
        G.gelu_stepwise_bwd = G.gelu_stepwise_vjp_plain
        try:
            plain = grads(cfg, params, batch, plan)[3]
        finally:
            G.gelu_stepwise_bwd = bwd
        diff = max(float((a.float() - c.float()).abs().max())
                   for a, c in zip(kernel, plain))
        cs.say(f"[probe] {'tamed' if tamed else 'seed-0'} draw: loss "
               f"{loss:.6f}, global norm {gn:.4g}; largest leaves "
               + "; ".join(f"{p} {m:.4g}" for m, p in top[:4])
               + f"; the gelu kernel's backward against the plain VJP: "
               f"max |diff| {diff} on {card}")
        del params, kernel, plain
        cs.gc_cuda()


def accelerator(dev, card: str) -> None:
    from repro_torch.configs import get
    from repro_torch.core.plan import single_device_plan
    from repro_torch.kernels.silu_stepwise import (silu_stepwise,
                                                   silu_stepwise_plain)
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    cfg = get("mixtral-8x7b")
    fail = cs.fail
    cs.fail = lambda msg: cs.say(f"[probe] the check fails: {msg}")
    try:
        for kind in ("kernel", "plain", "plain", "kernel") * 2:
            moe.silu_stepwise = silu_stepwise if kind == "kernel" \
                else silu_stepwise_plain
            r = cs.phase_accelerator(single_device_plan(), cfg, card=card,
                                     check_launches=False)
            cs.say(f"[probe] accelerator, silu {kind}: host offload "
                   f"{r['offload_s'] * 1e3:.1f} ms, device "
                   f"{r['device_s'] * 1e3:.1f} ms")
        p = init_params(moe.moe_defs(cfg), torch.Generator(device=dev)
                        .manual_seed(0))
        x = torch.randn(1, cs.ACC_TOKENS, cfg.d_model, device=dev,
                        dtype=torch.bfloat16)
        for kind in ("kernel", "plain") * 2:
            moe.silu_stepwise = silu_stepwise if kind == "kernel" \
                else silu_stepwise_plain
            for _ in range(3):
                moe.moe_block(x, p, cfg, losses=False)
            hs = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                moe.moe_block(x, p, cfg, losses=False)
                hs.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            cs.say(f"[probe] one MoE block, silu {kind}: host "
                   f"enqueue {sorted(hs)[10] * 1e3:.3f} ms (median of 20)")
    finally:
        moe.silu_stepwise = silu_stepwise
        cs.fail = fail


def main() -> int:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this tool needs a GPU")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.phase_card()["card"]
    whisper(dev, card)
    accelerator(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
