#!/usr/bin/env python3
"""Prefill time of one served config on one NVIDIA GPU, for one checkout.

    python3 tools/time_prefill.py [--src DIR] [--arch mixtral-8x7b]
                                  [--layers 4] [--tokens 5000] [--reps 7]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), so that
two checkouts can be timed on one card, each in its own process, with the
same weights: the config's parameter tree is built by the checkout's
``make_model(cfg).init`` and then every leaf of two or more dimensions is
refilled, in the tree's sorted-key order, from one torch.Generator seeded 0
on the card (normal, scaled by 1/sqrt of its next-to-last dimension), so
the draw does not depend on the checkout's initialiser.  One prompt of
``--tokens`` tokens (numpy seed 0) is prefilled at cache_len 4096, once to
warm up and then ``--reps`` times; prints the median device time (CUDA
events) and the median synchronised host time of a prefill, and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve()
                                         .parents[1] / "src"))
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=5000)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get
    from repro_torch.core.plan import single_device_plan
    from repro_torch.core.tree import jax_leaves
    from repro_torch.runtime.steps import make_model, make_prefill_step
    dev = torch.device("cuda:0")
    cfg = dataclasses.replace(get(args.arch), n_layers=args.layers)
    plan = single_device_plan()
    params = make_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for leaf in jax_leaves(params):
            if leaf.dim() >= 2:
                leaf.copy_(torch.randn(leaf.shape, generator=g, device=dev)
                           / leaf.shape[-2] ** 0.5)
    prefill = make_prefill_step(cfg, plan, 4096)
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, args.tokens,
                                          dtype=np.int32), device=dev)[None]
    prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(args.reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = time.perf_counter()
        a.record()
        prefill(params, {"tokens": tokens})
        b.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t) * 1e3)
        dev_ms.append(a.elapsed_time(b))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    d, h = statistics.median(dev_ms), statistics.median(host_ms)
    print(f"[prefill] {args.src}: {cfg.name} at {args.layers} layers, "
          f"{args.tokens} tokens: {d:.3f} ms on the device (CUDA events), "
          f"{h:.3f} ms synchronised host time, {args.tokens / h * 1e3:.1f} "
          f"tokens/s (median of {args.reps}; device times "
          f"{[round(x, 3) for x in dev_ms]}) on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
