"""Serving launcher: the continuous-batching engine behind the typed
client API (``submit`` -> ``RequestHandle``, ``results()``, context-manager
lifecycle), on the GPU unless ``--device`` names another device.

Port of ``src/repro/launch/serve.py``.  ``--adaptive`` attaches the
runtime Supervisor (SLO pressure levels, cost-model observation) and
prints its events; ``--tuned`` re-execs once with tcmalloc preloaded
(where installed) and one intra-op thread (``launch/tuned.py``).
``--layers`` cuts the depth of a config built from
``n_layers`` and is refused for one built from a segment list (Zamba2,
xLSTM); a config other than ``ff-tiny`` runs reduced, as the reference
launcher runs it.  Weights are random, drawn on the device from seed 0.
Qwen2-VL serves text prompts (the engine passes tokens only, as the
reference's does); Whisper is refused, since its prefill also takes frames:
``runtime.steps.make_prefill_step`` / ``make_decode_step`` run it.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 4 \\
        --max-new 6 --layers 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
        --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..configs import get
from ..core.plan import single_device_plan
from ..runtime.steps import make_model
from ..serving import InferenceEngine, Overloaded, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ff-tiny")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request SLO deadline in seconds: past it a "
                         "request finishes truncated (or is shed before "
                         "admission)")
    ap.add_argument("--exit-threshold", type=float, default=None,
                    help="FastBERT-style early exit: stop decoding a "
                         "request once next-token confidence (max softmax "
                         "prob) reaches this")
    ap.add_argument("--adaptive", action="store_true",
                    help="attach the runtime Supervisor: live stage stats "
                         "sampling, SLO pressure-level control, cost-model "
                         "observation (events land in the report)")
    ap.add_argument("--tuned", action="store_true",
                    help="tuned host runtime: tcmalloc LD_PRELOAD when "
                         "installed, one OpenMP/MKL thread a process "
                         "(re-execs once; see repro_torch.launch.tuned)")
    args = ap.parse_args(argv)
    if args.tuned:
        from .tuned import apply_tuned
        apply_tuned()

    cfg = get(args.arch)
    if cfg.family == "encdec":
        ap.error(f"--arch {args.arch}: the engine serves token prompts and "
                 f"an encoder-decoder model also takes frames; run it with "
                 f"runtime.steps.make_prefill_step / make_decode_step on "
                 f"{{'frames', 'tokens'}}")
    if args.arch != "ff-tiny":
        cfg = cfg.reduced()
    if args.layers is not None:
        if cfg.segments_spec is not None:
            ap.error(f"--layers: {cfg.name} is built from its segment list "
                     f"{cfg.segments}, which n_layers does not change")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    plan = single_device_plan(args.device)
    gen = torch.Generator(device=plan.device).manual_seed(0)
    params = make_model(cfg).init(gen)

    eng = InferenceEngine(cfg, plan, params, max_batch=args.max_batch,
                          cache_len=args.cache_len, adaptive=args.adaptive,
                          exit_threshold=args.exit_threshold)
    print(f"engine graph on {plan.device}: {eng.graph.describe()}")
    for desc, p in eng.placements:
        print(f"  [{p.target:6s}] {desc}")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    total_toks = shed = 0
    with eng:
        for _ in range(args.requests):
            eng.submit(Request(
                prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                    dtype=np.int32),
                max_new_tokens=args.max_new, deadline_s=args.deadline))
    for out in eng.results():
        if isinstance(out, Overloaded):
            shed += 1
            print(f"req {out.request.id}: SHED ({out.reason})")
            continue
        total_toks += len(out.tokens)
        print(f"req {out.id}: {len(out.tokens)} tokens "
              f"[{out.finish_reason}] in "
              f"{(out.finish_t - out.submit_t)*1e3:.0f} ms")
    dt = time.perf_counter() - t0
    print(f"served {args.requests - shed}/{args.requests} requests, "
          f"{total_toks} tokens in {dt:.2f}s ({total_toks/dt:.1f} tok/s); "
          f"decode steps={eng.steps}, early exits={eng.early_exits}, "
          f"shed={eng.shed_count}")
    print("engine graph stats (svc-time EMA / cache occupancy / SLO):")
    print("  " + json.dumps(eng.stats(), default=str))
    if args.adaptive:
        events = eng.replacement_events()
        print(f"re-placement events: {len(events)}"
              + (f" (supervisor {eng.supervisor.stats()})"
                 if eng.supervisor else ""))
        for e in events:
            print(f"  {e}")
    return 0


if __name__ == "__main__":
    main()
