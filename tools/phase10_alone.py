#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s kernel checks and its phase 10 alone, on one
NVIDIA GPU.

    python3 tools/phase10_alone.py [--src DIR]

Builds the kernels and holds each against its plain version (phase 2,
``chip_smoke.phase_kernels``), runs phases 3 and 4 (the graph path, whose
one-rank outputs 10e's over two ranks must equal), takes phase 5c's first
two one-device steps of Mixtral-8x7B at 1 of 32 layers (the losses and
parameters phase 10a is held to, which the whole script takes from phase
5c), then runs phase 10 (``phase_multi_device``: 10a on one rank, 10b-10e
on two ranks sharing the card).  ``--src DIR`` runs the ``chip_smoke.py``
and ``src/`` of another checkout (unpack it with ``git archive`` under
``build/``), so that two trees' phase 10 readings, 10b's peak memory among
them, come from one card; a tree whose phase 10 has no 10e (before it
took phases 3-4's outputs) runs without them.  About five minutes, where
the whole script takes thirteen.
"""

from __future__ import annotations

import argparse
import inspect
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT),
                    help="the checkout whose chip_smoke.py and src/ run")
    src = pathlib.Path(ap.parse_args().src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(src / "src"))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this tool needs a GPU")
    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.phase_card()
    cs.phase_kernels(dev)
    graph = ()
    if len(inspect.signature(cs.phase_multi_device).parameters) > 2:
        main = cs.phase_main_path(dev)
        graph = (main, cs.phase_hybrid(main))
    from repro_torch.core.plan import single_device_plan
    from repro_torch.runtime.steps import init_state, make_train_step
    cfg = cs.md_config()
    one = single_device_plan()
    state = init_state(cfg, one, torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(cfg, one, cs.md_schedule())
    losses, dts = [], []
    for b in cs.md_batches(cfg, cs.MD_STEPS_A):
        t1 = time.perf_counter()
        state, m = step(state, {"tokens": torch.as_tensor(b["tokens"],
                                                          device=dev)})
        losses.append(float(m["loss"]))
        dts.append(time.perf_counter() - t1)
    train5c = {"losses": losses, "params_at": cs.host_params(state["params"]),
               "tok_s": 2 * 2048 / dts[-1]}
    del state
    cs.gc_cuda()
    cs.say(f"[alone] phase 5c's first steps from {src}: losses {losses}")
    cs.phase_multi_device(card["card"], train5c, *graph)
    cs.say(f"[alone] {time.perf_counter() - t0:.1f} s on {card['card']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
