#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s kernel checks and its phase 11 alone, on one
NVIDIA GPU.

    python3 tools/phase11_alone.py

Builds the kernels and holds each against its plain version (phase 2,
``chip_smoke.phase_kernels``), takes two one-device steps of Mixtral-8x7B
at 1 of 32 layers on phase 5c's batches (the losses and parameters phase
11a is held to, which the whole script takes from phase 5c), then runs
phase 11 on two ranks sharing the card (``tensor_parallel_rows``) and
prints its ``kernels`` rows as one JSON line.  About two minutes, where
the whole script takes ten: the first run of a change to phase 11 on the
card.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def phase5c_steps(dev: torch.device) -> dict:
    """Phase 5c's first ``TP_STEPS`` steps of Mixtral at 1 layer on one
    device: their losses and host copies of the parameters after them."""
    from repro_torch.core.plan import single_device_plan
    from repro_torch.runtime.steps import init_state, make_train_step
    cfg = cs.md_config()
    one = single_device_plan()
    state = init_state(cfg, one, torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(cfg, one, cs.md_schedule())
    losses = []
    for b in cs.md_batches(cfg, cs.TP_STEPS):
        state, m = step(state, {"tokens": torch.as_tensor(b["tokens"],
                                                          device=dev)})
        losses.append(float(m["loss"]))
    out = {"losses": losses, "params_at": cs.host_params(state["params"])}
    del state
    cs.gc_cuda()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this tool needs a GPU")
    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.phase_card()
    errs = cs.phase_kernels(dev)["max_abs_err"]
    t1 = time.perf_counter()
    train5c = phase5c_steps(dev)
    cs.say(f"[alone] phase 5c's first steps: losses {train5c['losses']} "
           f"in {time.perf_counter() - t1:.1f} s")
    rows = cs.tensor_parallel_rows(dev, card["card"], errs, train5c)
    cs.say(json.dumps({"kernels": rows}))
    cs.say(f"[alone] {time.perf_counter() - t0:.1f} s on {card['card']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
