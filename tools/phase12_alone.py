#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s kernel checks and its phase 12 alone, on one
NVIDIA GPU.

    python3 tools/phase12_alone.py

Builds the kernels and holds each against its plain version (phase 2,
``chip_smoke.phase_kernels``), then runs phase 12 on two ranks sharing the
card (``tp_families_rows``: Llama-3.2-3B with context-parallel attention,
Qwen2-VL-2B, xLSTM-125m and Whisper-medium over a model axis of 2, each
held to the one-device port) and prints its ``kernels`` rows as one JSON
line.  A few minutes, where the whole script takes over ten: the first run
of a change to phase 12 on the card.
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
    rows = cs.tp_families_rows(dev, card["card"], errs)
    cs.say(json.dumps({"kernels": rows}))
    cs.say(f"[alone] {time.perf_counter() - t0:.1f} s on {card['card']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
