#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s card phase and its phase 13 alone, on one
NVIDIA GPU.

    python3 tools/phase13_alone.py

Builds the kernels (phase 1, ``chip_smoke.phase_card``), then holds the dry
run to the card (phase 13, ``chip_smoke.phase_dry_run``): each cell's step
traced on fake ``cuda:0`` tensors by ``repro_torch.launch.dryrun.dry_step``
in this process, then the same step run on the card — the launches, the
roofline's step time against the measured one, and the traced peak
against ``torch.cuda.max_memory_allocated``.  About a minute, where the whole
script takes over ten: the first run of a change to the dry run on the
card.
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


def main() -> int:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this tool needs a GPU")
    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.phase_card()
    cs.phase_dry_run(card["card"])
    cs.say(f"[alone] {time.perf_counter() - t0:.1f} s on {card['card']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
