#!/usr/bin/env python3
"""What phase 7's host-offload check of ``chip_smoke.py`` measures, with
the accelerator's first round timed and untimed, on one NVIDIA GPU.

    python3 tools/probe_accelerator.py [--runs 4] [--spin 0]

In turns, ``--runs`` times each:

- ``warm``: ``chip_smoke.phase_accelerator`` as the script runs it (one
  untimed round of the 32 tasks through the accelerator, then the same 32
  timed): the host offload against the synchronous loop's device time,
  and the new device segments (cudaMalloc calls) in the timed round;
- ``cold``: the same Mixtral-8x7B MoE block offloaded 32 times through a
  new ``TorchAccelerator`` with the timer started before its first task,
  against a synchronous loop's device time measured as the phase measures
  it; the new device segments in that window.

``--spin K`` keeps K processes spinning on the host meanwhile (a host
shared with other work).  Prints one line a run and whether the check's
``offload < device`` held.  About a minute.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def spin(stop) -> None:
    while not stop.is_set():
        sum(range(10000))


def cold_run(dev, p, cfg, xs) -> dict:
    """The phase's timing with the accelerator's first round inside it."""
    from repro_torch.core import FF_EOS, TorchAccelerator
    from repro_torch.models.moe import moe_block

    def block(x):
        return moe_block(x, p, cfg, losses=False)[0]

    device_ms = 0.0
    for x in xs:
        xd = x.to(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        moe_block(xd, p, cfg, losses=False)
        b.record()
        b.synchronize()
        device_ms += a.elapsed_time(b)
    acc = TorchAccelerator(block, max_inflight=cs.ACC_INFLIGHT, device=dev)
    acc.run_then_freeze()
    segs = cs.device_segments(dev)
    t0 = time.perf_counter()
    for x in xs:
        acc.offload(x)
    acc.offload(FF_EOS)
    offload_s = time.perf_counter() - t0
    while acc.load_result(timeout=300)[0]:
        pass
    torch.cuda.synchronize()
    acc.wait(60)
    return {"offload_s": offload_s, "device_s": device_ms / 1e3,
            "timed_segs": cs.device_segments(dev) - segs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--spin", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_accelerator: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get
    from repro_torch.core.plan import single_device_plan
    from repro_torch.models.moe import moe_block, moe_defs
    from repro_torch.models.params import init_params
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_name()
    cfg = get("mixtral-8x7b")
    p = init_params(moe_defs(cfg), torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator().manual_seed(12)
    xs = [torch.randn(1, cs.ACC_TOKENS, cfg.d_model, generator=g)
          .to(torch.bfloat16).pin_memory() for _ in range(cs.ACC_TASKS)]
    moe_block(xs[0].to(dev), p, cfg, losses=False)
    torch.cuda.synchronize()
    failed = []
    cs.fail = lambda msg: failed.append(msg)
    stop = mp.get_context("fork").Event()
    procs = [mp.get_context("fork").Process(target=spin, args=(stop,))
             for _ in range(args.spin)]
    for q in procs:
        q.start()
    try:
        for i in range(args.runs):
            for kind in ("warm", "cold") if i % 2 == 0 else ("cold", "warm"):
                failed.clear()
                r = (cs.phase_accelerator(single_device_plan(), cfg, card=card)
                     if kind == "warm" else cold_run(dev, p, cfg, xs))
                held = r["offload_s"] < r["device_s"] and not failed
                cs.say(f"[probe] {kind} run {i}, {args.spin} spinning: host "
                       f"offload {r['offload_s'] * 1e3:.1f} ms against "
                       f"{r['device_s'] * 1e3:.1f} ms of device time, "
                       f"{r['timed_segs']} new device segments: "
                       f"{'held' if held else 'FAILED'} on {card}")
    finally:
        stop.set()
        for q in procs:
            q.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
