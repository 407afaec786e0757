#!/usr/bin/env python3
"""Time the ``ssd_scan`` kernel on one NVIDIA GPU.

    python3 tools/time_ssd.py [--src DIR]

Times the kernel at the shapes of ``PERF.md``'s ``ssd_scan`` rows
(:data:`SHAPES`: xLSTM-125m's mLSTM at P 384 and its P 1 normaliser, on 4
heads and on a rank's 2; Zamba2-1.2B's Mamba2 layer at serving B1 and the
training batch B4, and on a rank's 32 heads; and Zamba2's layer on 16
heads, whose 128 blocks are under one wave of the card, so its time is one
block's), each at S 2048 and chunk 256 in the blocks' types (bf16 q/k, f32
v, log_a and y, with the final state), three ways: in a CUDA graph of 20
calls, median of 5 (``chip_smoke.graph_ms``: the device's time); eager, 20
calls back to back between CUDA events, median of 5 (``chip_smoke.time_ms``:
what the model path, which calls it eagerly, pays where the host is
slower than the device); and the host's own time to issue one call (the
wrapper, its allocations and the launch, by the host's clock over 20 calls,
median of 5).  Beside each row the bound (``work()``: the larger of the
bytes over 3.35 TB/s and the products at their types' peaks).  Prints one
JSON line of the results with the card's name and power limit.  ``--src
DIR`` times another tree's package (``chip_smoke.tool_start``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)

# (row, B, H, G, N, P)
SHAPES = [("xlstm_p384", 1, 4, 4, 384, 384),
          ("xlstm_p1", 1, 4, 4, 384, 1),
          ("xlstm_p384_h2", 1, 2, 2, 384, 384),
          ("xlstm_p1_h2", 1, 2, 2, 384, 1),
          ("zamba2_serve", 1, 64, 1, 64, 64),
          ("zamba2_train", 4, 64, 1, 64, 64),
          ("zamba2_h32", 1, 32, 1, 64, 64),
          ("zamba2_h16", 1, 16, 1, 64, 64)]
S, CHUNK = 2048, 256


def host_ms(fn, reps: int = 5, iters: int = 20) -> float:
    """The host's time to issue one call: ``iters`` calls back to back by
    ``time.perf_counter``, the device drained before each run (median of
    ``reps``)."""
    import torch
    for _ in range(3):
        fn()
    meds = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        meds.append((time.perf_counter() - t0) * 1e3 / iters)
    torch.cuda.synchronize()
    return sorted(meds)[len(meds) // 2]


def main() -> int:
    _, card, pkg = cs.tool_start(
        argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan, work
    dev = torch.device("cuda:0")
    f32 = torch.float32
    out, eager, host, bound = {}, {}, {}, {}
    for row, B, H, G, N, P in SHAPES:
        g = torch.Generator().manual_seed(7)
        q, k, v, la = cs.ssd_inputs(g, dev, B, H, G, S, N, P, "model")

        def call():
            return ssd_scan(q, k, v, la, CHUNK, out_dtype=f32,
                            return_state=True)
        out[row] = cs.graph_ms(call)
        eager[row] = cs.time_ms(call)
        host[row] = host_ms(call)
        w = work(B, H, G, S, N, P, CHUNK, q.dtype, v.dtype, la.dtype, f32)
        bound[row] = w.bound_s * 1e3
        cs.say(f"[time] {row} B{B} H{H}/G{G} S{S} N{N} P{P} chunk {CHUNK}: "
               f"{out[row]:.4f} ms (CUDA graph), {eager[row]:.4f} ms per "
               f"eager call, host {host[row]:.4f} ms to issue one, bound "
               f"{bound[row]:.4f} ms ({w.bound_by}) on {card}")
        del q, k, v, la
    print(json.dumps({"package": str(pkg), "card": card, "ms": out,
                      "eager_ms": eager, "host_ms": host,
                      "bound_ms": bound}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
