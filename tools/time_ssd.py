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

    python3 tools/time_ssd.py --backward [--src DIR]

times the backward at the training paths' shapes (:data:`BWD_SHAPES`:
Zamba2's Mamba2 layer at B4, xLSTM's mLSTM on a rank's 2 heads and on all
4, P 384 and 1), with dy f32 and the final state's cotangent zero as
training hands them: ``torch.autograd.grad`` through the tree's
``ssd_scan`` (what the model path runs: the backward kernel, or in a tree
before it the plain recompute), eager, median of 3 x 3; the plain
recompute (``chip_smoke.ssd_recompute``) the same way; and where the tree
has it the kernel ``ssd_scan_bwd`` alone, in a CUDA graph and eager, beside
its bound (``work_backward``), and the device time of each of its kernels
in one call (torch.profiler).

    python3 tools/time_ssd.py --train [--src DIR]

runs phase 5c's Zamba2-1.2B training (``chip_smoke.phase_train``: B4 x
S2048 from its seed-0 draw, ``TRAIN_STEPS`` steps through ``TrainDriver``)
on the tree's package and prints its median step after the first, its
forward/backward/optimizer split by step, its losses and its peak device
memory (the launch counts are not held to this checkout's: a tree before
the backward kernel launches none).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
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
# (row, B, H, G, N, P) of the backward: the training calls
BWD_SHAPES = [("zamba2_train", 4, 64, 1, 64, 64),
              ("xlstm_p384_h2", 1, 2, 2, 384, 384),
              ("xlstm_p1_h2", 1, 2, 2, 384, 1),
              ("xlstm_p384", 1, 4, 4, 384, 384),
              ("xlstm_p1", 1, 4, 4, 384, 1)]


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


def kernel_split(fn) -> dict:
    """Device milliseconds of each backward kernel (``ssd_bwd_*``) in one
    call of ``fn`` after one unprofiled call (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"ssd_bwd_\w+", e.key)
        if m and e.self_device_time_total > 0:
            out[m.group(0)] = out.get(m.group(0), 0.0) \
                + e.self_device_time_total / 1e3
    return out


def backward(card: str) -> dict:
    """``--backward``: see the module's docstring."""
    import torch
    from repro_torch.kernels import ssd_scan as module
    kernel = getattr(module, "ssd_scan_bwd", None)
    work = getattr(module, "work_backward", None)
    dev = torch.device("cuda:0")
    res = {"autograd_ms": {}, "recompute_ms": {}, "ms": {}, "eager_ms": {},
           "bound_ms": {}, "kernel_ms": {}}
    for row, B, H, G, N, P in BWD_SHAPES:
        g = torch.Generator().manual_seed(8)
        args = cs.ssd_bwd_inputs(g, dev, (B, H, G, S, N, P), "model")
        q, k, v, la, gy, gs = args
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v, la)]
        y, state = module.ssd_scan(*leaves, CHUNK, out_dtype=torch.float32,
                                   return_state=True)
        res["autograd_ms"][row] = cs.time_ms(
            lambda: torch.autograd.grad((y, state), leaves, (gy, gs),
                                        retain_graph=True), reps=3, iters=3)
        res["recompute_ms"][row] = cs.time_ms(
            lambda: cs.ssd_recompute(*args, CHUNK), reps=3, iters=3)
        line = (f"[time] backward {row} B{B} H{H}/G{G} S{S} N{N} P{P} chunk "
                f"{CHUNK}: autograd through ssd_scan "
                f"{res['autograd_ms'][row]:.4f} ms, the plain recompute "
                f"{res['recompute_ms'][row]:.4f} ms (eager)")
        if kernel is not None:
            res["ms"][row] = cs.graph_ms(lambda: kernel(*args, CHUNK))
            res["eager_ms"][row] = cs.time_ms(lambda: kernel(*args, CHUNK))
            w = work(B, H, G, S, N, P, CHUNK, q.dtype, v.dtype, la.dtype,
                     gy.dtype)
            res["bound_ms"][row] = w.bound_s * 1e3
            res["kernel_ms"][row] = kernel_split(lambda: kernel(*args, CHUNK))
            line += (f"; ssd_scan_bwd {res['ms'][row]:.4f} ms (CUDA graph), "
                     f"{res['eager_ms'][row]:.4f} ms eager, bound "
                     f"{res['bound_ms'][row]:.4f} ms ({w.bound_by}); its "
                     f"kernels in one profiled call {res['kernel_ms'][row]}")
        cs.say(line + f" on {card}")
        del args, q, k, v, la, gy, gs, leaves, y, state
    return res


def train(card: str) -> dict:
    """``--train``: see the module's docstring."""
    from repro_torch.core.plan import single_device_plan
    cfg, batch, seq = cs.train_configs()[0]
    res = cs.phase_train(single_device_plan(), cfg, batch, seq,
                         check_launches=False)
    cs.say(f"[time] {cfg.name} train step B{batch} x S{seq}: median "
           f"{res['step_ms']:.1f} ms after the first, peak "
           f"{res['peak_gb']:.2f} GB on {card}")
    return {"arch": cfg.name, **{k: res[k] for k in (
        "step_ms", "split", "losses", "peak_gb", "per_step")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backward", action="store_true",
                    help="time the backward at the training shapes")
    ap.add_argument("--train", action="store_true",
                    help="time Zamba2-1.2B's train step at B4 x S2048")
    args, card, pkg = cs.tool_start(ap)
    if args.backward or args.train:
        res = backward(card) if args.backward else train(card)
        print(json.dumps({"package": str(pkg), "card": card, **res}))
        return 0
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
