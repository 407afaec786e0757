#!/usr/bin/env python3
"""Where the remote featuriser farm's parent spends its time, on one NVIDIA
GPU.

    python3 tools/remote_probe.py [--interval 5e-4]

Builds ``chip_smoke.py`` phase 9a's graph at its widths:
``pipeline(farm(featurise, n=4), pre, all_to_all, post)`` over 4096 tokens
of d 4096 (Mixtral's MoE hop, 8 experts of 14336, bf16 weights from seed 0),
the farm ``host_remote`` on 4 loopback pools forked after CUDA init, the hop
on the card, microbatch 512, 4 in flight.  Runs it four times: at the
interpreter's default GIL switch interval, twice at ``--interval``, then at
the default again (the switch interval is restored after each run).  Every
run's output must equal the first's byte for byte.  Prints each run's
items/s and the farm's ``hop_ema_s`` (the parent's push time an item), and
the parent's encode and decode time of one 16 KiB item through the net
lane's codec (mean of 2000 on the host clock).  A shorter switch interval
hands the GIL to the emitter and the lane readers sooner: if the rate does
not move with it, the parent's GIL hand-off is not what bounds the farm.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def codec_us(item, n: int = 2000) -> tuple:
    """Mean per-item time of the net lane's encode and decode of ``item``
    on this host (the parent's emitter and collector pay both per item)."""
    from repro_torch.core.net import (_SLOT_HDR, TAG_ARR, decode_payload,
                                      encode_item)
    t0 = time.perf_counter()
    for i in range(n):
        frame = encode_item(item, i)
    enc = (time.perf_counter() - t0) / n
    payload = frame[_SLOT_HDR:]
    t0 = time.perf_counter()
    for _ in range(n):
        decode_payload(TAG_ARR, payload)
    dec = (time.perf_counter() - t0) / n
    return enc * 1e6, dec * 1e6


def probe(fns: dict, plan, stream: list, interval: float) -> list:
    """The four runs on fresh loopback pools: ``(switch interval, items/s,
    hop_ema_s)`` each."""
    import chip_smoke as cs
    import torch
    from repro_torch.core import spawn_loopback_pool
    if plan.device.type == "cuda":
        torch.cuda.synchronize()         # no stream runs across the fork
    default = sys.getswitchinterval()
    addrs, procs = spawn_loopback_pool(cs.REMOTE_POOLS)
    rows, first = [], None
    try:
        for si in (default, interval, interval, default):
            runner = cs.compile_remote(fns, plan, addrs)
            sys.setswitchinterval(si)
            try:
                t0 = time.perf_counter()
                out = runner.run(stream, timeout=600)
                secs = time.perf_counter() - t0
            finally:
                sys.setswitchinterval(default)
            if first is None:
                first = out
            elif not cs.same_bytes(out, first):
                cs.fail(f"switch interval {si}: the output differs from "
                        "the first run's")
            rows.append((si, len(stream) / secs,
                         cs.remote_farm(runner).node_stats()["hop_ema_s"]))
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(timeout=10.0)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--interval", type=float, default=5e-4,
                    help="the probed GIL switch interval in seconds")
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core.plan import single_device_plan
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this tool needs a GPU")
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fns = cs.make_fns(cs.make_model(dev))
    rng = np.random.default_rng(0)
    stream = list(rng.standard_normal((cs.T_TOKENS, cs.D_MODEL),
                                      dtype=np.float32))
    plan = single_device_plan()
    enc, dec = codec_us(stream[0])
    print(f"codec: encode {enc:.2f} us, decode {dec:.2f} us of one "
          f"{stream[0].nbytes} B item on {card}", flush=True)
    for si, rate, hop in probe(fns, plan, stream, args.interval):
        print(f"switch interval {si * 1e3:.2f} ms: {rate:.1f} items/s, "
              f"hop_ema_s {hop:.3g}, byte-equal to the first run on {card}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
