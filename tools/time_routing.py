#!/usr/bin/env python3
"""Time the routing kernels on one NVIDIA GPU.

    python3 tools/time_routing.py [--src DIR] [--sweep]

Times ``router_topk`` and ``a2a_route`` at ``chip_smoke.py``'s
``ROUTE_TIMES`` shapes, in CUDA graphs (``chip_smoke.graph_ms``), beside an
empty kernel's time, and prints one JSON line of the results.  ``--src
DIR`` times the ``repro_torch`` package under ``DIR/src`` instead of this
checkout's (an unpacked copy of another commit: compare two trees in one
run, in turns).  ``--sweep`` also times the multi-block router at other
tile sizes than ``router_topk.TOKENS_PER_BLOCK``'s.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)

# (T, E, K) and the tile sizes tried at each
SWEEP = [((2048, 8, 2), (64, 128, 256, 512)), ((5000, 8, 2), (64, 128, 256, 512)),
         ((4096, 8, 1), (64, 128, 256, 512)),
         ((2048, 256, 8), (8, 16, 32, 64)), ((5000, 384, 8), (8, 16, 32, 64))]


def sweep(dev) -> list:
    import torch
    from repro_torch.core.device import expert_capacity
    from repro_torch.kernels import router_topk as rt
    out = []
    for (T, E, K), tiles in SWEEP:
        g = torch.Generator().manual_seed(T + E + K)
        x = (torch.randn(T, E, generator=g) * 2).to(dev)
        cap = expert_capacity(T, E, K, 1.25)
        want = rt.router_topk_plain(x, K, cap)
        path = "warp" if E > rt.THREAD_PATH_MAX_E else "thread"
        chosen = rt.TOKENS_PER_BLOCK[path]
        for tt in tiles:
            rt.TOKENS_PER_BLOCK[path] = tt
            try:
                plan = rt.launch_plan(T, E, K)
                got = rt.router_topk(x, K, cap)
                ms = cs.graph_ms(lambda: rt.router_topk(x, K, cap))
            finally:
                rt.TOKENS_PER_BLOCK[path] = chosen
            if not all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])):
                cs.fail(f"router_topk at tile {tt} != plain at T{T} E{E} K{K}")
            cs.say(f"[sweep] router_topk T{T} E{E} K{K} tile {tt}: {ms:.4f} ms "
                   f"({plan.blocks} blocks x {plan.threads} threads)")
            out.append({"T": T, "E": E, "K": K, "tile": tt, "ms": ms,
                        "blocks": plan.blocks})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    args, card, _ = cs.tool_start(ap)
    import torch
    dev = torch.device("cuda:0")
    floor = cs.empty_kernel_ms()
    cs.say(f"[time] empty kernel: {floor:.4f} ms")
    rows = []
    for case in cs.ROUTE_TIMES:
        r = cs.route_time(dev, *case)
        cs.say(f"[time] {r['name']} T{r['T']} E{r['E']} K{r['K']}: "
               f"{r['ms']:.4f} ms (CUDA graph), plain {r['plain_ms']:.4f} ms")
        rows.append(r)
    result = {"card": card, "src": args.src or ".", "empty_kernel_ms": floor,
              "routes": rows}
    if args.sweep:
        result["sweep"] = sweep(dev)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
