#!/usr/bin/env python3
"""Where the card's and the CPU's router logits part, on one NVIDIA GPU.

    python3 tools/router_logit_noise.py [--seeds 1 2 3]

Runs reduced Mixtral's loss and gradient on the card and, routed to the
card's experts, on the CPU (``chip_smoke.card_cpu_parity``), once with the
attention kernel on the card and once with the plain attention there, and
prints for every router call (the forward's, then the recompute's) the rms
difference of the two runs' logits relative to their rms and the tokens the
CPU would route to other experts, with their margins in bf16 ulps of the
tied logits and in rms logit differences of the call.
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("needs a CUDA device")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds:
        for kernel in (True, False):
            with contextlib.nullcontext() if kernel else cs.plain_attention():
                r = cs.card_cpu_parity("mixtral-8x7b", seed, dev)
            cs.say(f"seed {seed}, attention {'kernel' if kernel else 'plain'}"
                   f" on the card: loss rel {r['rel']:.2e}, min cosine "
                   f"{r['min_cos']:.6f}, the card's experts its logits' "
                   f"top-K: {r['top_k']}")
            for i, c in enumerate(r["per_call"]):
                cs.say(f"  router call {i}: logits differ by "
                       f"{c['dlogit_rel']:.2e} of their rms; "
                       f"{len(c['margins_ulps'])} tokens route otherwise, "
                       f"margins {[round(m, 2) for m in c['margins_ulps']]}"
                       f" bf16 ulps, {[round(m, 2) for m in c['margins_rms']]}"
                       f" rms differences")
    return 0


if __name__ == "__main__":
    sys.exit(main())
