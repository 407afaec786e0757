#!/usr/bin/env python3
"""Time the bf16 ``flash_attention`` kernel on one NVIDIA GPU.

    python3 tools/time_flash.py [--src DIR]

Times the kernel at the shapes of ``PERF.md``'s ``flash_attention`` rows
(:data:`SHAPES`: the serving and training shapes of Mixtral-8x7B and
Zamba2-1.2B, Gemma-7B's head dim 256, Kimi-K2's H32/Hkv4 on a model axis of
2, Qwen2-VL's group of 6, Whisper's encoder and its cross attention at Sq
32 and 1 against 1500 frames, whole and on a rank's 8 heads), each in a
CUDA graph of 20 calls, median of 5 (``chip_smoke.graph_ms``), beside
``scaled_dot_product_attention`` on the same inputs and the bound
(``work()``: the larger of the bytes over 3.35 TB/s and the products over
989 TFLOP/s), and prints one JSON line of the results with the card's name
and power limit.  ``--src DIR`` times the ``repro_torch`` package under
``DIR/src`` instead of this checkout's (an unpacked copy of another commit,
built into its own ``build/``): run two trees in one call, in turns
(parent, change, change, parent), to compare them on one card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)

# (row, B, H, Hkv, Sq, Sk, D, causal, window)
SHAPES = [("mixtral_d128_serve", 1, 32, 8, 2048, 2048, 128, True, 4096),
          ("mixtral_d128_train", 2, 32, 8, 2048, 2048, 128, True, 4096),
          ("zamba2_d64_serve", 1, 32, 32, 2048, 2048, 64, True, 4096),
          ("zamba2_d64_train", 4, 32, 32, 2048, 2048, 64, True, 4096),
          ("gemma_d256", 1, 16, 16, 2048, 2048, 256, True, 0),
          ("kimi_h32_hkv4", 1, 32, 4, 2048, 2048, 128, True, 0),
          ("qwen2vl_gqa6", 1, 12, 2, 2048, 2048, 128, True, 0),
          ("whisper_encoder", 8, 16, 16, 1500, 1500, 64, False, 0),
          ("whisper_cross_prefill", 8, 16, 16, 32, 1500, 64, False, 0),
          ("whisper_cross_decode", 8, 16, 16, 1, 1500, 64, False, 0),
          ("whisper_cross_decode_h8", 8, 8, 8, 1, 1500, 64, False, 0)]


def main() -> int:
    _, card, pkg = cs.tool_start(
        argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, work
    dev = torch.device("cuda:0")
    g = torch.Generator().manual_seed(5)
    out, sdpa, bound = {}, {}, {}
    for row, B, H, Hkv, Sq, Sk, D, causal, window in SHAPES:
        q = torch.randn(B, H, Sq, D, generator=g).to(torch.bfloat16).to(dev)
        k = torch.randn(B, Hkv, Sk, D, generator=g).to(torch.bfloat16).to(dev)
        v = torch.randn(B, Hkv, Sk, D, generator=g).to(torch.bfloat16).to(dev)
        out[row] = cs.graph_ms(lambda: flash_attention(q, k, v, causal,
                                                       window))
        # SDPA's causal mask is aligned to the start of the keys: Sq == Sk
        sdpa[row] = cs.graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal and Sq == Sk, enable_gqa=True))
        bound[row] = work(q.shape, Hkv, Sk, q.dtype, causal,
                          window).bound_s * 1e3
        cs.say(f"[time] {row} B{B} H{H}/{Hkv} Sq{Sq} Sk{Sk} D{D}: "
               f"{out[row]:.4f} ms, scaled_dot_product_attention "
               f"{sdpa[row]:.4f} ms, bound {bound[row]:.4f} ms on {card}")
    print(json.dumps({"package": str(pkg), "card": card, "ms": out,
                      "sdpa_ms": sdpa, "bound_ms": bound}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
