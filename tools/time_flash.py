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

    python3 tools/time_flash.py --backward [--src DIR]

times attention's backward at phase 5c's training shapes
(:data:`BWD_SHAPES`: Zamba2-1.2B's shared block, Mixtral-8x7B, Gemma-7B and
Whisper-medium's encoder; ``chip_smoke.FLASH_BWD_CASES``) in bf16:
``torch.autograd.grad`` through the tree's ``flash_attention`` (what the
model path runs: the backward kernel, or in a tree before it the plain
recompute), eager, median of 3 x 3; the plain recompute
(``chip_smoke.flash_recompute``) the same way; the backward of
``scaled_dot_product_attention`` (autograd of one bf16 call, a yardstick);
and where the tree has it the kernel ``flash_attention_bwd`` alone, in a
CUDA graph and eager, with the host's time to issue a call, the device
time of each of its two kernels in one call (torch.profiler) and its
bound (``work_backward``).

    python3 tools/time_flash.py --train [--steps N] [--only NAME] [--src DIR]

runs phase 5c's Zamba2-1.2B and Whisper-medium training
(``chip_smoke.phase_train``: their seed-0 draws, ``TRAIN_STEPS`` steps, or
``N``, through ``TrainDriver``; ``--only`` takes one of the two by its
config's name) on the tree's package and prints each one's median step
after the first, its forward/backward/optimizer split, its losses and its
peak device memory (launch counts not held: a tree before the backward
kernel launches none).  Whisper's step is host-bound and moves by 100 ms
and more between runs: read it over several runs of each tree in turns.
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
# (row, case of chip_smoke.FLASH_BWD_CASES) of the backward
BWD_SHAPES = [("zamba2_d64_train", 0), ("mixtral_d128_train", 1),
              ("gemma_d256_train", 2), ("whisper_encoder_train", 3),
              ("whisper_dec_self_train", 4)]


def backward(card: str) -> dict:
    """``--backward``: see the module's docstring."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as module
    kernel = getattr(module, "flash_attention_bwd", None)
    dev = torch.device("cuda:0")
    res = {"autograd_ms": {}, "recompute_ms": {}, "sdpa_bwd_ms": {},
           "ms": {}, "eager_ms": {}, "host_ms": {}, "bound_ms": {},
           "kernel_ms": {}}
    for row, i in BWD_SHAPES:
        case = cs.FLASH_BWD_CASES[i]
        B, H, Hkv, Sq, Sk, D, causal, window = case[:8]
        g = torch.Generator().manual_seed(10)
        bf16 = torch.bfloat16
        q = torch.randn(B, H, Sq, D, generator=g).to(bf16).to(dev)
        k = torch.randn(B, Hkv, Sk, D, generator=g).to(bf16).to(dev)
        v = torch.randn(B, Hkv, Sk, D, generator=g).to(bf16).to(dev)
        do = torch.randn(B, Sq, H, D, generator=g).to(bf16).to(dev)
        do = do.transpose(1, 2)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        y = module.flash_attention(*leaves, causal, window)
        res["autograd_ms"][row] = cs.time_ms(
            lambda: torch.autograd.grad(y, leaves, do, retain_graph=True),
            reps=3, iters=3)
        o = y.detach()
        res["recompute_ms"][row] = cs.time_ms(
            lambda: cs.flash_recompute(q, k, v, o, None, do, causal, window),
            reps=3, iters=3)
        ys = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                            enable_gqa=Hkv != H)
        res["sdpa_bwd_ms"][row] = cs.time_ms(
            lambda: torch.autograd.grad(ys, leaves, do, retain_graph=True),
            reps=3, iters=5)
        line = (f"[time] backward {row} B{B} H{H}/{Hkv} Sq{Sq} Sk{Sk} D{D} "
                f"{'causal' if causal else 'non-causal'}: autograd through "
                f"flash_attention {res['autograd_ms'][row]:.4f} ms, the "
                f"plain recompute {res['recompute_ms'][row]:.4f} ms, "
                f"scaled_dot_product_attention's backward "
                f"{res['sdpa_bwd_ms'][row]:.4f} ms (eager)")
        if kernel is not None:
            o, lse = module.flash_attention_with_lse(q, k, v, causal, window)
            args = (q, k, v, o, lse, do, causal, window)
            res["ms"][row] = cs.graph_ms(lambda: kernel(*args))
            res["eager_ms"][row] = cs.time_ms(lambda: kernel(*args))
            res["host_ms"][row] = cs.host_ms(lambda: kernel(*args))
            w = module.work_backward(q.shape, Hkv, Sk, q.dtype, causal,
                                     window)
            res["bound_ms"][row] = w.bound_s * 1e3
            res["kernel_ms"][row] = cs.kernel_split(lambda: kernel(*args))
            line += (f"; flash_attention_bwd {res['ms'][row]:.4f} ms (CUDA "
                     f"graph), {res['eager_ms'][row]:.4f} ms eager, host "
                     f"{res['host_ms'][row]:.4f} ms to issue one, bound "
                     f"{res['bound_ms'][row]:.4f} ms ({w.bound_by}); its "
                     f"kernels in one profiled call {res['kernel_ms'][row]}")
            del args, o, lse
        cs.say(line + f" on {card}")
        del q, k, v, do, leaves, y, ys
        torch.cuda.empty_cache()
    return res


def train(card: str, steps: int, only) -> dict:
    """``--train``: see the module's docstring."""
    import gc
    import torch
    from repro_torch.core.plan import single_device_plan
    out = {}
    configs = cs.train_configs()
    for cfg, batch, seq in (configs[0], configs[3]):
        if only and cfg.name != only:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        res = cs.phase_train(single_device_plan(), cfg, batch, seq,
                             steps=steps, check_launches=False)
        cs.say(f"[time] {cfg.name} train step B{batch} x S{seq}: median "
               f"{res['step_ms']:.1f} ms after the first, peak "
               f"{res['peak_gb']:.2f} GB on {card}")
        out[cfg.name] = {k: res[k] for k in (
            "step_ms", "split", "losses", "peak_gb", "per_step", "ranges")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backward", action="store_true",
                    help="time the backward at the training shapes")
    ap.add_argument("--train", action="store_true",
                    help="time Zamba2-1.2B's and Whisper-medium's steps")
    ap.add_argument("--steps", type=int, default=cs.TRAIN_STEPS,
                    help="--train: steps a model")
    ap.add_argument("--only", help="--train: one config's name "
                    "(zamba2-1.2b or whisper-medium)")
    args, card, pkg = cs.tool_start(ap)
    if args.backward or args.train:
        res = backward(card) if args.backward else train(card, args.steps,
                                                          args.only)
        print(json.dumps({"package": str(pkg), "card": card, **res}))
        return 0
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
