#!/usr/bin/env python3
"""Time variants of the bf16 ``flash_attention`` kernel on one NVIDIA GPU.

    python3 tools/flash_variants.py

Builds ``csrc/flash_attention.cu`` as it stands and with each edit of
:data:`VARIANTS` (64-key tiles up to D 64, no ping-pong between the two
consumer warpgroups, no ``lo`` half of P, which gives wrong outputs and
only times what the second product costs), each into its own library
under ``build/flash_variants/``, then times every variant at
:data:`SHAPES` with the keys split as ``launch_plan`` says and, at the
few-query shapes, also unsplit and in two splits (CUDA graph of 20 calls,
median of 5, ``chip_smoke.graph_ms``).  Prints one JSON line, ms by shape
and variant, with the card's name and power limit: the measurements
behind the kernel's tiles, its ping-pong and ``launch_plan``'s split rule.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)

# name -> (text in csrc/flash_attention.cu, its replacement)
VARIANTS = {
    "bk64_to_d64": ("static constexpr int BK = D > 128 ? 64 : 128;",
                    "static constexpr int BK = D == 128 ? 128 : 64;"),
    "no_pingpong": ("constexpr bool kPingPong = D <= 128;",
                    "constexpr bool kPingPong = false;"),
    "no_lo_half": ("    hopper::Wgmma<D>::template rs<1>(acc, pl[kk], dv, 1);\n",
                   ""),
}
# (row, B, H, Hkv, Sq, Sk, D, causal, window)
SHAPES = [("mixtral_d128_serve", 1, 32, 8, 2048, 2048, 128, True, 4096),
          ("zamba2_d64_train", 4, 32, 32, 2048, 2048, 64, True, 4096),
          ("gemma_d256", 1, 16, 16, 2048, 2048, 256, True, 0),
          ("whisper_encoder", 8, 16, 16, 1500, 1500, 64, False, 0),
          ("whisper_cross_decode", 8, 16, 16, 1, 1500, 64, False, 0),
          ("whisper_cross_decode_h8", 8, 8, 8, 1, 1500, 64, False, 0),
          ("whisper_dec_self_h8", 8, 8, 8, 32, 32, 64, True, 0)]


def build(backend, name: str, text: str) -> ctypes.CDLL:
    out_dir = ROOT / "build" / "flash_variants" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in backend.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    (out_dir / "flash_attention.cu").write_text(text)
    lib = out_dir / "libflash_attention.so"
    res = subprocess.run([backend._nvcc(), *backend.ARCH_FLAGS, "-std=c++17",
                          "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                          str(lib), str(out_dir / "flash_attention.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        cs.fail(f"nvcc failed for variant {name}:\n{res.stderr}")
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.flash_attention_split_launch.argtypes = [p] * 5 + [i] * 9 + \
        [p, p, p]
    dll.flash_attention_split_launch.restype = i
    return dll


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a GPU")
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import launch_plan
    src = (backend.CSRC / "flash_attention.cu").read_text()
    texts = {"as_built": src}
    for name, (old, new) in VARIANTS.items():
        if old not in src:
            cs.fail(f"variant {name}: its text is not in the source")
        texts[name] = src.replace(old, new)
    with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:
        jobs = {n: pool.submit(build, backend, n, t) for n, t in texts.items()}
        libs = {n: j.result() for n, j in jobs.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        torch.cuda.get_device_name(0)
    dev = torch.device("cuda:0")
    g = torch.Generator().manual_seed(5)
    out = {}
    for row, B, H, Hkv, Sq, Sk, D, causal, window in SHAPES:
        q = torch.randn(B, H, Sq, D, generator=g).to(torch.bfloat16).to(dev)
        k = torch.randn(B, Hkv, Sk, D, generator=g).to(torch.bfloat16).to(dev)
        v = torch.randn(B, Hkv, Sk, D, generator=g).to(torch.bfloat16).to(dev)
        o = torch.empty_like(q)
        plan = launch_plan(B, H, Hkv, Sq, Sk, D)
        splits = sorted({plan.splits, 1, 2}) if Sq <= 64 else [plan.splits]
        for name, lib in libs.items():
            for n in splits:
                part = torch.empty(B * H * n * Sq * (D + 2), device=dev)
                tickets = torch.zeros(B * H * plan.q_tiles, device=dev,
                                      dtype=torch.int32)

                def call():
                    tickets.zero_()
                    # the stream of the moment: graph_ms captures on its own
                    err = lib.flash_attention_split_launch(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), None, B, H, Hkv, Sq, Sk, D, int(causal),
                        window, n, part.data_ptr(), tickets.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        cs.fail(f"{name} at {row}: cudaError {err}")
                out.setdefault(row, {})[f"{name}/splits{n}"] = \
                    cs.graph_ms(call)
        cs.say(f"[variants] {row}: {out[row]} on {card}")
    print(json.dumps({"card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
