#!/usr/bin/env python3
"""Time variants of attention's wgmma backward on one NVIDIA GPU.

    python3 tools/flash_bwd_variants.py [--only NAME,...]

Builds ``csrc/flash_attention_bwd_wgmma.cu`` as it stands and with each
combination of the edits in :data:`EDITS` that :data:`VARIANTS` names
(the exponential as ``exp2f``, the producer warp at 32 registers, the dq
kernel's warpgroups without ping-pong, its K/V tiles of 128 keys up to D
64; the dk/dv kernel's warpgroups in ping-pong at D 128 too or at no D,
its Q/dO tiles of 64 queries at D 128; and ablations, ``x_``, that leave
a part out and only time what it costs: the exponential, the dq kernel's
sweep for delta, its dq product), each into its own library under
``build/flash_bwd_variants/`` with ptxas's report (registers, spill bytes,
the ``C75xx`` advisories), then runs every variant at :data:`SHAPES` (phase
5c's training calls at D 64 and D 128) against the plain backward (within
2**-7 of each gradient's scale; one that misses is reported, not timed)
and times it in a CUDA graph of 20 calls, median of 5
(``chip_smoke.graph_ms``), and each of its two kernels in one profiled
call.  Prints one JSON line, ms by shape
and variant, with the card's name and power limit: the measurements behind
the kernel's exponential, register split, pipelining and tiles.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)

# name -> (text in csrc/flash_attention_bwd_wgmma.cu, its replacement);
# an "x_" edit is an ablation: its output is wrong, it only times what it
# leaves out
EDITS = {
    "exp2f": ("  float y;\n"
              "  asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) : \"f\"(x));\n"
              "  return y;\n",
              "  return exp2f(x);\n"),
    "producer32": ("constexpr int kProducerRegs = 40;",
                   "constexpr int kProducerRegs = 32;"),
    "dq_no_pp": ("  const bool pp = j.n_wg == 2;",
                 "  const bool pp = false;"),
    "dq_bk128": ("static constexpr int DQ_BK = 64;",
                 "static constexpr int DQ_BK = D > 64 ? 64 : 128;"),
    "kv_pp_all": ("static constexpr bool KV_PP = D <= 64;",
                  "static constexpr bool KV_PP = true;"),
    "kv_pp_none": ("static constexpr bool KV_PP = D <= 64;",
                   "static constexpr bool KV_PP = false;"),
    "kv_bq64": ("static constexpr int KV_BQ = D > 64 ? 32 : 64;",
                "static constexpr int KV_BQ = 64;"),
    "x_no_exp": ("  float y;\n"
                 "  asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) : \"f\"(x));\n"
                 "  return y;\n",
                 "  return x;\n"),
    "x_no_sweep1": ("  for (int step = 0; step < w_lo; ++step) pass(step);\n"
                    "  for (int step = w_lo; step < w_hi; ++step) {",
                    "  for (int step = 0; step < w_hi; ++step) pass(step);\n"
                    "  for (int step = w_hi; step < w_hi; ++step) {"),
    "x_no_dq_mma": ("    issue_rn<D, BK>(dq, dh, dl, kst_of(step));",
                    "    hopper::wgmma_commit();"),
}
# the variants timed: "+"-joined edits
VARIANTS = ["exp2f", "producer32", "dq_no_pp", "dq_bk128", "kv_pp_all",
            "kv_pp_none", "kv_bq64", "x_no_exp", "x_no_sweep1",
            "x_no_dq_mma"]
# (row, index in chip_smoke.FLASH_BWD_CASES)
SHAPES = [("zamba2_d64_train", 0), ("mixtral_d128_train", 1),
          ("whisper_encoder_train", 3)]


def build(backend, name: str, text: str) -> tuple:
    out_dir = ROOT / "build" / "flash_bwd_variants" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in backend.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    src = out_dir / "flash_attention_bwd_wgmma.cu"
    src.write_text(text)
    lib = out_dir / "libflash_attention_bwd_wgmma.so"
    res = subprocess.run([backend._nvcc(), *backend.ARCH_FLAGS, "-std=c++17",
                          "-O3", "-Xptxas=-v", "-shared", "-Xcompiler",
                          "-fPIC", "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        cs.fail(f"nvcc failed for variant {name}:\n{res.stderr}")
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.flash_attention_bwd_wgmma_launch.argtypes = [p] * 9 + [
        ctypes.POINTER(ctypes.c_longlong)] + [i] * 8 + [p]
    dll.flash_attention_bwd_wgmma_launch.restype = i
    usage = {k: v for k, v in cs.ptxas_usage(res.stderr).items()
             if k.startswith("fa_bwd_wg_") and k.endswith(("<64>", "<128>"))}
    notes = sorted({m.group(0) for m in re.finditer(
        r"C75\d\d\).*?fa_bwd_wg_\w+?ILi\d+E", res.stderr)})
    return dll, usage, notes


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", help="comma-separated variants to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a GPU")
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import (
        bwd_plan, flash_attention_bwd_plain)
    src = (backend.CSRC / "flash_attention_bwd_wgmma.cu").read_text()
    names = args.only.split(",") if args.only else VARIANTS
    texts = {"as_built": src}
    for name in names:
        text = src
        for edit in name.split("+"):
            old, new = EDITS[edit]
            if old not in text:
                cs.fail(f"variant {name}: the text of {edit} is not in the "
                        f"source")
            text = text.replace(old, new)
        texts[name] = text
    with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:
        jobs = {n: pool.submit(build, backend, n, t) for n, t in texts.items()}
        built = {n: j.result() for n, j in jobs.items()}
    for n, (_, usage, notes) in built.items():
        cs.say(f"[variants] {n}: (registers, spill store B, spill load B) "
               f"{usage}; advisories {notes or 'none'}")
    card = cs.card_name(torch.cuda.get_device_name(0))
    dev = torch.device("cuda:0")
    out, errs, split = {}, {}, {}
    for row, i in SHAPES:
        case = cs.FLASH_BWD_CASES[i]
        B, H, Hkv, Sq, Sk, D, causal, window = case[:8]
        g = torch.Generator().manual_seed(10)
        q, k, v, o, lse, do, _, _ = cs.flash_bwd_inputs(g, dev, case,
                                                        torch.bfloat16)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal, window)
        ws = torch.empty(bwd_plan(B, H, Hkv, Sq, Sk, D,
                                  torch.bfloat16).workspace, device=dev)
        st = (ctypes.c_longlong * 4)(*do.stride())
        for name, (lib, _, _) in built.items():
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))

            def call():
                err = lib.flash_attention_bwd_wgmma_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                    do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), ws.data_ptr(), st, B, H, Hkv, Sq, Sk, D,
                    int(causal), window,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    cs.fail(f"{name} at {row}: cudaError {err}")
            call()
            torch.cuda.synchronize()
            worst = max(float((a.float() - w.float()).abs().max()
                              / w.float().abs().max())
                        for a, w in zip((dq, dk, dv), want))
            errs.setdefault(row, {})[name] = worst
            # a variant off the plain backward is reported and not timed,
            # unless it is an ablation
            ok = worst <= 2.0 ** -7 or name.startswith("x_")
            out.setdefault(row, {})[name] = cs.graph_ms(call) if ok else None
            if ok:
                split.setdefault(row, {})[name] = {
                    k: round(v, 4) for k, v in cs.kernel_split(call).items()}
        cs.say(f"[variants] {row}: ms {out[row]}, by kernel {split[row]}, "
               f"|err| / scale {errs[row]} on {card}")
    print(json.dumps({"card": card, "ms": out, "kernel_ms": split,
                      "err": errs,
                      "ptxas": {n: b[1] for n, b in built.items()},
                      "advisories": {n: b[2] for n, b in built.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
