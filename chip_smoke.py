#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. card — its name and power limit; the CUDA kernels built from the sources
   in ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a, one nvcc per
   source, all started together; each kernel's registers and spill bytes
   (``-Xptxas -v``) are printed, and an attention instance that spills
   fails the run; ``cuobjdump -sass`` must find HMMA/HGMMA (tensor-core)
   instructions in every bf16 ``flash_fwd_kernel_tc`` (D 16-256) and in
   the ``ssd_scan_kernel`` instantiations with bf16 q/k (the count per
   kernel is printed);
2. kernels — ``a2a_route`` and ``a2a_combine`` against their plain PyTorch
   versions on the card (exact indices, byte-equal outputs);
   ``flash_attention`` against its plain version (bf16 within 2e-2, f32
   within 2e-5) at Mixtral's attention shapes (H32/Hkv8, D128, window 4096:
   S 2048, ragged S 5000, Sq 512 against Sk 4096), at Gemma-7B's (H16/16,
   D256, no window, the same three lengths, f32 and bf16), at Zamba2's
   shared block (H32/32, D64), at phase 5e's shapes (Qwen2-VL's H12/2
   D128 S2048, a GQA group of 6; Whisper's encoder, H16/16 D64 without a
   mask over 1500 frames at B8 and 4096 at B1, and its cross attention,
   32 and 1 queries against 1500 frames at B8), on the grid of
   ``tests/test_kernels.py`` and at the kernels' tile edges (lengths 1,
   15, 17, 63, 65, 129, q_offset off the tile, windows whose edge falls
   inside a tile, a group of 6, one query against 65 keys without a mask;
   D 16-256, f32 and bf16); at Mixtral's D128 S2048, Whisper's encoder,
   its cross attention at Sq 32 and 1 and Gemma's D256, at most 1% of the
   bf16 outputs may differ from the plain version's (P V at the
   reference's fp32 precision: P's two bf16 halves);
   ``router_topk`` against its plain version
   (experts, positions and keep flags equal) at T 8/2048/5000 with E 8,
   K 2, at E 64/256/384 with K up to 8, and at Kimi-K2's E 384 top-8 at
   phase 5d's decode batch (T 8) and each of its prompt lengths;
   ``ssd_scan`` against its plain
   version, y and the final state, at Zamba2's serving shapes (B1 H64, one
   group of q/k, N = P = 64, chunk 256; S 2048, ragged 5000, and 100 under
   the chunk, B 4, tail chunks of 9 and 5 steps; in the model path's types
   and in f32 and bf16), N and P past one 64 tile, on the grid of
   ``tests/test_kernels.py`` and at xLSTM's N = P = 384 and P = 1 (B1 H4,
   in the mLSTM block's types at S 2048 and each of phase 5d's prompt
   lengths, and in all three types at S 1000; f32
   within 1e-4 of the output's scale: sums in another order; a bf16 y one
   bf16 step, 2**-7 relative, more);
3. main path — ``pipeline(pre, all_to_all([left]*2, experts), post)``
   compiled for the device and run through ``FFGraph.compile(...).run`` at
   the widths of the repo's Mixtral-8x7B config (d_model 4096, moe_d_ff
   14336, 8 SwiGLU experts, bf16, top-1), T = 4096 tokens, weights from a
   seed: once lossless, once with ``a2a_capacity_factor=1.25``; the kernels'
   launch counts must rise, and the outputs must agree with a plain
   composition on the card (route with the plain version, each expert
   applied to its routed tokens);
4. overlapped hybrid — the same segment between host stages, microbatch
   512 and 4 in flight: byte-equal to the synchronous boundary, rows in
   stream order;
5. serve — ``repro_torch.serving.InferenceEngine`` at the widths of the
   repo's Mixtral-8x7B config (d_model 4096, 32/8 heads of 128, 8 experts
   top-2 of 14336, vocab 32000, window 4096, bf16), cut to 4 of its 32
   layers, random weights from a torch.Generator seeded 0; max_batch 8,
   cache_len 4096 (the window, so decode runs on the ring); 16 requests
   with prompts of 100-3000 tokens (numpy seed 0) and one of 5000 (the
   window mask and the cache roll), 32 new tokens each.  Every request must
   finish with its 32 tokens; ``flash_attention`` must have launched
   layers x prefills times and ``router_topk`` layers x (prefills + decode
   steps); one request's tokens must equal a manual prefill + decode loop
   on the card.  The decode step, the slot insert and the engine's decode
   tick must queue their work without making the host wait for the card
   (``torch.cuda.set_sync_debug_mode("error")``).  Prints prefill and
   decode tokens/s and ms per decode step, split into the host's time to
   queue a step and the step's device time (CUDA graph);
5b. hybrid serve — the same engine and checks on the repo's Zamba2-1.2B
   config at full width and full depth (d_model 2048, 38 Mamba2 layers of
   64 SSM heads with N = P = 64, one shared attention block called 5 times,
   32/32 heads of 64, window 4096, vocab 32000; 1.17 B parameters, bf16),
   random weights from a torch.Generator seeded 0, the same 16 requests;
   ``ssd_scan`` must have launched 38 x prefills times and
   ``flash_attention`` 5 x prefills;
5c. train — ``repro_torch.runtime.driver.TrainDriver`` over
   ``make_train_step`` (AdamW, ``cosine_warmup(3e-3, 20, 6)``, every block
   under activation checkpointing) and ``make_pipeline(SyntheticLMSource)``
   for 6 steps: Zamba2-1.2B at full width and depth at B4 x S2048, then
   Mixtral-8x7B at full width cut to 1 of its 32 layers at B2 x S2048,
   weights from seed 0.  The loss must be finite at every step and lower at
   the last than at the first; each kernel of the path must launch twice
   per block per step (forward and recompute: Zamba2 ``ssd_scan`` 76 and
   ``flash_attention`` 10, Mixtral ``flash_attention`` and ``router_topk``
   2); the driver's final checkpoint (under ``build/``, deleted after) must
   restore bit for bit.  Prints the train tokens/s (B*S over the median
   step after the first), each step's forward, backward and optimizer ms
   (CUDA events), the peak memory, the checkpoint's bytes and seconds, and
   a profile of one step with the recompute backward of attention and
   ``ssd_scan`` (their ``record_function`` ranges) on their own.  Then one
   loss and gradient of reduced Zamba2 and Mixtral on the card against
   the CPU (loss within 2e-2, every leaf's cosine >= 0.99), the router's
   weight gradient through the kernel against the plain recompute's, and
   ff-tiny through the driver with a failure injected at step 6 (one
   restart);
5d. families — the same engine and checks on six more of the repo's
   configs in turn, at full width, each built from a torch.Generator seeded
   0, served and freed before the next: xLSTM-125m whole (12 = 3 x (3
   mLSTM + 1 sLSTM); ``ssd_scan`` 2 x 9 x prefills at N = P = 384 and
   P = 1), Gemma-7B whole (28 layers, D 256 attention, gelu), Llama-3.2-3B
   whole (28), Yi-34B at 50 of 60 layers, Mistral-Large-123B at 23 of 88
   and Kimi-K2 at 1 of 61 (384 experts top-8 and a shared expert;
   ``router_topk`` per prefill and decode step): 8 requests of 100-3000
   prompt tokens (numpy seed 0), 16 new tokens each, max_batch 8,
   cache_len 4096.  Prints each model's prefill tokens/s, decode ms per
   step (host and device), peak memory and seconds;
5e. front ends — Qwen2-VL-2B whole (28 layers, 12/2 heads of 128, M-RoPE)
   through the same engine and checks with phase 5d's requests (text), then
   through ``make_prefill_step`` / ``make_decode_step`` at B4 x S2048 with
   N(0, 0.1²) vision embeddings (16 text tokens, a 32 x 32 grid, text) and
   their M-RoPE ids, 16 decode steps; Whisper-medium whole (24 + 24
   layers, LayerNorm, gelu) through the steps: B8 clips of 1500 frames,
   32-token prompts, 64 greedy steps (cache 448), then B1 x 4096 frames.
   ``flash_attention`` must launch once a layer a prefill (Whisper: encoder,
   decoder self and cross) and, for Whisper, once a decoder layer a decode
   step; logits must be finite; every decoder block's decode step at
   position S must equal its prefill's row S within 3e-2 of its scale
   (``block_walk``: the random models are chaotic, so whole-model
   decode-versus-prefill numbers are printed, not held); and both models,
   reduced, must match the port on the CPU block by block.  Prints
   prefill tokens/s, encoder frames/s, decoder tokens/s, decode ms per
   step (host and device), peak memory and seconds;
6. times — each kernel and its plain version (CUDA events, median of
   repeats) beside its bound: the a2a kernels at the phase-3 shapes, the
   phase-5 kernels at its shapes (attention at S 2048, Mixtral's D128 and
   Zamba2's D64, with ``scaled_dot_product_attention`` beside it),
   ``ssd_scan`` at phase 5b's
   (B1 H64 S2048 N64 P64, chunk 256), the same kernels at phase 5c's
   training shapes, phase 5d's (attention at Gemma's D256, B1 H16 S2048,
   beside ``scaled_dot_product_attention``; Kimi's router at E384 K8;
   ``ssd_scan`` at xLSTM's B1 H4 S2048 N = P = 384 and P = 1), phase 5e's
   (attention at Qwen2-VL's group of 6, Whisper's encoder and its cross
   attention at Sq 32 and 1, beside ``scaled_dot_product_attention``), and
   the phase-3 items/s; then the
   routing kernels at :data:`ROUTE_TIMES` (``router_topk`` at decode's T 8,
   prefill's T 1859-5000 and wide routers; ``a2a_route`` at T 512 and 4096),
   each with its grid, beside an empty kernel's time (the latency floor)
   and the one-block kernel's time at the same shape;
7. the accelerator and the process tier — ``TorchAccelerator`` offloading
   one Mixtral-8x7B MoE block (d_model 4096, 8 experts top-2 of 14336,
   ``router_topk`` on the card): 32 tasks of 2048 tokens from pinned
   memory, 8 in flight, equal to a synchronous loop of the same calls bit
   for bit, offloaded in less host time than the blocks' device time,
   ``router_topk`` launched 32 times; phase 3's hop behind a farm of 4
   numpy featuriser workers, on threads and as a ``host_process`` farm
   forked after CUDA is up (the same items; the process run in stream
   order; the a2a kernels launched); Zamba2-1.2B whole through
   ``TrainDriver`` at B4 x S2048 for 3 steps, fed by
   ``make_pipeline(compute_workers=4)`` (a process farm) and twice by one
   compute stage: the same batches bit for bit, losses as close as the two
   single-stage runs are, ``ssd_scan`` and ``flash_attention`` launched
   twice a block a step; and the reference's 2 x 2 heterogeneous
   ``all_to_all`` on 4 worker processes (2000 items, routed by value and
   round-robin: in input order, equal to the expected outputs; the thread
   and device runs the same multisets).  Prints tasks/s, items/s on threads
   and processes, the calibrated shm hop and train tokens/s of each feed;
8. the adaptive runtime — phase 7's featuriser graph compiled with
   ``adaptive=True`` (the farm an ``AdaptiveFarmNode`` on host threads, the
   hop on the device, microbatch 512, 4 in flight) under
   ``Supervisor(runner, interval=0.02)``: the Supervisor must migrate the
   farm to ``host_process`` while the stream runs, the output must be in
   stream order and byte-equal to phase 7's process run, and the a2a
   kernels must launch; afterwards the compiler's annotate and place
   passes, without overrides or a sample, must read the featuriser's cost
   from the observed table.  Mixtral-8x7B at 4 of 32 layers through
   ``InferenceEngine(adaptive=True, max_pending=8)`` under a burst of phase
   5's 16 requests: the Supervisor's events must show a pressure change
   and a later restore, every request end as a ``Request`` or an
   ``Overloaded``, request 0 give phase 5's tokens, ``flash_attention``
   and ``router_topk`` launch.  Zamba2-1.2B whole through ``TrainDriver``
   at B4 x S2048 for 3 steps fed by ``make_pipeline(compute_workers=4,
   adaptive=True)``: batches and losses bit for bit phase 7's process-fed
   run; then ``launch/train.py --adaptive`` on ff-tiny for 6 steps.
   Prints items/s beside phase 7's, the migration's time and latency,
   every event, the Supervisor's loop time, tokens/s and the count shed;
9. the remote tier and the device boundary — phase 7's featuriser graph
   with ``farm(featurise, n=4)`` on 4 loopback worker pools
   (``spawn_loopback_pool``, forked after CUDA is up; ``host_remote`` x4,
   the hop on the device, microbatch 512, 4 in flight): the output in
   stream order and byte-equal to phase 7's process run, the a2a kernels
   launched; once more at ``net_credit=64``; the same graph under
   ``Supervisor(migrate=False)``: byte-equal again, the calibration
   ``observed`` with the net hop moved from the measured one and the
   featuriser's observed record refreshed; ``annotate``/``place`` with the
   pool and no override (where the cost model puts the featuriser is
   printed, not held); ``python -m repro_torch.launch.worker`` serving one
   lane of ``demo_fn`` (5 items squared, a ``WorkerStats`` of 5); and
   ``perf_model.calibrate()`` on the card, whose boundary constants
   (fused segment, h2d and d2h bandwidth, overlap efficiency) are printed
   beside ``place()``'s per-item cost of phase 4's segment under the
   defaults and under them (printed, not held), and phase 4's measured
   times.  Prints items/s beside phase 7's, the net hop and the farm's
   ``node_stats()``.

The last line of standard output is a JSON object with ``"ok": true`` and
the device; the line before it the card's name and power limit, and the
line before that the ``kernels`` record.  Without a CUDA
device, or without the ``src/repro_torch`` package beside this file, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM, f32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM, dense bf16 on the tensor cores
TF32_FLOPS = 495e12              # H100 SXM, dense TF32 on the tensor cores


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# phase 1: the card and the build
# ---------------------------------------------------------------------------
def phase_card() -> dict:
    from repro_torch.kernels import backend
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    say(f"[card] {card}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    secs = backend.build_all(verbose=True)
    for name, s in secs.items():
        say(f"[build] {name}.cu {s:.2f} s")
    check_spills(backend)
    check_tensor_cores(backend)
    return {"card": card, "build_s": secs}


def ptxas_usage(report: str) -> dict:
    """(registers, spill store bytes, spill load bytes) per kernel of one
    ptxas report (``-Xptxas -v``), keyed as :func:`sass_mma_counts` keys
    them."""
    import re
    usage, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = kernel_name(m.group(1))
            usage[fn] = [0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            usage[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            usage[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in usage.items()}


def check_spills(backend) -> None:
    """Print each kernel's registers and spill bytes; fail if an instance
    of the attention kernels spills (its D 256 layout is chosen not to).
    A library built before this run has no report."""
    if "flash_attention" not in backend.PTXAS_REPORT:
        say("[build] flash_attention: built before this run, no ptxas report")
    for name in sorted(backend.PTXAS_REPORT):
        usage = ptxas_usage(backend.PTXAS_REPORT[name])
        say(f"[build] {name}: (registers, spill store B, spill load B) per "
            f"kernel {usage}")
        spilled = {fn: u for fn, u in usage.items()
                   if fn.startswith("flash_fwd_kernel") and (u[1] or u[2])}
        if spilled:
            fail(f"{name}: instances that spill: {spilled}")


# the kernels that must run on the tensor cores: (library, name prefix,
# count of instantiations): the bf16 flash kernel for each head dim, the
# recurrence with bf16 q/k (template <QK_BF16, V_BF16>) for f32 and bf16 v;
# their SASS must hold HMMA (mma.sync) or HGMMA (wgmma)
TENSOR_CORE_KERNELS = (("flash_attention", "flash_fwd_kernel_tc<", 5),
                       ("ssd_scan", "ssd_scan_kernel<1,", 2))


def sass_mma_counts(lib: pathlib.Path) -> dict:
    """HMMA/HGMMA instructions per kernel of a built library, by
    ``cuobjdump -sass``; keys are the kernels' names with their template
    arguments as mangled (``ILi64EE`` -> ``<64>``)."""
    import os
    import re
    tool = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                        "bin", "cuobjdump")
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    if res.returncode != 0:
        fail(f"cuobjdump -sass {lib.name} failed: {res.stderr.strip()}")
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            fn = m.group(1) if fn in counts else fn
            counts[fn] = 0
        elif fn is not None and re.search(r"\bH(?:G)?MMA\b", line):
            counts[fn] += 1
    return counts


def kernel_name(mangled: str) -> str:
    """``_ZN<len><ns>...<len><name>I<args>E...`` -> ``name<args>``."""
    import re
    rest, parts = mangled[3:] if mangled.startswith("_ZN") else "", []
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group()
        parts.append(rest[len(n):len(n) + int(n)])
        rest = rest[len(n) + int(n):]
    if not parts:
        return mangled
    args = re.match(r"I((?:L[a-z]+-?\d+E)+)E", rest)
    return parts[-1] + ("<" + ",".join(re.findall(r"L[a-z]+(-?\d+)E",
                                                  args.group(1))) + ">"
                        if args else "")


def check_tensor_cores(backend) -> None:
    """Fail unless every bf16 instantiation of the tensor-core kernels
    holds HMMA or HGMMA instructions; print the count per kernel."""
    for name, symbol, n in TENSOR_CORE_KERNELS:
        counts = sass_mma_counts(backend.library_path(name))
        say(f"[build] {name}: HMMA/HGMMA per kernel {counts}")
        tc = {fn: c for fn, c in counts.items() if fn.startswith(symbol)}
        if len(tc) != n or not all(tc.values()):
            fail(f"{name}: expected {n} instantiations of {symbol} with "
                 f"HMMA/HGMMA instructions, found {tc}")


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version on the card
# ---------------------------------------------------------------------------
def phase_kernels(dev: torch.device) -> dict:
    from repro_torch.kernels.a2a_fused import (a2a_combine, a2a_combine_plain,
                                               a2a_route, a2a_route_plain)
    g = torch.Generator().manual_seed(1)
    checks = 0
    err = {"a2a_route": 0.0, "a2a_combine": 0.0}
    for E in (2, 8, 64):
        for T in (1, 37, 512, 1000, 4099):   # 512: the hybrid's microbatch
            logits = torch.randn(T, E, generator=g).to(dev)
            for cap in (T, max(1, T // E - 3), 1):
                idx, pos, keep = a2a_route(logits, cap)
                pidx, ppos, pkeep = a2a_route_plain(logits, cap)
                err["a2a_route"] = max(
                    err["a2a_route"], float((idx - pidx).abs().max()),
                    float((pos - ppos).abs().max()),
                    float((keep != pkeep).sum()))
                if not (torch.equal(idx, pidx) and torch.equal(pos, ppos)
                        and torch.equal(keep, pkeep)):
                    fail(f"a2a_route != plain at T={T} E={E} cap={cap}")
                checks += 1
                for dtype in (torch.float32, torch.bfloat16, torch.int32):
                    for item in ((), (5,), (3, 64)):
                        shape = (E, T) + item
                        if dtype == torch.int32:
                            ys = torch.randint(-1000, 1000, shape, generator=g,
                                               dtype=torch.int32).to(dev)
                        else:
                            ys = torch.randn(shape, generator=g).to(dtype).to(dev)
                        out = a2a_combine(ys, idx, keep)
                        ref = a2a_combine_plain(ys, idx, keep)
                        if out.dtype != ref.dtype or out.shape != ref.shape:
                            fail(f"a2a_combine gave {out.dtype} "
                                 f"{tuple(out.shape)}, plain {ref.dtype} "
                                 f"{tuple(ref.shape)}")
                        err["a2a_combine"] = max(
                            err["a2a_combine"],
                            float((out.double() - ref.double()).abs().max()))
                        if not torch.equal(out.view(torch.uint8),
                                           ref.view(torch.uint8)):
                            fail(f"a2a_combine != plain (bytes) at T={T} "
                                 f"E={E} cap={cap} {dtype} item={item}")
                        checks += 1
    say(f"[kernels] a2a_route, a2a_combine equal their plain versions "
        f"({checks} cases, max |err| {err})")
    err["flash_attention"], err["flash_attention_d256"], rows, n_flash = \
        check_flash(dev)
    err.update(rows)
    err["router_topk"], err["router_topk_e384"], n_router = check_router(dev)
    err["ssd_scan"], xlstm, n_ssd = check_ssd(dev)
    err.update(xlstm)
    gelu, n_gelu = check_gelu(dev)
    err.update(gelu)
    return {"checks": checks + n_flash + n_router + n_ssd + n_gelu,
            "max_abs_err": err}


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py
# (B, H, Hkv, Sq, Sk, D, causal, window, dtypes): Mixtral's attention at the
# serving shapes, then the grid of tests/test_kernels.py:22-30
BF16, F32 = (torch.bfloat16,), (torch.float32, torch.bfloat16)
# (B, H, Hkv, Sq, Sk, causal, window) at the edges of the kernels' 64-row
# tiles and 16-row mma fragments: lengths of 1, 15, 17, 63, 65 and 129,
# q_offset = Sk - Sq off the tile, windows whose edge falls inside a tile
FLASH_EDGES = [(1, 2, 2, 1, 1, True, 0), (2, 4, 2, 15, 15, True, 0),
               (1, 4, 1, 17, 129, True, 0), (1, 2, 2, 63, 63, False, 0),
               (1, 4, 2, 65, 65, True, 7), (1, 4, 4, 129, 129, True, 100),
               (1, 2, 1, 1, 65, True, 0), (1, 8, 2, 100, 1000, True, 300),
               (2, 2, 2, 65, 129, False, 0), (1, 4, 2, 129, 200, True, 33),
               (1, 12, 2, 65, 129, True, 0),     # a GQA group of 6
               (1, 2, 2, 1, 65, False, 0)]       # one query, every key
FLASH_CASES = [
    (1, 32, 8, 2048, 2048, 128, True, 4096, BF16),
    (1, 32, 8, 5000, 5000, 128, True, 4096, BF16),   # ragged, past the window
    (1, 32, 8, 512, 4096, 128, True, 4096, BF16),    # chunked prefill
    (1, 32, 32, 2048, 2048, 64, True, 4096, BF16),  # Zamba2's shared block
    (4, 32, 32, 2048, 2048, 64, True, 4096, BF16),  # Zamba2's training batch
    (2, 32, 8, 2048, 2048, 128, True, 4096, BF16),  # Mixtral's training batch
    (1, 16, 16, 2048, 2048, 256, True, 0, F32),      # Gemma-7B's D 256
    (1, 16, 16, 5000, 5000, 256, True, 0, F32),      # ragged
    (1, 16, 16, 512, 4096, 256, True, 0, F32),       # chunked prefill
    (1, 12, 2, 2048, 2048, 128, True, 0, BF16),      # Qwen2-VL's group of 6
    (8, 16, 16, 1500, 1500, 64, False, 0, F32),      # Whisper's encoder
    (1, 16, 16, 4096, 4096, 64, False, 0, F32),      # at its enc_len
    (8, 16, 16, 32, 1500, 64, False, 0, F32),        # cross attention:
    (8, 16, 16, 1, 1500, 64, False, 0, F32),         # prefill, decode
] + [(B, H, Hkv, Sq, Sk, D, c, w, F32)
     for B, H, Hkv, Sq, Sk, D in ((1, 2, 2, 128, 128, 64),
                                  (2, 4, 2, 256, 256, 64),
                                  (1, 4, 1, 128, 256, 32),
                                  (1, 2, 2, 128, 128, 128),
                                  (1, 4, 2, 100, 100, 16))
     for c, w in ((True, 0), (True, 64), (False, 0))
] + [(B, H, Hkv, Sq, Sk, D, c, w, F32) for D in (16, 32, 64, 128, 256)
     for B, H, Hkv, Sq, Sk, c, w in FLASH_EDGES]


# the cases at phase 5e's shapes, by the ``kernels`` row that reports them
FLASH_ROWS = {(1, 12, 2, 2048, 2048, 128, True, 0): "flash_attention_gqa6",
              (8, 16, 16, 1500, 1500, 64, False, 0):
              "flash_attention_encoder",
              (8, 16, 16, 32, 1500, 64, False, 0):
              "flash_attention_cross_prefill",
              (8, 16, 16, 1, 1500, 64, False, 0):
              "flash_attention_cross_decode"}


# bf16 also held against the output's scale: max |err| / max |want|.  At
# Sk >= 1500 with every key visible the outputs are small (std ~0.04, a
# weighted mean over 1500 unit-normal values), so 2e-2 absolute is half a
# typical value; there the scale check is what would see a dropped key tile,
# and each such case also plants one (the plain version without the keys
# past the last whole 64-key tile, 28 of 1500 or 64 of 4096), which must
# land past the limit.  Read on the card (NVIDIA H100 80GB HBM3, 700.00 W):
# every sound bf16 case within 0.0075 of the scale, the planted ones
# 0.2967-0.4287; the limit sits 6.7x over the one and 5.9x under the other
FLASH_SCALE_TOL = 5e-2

# P V at the reference's fp32 precision (P split into two bf16 halves): at
# these shapes (Mixtral's D128 S2048, Whisper's encoder B8 H16 S1500 D64
# without a mask, its cross attention at Sq 32 and 1 against Sk 1500,
# Gemma's D256 S2048) at most this share of the bf16 outputs may differ
# from the plain version's (fp32 throughout, rounded to bf16 once).  A CPU
# emulation of the kernel's rounding differs from the reference's Pallas
# kernel in 0.10-0.24% of them; with P rounded to bf16 in 34-40%
# (tests/test_torch_flash.py::test_tensor_core_p_v_keeps_the_references_precision)
FLASH_SHARE_CASES = {(1, 32, 8, 2048, 2048, 128, True, 4096),
                     (8, 16, 16, 1500, 1500, 64, False, 0),
                     (8, 16, 16, 32, 1500, 64, False, 0),
                     (8, 16, 16, 1, 1500, 64, False, 0),
                     (1, 16, 16, 2048, 2048, 256, True, 0)}
FLASH_MAX_SHARE = 0.01


def check_flash(dev: torch.device) -> tuple:
    """The worst bf16 error over every case, over those at D 256 (the
    ``flash_attention_d256`` row) and at each shape of :data:`FLASH_ROWS`
    (a dict by row), and the number of cases.  bf16 is also held to
    :data:`FLASH_SCALE_TOL` of the output's scale, and with every key
    visible over Sk >= 1500 a planted tail-drop must fail that limit."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator().manual_seed(3)
    worst, d256, n = 0.0, 0.0, 0
    rows = {name: 0.0 for name in FLASH_ROWS.values()}
    scaled, planted, shares = 0.0, [], {}
    for B, H, Hkv, Sq, Sk, D, causal, window, dtypes in FLASH_CASES:
        for dtype in dtypes:
            q = torch.randn(B, H, Sq, D, generator=g).to(dtype).to(dev)
            k = torch.randn(B, Hkv, Sk, D, generator=g).to(dtype).to(dev)
            v = torch.randn(B, Hkv, Sk, D, generator=g).to(dtype).to(dev)
            got = flash_attention(q, k, v, causal, window).float()
            want = flash_attention_plain(q, k, v, causal, window).float()
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            tol = FLASH_TOL[dtype]
            where = (f"B{B} H{H}/{Hkv} Sq{Sq} Sk{Sk} D{D} causal={causal} "
                     f"window={window} {dtype}")
            if not torch.allclose(got, want, rtol=tol, atol=tol):
                fail(f"flash_attention != plain at {where}: max |err| {e}")
            if dtype == torch.bfloat16:
                rel = e / float(want.abs().max())
                scaled = max(scaled, rel)
                if rel > FLASH_SCALE_TOL:
                    fail(f"flash_attention != plain at {where}: max |err| "
                         f"{e} is {rel:.4f} of the output's scale, above "
                         f"{FLASH_SCALE_TOL}")
                if not causal and Sk >= 1500:
                    keep = Sk - (Sk % 64 or 64)
                    drop = flash_attention_plain(q, k[:, :, :keep],
                                                 v[:, :, :keep], False,
                                                 0).float()
                    fault = float((got - drop).abs().max()
                                  / drop.abs().max())
                    planted.append(round(fault, 4))
                    if fault <= FLASH_SCALE_TOL:
                        fail(f"the scale check does not see a dropped key "
                             f"tail at {where}: {fault:.4f}")
                key = (B, H, Hkv, Sq, Sk, D, causal, window)
                if key in FLASH_SHARE_CASES:
                    share = float((got != want).float().mean())
                    shares[f"B{B} H{H}/{Hkv} Sq{Sq} Sk{Sk} D{D}"] = round(
                        share, 5)
                    if share > FLASH_MAX_SHARE:
                        fail(f"flash_attention: {share:.4%} of the bf16 "
                             f"outputs differ from the plain version's at "
                             f"{where}, above {FLASH_MAX_SHARE:.0%}")
                worst = max(worst, e)
                if D == 256:
                    d256 = max(d256, e)
                row = FLASH_ROWS.get((B, H, Hkv, Sq, Sk, D, causal, window))
                if row:
                    rows[row] = max(rows[row], e)
            n += 1
            del q, k, v, got, want
    say(f"[kernels] flash_attention equals its plain version ({n} cases, "
        f"max |err| {worst:.3g} in bf16, at D 256 {d256:.3g}, at phase "
        f"5e's shapes {rows}, within 2e-2; f32 within 2e-5); bf16 within "
        f"{scaled:.4f} of the output's scale (limit {FLASH_SCALE_TOL}); "
        f"the kernel against the plain version without the keys past the "
        f"last whole 64-key tile, non-causal at Sk >= 1500: {planted} of "
        f"the scale (each must exceed the limit); the share of bf16 "
        f"outputs that differ from the plain version's {shares} (limit "
        f"{FLASH_MAX_SHARE})")
    if len(shares) != len(FLASH_SHARE_CASES):
        fail(f"flash_attention: the share was read at {sorted(shares)}, "
             f"not at every case of FLASH_SHARE_CASES")
    return worst, d256, rows, n


# (shape, dtype, storage offset, kernels row or None): the main paths'
# gelu calls (Whisper's MLP over B8 x 1500 frames and a decode step,
# Gemma-7B's 2567-token prefill, Zamba2's shared block at its training
# batch, there in f32 as a model with fp32 parameters runs it), then sizes
# under and off the kernel's 16-byte vectors and an unaligned view; a row
# "wide" draws magnitudes from 2**-140 to 2**100 (subnormal products,
# overflow to infinity, rounding carries into the exponent)
GELU_CASES = [((8, 1500, 4096), torch.bfloat16, 0, "gelu_stepwise"),
              ((8, 1, 4096), torch.bfloat16, 0, None),
              ((1, 2567, 24576), torch.bfloat16, 0, "gelu_stepwise_gemma"),
              ((4, 2048, 8192), torch.float32, 0, None),
              ((1,), torch.bfloat16, 0, None), ((7,), torch.float32, 0, None),
              ((3, 37, 64), torch.bfloat16, 0, None),
              ((5, 333), torch.bfloat16, 1, None),
              ((5, 333), torch.float32, 1, None),
              ((1 << 20,), torch.bfloat16, 0, "wide"),
              ((1 << 20,), torch.float32, 0, "wide")]


def check_gelu(dev: torch.device) -> tuple:
    """``gelu_stepwise`` against its plain version, bit for bit (each step
    rounds to the type in both); the worst error by ``kernels`` row and
    the number of cases."""
    from repro_torch.kernels.gelu_stepwise import (gelu_stepwise,
                                                   gelu_stepwise_plain)
    g = torch.Generator().manual_seed(17)
    rows = {}
    for shape, dtype, offset, row in GELU_CASES:
        n = math.prod(shape)
        x = torch.randn(n + offset, generator=g) * 4
        if row == "wide":
            x = x * torch.exp2(torch.randint(-140, 100, x.shape,
                                             generator=g).float())
        x = x.to(dtype).to(dev)[offset:].view(shape)
        got, want = gelu_stepwise(x), gelu_stepwise_plain(x)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            fail(f"gelu_stepwise != plain at {shape} {dtype} offset "
                 f"{offset}: max |err| {e}, "
                 f"{int((got != want).sum())} of {n} elements differ")
        if row and row != "wide":
            rows[row] = e
        del x, got, want
    say(f"[kernels] gelu_stepwise equals its plain version bit for bit "
        f"({len(GELU_CASES)} cases)")
    return rows, len(GELU_CASES)


# the prompt lengths of phase 5d's requests (serve_prompts at numpy seed 0:
# 8 of 100-3000 tokens), and the length its kernels are timed at
FAMILY_LENS = (2567, 1947, 1582, 882, 993, 218, 318, 147)
# (T, E, K): the serving shapes (decode T = max_batch, prefill T = prompt
# length; 300 and 512 are prompts that one block of many warps takes whole),
# the training batch's 4096 tokens, and wider routers; then Kimi-K2's E384
# top-8 at phase 5d's decode batch, its prefills and the timed 2048
ROUTER_CASES = [(8, 8, 2), (300, 8, 2), (512, 8, 2), (2048, 8, 2),
                (4096, 8, 2), (5000, 8, 2), (8, 64, 8),
                (2048, 64, 8), (2048, 256, 8), (5000, 256, 4), (5000, 384, 8),
                (8, 384, 8), (2048, 384, 8)] + [(T, 384, 8)
                                                for T in FAMILY_LENS]


def check_router(dev: torch.device) -> tuple:
    """The worst weight error over every case, over those at Kimi-K2's E384
    top-8 (the ``router_topk_e384`` row), and the number of cases."""
    from repro_torch.core.device import expert_capacity
    from repro_torch.kernels.router_topk import router_topk, router_topk_plain
    g = torch.Generator().manual_seed(4)
    worst, kimi, n = 0.0, 0.0, 0
    for T, E, K in ROUTER_CASES:
        logits = (torch.randn(T, E, generator=g) * 2).to(dev)
        for cap in (expert_capacity(T, E, K, 1.25), T, 1):
            w, idx, pos, keep = router_topk(logits, K, cap)
            pw, pidx, ppos, pkeep = router_topk_plain(logits, K, cap)
            if not (torch.equal(idx, pidx) and torch.equal(pos, ppos)
                    and torch.equal(keep, pkeep)):
                fail(f"router_topk != plain at T={T} E={E} K={K} cap={cap}")
            e = float((w - pw).abs().max())
            worst = max(worst, e)
            if (E, K) == (384, 8):
                kimi = max(kimi, e)
            n += 1
    if worst > 1.2e-7:               # one ulp of a weight near 1
        fail(f"router_topk weights differ from plain by {worst}")
    say(f"[kernels] router_topk equals its plain version ({n} cases: "
        f"experts, positions, keep equal; max |w err| {worst:.3g}, at E384 "
        f"K8 {kimi:.3g})")
    return worst, kimi, n


# (B, H, G, S, N, P, chunk, types): Zamba2's prefill (one group of q/k for
# 64 heads), the grid of tests/test_kernels.py:61-66, and xLSTM-125m's mLSTM
# (4 heads of N = P = 384, and its P = 1 normaliser) at phase 5d's prompt
# lengths and the timed 2048.  Types: "model" is the Mamba2 and mLSTM
# blocks' call (bf16 q/k, f32 v and log_a, f32 y), "f32" and "bf16" give
# every tensor that type.
SSD_ALL = ("model", "f32", "bf16")
SSD_CASES = [
    (1, 64, 1, 2048, 64, 64, 256, SSD_ALL),
    (4, 64, 1, 2048, 64, 64, 256, ("model",)),  # Zamba2's training batch
    (1, 64, 1, 5000, 64, 64, 256, SSD_ALL),     # ragged tail chunk
    (1, 64, 1, 100, 64, 64, 256, SSD_ALL),      # shorter than a chunk
    (4, 64, 1, 300, 64, 64, 256, SSD_ALL),      # B 4 prefill
    (1, 64, 1, 265, 64, 64, 256, SSD_ALL),      # a tail chunk of 9 steps
    (4, 64, 1, 133, 64, 64, 128, SSD_ALL),      # at B 4, a tail of 5
    (1, 2, 1, 200, 72, 130, 96, ("f32", "bf16")),   # N, P past a 64 tile
    (1, 2, 2, 128, 16, 32, 64, ("f32", "bf16")),
    (2, 3, 3, 256, 32, 64, 128, ("f32", "bf16")),
    (1, 1, 1, 64, 8, 8, 64, ("f32", "bf16")),
    (1, 4, 4, 1000, 384, 384, 256, SSD_ALL),
    (1, 4, 4, 1000, 384, 1, 256, SSD_ALL),
] + [(1, 4, 4, S, 384, P, 256, ("model",))
     for S in (2048,) + FAMILY_LENS for P in (384, 1)]
# f32: both versions sum in fp32, in other orders; a bf16 y may round to the
# other side of one bf16 step (2**-7 relative) on top
SSD_TOL = {"f32": 1e-4, "bf16": 2.0 ** -7}


def ssd_inputs(g: torch.Generator, dev: torch.device, B: int, H: int,
               G: int, S: int, N: int, P: int, types: str) -> tuple:
    """q, k (B,G,S,N) at scale 0.3, v (B,H,S,P), log_a in [-0.2, 0]: decays
    of a few dozen steps, as a trained Mamba2's dt * A gives."""
    qk_t = torch.float32 if types == "f32" else torch.bfloat16
    v_t = torch.bfloat16 if types == "bf16" else torch.float32
    q = (torch.randn(B, G, S, N, generator=g) * 0.3).to(qk_t).to(dev)
    k = (torch.randn(B, G, S, N, generator=g) * 0.3).to(qk_t).to(dev)
    v = torch.randn(B, H, S, P, generator=g).to(v_t).to(dev)
    la = (-torch.rand(B, H, S, generator=g) * 0.2).to(v_t).to(dev)
    return q, k, v, la


def check_ssd(dev: torch.device) -> tuple:
    """The worst error over every case, a dict of the worst over xLSTM's
    model-type cases by timing row (``ssd_scan_xlstm`` at P = 384,
    ``ssd_scan_xlstm_p1`` at P = 1), and the number of cases."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    g = torch.Generator().manual_seed(6)
    worst, n = 0.0, 0
    xlstm = {"ssd_scan_xlstm": 0.0, "ssd_scan_xlstm_p1": 0.0}
    for B, H, G, S, N, P, chunk, types in SSD_CASES:
        for t in types:
            q, k, v, la = ssd_inputs(g, dev, B, H, G, S, N, P, t)
            out = torch.float32 if t == "model" else None
            y, st = ssd_scan(q, k, v, la, chunk, out_dtype=out,
                             return_state=True)
            py, pst = ssd_scan_plain(q, k, v, la, chunk, out_dtype=out)
            torch.cuda.synchronize()
            for name, got, want, tol in (
                    ("y", y, py, SSD_TOL["bf16" if t == "bf16" else "f32"]),
                    ("state", st, pst, SSD_TOL["f32"])):
                if got.dtype != want.dtype or got.shape != want.shape:
                    fail(f"ssd_scan {name} {got.dtype} {tuple(got.shape)}, "
                         f"plain {want.dtype} {tuple(want.shape)}")
                got, want = got.float(), want.float()
                e = float((got - want).abs().max())
                scale = max(float(want.abs().max()), 1.0)
                if not bool(torch.isfinite(got).all()) or not torch.allclose(
                        got, want, rtol=tol, atol=1e-4 * scale):
                    fail(f"ssd_scan {name} != plain at B{B} H{H}/G{G} S{S} "
                         f"N{N} P{P} chunk {chunk} ({t}): max |err| {e}, "
                         f"scale {scale}")
                worst = max(worst, e)
                if N == 384 and t == "model":
                    row = "ssd_scan_xlstm" + ("_p1" if P == 1 else "")
                    xlstm[row] = max(xlstm[row], e)
            n += 1
            del q, k, v, la, y, st, py, pst
    say(f"[kernels] ssd_scan equals its plain version ({n} cases, y and "
        f"state; max |err| {worst:.3g}, xLSTM's model types "
        f"{ {r: float(f'{e:.3g}') for r, e in xlstm.items()} }; f32 within "
        f"1e-4 of the scale, bf16 y within 2**-7)")
    return worst, xlstm, n


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------
# src/repro/configs/mixtral_8x7b.py: d_model 4096, moe_d_ff 14336, 8 experts
D_MODEL, D_FF, N_EXPERTS, N_LEFT, T_TOKENS = 4096, 14336, 8, 2, 4096
CAPACITY_FACTOR = 1.25
# bf16 products on the card: the runner computes every expert on all 4096
# tokens, the plain composition only on each expert's routed rows, and
# cuBLAS may tile and sum the two shapes differently; each of the three
# bf16 roundings per expert may then differ by one ulp (2**-8 relative),
# so outputs must agree within 2**-5 of the largest output magnitude
REL_TOL = 2.0 ** -5


def make_model(dev: torch.device, seed: int = 0) -> dict:
    """Expert, router and norm weights from a seeded torch.Generator, moved
    to the card through ``from_numpy`` as bf16.  The router favours expert 0
    (bias 1.0), as a trained router is seldom balanced, so a capacity of
    1.25x the mean load drops tokens."""
    from repro_torch.core.params import from_numpy
    g = torch.Generator().manual_seed(seed)

    def randn(*shape: int, scale: float):
        return (torch.randn(*shape, generator=g) * scale).numpy()

    experts = []
    for _ in range(N_EXPERTS):   # one expert at a time bounds host memory
        experts.append(from_numpy(
            {"w1": randn(D_MODEL, D_FF, scale=D_MODEL ** -0.5),
             "w3": randn(D_MODEL, D_FF, scale=D_MODEL ** -0.5),
             "w2": randn(D_FF, D_MODEL, scale=D_FF ** -0.5)},
            dev, dtype=torch.bfloat16))
    rest = from_numpy({"router": randn(D_MODEL, N_EXPERTS,
                                       scale=D_MODEL ** -0.5),
                       "norm": 1.0 + randn(D_MODEL, scale=0.1)}, dev)
    bias = torch.zeros(N_EXPERTS, device=dev)
    bias[0] = 1.0
    return {"experts": experts, "router": rest["router"],
            "norm": rest["norm"], "bias": bias}


def make_fns(model: dict) -> dict:
    """The per-item stage functions (each maps one token)."""
    import torch.nn.functional as F

    def pre(x):                      # f32 token from the host -> bf16
        return x.to(torch.bfloat16)

    def left(x):                     # RMSNorm, the left workers of the hop
        x32 = x.float()
        y = x32 * torch.rsqrt((x32 * x32).mean() + 1e-6) * model["norm"]
        return y.to(torch.bfloat16)

    def router(y, n):                # learned top-1 router
        return torch.argmax(y.float() @ model["router"] + model["bias"])

    def expert(w):
        def swiglu(x):
            return (F.silu(x @ w["w1"]) * (x @ w["w3"])) @ w["w2"]
        return swiglu

    def post(y):
        return y.float()

    return {"pre": pre, "left": left, "router": router, "post": post,
            "experts": [expert(w) for w in model["experts"]]}


def build_graph(fns: dict, host_stages: bool = False):
    from repro_torch.core import all_to_all, pipeline
    hop = all_to_all([fns["left"]] * N_LEFT, fns["experts"],
                     router=fns["router"])
    if not host_stages:
        return pipeline(fns["pre"], hop, fns["post"])
    return pipeline(host_in, fns["pre"], hop, fns["post"], host_out)


def host_in(x):                      # host side of the boundary: the token
    import numpy as np               # as the f32 array the device stage takes
    return np.asarray(x, dtype=np.float32)


def host_out(y):
    return y


def plain_composition(fns: dict, xs: torch.Tensor, cap: int):
    """The hop without the runner or the kernels: left map, router, the
    plain route, each expert on its routed tokens, dropped tokens zero."""
    from repro_torch.kernels.a2a_fused import a2a_route_plain
    vmap = torch.func.vmap
    y = vmap(fns["left"])(vmap(fns["pre"])(xs))
    e = vmap(lambda t: fns["router"](t, N_EXPERTS))(y).to(torch.int32)
    logits = torch.nn.functional.one_hot(e.long() % N_EXPERTS,
                                         N_EXPERTS).float()
    idx, _pos, keep = a2a_route_plain(logits, cap)
    out = torch.zeros_like(y)
    for j, fn in enumerate(fns["experts"]):
        rows = ((idx == j) & keep).nonzero().squeeze(1)
        if rows.numel():
            out[rows] = vmap(fn)(y[rows])
    return vmap(fns["post"])(out), keep


def compare(name: str, got, want: torch.Tensor) -> float:
    import numpy as np
    got_t = torch.from_numpy(np.stack(got)).to(want.device)
    if got_t.shape != want.shape or got_t.dtype != want.dtype:
        fail(f"{name}: output {tuple(got_t.shape)} {got_t.dtype}, expected "
             f"{tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got_t).all()):
        fail(f"{name}: non-finite outputs")
    err = float((got_t - want).abs().max())
    scale = float(want.abs().max())
    if err > REL_TOL * scale:
        fail(f"{name}: max |err| {err} > {REL_TOL} x max |ref| {scale}")
    return err


def phase_main_path(dev: torch.device) -> dict:
    import numpy as np
    from repro_torch.core import CompileConfig
    from repro_torch.core.device import expert_capacity
    from repro_torch.core.plan import single_device_plan
    from repro_torch.kernels.a2a_fused import a2a_combine, a2a_route
    t0 = time.perf_counter()
    model = make_model(dev)
    fns = make_fns(model)
    say(f"[main] weights: {N_EXPERTS} experts {D_MODEL}x{D_FF} bf16 from "
        f"seed 0 in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    tokens = rng.standard_normal((T_TOKENS, D_MODEL), dtype=np.float32)
    stream = list(tokens)
    xs = torch.from_numpy(tokens).to(dev)
    cap = expert_capacity(T_TOKENS, N_EXPERTS, 1, CAPACITY_FACTOR)
    plan = single_device_plan()
    runs = {}
    a2a_route.launches = 0
    a2a_combine.launches = 0
    for label, cf in (("lossless", None), ("capacity", CAPACITY_FACTOR)):
        runner = build_graph(fns).compile(config=CompileConfig(
            plan=plan, mode="device", a2a_capacity_factor=cf))
        t1 = time.perf_counter()
        out = runner.run(stream)
        dt = time.perf_counter() - t1
        runs[label] = (runner, out, dt)
    launches = {"a2a_route": a2a_route.launches,
                "a2a_combine": a2a_combine.launches}
    say(f"[main] kernel launches on the main path: {launches}")
    for name, n in launches.items():
        if n < 1:
            fail(f"{name} was not launched on the main path")
    result = {"launches": launches, "cap": cap, "stream": stream,
              "fns": fns, "plan": plan, "xs": xs}
    for label, cf in (("lossless", None), ("capacity", CAPACITY_FACTOR)):
        runner, out, dt = runs[label]
        want, keep = plain_composition(fns, xs, T_TOKENS if cf is None
                                       else cap)
        err = compare(f"main path ({label})", out, want)
        dropped = int((~keep).sum())
        if cf is not None and dropped == 0:
            fail("capacity run dropped no token: the check is vacuous")
        if cf is None and dropped:
            fail("lossless run dropped tokens")
        where = [f"{d}->{p.target}" for d, p in runner.placements]
        say(f"[main] {label}: {type(runner).__name__} {where}, "
            f"{len(out)} items in {dt:.3f} s (first run), max |err| {err:.3g} "
            f"vs plain composition, {dropped} dropped (cap "
            f"{T_TOKENS if cf is None else cap})")
        result[label] = out
    return result


# ---------------------------------------------------------------------------
# phase 4: the same segment behind host stages, overlapped
# ---------------------------------------------------------------------------
HYBRID_MICROBATCH = 512         # phase 4's boundary: items a microbatch


def phase_hybrid(main: dict) -> dict:
    import numpy as np
    from repro_torch.core import CompileConfig
    placements = {0: "host", 1: "device", 2: "device", 3: "device",
                  4: "host"}
    outs, times = {}, {True: [], False: []}
    # the first two runs warm up each form (cuBLAS's 512-row kernels, the
    # pinned host buffers); then the two alternate
    for k, overlap in enumerate((True, False, True, False, False, True)):
        runner = build_graph(main["fns"], host_stages=True).compile(
            config=CompileConfig(plan=main["plan"], placements=placements,
                                 microbatch=HYBRID_MICROBATCH,
                                 inflight=4, overlap=overlap))
        if type(runner).__name__ != "HybridRunner":
            fail(f"hybrid graph compiled to {type(runner).__name__}")
        t1 = time.perf_counter()
        outs[overlap] = runner.run(main["stream"])
        if k >= 2:
            times[overlap].append(time.perf_counter() - t1)
        if k == 5:
            stats = [s for s in runner.stats()["graph"]["stages"]
                     if s.get("backend") == "device"]
            say(f"[hybrid] boundary {stats[0]['boundary']}")
    times = {o: sum(ts) / len(ts) for o, ts in times.items()}
    a, b = outs[True], outs[False]
    if len(a) != len(b) or any(x.tobytes() != y.tobytes()
                               for x, y in zip(a, b)):
        fail("overlapped hybrid run differs from the synchronous one")
    ref = main["lossless"]
    want = torch.from_numpy(np.stack(ref))
    err = compare("hybrid vs main path", a, want)
    say(f"[hybrid] {len(a)} items, overlapped {times[True]:.4f} s, sync "
        f"{times[False]:.4f} s (mean of 2 alternating runs each); "
        f"byte-equal; in stream order (max |err| {err:.3g} vs the "
        f"whole-batch run)")
    return {"overlap_s": times[True], "sync_s": times[False]}


# ---------------------------------------------------------------------------
# phase 5: the serving path at Mixtral-8x7B's width
# ---------------------------------------------------------------------------
SERVE_LAYERS = 4                 # of Mixtral's 32: ~12.1 GB of bf16 weights
SERVE_BATCH, SERVE_CACHE = 8, 4096
SERVE_REQUESTS, SERVE_NEW = 16, 32
PROMPT_LENS, LONG_PROMPT = (100, 3000), 5000


def serve_config():
    import dataclasses
    from repro_torch.configs import get
    return dataclasses.replace(get("mixtral-8x7b"), n_layers=SERVE_LAYERS)


def kernel_fns() -> dict:
    """The model paths' kernel wrappers, each with its launch count."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gelu_stepwise import gelu_stepwise
    from repro_torch.kernels.router_topk import router_topk
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"flash_attention": flash_attention, "router_topk": router_topk,
            "ssd_scan": ssd_scan, "gelu_stepwise": gelu_stepwise}


def zero_launches() -> dict:
    kernels = kernel_fns()
    for fn in kernels.values():
        fn.launches = 0
    return kernels


def read_launches(kernels: dict) -> dict:
    """The kernels that launched, with their counts."""
    return {n: f.launches for n, f in kernels.items() if f.launches}


def nonzero(want: dict) -> dict:
    return {n: c for n, c in want.items() if c}


def expected_launches(cfg, prefills: int, steps: int) -> dict:
    """Launches a model path must make over ``prefills`` prefills and
    ``steps`` decode steps: attention once per attention block per prefill
    (decode's self-attention is plain; a ``dec`` block adds its cross
    attention, which runs the kernel at every decode step too), the router
    once per MoE layer per prefill and decode step, the recurrence once per
    Mamba2 layer and twice per mLSTM layer (numerator and normaliser) per
    prefill (decode runs the plain step), and for a gelu model the gelu
    once per dense MLP per prefill and decode step (the encoder's at
    prefill only)."""
    n = {}
    for kind, count in cfg.segments:
        n[kind] = n.get(kind, 0) + count
    dense = n.get("dense", 0) + n.get("shared_attn", 0)
    enc, dec = n.get("enc", 0), n.get("dec", 0)
    want = {"flash_attention": (dense + n.get("moe", 0) + enc + 2 * dec)
            * prefills + dec * steps}
    if n.get("moe"):
        want["router_topk"] = n["moe"] * (prefills + steps)
    if n.get("mamba2") or n.get("mlstm"):
        want["ssd_scan"] = (n.get("mamba2", 0) + 2 * n.get("mlstm", 0)) \
            * prefills
    if cfg.act == "gelu" and dense + enc + dec:
        want["gelu_stepwise"] = (dense + enc + dec) * prefills \
            + (dense + dec) * steps
    return want


def describe(cfg) -> str:
    parts = [f"{cfg.name} at d_model {cfg.d_model}",
             f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}"]
    if cfg.n_experts:
        parts.append(f"{cfg.n_experts} experts top-{cfg.top_k} of "
                     f"{cfg.moe_d_ff}")
    kinds = {}
    for kind, count in cfg.segments:
        kinds[kind] = kinds.get(kind, 0) + count
    if "mamba2" in kinds:
        from repro_torch.models.ssm import mamba2_dims
        d_inner, H = mamba2_dims(cfg)
        parts.append(f"{kinds['mamba2']} mamba2 layers of {H} SSM heads "
                     f"(N {cfg.ssm_state}, P {cfg.ssm_headdim}, d_inner "
                     f"{d_inner}, chunk {cfg.gla_chunk})")
    if "mlstm" in kinds:
        from repro_torch.models.xlstm import mlstm_dims
        d_inner, H, P = mlstm_dims(cfg)
        parts.append(f"{kinds['mlstm']} mlstm layers of {H} heads (N = P = "
                     f"{P}, d_inner {d_inner}, chunk {cfg.gla_chunk}), "
                     f"{kinds.get('slstm', 0)} slstm layers")
    if "shared_attn" in kinds:
        parts.append(f"a shared {cfg.act} block called "
                     f"{kinds['shared_attn']} times (window "
                     f"{cfg.shared_attn_window}, d_ff {cfg.d_ff})")
    if "enc" in kinds:
        parts.append(f"{kinds['enc']} encoder and {kinds['dec']} decoder "
                     f"layers (cross attention over up to {cfg.enc_len} "
                     f"frames), {cfg.norm} norm"
                     + ("" if cfg.use_rope else ", no RoPE"))
    if cfg.mrope:
        parts.append(f"M-RoPE (theta {cfg.rope_theta:g})")
    if cfg.family in ("dense", "vlm", "encdec"):
        parts.append(f"{cfg.act} MLP of {cfg.d_ff}")
    parts.append(f"vocab {cfg.vocab}, window {cfg.window}")
    return ", ".join(parts) + f"; segments {kinds}"


def serve_prompts(vocab: int, n: int = SERVE_REQUESTS,
                  lens: tuple = PROMPT_LENS, long: int = LONG_PROMPT,
                  seed: int = 0) -> list:
    """n prompts from numpy seed 0: n-1 of ragged length in ``lens`` and one
    of ``long`` tokens in the middle (n of ragged length if ``long`` is
    None)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sizes = [int(x) for x in rng.integers(lens[0], lens[1] + 1,
                                          n - (long is not None))]
    if long is not None:
        sizes.insert(n // 2, long)
    return [rng.integers(0, vocab, m, dtype=np.int32) for m in sizes]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def no_host_wait(dev: torch.device):
    """Raise if the code inside makes the host wait for the card: a read of
    a device value, a blocking copy, a synchronize."""
    if dev.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


# kernel families by a substring of the CUDA kernel's name (cuBLAS on
# Hopper names its kernels nvjet_*, sm90_xmma_* or *gemm*)
KERNEL_FAMILIES = (("ssd_scan", ("ssd_scan_kernel",)),
                   ("flash_attention", ("flash_fwd_kernel",)),
                   ("router_topk", ("router_topk", "route_kernel")),
                   ("matmul (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
                   ("elementwise (torch)", ("elementwise", "CatArray")),
                   ("reductions (torch)", ("reduce", "scan", "softmax")))


def _kernel_us(event) -> float:
    """Device time of the kernels an op and every op under it launched."""
    return sum(k.duration for k in event.kernels) + \
        sum(_kernel_us(c) for c in event.cpu_children)


def device_breakdown(dev: torch.device, fn, ranges: tuple = (),
                     out: dict = None) -> str:
    """Device time of one call of ``fn`` by kernel family (torch.profiler,
    which reads the card's kernel records through CUPTI): milliseconds and
    kernel count per family; the names of the largest kernels of no family
    follow.  For each name in ``ranges`` (a ``record_function`` range in
    the code), the device time of the kernels launched inside it (summed
    over the range's calls and every op under them) goes into ``out`` as
    (ms, calls); those kernels are counted in the families too."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    fams, others, named = {}, [], {}
    for e in prof.events():
        if e.name in ranges and e.device_type == \
                torch.autograd.DeviceType.CPU:
            ms, calls = named.get(e.name, (0.0, 0))
            named[e.name] = (ms + _kernel_us(e) / 1e3, calls + 1)
    for e in prof.key_averages():
        if e.key in ranges:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = next((name for name, keys in KERNEL_FAMILIES
                    if any(k in e.key for k in keys)), "other")
        if fam == "other":
            others.append((us, e.key[:48]))
        ms, count = fams.get(fam, (0.0, 0))
        fams[fam] = (ms + us / 1e3, count + e.count)
    total = sum(ms for ms, _ in fams.values())
    if total <= 0:
        return "device time not measured (the profiler saw no kernel)"
    parts = [f"{fam} {ms:.3f} ms ({ms / total:.0%}, {c} kernels)"
             for fam, (ms, c) in sorted(fams.items(), key=lambda x: -x[1][0])]
    top = "; ".join(f"{k} {us / 1e3:.3f} ms"
                    for us, k in sorted(others, reverse=True)[:3])
    if out is not None:
        out.update(named)
    return (f"{total:.3f} ms of kernels: " + ", ".join(parts)
            + (f" [largest other: {top}]" if top else ""))


def manual_greedy(cfg, plan, params, prompt, n_new: int, batch: int,
                  cache_len: int) -> list:
    """The twin of the engine for one request (tests/test_serving.py:44):
    prefill it alone, then decode step by step at the engine's batch width
    with the request in slot 0 and the other slots idle, as the engine's
    free slots are."""
    from repro_torch.models.lm import LM
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    dev = plan.device
    prefill = make_prefill_step(cfg, plan, cache_len)
    decode = make_decode_step(cfg, plan, cache_len)
    logits, cache1 = prefill(params, {"tokens": torch.as_tensor(
        prompt, dtype=torch.int32, device=dev)[None]})
    caches = {kind: {n: torch.zeros(shape, dtype=dtype, device=dev)
                     for n, (shape, dtype) in kv.items()}
              for kind, kv in LM(cfg).cache_defs(batch, cache_len).items()}
    for kind, kv in cache1.items():
        for n, c in kv.items():
            caches[kind][n][:, 0] = c[:, 0]
    tok = torch.zeros(batch, 1, dtype=torch.int32, device=dev)
    tok[0, 0] = torch.argmax(logits[0, -1])
    pos = torch.zeros(batch, dtype=torch.int32, device=dev)
    pos[0] = len(prompt)
    step = torch.zeros(batch, dtype=torch.int32, device=dev)
    step[0] = 1
    out = [int(tok[0, 0])]
    for _ in range(n_new - 1):
        tok, _, caches = decode(params, caches, {"token": tok, "pos": pos})
        pos = pos + step
        out.append(int(tok[0, 0]))
    return out


def phase_serve(plan, cfg, prompts: list, max_new: int = SERVE_NEW,
                max_batch: int = SERVE_BATCH, cache_len: int = SERVE_CACHE,
                check_launches: bool = True, tag: str = "serve") -> dict:
    """Serve ``prompts`` through the engine; fail unless every request
    finishes with ``max_new`` tokens, the kernels launched as
    :func:`expected_launches` says, and request 0's tokens equal the manual
    loop.  ``check_launches=False`` is for a rehearsal on the CPU, where the
    kernels' plain versions run.  Prints the peak device memory above what
    earlier phases hold and the seconds the model took, all checks
    included."""
    from repro_torch.models.params import bytes_params, count_params
    from repro_torch.models.lm import LM
    from repro_torch.runtime.steps import make_decode_step, make_model, \
        make_prefill_step
    from repro_torch.serving import InferenceEngine, Request
    from repro_torch.serving.engine import _TICK, _insert
    dev = plan.device
    t0 = time.perf_counter()
    base = 0
    if dev.type == "cuda":
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    params = make_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    sync(dev)
    defs = LM(cfg).param_defs()
    say(f"[{tag}] {describe(cfg)}: {count_params(defs) / 1e9:.3f} B "
        f"parameters, {bytes_params(defs) / 1e9:.2f} GB of weights from "
        f"seed 0 in {time.perf_counter() - t0:.1f} s")
    eng = InferenceEngine(cfg, plan, params, max_batch=max_batch,
                          cache_len=cache_len)
    n_prompt = sum(len(p) for p in prompts)
    kernels = zero_launches()
    t1 = time.perf_counter()
    with eng:
        handles = [eng.submit(Request(prompt=p, max_new_tokens=max_new))
                   for p in prompts]
        outs = [h.result(timeout=900) for h in handles]
    wall = time.perf_counter() - t1
    n = len(prompts)
    want = expected_launches(cfg, n, eng.steps)
    launches = {name: kernels[name].launches for name in want}
    for i, out in enumerate(outs):
        if not isinstance(out, Request) or len(out.tokens) != max_new:
            fail(f"request {i} ended as {out!r}")
        if not all(0 <= t < cfg.vocab for t in out.tokens):
            fail(f"request {i}: token out of the vocabulary: {out.tokens}")
    say(f"[{tag}] {cfg.name}: {n} requests, {n_prompt} prompt tokens, "
        f"{n * max_new} generated in {wall:.2f} s ({eng.steps} decode "
        f"steps); kernel launches {launches}, expected {want}")
    if check_launches and launches != want:
        fail(f"kernel launches {launches} on the serving path, expected "
             f"{want}")
    manual = manual_greedy(cfg, plan, params, prompts[0], max_new, max_batch,
                           cache_len)
    if manual != outs[0].tokens:
        fail(f"engine tokens {outs[0].tokens} != manual loop {manual}")
    say(f"[{tag}] {cfg.name} request 0 ({len(prompts[0])} prompt tokens): "
        f"engine tokens "
        f"equal the manual prefill + decode loop ({max_new} tokens)")

    # the path's rates, each part alone: prefill of the longest and of a
    # median prompt, and the engine's batched decode step on its caches
    prefill = make_prefill_step(cfg, plan, cache_len)
    decode = make_decode_step(cfg, plan, cache_len)
    rates = {}
    for p in (max(prompts, key=len), sorted(prompts, key=len)[n // 2]):
        tokens = torch.as_tensor(p, dtype=torch.int32, device=dev)[None]
        rates[len(p)] = len(p) / prefill_secs(dev, prefill, params,
                                              {"tokens": tokens})

    # decode on the engine's caches: the host's time to queue a step, the
    # synchronised step and its device time alone (CUDA graph) split what a
    # step costs; then the step, the engine's slot insert and its decode
    # tick must queue their work without a host wait
    st = eng.state
    batch = {"token": st.cur_tok, "pos": st.pos}
    r = decode_rates(dev, decode, params, st.caches, batch)
    queue_ms, step_ms, dev_ms = r["queue_ms"], r["step_ms"], r["device_ms"]
    logits, cache1 = prefill(params, {"tokens": tokens})
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None].cpu()
    with no_host_wait(dev):
        decode(params, st.caches, batch)
        _insert(st, cache1, 0, tok, len(p))
        eng._decode_node.svc(_TICK)
    sync(dev)
    say(f"[{tag}] {cfg.name} prefill "
        f"{', '.join(f'{r:.1f} tokens/s at {m}' for m, r in rates.items())} "
        f"(B=1, median of 3); decode {step_ms:.2f} ms per step at batch "
        f"{max_batch} (mean of 10), {max_batch / step_ms * 1e3:.1f} "
        f"tokens/s: {queue_ms:.2f} ms of host time to queue a step, "
        f"{dev_ms:.2f} ms of device time (CUDA graph, median of 3), "
        f"{threading.active_count()} threads alive; no host wait in the "
        f"step, the slot insert or the engine's decode tick; whole run "
        f"{n * max_new / wall:.1f} generated tokens/s end to end")
    if dev.type == "cuda":
        for what, fn in ((f"prefill of {len(p)} tokens",
                          lambda: prefill(params, {"tokens": tokens})),
                         (f"decode step at batch {max_batch}",
                          lambda: decode(params, st.caches, batch))):
            say(f"[profile] {cfg.name} {what}: {device_breakdown(dev, fn)}")
    peak_gb = ((torch.cuda.max_memory_allocated(dev) - base) / 1e9
               if dev.type == "cuda" else float("nan"))
    model_s = time.perf_counter() - t0
    total_gb = (torch.cuda.get_device_properties(dev).total_memory / 1e9
                if dev.type == "cuda" else float("nan"))
    say(f"[{tag}] {cfg.name}: peak {peak_gb:.2f} GB of device memory above "
        f"the {base / 1e9:.2f} GB earlier phases hold, of the card's "
        f"{total_gb:.2f} GB; {model_s:.1f} s for "
        f"the model (weights, engine run, checks, rates, profile)")
    return {"launches": launches, "wall_s": wall, "steps": eng.steps,
            "tokens0": outs[0].tokens, "prefill_tok_s": rates,
            "decode_ms": step_ms,
            "decode_queue_ms": queue_ms, "decode_device_ms": dev_ms,
            "peak_gb": peak_gb, "model_s": model_s}


# ---------------------------------------------------------------------------
# phase 5d: the decoder-only families at full width
# ---------------------------------------------------------------------------
# (config, layers on one 80 GB card: None = whole).  Depths are cut only as
# far as the card's 85.0e9 bytes force, with ~10 GB left for the allocator
# and the earlier phases' ~3.3 GB: a layer takes its bf16 weights and two
# KV caches of 8 x 4096 positions (the engine's and the manual loop's,
# 0.27 GB at 8 KV heads of 128): Yi-34B 1.12 + 0.27 GB a layer, so 50 of 60
# peak near 72 GB above the earlier phases; Mistral-Large-123B 2.77 + 0.27
# GB, 23 of 88 near 72 GB; Kimi-K2 35 GB a layer (34.2 GB of its 384
# experts) beside 4.7 GB of embeddings, so a second layer cannot fit
FAMILIES = (("xlstm-125m", None), ("gemma-7b", None), ("llama3.2-3b", None),
            ("yi-34b", 50), ("mistral-large-123b", 23),
            ("kimi-k2-1t-a32b", 1))
FAMILY_REQUESTS, FAMILY_NEW = 8, 16


def family_config(name: str, layers):
    import dataclasses
    from repro_torch.configs import get
    cfg = get(name)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                         n_layers=layers)


def phase_families(plan) -> dict:
    """Each config of :data:`FAMILIES` in turn through the serving engine
    (:func:`phase_serve`'s checks: every request's tokens, the launch
    counts, request 0 against the manual loop, no host wait in the decode
    tick), 8 requests of 100-3000 prompt tokens and 16 new tokens each;
    each model is freed before the next is built."""
    import gc
    out = {}
    for name, layers in FAMILIES:
        cfg = family_config(name, layers)
        prompts = serve_prompts(cfg.vocab, n=FAMILY_REQUESTS, long=None)
        if tuple(len(p) for p in prompts) != FAMILY_LENS:
            fail(f"phase 5d's prompt lengths {[len(p) for p in prompts]} "
                 f"are not FAMILY_LENS, at which phase 2 holds the kernels")
        out[name] = phase_serve(plan, cfg, prompts, max_new=FAMILY_NEW,
                                tag="families")
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5e: the families with front ends at full width
# ---------------------------------------------------------------------------
# Qwen2-VL-2B through the steps: B4 rows of 16 text tokens, a 32 x 32 grid
# of vision embeddings, then text to 2048; 16 decode steps after them
VLM_B, VLM_S, VLM_TEXT, VLM_GRID, VLM_NEW = 4, 2048, 16, 32, 16
# Whisper-medium: B8 clips of 1500 frames, its 30-second window (3000 mel
# frames after the stride-2 convolution, arXiv:2212.04356 §2.2), prompts of
# 32 tokens, 64 greedy steps in a cache of 448 (its text context); then one
# clip at the config's enc_len, 4096 frames, with 8 steps
WHISPER_B, WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_NEW = 8, 1500, 32, 64
WHISPER_CACHE, WHISPER_LONG_NEW = 448, 8
MODEL_TOL = 3e-2                 # tests/test_models.py:70-88, of the scale
# the limit of the block walk's decode step against the prefill
# (:func:`check_blocks`), of the output's scale, set between two readings
# on the card (NVIDIA H100 80GB HBM3, 700.00 W): the largest sound one,
# 0.0288 (Whisper, B1 x 4096 frames, its first decoder block), and the
# smallest planted fault, 0.1805 (the same clip's cross k/v without its
# last 64 keys); 2.4x over the one and 2.6x under the other
WALK_TOL = 7e-2
# the reduced card-against-CPU runs: Qwen2-VL at its 12 query heads over 2
# (a group of 6), rows of 4 text tokens, a 4 x 6 grid, text to 40
PARITY_VLM_HEADS, PARITY_S, PARITY_GRID = 12, 40, (4, 4, 6)


def mrope_ids(B: int, S: int, before: int, rows: int, cols: int,
              dev: torch.device) -> tuple:
    """(3, B, S) int32 M-RoPE ids of rows of ``before`` text tokens, a rows
    x cols grid of vision embeddings, then text to S (arXiv:2409.12191
    §2.1): text ids are the index before the grid; on it (t, h, w) =
    (before, before + row, before + col); after it text goes on from
    before + max(rows, cols) on all three streams.  Also the shift: the
    text token at position p past the grid takes id p - shift."""
    n = rows * cols
    i = torch.arange(S, dtype=torch.int32, device=dev)
    cell = (i - before).clamp(0, n - 1)
    grid = (i >= before) & (i < before + n)
    shift = n - max(rows, cols)
    text = torch.where(i < before, i, i - shift)
    ids = torch.stack([torch.where(grid, before, text),
                       torch.where(grid, before + cell // cols, text),
                       torch.where(grid, before + cell % cols, text)])
    return ids.to(torch.int32)[:, None].expand(3, B, S).contiguous(), shift


def scale_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the output's scale (at least 1)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def decode_rates(dev: torch.device, decode, params, caches, batch) -> dict:
    """One decode step on ``caches``: the host's time to queue it (mean of
    10), the synchronised step (the same 10) and its device time (CUDA
    graph, median of 3)."""
    decode(params, caches, batch)
    sync(dev)
    t = time.perf_counter()
    for _ in range(10):
        decode(params, caches, batch)
    queue_ms = (time.perf_counter() - t) / 10 * 1e3
    sync(dev)
    step_ms = (time.perf_counter() - t) / 10 * 1e3
    dev_ms = (graph_ms(lambda: decode(params, caches, batch), reps=3,
                       iters=5) if dev.type == "cuda" else float("nan"))
    return {"queue_ms": queue_ms, "step_ms": step_ms, "device_ms": dev_ms}


def prefill_secs(dev: torch.device, prefill, params, batch) -> float:
    """A synchronised prefill, median of 3 (seconds)."""
    secs = []
    for _ in range(3):
        sync(dev)
        t = time.perf_counter()
        prefill(params, batch)
        sync(dev)
        secs.append(time.perf_counter() - t)
    return sorted(secs)[1]


# the planted faults of the block walk's decode step (:func:`block_walk`),
# by family: each must move some block's output past WALK_TOL
# (a decode step that writes its k/v one slot early is not among them: the
# random model's nearly one-hot attention puts almost no weight on the
# newest keys, so no output moves)
WALK_FAULTS = {"vlm": ("rope_for_mrope", "mrope_id_plus_1"),
               "encdec": ("cross_next_layer", "cross_tail_dropped")}


@contextlib.contextmanager
def launches_inside(owner, attr: str, kernel, pick=None):
    """Within, ``counts[0]`` sums ``kernel``'s launches made inside the calls
    of ``owner.attr`` that ``pick(*args, **kw)`` accepts (every call
    without ``pick``): how :func:`whisper_clip` reads the encoder's and the
    cross attention's share of a prefill's launches."""
    real = getattr(owner, attr)
    counts = [0]

    def counted(*args, **kw):
        if pick is not None and not pick(*args, **kw):
            return real(*args, **kw)
        before = kernel.launches
        out = real(*args, **kw)
        counts[0] += kernel.launches - before
        return out
    setattr(owner, attr, counted)
    try:
        yield counts
    finally:
        setattr(owner, attr, real)


def block_walk(cfg, params, batch: dict, S: int, dev: torch.device,
               forced: dict = None, fault: str = None) -> dict:
    """The model block by block on ``dev`` over ``batch`` (S+1 positions:
    Qwen2-VL's ``embeds`` and ``mrope_positions``, Whisper's ``frames`` and
    ``tokens``) as a prefill, and at every decoder block one decode step for
    position S on that block's own prefill cache (M-RoPE id, cache slot and
    mask at S; Whisper's cross attention on the cached k/v).  Returns, per
    block, its input, its prefill output and its decode output (None for an
    encoder block), and the logits of row S from the last block's prefill
    and decode outputs, all on the CPU.  The prefill cache's slot S is
    zeroed before the decode step, which must write its own k/v there.
    With ``forced`` (another walk's
    result) every block takes that walk's input instead of its own last
    output, so each block is held alone: a random model at these widths is
    chaotic (its q and k are drawn at the fan-in of their head axis, so
    attention is nearly one-hot), and a one-ulp difference grows about
    twofold a layer (``tools/decode_drift.py``).  ``fault`` plants one of
    :data:`WALK_FAULTS` in every decode step: RoPE at position S in place
    of M-RoPE, the M-RoPE id one too far, the cross k/v of the next
    decoder layer (a nested cache sliced at the wrong layer), the cross
    k/v without the ragged tail past the last whole 64-key tile (a whole
    tile when there is none)."""
    import dataclasses
    from repro_torch.core.tree import tree_map
    from repro_torch.models import lm as L
    from repro_torch.models.attention import cross_kv
    from repro_torch.models.layers import apply_norm, embed, unembed
    cfg = dataclasses.replace(cfg, cache_len=S + 1)
    p = tree_map(lambda t: t.to(dev), params)
    b = tree_map(lambda t: t.to(dev), batch)
    out = {"inputs": [], "prefill": [], "decode": []}

    def take(x):
        if forced is not None:
            x = forced["inputs"][len(out["inputs"])].to(dev)
        out["inputs"].append(x.cpu())
        return x
    enc_out, mr = None, b.get("mrope_positions")
    if cfg.family == "encdec":
        x = b["frames"].to(torch.bfloat16)
        B, Se = x.shape[:2]
        pos = torch.arange(Se, device=dev)[None].expand(B, Se)
        for pl in L._layers(p["stacks"]["enc"]):
            x, _, _ = L.apply_block("enc", take(x), pl, cfg, positions=pos)
            out["prefill"].append(x.cpu())
            out["decode"].append(None)
        enc_out = take(apply_norm(x, p["enc_norm"], cfg.norm))
        x, kind = embed(b["tokens"], p["embed"]), "dec"
    else:
        x, kind = b["embeds"].to(torch.bfloat16), "dense"
    B = x.shape[0]
    pos = torch.arange(S + 1, device=dev)[None].expand(B, S + 1)
    pos1 = torch.full((B, 1), S, dtype=torch.int32, device=dev)
    mr1 = None if mr is None else mr[:, :, S:S + 1]
    if fault == "rope_for_mrope":
        mr1 = None
    elif fault == "mrope_id_plus_1":
        mr1 = mr1 + 1
    layers = L._layers(p["stacks"][kind])
    for i, pl in enumerate(layers):
        x = take(x)
        y, cache, _ = L.apply_block(kind, x, pl, cfg, cache="init",
                                    positions=pos, mrope_positions=mr,
                                    enc_out=enc_out)
        # the decode step must write position S's k/v itself
        own = cache["self"] if kind == "dec" else cache
        own["k"][:, S] = 0
        own["v"][:, S] = 0
        if fault == "cross_next_layer":
            cache = {"self": cache["self"], "cross": cross_kv(
                enc_out, layers[(i + 1) % len(layers)]["xattn"])}
        elif fault == "cross_tail_dropped":
            k, v = cache["cross"]["k"], cache["cross"]["v"]
            keep = k.shape[1] - (k.shape[1] % 64 or 64)
            cache = {"self": cache["self"],
                     "cross": {"k": k[:, :keep], "v": v[:, :keep]}}
        yd, _, _ = L.apply_block(
            kind, x[:, S:S + 1], pl, cfg, cache=cache, positions=pos1,
            pos_offset=pos1[:, 0], enc_out=enc_out, mrope_positions=mr1)
        out["prefill"].append(y.cpu())
        out["decode"].append(yd.cpu())
        x = y
    out["logits"] = [unembed(apply_norm(h, p["final_norm"], cfg.norm),
                             p["embed"]).float().cpu()
                     for h in (x[:, S:S + 1], yd)]
    return out


def walk_decode_err(w: dict, S: int) -> tuple:
    """The worst, over the decoder blocks and the logits, of the decode
    step's output against the prefill's row S, over its scale, and where
    (block index or "logits")."""
    errs = [(scale_err(d[:, 0], pre[:, S]), i)
            for i, (pre, d) in enumerate(zip(w["prefill"], w["decode"]))
            if d is not None]
    errs.append((scale_err(w["logits"][1], w["logits"][0]), "logits"))
    return max(errs, key=lambda e: e[0])


def walk_pair_err(a: dict, b: dict) -> float:
    """The worst, over the blocks' prefill and decode outputs and both
    logits, of walk ``a`` against walk ``b``, over the output's scale."""
    errs = [scale_err(x, y) for x, y in zip(a["prefill"], b["prefill"])]
    errs += [scale_err(x, y) for x, y in zip(a["decode"], b["decode"])
             if y is not None]
    return max(errs + [scale_err(x, y) for x, y in zip(a["logits"],
                                                       b["logits"])])


def check_blocks(tag: str, cfg, params, batch: dict, S: int,
                 dev: torch.device) -> dict:
    """The block walk's decode-against-prefill check, sound and with each
    planted fault of the family: the sound walk must stay within
    :data:`WALK_TOL` and every faulted one must exceed it."""
    err, at = walk_decode_err(block_walk(cfg, params, batch, S, dev), S)
    faults = {f: walk_decode_err(block_walk(cfg, params, batch, S, dev,
                                            fault=f), S)[0]
              for f in WALK_FAULTS[cfg.family]}
    say(f"[front-ends] {tag}: every block's decode step at position S "
        f"within {err:.4f} of its scale of the prefill's row S, the logits "
        f"included (worst at block {at}; tolerance {WALK_TOL}); with a "
        f"planted fault in the decode step: "
        + ", ".join(f"{f} {e:.4f}" for f, e in faults.items())
        + f" (each must exceed {WALK_TOL})")
    if err > WALK_TOL:
        fail(f"{tag}: a block's decode step is {err:.4f} of its scale from "
             f"the prefill's row S, above {WALK_TOL}")
    missed = [f for f, e in faults.items() if e <= WALK_TOL]
    if missed:
        fail(f"{tag}: the block walk does not see the planted faults "
             f"{missed}: {faults}")
    return {"err": err, "at": at, "faults": faults}


def vlm_steps(plan, cfg, params) -> dict:
    """Qwen2-VL through ``make_prefill_step`` / ``make_decode_step`` with
    vision embeddings and M-RoPE ids: a B4 x S2048 prefill (16 text tokens,
    a 32 x 32 grid, text), then 16 decode steps, each with its embedding
    and the next text id.  The kernels must launch as
    :func:`expected_launches` says (attention once a layer for the prefill,
    never in decode: decode attention is plain), counted for the prefill
    and for the decode steps apart; the logits must be finite, and at every
    block the decode step at position S must equal the prefill's row S over
    S+1 positions (:func:`check_blocks`)."""
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    dev = plan.device
    B, S = VLM_B, VLM_S
    g = torch.Generator(device=dev).manual_seed(1)
    embeds = (torch.randn(B, S + VLM_NEW, cfg.d_model, generator=g,
                          device=dev) * 0.1).to(torch.bfloat16)
    ids, shift = mrope_ids(B, S + VLM_NEW, VLM_TEXT, VLM_GRID, VLM_GRID,
                           dev)
    prefill = make_prefill_step(cfg, plan, SERVE_CACHE)
    decode = make_decode_step(cfg, plan, SERVE_CACHE)
    batch = {"embeds": embeds[:, :S], "mrope_positions": ids[:, :, :S]}

    def step_batch(tok, pos, i):
        return {"token": tok, "pos": pos,
                "embeds": embeds[:, S + i:S + i + 1],
                "mrope_positions": ids[:, :, S + i:S + i + 1]}
    kernels = zero_launches()
    logits, caches = prefill(params, batch)
    sync(dev)
    pre = read_launches(kernels)
    kernels = zero_launches()
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    finite = bool(torch.isfinite(logits).all())
    for i in range(VLM_NEW):
        tok, lg, caches = decode(params, caches, step_batch(tok, pos, i))
        finite &= bool(torch.isfinite(lg).all())
        pos = pos + 1
    sync(dev)
    dec = read_launches(kernels)
    want_pre = nonzero(expected_launches(cfg, 1, 0))
    want_dec = nonzero(expected_launches(cfg, 0, VLM_NEW))
    after = VLM_TEXT + VLM_GRID ** 2
    say(f"[front-ends] {cfg.name} steps: B{B} x S{S} (text ids 0-"
        f"{VLM_TEXT - 1}, a {VLM_GRID} x {VLM_GRID} grid of vision "
        f"embeddings, text from position {after} with id "
        f"{int(ids[0, 0, after])}), {VLM_NEW} decode steps with embeddings "
        f"and M-RoPE ids (step 0 at position {S}, id {S - shift}); "
        f"launches in the prefill {pre}, expected {want_pre}; in the decode "
        f"steps {dec}, expected {want_dec}; logits finite: {finite}")
    if dev.type == "cuda" and (pre != want_pre or dec != want_dec):
        fail(f"{cfg.name} steps: launches {pre} / {dec}, expected "
             f"{want_pre} / {want_dec}")
    if not finite:
        fail(f"{cfg.name} steps: logits not finite")
    walk = check_blocks(f"{cfg.name} steps", cfg, params,
                        {"embeds": embeds[:, :S + 1],
                         "mrope_positions": ids[:, :, :S + 1]}, S, dev)
    prefill_s = prefill_secs(dev, prefill, params, batch)
    rates = decode_rates(dev, decode, params, caches,
                         step_batch(tok, pos, VLM_NEW - 1))
    say(f"[front-ends] {cfg.name} steps: "
        f"prefill {B * S / prefill_s:.1f} tokens/s at B{B} x S{S} (median "
        f"of 3); decode {rates['step_ms']:.2f} ms a step at B{B}: "
        f"{rates['queue_ms']:.2f} ms of host time to queue it, "
        f"{rates['device_ms']:.2f} ms of device time (CUDA graph)")
    return {"launches": {"prefill": pre, "decode": dec}, "walk": walk,
            "prefill_tok_s": B * S / prefill_s, **rates}


def whisper_clip(plan, cfg, params, B: int, frames_len: int, n_new: int,
                 seed: int, profile: bool = False) -> dict:
    """B clips of ``frames_len`` N(0, 0.1²) bf16 frames and 32-token
    prompts through ``make_prefill_step``, then ``n_new`` greedy steps
    through ``make_decode_step`` on the nested cache.  The kernels'
    launches are read after the prefill and after the decode steps apart,
    and within the prefill the attention's launches inside the encoder
    segment and inside the cross attention (:func:`launches_inside`); each
    must be what :func:`expected_launches` and the config say (24 encoder,
    24 decoder self and 24 cross attention calls and 48 gelus a prefill;
    24 cross attention calls and 24 gelus a step).  The logits must be
    finite, and at every decoder block the decode step at position 32 must
    equal the prefill's row 32 over the prompt and the first greedy token
    (:func:`check_blocks`)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import lm as L
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    dev = plan.device
    g = torch.Generator(device=dev).manual_seed(seed)
    frames = (torch.randn(B, frames_len, cfg.d_model, generator=g,
                          device=dev) * 0.1).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (B, WHISPER_PROMPT), generator=g,
                           device=dev, dtype=torch.int32)
    prefill = make_prefill_step(cfg, plan, WHISPER_CACHE)
    decode = make_decode_step(cfg, plan, WHISPER_CACHE)
    batch = {"frames": frames, "tokens": tokens}

    def encoder(model, *args, segments=None, **kw):
        return segments is not None and segments[0][0] == "enc"
    with launches_inside(L.LM, "_run_segments", flash_attention,
                         encoder) as enc, \
            launches_inside(L, "cross_attention", flash_attention) as cross:
        kernels = zero_launches()
        logits, caches = prefill(params, batch)
        sync(dev)
        pre = read_launches(kernels)
        counted = {"encoder": enc[0], "cross_prefill": cross[0]}
        kernels = zero_launches()
        cross[0] = 0
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        tok0 = tok
        pos = torch.full((B,), WHISPER_PROMPT, dtype=torch.int32,
                         device=dev)
        finite = bool(torch.isfinite(logits).all())
        for i in range(n_new):
            tok, lg, caches = decode(params, caches,
                                     {"token": tok, "pos": pos})
            finite &= bool(torch.isfinite(lg).all())
            pos = pos + 1
        sync(dev)
        dec = read_launches(kernels)
        counted["cross_decode"] = cross[0]
    want = {"prefill": nonzero(expected_launches(cfg, 1, 0)),
            "decode": nonzero(expected_launches(cfg, 0, n_new)),
            "encoder": cfg.enc_layers, "cross_prefill": cfg.dec_layers,
            "cross_decode": cfg.dec_layers * n_new}
    got = {"prefill": pre, "decode": dec, **counted}
    say(f"[front-ends] {cfg.name} B{B} x {frames_len} frames, "
        f"{WHISPER_PROMPT}-token prompts, {n_new} greedy steps (cache "
        f"{WHISPER_CACHE}, cross {frames_len}): launches {got}, expected "
        f"{want}; logits finite: {finite}")
    if dev.type == "cuda" and got != want:
        fail(f"{cfg.name}: launches {got}, expected {want}")
    if not finite:
        fail(f"{cfg.name}: logits not finite")
    walk = check_blocks(
        f"{cfg.name} B{B} x {frames_len} frames", cfg, params,
        {"frames": frames, "tokens": torch.cat([tokens, tok0], 1)},
        WHISPER_PROMPT, dev)
    prefill_s = prefill_secs(dev, prefill, params, batch)
    step = {"token": tok, "pos": pos - 1}
    rates = decode_rates(dev, decode, params, caches, step)
    say(f"[front-ends] {cfg.name} B{B} x {frames_len} frames: prefill "
        f"(encoder and prompt) {prefill_s * 1e3:.2f} ms, "
        f"{B * frames_len / prefill_s:.1f} encoder frames/s (median of 3); "
        f"decode {rates['step_ms']:.2f} ms a step at B{B}, "
        f"{B / rates['step_ms'] * 1e3:.1f} decoder tokens/s: "
        f"{rates['queue_ms']:.2f} ms of host time to queue it, "
        f"{rates['device_ms']:.2f} ms of device time (CUDA graph)")
    if profile and dev.type == "cuda":
        for what, fn in ((f"prefill of B{B} x {frames_len} frames",
                          lambda: prefill(params, batch)),
                         (f"decode step at B{B}",
                          lambda: decode(params, caches, step))):
            say(f"[profile] {cfg.name} {what}: {device_breakdown(dev, fn)}")
    return {"launches": got, "walk": walk, "prefill_ms": prefill_s * 1e3,
            "frames_s": B * frames_len / prefill_s,
            "decoder_tok_s": B / rates["step_ms"] * 1e3, **rates}


def front_end_parity(arch: str, dev: torch.device, seed: int = 0) -> dict:
    """Reduced ``arch`` on the card (kernels) against the port on the CPU
    (plain versions), the same parameters (a CPU generator seeded ``seed``)
    and inputs: Qwen2-VL at 12/2 heads with vision embeddings and M-RoPE
    ids over 41 positions, Whisper with 48 frames and 41 tokens.  Held:
    every block on the card against the CPU given the CPU's input, prefill
    and a decode step at position 40 (:func:`block_walk`), with the
    kernels' launches.  The whole model through the steps is not held: the
    reduced random Whisper is chaotic, one ulp at a block's input moves its
    logits by hundredths (``tools/decode_drift.py --parity`` measures it)."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.models.lm import LM
    cfg = get(arch).reduced()
    if cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, n_heads=PARITY_VLM_HEADS)
    params = LM(cfg).init(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    B, S, cpu = 2, PARITY_S, torch.device("cpu")
    # drawn for S+4 positions, the walk takes S+1
    tokens = torch.randint(0, cfg.vocab, (B, S + 4), generator=g,
                           dtype=torch.int32)
    if cfg.family == "encdec":
        walk = {"frames": (torch.randn(B, 48, cfg.d_model, generator=g)
                           * 0.1).to(torch.bfloat16),
                "tokens": tokens[:, :S + 1]}
    else:
        e = (torch.randn(B, S + 4, cfg.d_model, generator=g)
             * 0.1).to(torch.bfloat16)
        walk = {"embeds": e[:, :S + 1], "mrope_positions":
                mrope_ids(B, S + 4, *PARITY_GRID, cpu)[0][:, :, :S + 1]}
    with torch.no_grad():
        on_cpu = block_walk(cfg, params, walk, S, cpu)
        kernels = zero_launches()
        on_card = block_walk(cfg, params, walk, S, dev, forced=on_cpu)
        ran = read_launches(kernels)
    return {"arch": arch, "err": walk_pair_err(on_card, on_cpu), "ran": ran,
            "heads": (cfg.n_heads, cfg.n_kv_heads)}


def parity_launches(arch: str) -> dict:
    """The kernels' launches in :func:`front_end_parity`'s walk on the
    card: a prefill and one decode step at each block."""
    from repro_torch.configs import get
    return nonzero(expected_launches(get(arch).reduced(), 1, 1))


def free_and_mark(dev: torch.device) -> None:
    """Free what the last model left and restart the peak-memory count."""
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def phase_front_ends(plan) -> dict:
    """Qwen2-VL-2B whole through the engine (:func:`phase_serve`'s checks,
    phase 5d's 8 requests, text only) and through the steps with vision
    embeddings and M-RoPE (:func:`vlm_steps`), then Whisper-medium whole,
    B8 x 1500 frames and B1 x 4096 (:func:`whisper_clip`), each model
    freed before the next; then both reduced on the card against the CPU
    (:func:`front_end_parity`)."""
    from repro_torch.configs import get
    from repro_torch.models.lm import LM
    from repro_torch.models.params import bytes_params, count_params
    from repro_torch.runtime.steps import make_model
    dev = plan.device
    out = {}
    cfg = get("qwen2-vl-2b")
    prompts = serve_prompts(cfg.vocab, n=FAMILY_REQUESTS, long=None)
    if tuple(len(p) for p in prompts) != FAMILY_LENS:
        fail(f"phase 5e's prompt lengths {[len(p) for p in prompts]} are "
             f"not FAMILY_LENS")
    t0 = time.perf_counter()
    out["qwen2-vl-2b"] = phase_serve(plan, cfg, prompts, max_new=FAMILY_NEW,
                                     check_launches=dev.type == "cuda",
                                     tag="front-ends")
    free_and_mark(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    params = make_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    steps = vlm_steps(plan, cfg, params)
    steps["peak_gb"] = ((torch.cuda.max_memory_allocated(dev) - base) / 1e9
                        if dev.type == "cuda" else float("nan"))
    out["qwen2-vl-2b"]["steps"] = steps
    out["qwen2-vl-2b"]["model_s"] = time.perf_counter() - t0
    say(f"[front-ends] {cfg.name} steps: peak {steps['peak_gb']:.2f} GB of "
        f"device memory above the {base / 1e9:.2f} GB earlier phases hold; "
        f"{out['qwen2-vl-2b']['model_s']:.1f} s for the model (engine run "
        f"and steps, checks, rates, profile)")
    del params
    free_and_mark(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    t0 = time.perf_counter()
    cfg = get("whisper-medium")
    params = make_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    sync(dev)
    defs = LM(cfg).param_defs()
    say(f"[front-ends] {describe(cfg)}: {count_params(defs) / 1e9:.3f} B "
        f"parameters, {bytes_params(defs) / 1e9:.2f} GB of weights from seed "
        f"0 in {time.perf_counter() - t0:.1f} s")
    w = {"clip": whisper_clip(plan, cfg, params, WHISPER_B, WHISPER_FRAMES,
                              WHISPER_NEW, seed=2, profile=True),
         "long": whisper_clip(plan, cfg, params, 1, cfg.enc_len,
                              WHISPER_LONG_NEW, seed=3)}
    peak_gb = ((torch.cuda.max_memory_allocated(dev) - base) / 1e9
               if dev.type == "cuda" else float("nan"))
    w["peak_gb"], w["model_s"] = peak_gb, time.perf_counter() - t0
    say(f"[front-ends] {cfg.name}: peak {peak_gb:.2f} GB of device memory "
        f"above the {base / 1e9:.2f} GB earlier phases hold; "
        f"{w['model_s']:.1f} s for the model (weights, both clips, checks, "
        f"rates, profile)")
    out["whisper-medium"] = w
    del params
    free_and_mark(dev)
    for arch in ("qwen2-vl-2b", "whisper-medium"):
        r = front_end_parity(arch, dev)
        want = parity_launches(arch) if dev.type == "cuda" else {}
        say(f"[front-ends] reduced {arch} (H{r['heads'][0]}/{r['heads'][1]})"
            f" on the card against the CPU: every block (prefill over 41 "
            f"positions and a decode step at 40) and the logits within "
            f"{r['err']:.4f} of their scale given the CPU's block inputs "
            f"(tolerance {MODEL_TOL}); launches {r['ran']}, expected {want}")
        if r["err"] > MODEL_TOL or r["ran"] != want:
            fail(f"reduced {arch} on the card against the CPU: {r}")
        out[arch]["parity"] = r
    return out


# ---------------------------------------------------------------------------
# phase 5c: the training path at full width
# ---------------------------------------------------------------------------
TRAIN_STEPS = 6
TRAIN_PEAK_LR, TRAIN_WARMUP = 3e-3, 20
TRAIN_MIXTRAL_LAYERS = 1         # of 32: 1.72 B parameters, ~20.6 GB of state
CARD_GB = 80
RECOMPUTE_RANGES = ("flash_attention.recompute_backward",
                    "ssd_scan.recompute_backward", "router_topk.backward")


def train_configs() -> list:
    """(config, batch, seq): Zamba2-1.2B whole at B4 x S2048, Mixtral-8x7B
    cut to 1 of its 32 layers at B2 x S2048."""
    import dataclasses
    from repro_torch.configs import get
    return [(get("zamba2-1.2b"), 4, 2048),
            (dataclasses.replace(get("mixtral-8x7b"),
                                 n_layers=TRAIN_MIXTRAL_LAYERS), 2, 2048)]


def train_launches_per_step(cfg) -> dict:
    """Each kernel of the path runs twice a step: in the forward, and again
    when activation checkpointing recomputes its block for the backward."""
    return expected_launches(cfg, 2, 0)


class PhaseClock:
    """Per train step, a CUDA event as its forward (``LM.loss`` called), its
    backward (``LM.loss`` returned) and its optimizer (the global-norm clip)
    begin and as the step returns, read once the step's metrics are on the
    host.  :meth:`wrap` wraps the step; within :meth:`timing` the two
    functions the step calls record their events."""

    def __init__(self):
        self.steps = []

    def mark(self, phase: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if phase == "forward":
            self.steps.append({})
        self.steps[-1][phase] = ev

    def wrap(self, step):
        def timed_step(state, batch):
            out = step(state, batch)
            self.mark("end")
            return out
        return timed_step

    @contextlib.contextmanager
    def timing(self):
        import repro_torch.runtime.steps as steps
        from repro_torch.models.lm import LM
        loss, clip = LM.loss, steps.clip_by_global_norm

        def timed_loss(model, *args, **kw):
            self.mark("forward")
            out = loss(model, *args, **kw)
            self.mark("backward")
            return out

        def timed_clip(*args, **kw):
            self.mark("optimizer")
            return clip(*args, **kw)

        LM.loss, steps.clip_by_global_norm = timed_loss, timed_clip
        try:
            yield
        finally:
            LM.loss, steps.clip_by_global_norm = loss, clip

    def split(self) -> list:
        """Per step: forward, backward and optimizer ms."""
        names = ("forward", "backward", "optimizer", "end")
        return [{a: s[a].elapsed_time(s[b]) for a, b in zip(names, names[1:])}
                for s in self.steps]


def phase_train(plan, cfg, batch: int, seq: int, steps: int = TRAIN_STEPS,
                check_launches: bool = True) -> dict:
    """Train ``cfg`` for ``steps`` steps through ``TrainDriver``, its data
    from ``make_pipeline(SyntheticLMSource)``; fail unless the loss is
    finite at every step and lower at the last than at the first, the
    kernels launched :func:`train_launches_per_step` times a step, and the
    driver's final checkpoint (written under ``build/``, deleted after)
    restores bit for bit.  ``check_launches=False`` is for a rehearsal on
    the CPU."""
    import shutil
    from repro_torch.core.tree import jax_leaves
    from repro_torch.data import SyntheticLMSource, make_pipeline
    from repro_torch.models.lm import LM
    from repro_torch.models.params import count_params
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime.driver import DriverConfig, TrainDriver
    from repro_torch.runtime.steps import init_state, make_train_step
    dev = plan.device
    cuda = dev.type == "cuda"
    base_gb = torch.cuda.memory_allocated(dev) / 1e9 if cuda else 0.0
    t0 = time.perf_counter()
    state = init_state(cfg, plan, torch.Generator(device=dev).manual_seed(0))
    sync(dev)
    n_params = count_params(LM(cfg).param_defs())
    state_gb = sum(t.numel() * t.element_size()
                   for t in jax_leaves(state)) / 1e9
    say(f"[train] {describe(cfg)}: {n_params / 1e9:.3f} B parameters, "
        f"{state_gb:.2f} GB of train state (bf16 parameters, fp32 AdamW "
        f"moments) from seed 0 in {time.perf_counter() - t0:.1f} s; batch "
        f"B{batch} x S{seq}, {steps} steps at cosine_warmup("
        f"{TRAIN_PEAK_LR}, {TRAIN_WARMUP}, {steps})")
    clock = PhaseClock() if cuda else None
    step = make_train_step(cfg, plan, cosine_warmup(
        TRAIN_PEAK_LR, TRAIN_WARMUP, steps))
    pipe = make_pipeline(SyntheticLMSource(cfg.vocab, seq, batch, seed=0),
                         plan, n_batches=steps)
    ckpt_dir = ROOT / "build" / f"train_ckpt_{cfg.name}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    driver = TrainDriver(clock.wrap(step) if clock else step, state, pipe,
                         DriverConfig(total_steps=steps, ckpt_every=steps + 1,
                                      ckpt_dir=str(ckpt_dir), keep=1,
                                      log_every=1))
    del state
    want = train_launches_per_step(cfg)
    try:
        kernels = zero_launches()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        with clock.timing() if clock else contextlib.nullcontext():
            out = driver.run()
        wall = time.perf_counter() - t1
        launches = {name: kernels[name].launches for name in want}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda \
            else float("nan")
        losses = [h["loss"] for h in out["history"]]
        dts = [h["dt"] for h in out["history"]]
        if out["final_step"] != steps or len(losses) != steps:
            fail(f"{cfg.name}: the driver ended at step {out['final_step']} "
                 f"with {len(losses)} steps logged")
        if not all(math.isfinite(x) for x in losses):
            fail(f"{cfg.name}: loss not finite: {losses}")
        if not losses[-1] < losses[0]:
            fail(f"{cfg.name}: loss did not fall: {losses}")
        per_step = {k: v / steps for k, v in launches.items()}
        say(f"[train] {cfg.name}: loss {' -> '.join(f'{x:.4f}' for x in losses)}"
            f"; kernel launches per step {per_step}, expected {want}")
        if check_launches and per_step != want:
            fail(f"{cfg.name}: kernel launches per step {per_step}, "
                 f"expected {want}")
        med = sorted(dts[1:])[len(dts[1:]) // 2]
        tok_s = batch * seq / med
        say(f"[train] {cfg.name}: {tok_s:.1f} train tokens/s (B*S over the "
            f"median step after the first, synchronised: {med * 1e3:.1f} ms;"
            f" first step {dts[0] * 1e3:.1f} ms); peak memory {peak_gb:.2f} "
            f"GB of {CARD_GB} ({peak_gb - base_gb:.2f} GB above the "
            f"{base_gb:.2f} GB earlier phases hold); driver run {wall:.1f} s "
            f"with the final checkpoint")
        split = clock.split()[:steps] if clock else []
        for i, s in enumerate(split):
            say(f"[train] {cfg.name} step {i}: forward {s['forward']:.1f} "
                f"ms, backward {s['backward']:.1f} ms, optimizer "
                f"{s['optimizer']:.1f} ms (CUDA events)")
        ck_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("*")
                       if f.is_file())
        say(f"[train] {cfg.name}: final checkpoint {ck_bytes / 1e9:.2f} GB "
            f"in {driver.ckpt.save_seconds:.1f} s "
            f"({ck_bytes / 1e9 / driver.ckpt.save_seconds:.2f} GB/s, device "
            f"to host and to disk)")
        tb = time.perf_counter()
        restored, _ = driver.ckpt.restore(driver.state)
        sync(dev)
        restore_s = time.perf_counter() - tb
        n = 0
        for a, b in zip(jax_leaves(restored),
                        jax_leaves(driver.state)):
            if a.dtype != b.dtype or a.device != b.device \
                    or not torch.equal(a, b):
                fail(f"{cfg.name}: a restored leaf differs from the trained "
                     f"state ({a.dtype} {tuple(a.shape)})")
            n += 1
        del restored
        say(f"[train] {cfg.name}: the checkpoint restores into a fresh "
            f"state bit for bit ({n} leaves) in {restore_s:.1f} s")
        ranges = {}
        if cuda:
            tokens = torch.as_tensor(SyntheticLMSource(
                cfg.vocab, seq, batch, seed=1).next_batch()["tokens"],
                device=dev)

            def one_step():
                driver.state, _ = step(driver.state, {"tokens": tokens})
            say(f"[profile] {cfg.name} train step B{batch} x S{seq}: "
                f"{device_breakdown(dev, one_step, RECOMPUTE_RANGES, ranges)}")
            say(f"[profile] {cfg.name} the same step's backward ranges "
                f"(their kernels, also counted in the families above): "
                + "; ".join(f"{name} {ms:.3f} ms over {c} calls"
                            for name, (ms, c) in sorted(ranges.items())))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"launches": launches, "per_step": per_step, "tok_s": tok_s,
            "step_ms": med * 1e3, "peak_gb": peak_gb - base_gb,
            "split": split,
            "ckpt_gb": ck_bytes / 1e9, "save_s": driver.ckpt.save_seconds,
            "restore_s": restore_s, "losses": losses, "ranges": ranges}


def loss_and_grads(cfg, params, tokens: torch.Tensor) -> tuple:
    """``LM.loss`` and the gradient of every parameter leaf."""
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from repro_torch.models.lm import LM
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = LM(cfg).loss(tree_unflatten(params, leaves), {"tokens": tokens})
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


# the card's kernels sum in another order than the CPU's plain versions
# (the attention kernel in 64-key tiles, P V from P's two bf16 halves), so
# the router logits of the two runs differ a little and a token near a tie between
# experts may be routed differently; the CPU replays the card's routing and
# these bound the difference: the logits' rms difference, relative to their
# rms, in every router call (the CPU tests' bf16 loss tolerance), and the
# share of the tokens whose own top-K on the CPU is another set of experts
MAX_DLOGIT_REL = 2e-2
MAX_FLIP_SHARE = 0.02


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at magnitude ``x`` (8 bits of
    precision)."""
    return torch.exp2(torch.floor(torch.log2(x.clamp_min(1e-30))) - 7)


def expert_sets(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(T, K) expert ids -> (T, E) bool: the set each token is routed to."""
    return torch.nn.functional.one_hot(idx.long(), n_experts).sum(1).bool()


@contextlib.contextmanager
def moe_routing(calls: list, replay: bool):
    """Within, the MoE block's router either records each call's logits and
    experts into ``calls`` or routes to the recorded experts in call order
    (the weights ``routing_weights`` of this run's logits at them, the
    positions first-come over them, as ``router_topk_plain`` counts).  A
    record notes whether the experts are the top-K of the logits
    (``router_topk_plain`` on the same device); a replay adds the rms
    difference between this run's logits and the recorded ones relative to
    the recorded ones' rms, and the tokens whose own top-K on this run's
    logits is another set of experts, each with its margin: the logit gap
    its own choice holds over the recorded one, in bf16 ulps of the largest
    |logit| among the experts the two choices do not share and in rms
    logit differences of the call."""
    import repro_torch.models.moe as moe
    from repro_torch.kernels.router_topk import (router_topk_plain,
                                                 routing_weights)
    real, replayed = moe.router_topk, iter(calls)

    def record(logits, k, capacity):
        out = real(logits, k, capacity)
        E = logits.shape[1]
        calls.append({"logits": logits.detach().cpu(), "idx": out[1].cpu(),
                      "top_k": torch.equal(expert_sets(router_topk_plain(
                          logits.detach(), k, logits.shape[0])[1], E),
                          expert_sets(out[1], E))})
        return out

    def route_to(logits, k, capacity):
        call = next(replayed)
        idx = call["idx"].to(logits.device)
        lg, rec = logits.detach(), call["logits"].to(logits.device)
        E = lg.shape[1]
        chosen = expert_sets(idx, E)
        own = expert_sets(router_topk_plain(lg, k, lg.shape[0])[1], E)
        diff = chosen != own
        flipped = diff.any(-1)
        ninf = torch.tensor(float("-inf"))
        gap = (torch.where(own & ~chosen, lg, ninf).amax(-1)
               + torch.where(chosen & ~own, -lg, ninf).amax(-1))
        rms_dl = float((lg - rec).pow(2).mean().sqrt())
        tie_ulp = bf16_ulp(torch.where(diff, lg.abs(), 0).amax(-1))
        call.update(
            tokens=lg.shape[0],
            dlogit_rel=rms_dl / float(rec.pow(2).mean().sqrt()),
            margins_ulps=(gap / tie_ulp)[flipped].tolist(),
            margins_rms=(gap / max(rms_dl, 1e-30))[flipped].tolist())
        onehot = torch.nn.functional.one_hot(idx.reshape(-1).long(),
                                             E).to(torch.int32)
        pos = ((torch.cumsum(onehot, 0) * onehot).sum(-1) - 1) \
            .reshape(idx.shape).to(torch.int32)
        return routing_weights(logits, idx), idx, pos, pos < capacity

    moe.router_topk = route_to if replay else record
    try:
        yield
    finally:
        moe.router_topk = real


@contextlib.contextmanager
def plain_attention():
    """Within, the model's attention runs the plain version on the card."""
    import repro_torch.models.attention as attention
    from repro_torch.kernels.flash_attention import flash_attention_plain
    real = attention.flash_attention
    attention.flash_attention = flash_attention_plain
    try:
        yield
    finally:
        attention.flash_attention = real


def min_cosine(grads_a, grads_b) -> float:
    worst = 1.0
    for a, b in zip(grads_a, grads_b):
        a, b = a.float().cpu(), b.float().cpu()
        worst = min(worst, float((a * b).sum()
                                 / (a.norm() * b.norm() + 1e-30)))
    return worst


def card_cpu_parity(arch: str, seed: int, dev: torch.device) -> dict:
    """One loss and gradient of reduced ``arch`` on the card (kernels)
    against the same parameters and tokens, drawn from ``seed``, on the CPU
    (plain versions).  The CPU run routes every MoE call to the experts the
    card picked (:func:`moe_routing`): a token the two would route
    differently makes them compute different functions.  Returns the
    losses, the smallest gradient cosine, the kernels' launches on the card
    and the routing records, for :func:`parity_faults`."""
    import numpy as np
    from repro_torch.configs import get
    from repro_torch.core.tree import tree_map
    from repro_torch.models.lm import LM
    cfg = get(arch).reduced()
    params = LM(cfg).init(torch.Generator().manual_seed(seed))
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, 64), dtype=np.int32))
    kernels = zero_launches()
    calls = []
    with moe_routing(calls, replay=False):
        loss_g, grads_g = loss_and_grads(
            cfg, tree_map(lambda t: t.to(dev), params), tokens.to(dev))
    ran = read_launches(kernels)
    with moe_routing(calls, replay=True):
        loss_c, grads_c = loss_and_grads(cfg, params, tokens)
    return {"arch": arch, "loss_card": loss_g, "loss_cpu": loss_c,
            "rel": abs(loss_g - loss_c) / abs(loss_c),
            "min_cos": min_cosine(grads_g, grads_c),
            "leaves": len(grads_c), "ran": ran,
            "tokens": sum(c["tokens"] for c in calls),
            "flips": sum(len(c["margins_ulps"]) for c in calls),
            "top_k": all(c["top_k"] for c in calls),
            "dlogit_rel": max((c["dlogit_rel"] for c in calls), default=0.),
            "margins_ulps": sorted(m for c in calls
                                   for m in c["margins_ulps"]),
            "margins_rms": sorted(m for c in calls
                                  for m in c["margins_rms"]),
            "per_call": [{k: c[k] for k in ("dlogit_rel", "margins_ulps",
                                            "margins_rms")} for c in calls]}


def parity_faults(r: dict) -> list:
    """What :func:`card_cpu_parity`'s result breaks of the CPU tests' bf16
    tolerances (loss within 2e-2 relative, every leaf's cosine >= 0.99)
    and of the routing bounds: the card's experts are the top-K of its own
    logits (so a flipped token's margin is at most the two runs' logit
    difference at its experts), the logits agree to ``MAX_DLOGIT_REL`` and
    the flips stay within ``MAX_FLIP_SHARE`` of the tokens."""
    out = []
    if r["rel"] > 2e-2:
        out.append(f"loss differs by {r['rel']:.2e} relative")
    if r["min_cos"] < 0.99:
        out.append(f"a gradient leaf's cosine is {r['min_cos']:.6f}")
    if not r["ran"]:
        out.append("no kernel launched on the card")
    if not r["top_k"]:
        out.append("the card's experts are not the top-K of its logits")
    if r["dlogit_rel"] > MAX_DLOGIT_REL:
        out.append(f"router logits differ by {r['dlogit_rel']:.2e} of "
                   f"their rms")
    if r["flips"] > MAX_FLIP_SHARE * r["tokens"]:
        out.append(f"{r['flips']} of {r['tokens']} tokens routed "
                   f"differently")
    return out


def describe_parity(r: dict) -> str:
    return (f"loss on the card {r['loss_card']:.6f}, on the CPU "
            f"{r['loss_cpu']:.6f} (rel {r['rel']:.2e}); {r['leaves']} "
            f"gradient leaves, min cosine {r['min_cos']:.6f}; kernels "
            f"launched {r['ran']}"
            + (f"; router logits within {r['dlogit_rel']:.2e} of their rms "
               f"(bound {MAX_DLOGIT_REL}), the card's experts the top-K of "
               f"its logits: {r['top_k']}; {r['flips']} of {r['tokens']} "
               f"tokens would route otherwise on the CPU (bound "
               f"{MAX_FLIP_SHARE:.0%}), margins "
               f"{[round(m, 2) for m in r['margins_ulps']]} bf16 ulps of "
               f"the tied logits, "
               f"{[round(m, 2) for m in r['margins_rms']]} rms logit "
               f"differences; the CPU routes to the card's experts"
               if r["tokens"] else ""))


def train_parity(dev: torch.device) -> None:
    """:func:`card_cpu_parity` of reduced Zamba2 and reduced Mixtral, held
    by :func:`parity_faults`; Mixtral again with the plain attention on the
    card, printed only, to show where the router logits part; then the
    router's weight gradient from the kernel path against the plain
    recompute's on the card."""
    from repro_torch.core.device import expert_capacity
    from repro_torch.kernels.router_topk import (router_topk,
                                                 router_topk_plain,
                                                 routing_weights)
    for arch in ("zamba2-1.2b", "mixtral-8x7b"):
        r = card_cpu_parity(arch, 1, dev)
        say(f"[train] reduced {arch}: {describe_parity(r)}")
        faults = parity_faults(r)
        if faults:
            fail(f"reduced {arch}: the card and the CPU differ: "
                 f"{'; '.join(faults)}")
    with plain_attention():
        r = card_cpu_parity("mixtral-8x7b", 1, dev)
    say(f"[train] reduced mixtral-8x7b, the plain attention on the card "
        f"(where the logits part): {describe_parity(r)}")
    g = torch.Generator().manual_seed(8)
    T, E, K = 4096, 8, 2
    logits = (torch.randn(T, E, generator=g) * 2).to(dev).requires_grad_(True)
    gw = torch.randn(T, K, generator=g).to(dev)
    w, idx, _, _ = router_topk(logits, K, expert_capacity(T, E, K, 1.25))
    (got,) = torch.autograd.grad(w, logits, gw)
    x = logits.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(routing_weights(x, idx), x, gw)
    _, pidx, _, _ = router_topk_plain(logits, K, T)
    err = float((got - want).abs().max())
    if not torch.equal(idx, pidx) or err > 0:
        fail(f"router_topk's weight gradient on the card differs from the "
             f"plain recompute's (max |err| {err})")
    say(f"[train] router_topk T{T} E{E} K{K}: the weight gradient through "
        f"the kernel equals the plain recompute's (max |err| {err}, experts "
        f"equal the plain version's)")


def train_restart(plan) -> None:
    """ff-tiny through ``TrainDriver`` with a failure injected at step 6:
    one restart from the step-4 checkpoint, the run ends at step 12."""
    import shutil
    from repro_torch.configs import get
    from repro_torch.data import SyntheticLMSource, make_pipeline
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime.driver import DriverConfig, TrainDriver
    from repro_torch.runtime.steps import init_state, make_train_step
    cfg = get("ff-tiny")
    state = init_state(cfg, plan, torch.Generator(device=plan.device)
                       .manual_seed(0))
    pipe = make_pipeline(SyntheticLMSource(cfg.vocab, 128, 8, seed=0), plan,
                         n_batches=30)
    fired = []

    def hook(s):
        if s == 6 and not fired:
            fired.append(s)
            raise RuntimeError("injected failure (preemption)")

    ckpt_dir = ROOT / "build" / "train_ckpt_restart"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        driver = TrainDriver(make_train_step(cfg, plan, cosine_warmup(
            3e-3, 5, 12)), state, pipe, DriverConfig(
            total_steps=12, ckpt_every=4, ckpt_dir=str(ckpt_dir),
            retry_backoff_s=0.01, log_every=100), fault_hook=hook)
        out = driver.run()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = [h["loss"] for h in out["history"]]
    if out["restarts"] != 1 or out["final_step"] != 12 \
            or not all(math.isfinite(x) for x in losses):
        fail(f"ff-tiny restart run: restarts {out['restarts']}, final step "
             f"{out['final_step']}, losses {losses}")
    say(f"[train] ff-tiny with a failure injected at step 6: restarted once "
        f"from the step-4 checkpoint, ended at step 12 ({len(losses)} steps "
        f"run, loss {losses[0]:.4f} -> {losses[-1]:.4f})")


def phase_train_all(dev: torch.device) -> dict:
    import gc
    from repro_torch.core.plan import single_device_plan
    out = {}
    for cfg, batch, seq in train_configs():
        gc.collect()
        torch.cuda.empty_cache()
        out[cfg.name] = phase_train(single_device_plan(), cfg, batch, seq)
    gc.collect()
    torch.cuda.empty_cache()
    train_parity(dev)
    train_restart(single_device_plan())
    return out


# ---------------------------------------------------------------------------
# phase 6: times
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 5, iters: int = 20) -> float:
    """Median over ``reps`` of the mean of ``iters`` back-to-back eager
    calls, timed with CUDA events: the host's launch cost shows where it
    exceeds the device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    meds = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        meds.append(start.elapsed_time(end) / iters)
    return sorted(meds)[len(meds) // 2]


def graph_ms(fn, reps: int = 5, iters: int = 20) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, timed with CUDA events (median of ``reps``), so no host
    launch cost is in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    meds = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        meds.append(start.elapsed_time(end) / iters)
    return sorted(meds)[len(meds) // 2]


def kernel_row(name: str, cu: str, replaces: str, launches: int, err: float,
               ms: float, plain_ms: float, t_bytes: float, t_ops: float,
               library_ms) -> dict:
    """One entry of the ``kernels`` line; the bound is the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{cu}.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def time_flash(dev: torch.device, g: torch.Generator, name: str, shape: tuple,
               launches: int, err: float, card: str, sq: int = None,
               causal: bool = True) -> dict:
    """``flash_attention`` over bf16 q (B, H, Sq, D) and k, v (B, Hkv, S, D),
    Sq = ``sq`` or S, causal with the window of ``shape`` (4096, which does
    not bind, or none) or with every key visible, beside its plain version
    and ``scaled_dot_product_attention``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    B, H, Hkv, S, D, W = shape
    Sq = sq or S
    q = torch.randn(B, H, Sq, D, generator=g).to(torch.bfloat16).to(dev)
    k = torch.randn(B, Hkv, S, D, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(B, Hkv, S, D, generator=g).to(torch.bfloat16).to(dev)
    # query i (aligned to the end of the keys) sees S - Sq + i + 1 keys when
    # causal (the window does not bind), all S otherwise
    pairs = (Sq * (2 * S - Sq + 1) // 2) if causal else Sq * S
    flops = 4 * D * pairs * B * H           # q.k and p.v, 2 FLOP per MAC
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    ms = graph_ms(lambda: flash_attention(q, k, v, causal, W))
    eager = time_ms(lambda: flash_attention(q, k, v, causal, W))
    plain = time_ms(lambda: flash_attention_plain(q, k, v, causal, W),
                    reps=3, iters=5)
    # SDPA's causal mask is aligned to the start of the keys: only Sq == S
    lib = graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal and Sq == S, enable_gqa=True))
    row = kernel_row(name, "flash_attention",
                     "src/repro/kernels/flash_attention.py:35", launches, err,
                     ms, plain, nbytes / HBM_BYTES_PER_S * 1e3,
                     flops / BF16_FLOPS * 1e3, lib)
    say(f"[time] {name} B{B} H{H}/{Hkv} Sq{Sq} Sk{S} D{D} bf16 "
        f"{'causal' if causal else 'non-causal'}: "
        f"{ms:.4f} ms on the device (CUDA graph), {eager:.4f} ms per eager "
        f"call, plain {plain:.4f} ms, scaled_dot_product_attention "
        f"{lib:.4f} ms, bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']}: {flops:.4g} FLOP, {nbytes} B); "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {row['bound_ms'] / ms:.1%} of the "
        f"bound on {card}")
    return row


def time_serving_kernels(dev: torch.device, serve: dict, hybrid: dict,
                         errs: dict, card: str) -> list:
    """The serving path's kernels at its shapes: attention over a 2048-token
    prompt (Mixtral: B1, H32/Hkv8, D128; Zamba2's shared block: H32/32,
    D64; both causal, window 4096) and the router over its 2048 tokens (E8,
    K2, capacity from the model's formula)."""
    g = torch.Generator().manual_seed(5)
    S = 2048
    rows = [time_flash(dev, g, "flash_attention", (1, 32, 8, S, 128, 4096),
                       serve["launches"]["flash_attention"],
                       errs["flash_attention"], card),
            time_flash(dev, g, "flash_attention_d64",
                       (1, 32, 32, S, 64, 4096),
                       hybrid["launches"]["flash_attention"],
                       errs["flash_attention"], card)]
    rows.append(time_router(dev, g, "router_topk", S,
                            serve["launches"]["router_topk"],
                            errs["router_topk"], card))
    return rows


def time_train_kernels(dev: torch.device, train: dict, errs: dict,
                       card: str) -> list:
    """The training path's kernels at its shapes (phase 5c), each with its
    launches in that phase's driver run: attention over Zamba2's B4 x S2048
    (D64) and Mixtral's B2 x S2048 (D128), the router over Mixtral's 4096
    tokens, ``ssd_scan`` over Zamba2's B4."""
    zamba, mixtral = (train[cfg.name]["launches"]
                      for cfg, _, _ in train_configs())
    g = torch.Generator().manual_seed(9)
    time_recompute_backward(dev, g, train, card)
    return [time_flash(dev, g, "flash_attention_train_d64",
                       (4, 32, 32, 2048, 64, 4096),
                       zamba["flash_attention"], errs["flash_attention"],
                       card),
            time_flash(dev, g, "flash_attention_train_d128",
                       (2, 32, 8, 2048, 128, 4096),
                       mixtral["flash_attention"], errs["flash_attention"],
                       card),
            time_router(dev, g, "router_topk_train", 4096,
                        mixtral["router_topk"], errs["router_topk"], card),
            time_ssd(dev, "ssd_scan_train", 4, zamba["ssd_scan"],
                     errs["ssd_scan"], card)]


def time_family_kernels(dev: torch.device, fams: dict, errs: dict,
                        card: str) -> list:
    """Phase 5d's kernels at its shapes, each with its launches in that
    phase's engine run: attention at Gemma-7B's D 256 (B1 H16/16 S2048,
    causal, no window) beside ``scaled_dot_product_attention``, Kimi-K2's
    router (E384 top-8) over 2048 tokens, and xLSTM's two ``ssd_scan``
    calls per mLSTM layer (B1 H4 S2048, N = P = 384 and P = 1; the run's
    launches are split evenly between them), and Gemma-7B's gelu over its
    2567-token prompt's 24576-wide MLP activations."""
    g = torch.Generator().manual_seed(11)
    xl = fams["xlstm-125m"]["launches"]["ssd_scan"]
    return [time_flash(dev, g, "flash_attention_d256",
                       (1, 16, 16, 2048, 256, 0),
                       fams["gemma-7b"]["launches"]["flash_attention"],
                       errs["flash_attention_d256"], card),
            time_router(dev, g, "router_topk_e384", 2048,
                        fams["kimi-k2-1t-a32b"]["launches"]["router_topk"],
                        errs["router_topk_e384"], card, E=384, K=8),
            time_ssd(dev, "ssd_scan_xlstm", 1, xl // 2,
                     errs["ssd_scan_xlstm"], card, H=4, G=4, N=384, P=384),
            time_ssd(dev, "ssd_scan_xlstm_p1", 1, xl // 2,
                     errs["ssd_scan_xlstm_p1"], card, H=4, G=4, N=384, P=1),
            time_gelu(dev, g, "gelu_stepwise_gemma", (1, 2567, 24576),
                      fams["gemma-7b"]["launches"]["gelu_stepwise"],
                      errs["gelu_stepwise_gemma"], card)]


def time_front_end_kernels(dev: torch.device, fronts: dict, errs: dict,
                           card: str) -> list:
    """Phase 5e's attention instances at its shapes beside
    ``scaled_dot_product_attention``: Qwen2-VL's prefill (B1 H12/2 S2048
    D128, causal; launches in the engine run and the steps' prefill),
    Whisper's encoder (B8 H16/16 S1500 D64, every key) and its cross
    attention at prefill (Sq 32) and decode (Sq 1) against the 1500 frames,
    each with the launches the B8 clip counted inside the encoder segment,
    inside the cross attention at prefill and over the decode steps; and
    the gelu over Whisper's B8 x 1500 x 4096 MLP activations with the
    clip's launches (prefill and decode)."""
    g = torch.Generator().manual_seed(13)
    qwen = fronts["qwen2-vl-2b"]
    clip = fronts["whisper-medium"]["clip"]["launches"]
    return [time_flash(dev, g, "flash_attention_gqa6",
                       (1, 12, 2, 2048, 128, 0),
                       qwen["launches"]["flash_attention"]
                       + qwen["steps"]["launches"]["prefill"]
                       ["flash_attention"],
                       errs["flash_attention_gqa6"], card),
            time_flash(dev, g, "flash_attention_encoder",
                       (WHISPER_B, 16, 16, WHISPER_FRAMES, 64, 0),
                       clip["encoder"], errs["flash_attention_encoder"],
                       card, causal=False),
            time_flash(dev, g, "flash_attention_cross_prefill",
                       (WHISPER_B, 16, 16, WHISPER_FRAMES, 64, 0),
                       clip["cross_prefill"],
                       errs["flash_attention_cross_prefill"], card,
                       sq=WHISPER_PROMPT, causal=False),
            time_flash(dev, g, "flash_attention_cross_decode",
                       (WHISPER_B, 16, 16, WHISPER_FRAMES, 64, 0),
                       clip["cross_decode"],
                       errs["flash_attention_cross_decode"], card, sq=1,
                       causal=False),
            time_gelu(dev, g, "gelu_stepwise", (WHISPER_B, WHISPER_FRAMES,
                                                4096),
                      clip["prefill"]["gelu_stepwise"]
                      + clip["decode"]["gelu_stepwise"],
                      errs["gelu_stepwise"], card)]


def time_gelu(dev: torch.device, g: torch.Generator, name: str,
              shape: tuple, launches: int, err: float, card: str) -> dict:
    """``gelu_stepwise`` over bf16 activations of ``shape`` beside its plain
    version and ``F.gelu`` (the one PyTorch call for gelu's tanh form; it
    rounds once, so it is not the same function to the last bit).  Bound:
    the bytes, each element read and written once; ~10 fp32 operations an
    element (nine steps and the tanh) are far under it."""
    import torch.nn.functional as F
    from repro_torch.kernels.gelu_stepwise import (gelu_stepwise,
                                                   gelu_stepwise_plain)
    x = (torch.randn(*shape, generator=g) * 4).to(torch.bfloat16).to(dev)
    n = x.numel()
    ms = graph_ms(lambda: gelu_stepwise(x))
    plain = time_ms(lambda: gelu_stepwise_plain(x), reps=3, iters=5)
    lib = graph_ms(lambda: F.gelu(x, approximate="tanh"))
    row = kernel_row(name, "gelu_stepwise", "src/repro/models/layers.py:71",
                     launches, err, ms, plain, 2 * n * 2 / HBM_BYTES_PER_S
                     * 1e3, 10 * n / F32_FLOPS * 1e3, lib)
    say(f"[time] {name} {tuple(shape)} bf16: {ms:.4f} ms on the device "
        f"(CUDA graph), plain (nine eager ops) {plain:.4f} ms, F.gelu "
        f"{lib:.4f} ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
        f"{4 * n} B), {row['bound_ms'] / ms:.1%} of the bound on {card}")
    return row


def time_recompute_backward(dev: torch.device, g: torch.Generator,
                            train: dict, card: str) -> dict:
    """Each kernel's backward on the training path (the recompute through
    the plain version and its VJP, the port of ``kernels/ops.py``'s VJP
    rules; the router's is the VJP of its renormalised weights) at phase
    5c's shapes: ms per call (CUDA events around ``torch.autograd.grad``,
    eager, median of 3 x 3), and per step (one call a block a step)."""
    from repro_torch.core.device import expert_capacity
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.router_topk import router_topk
    from repro_torch.kernels.ssd_scan import ssd_scan
    (zcfg, zb, zs), (mcfg, mb, ms_) = train_configs()
    bf16 = torch.bfloat16

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype).to(dev)

    q, k, v, la = ssd_inputs(g, dev, zb, 64, 1, zs, 64, 64, "model")
    T = mb * ms_
    cases = [
        ("flash_attention", zcfg.name, lambda q, k, v: flash_attention(
            q, k, v, True, 4096), [rand(zb, 32, zs, 64, dtype=bf16),
                                   rand(zb, 32, zs, 64, dtype=bf16),
                                   rand(zb, 32, zs, 64, dtype=bf16)]),
        ("flash_attention", mcfg.name, lambda q, k, v: flash_attention(
            q, k, v, True, 4096), [rand(mb, 32, ms_, 128, dtype=bf16),
                                   rand(mb, 8, ms_, 128, dtype=bf16),
                                   rand(mb, 8, ms_, 128, dtype=bf16)]),
        ("ssd_scan", zcfg.name, lambda *a: ssd_scan(
            *a, 256, out_dtype=torch.float32), [q, k, v, la]),
        ("router_topk", mcfg.name, lambda x: router_topk(
            x, 2, expert_capacity(T, 8, 2, 1.25))[0],
         [rand(T, 8, scale=2.0)]),
    ]
    out = {}
    for name, arch, fn, inputs in cases:
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        y = fn(*leaves)
        gy = torch.randn(y.shape, generator=g).to(y.dtype).to(dev)
        ms = time_ms(lambda: torch.autograd.grad(y, leaves, gy,
                                                 retain_graph=True),
                     reps=3, iters=3)
        calls = train[arch]["per_step"][name] / 2
        out[name, arch] = (ms, ms * calls)
        say(f"[time] {name} backward at {arch}'s training shape "
            f"({' x '.join(str(tuple(t.shape)) for t in inputs)}): "
            f"{ms:.3f} ms per call, {calls:.0f} calls a step, "
            f"{ms * calls:.1f} ms per step (CUDA events, eager) on {card}")
        del leaves, y, gy
    return out


def time_router(dev: torch.device, g: torch.Generator, name: str, T: int,
                launches: int, err: float, card: str, E: int = 8,
                K: int = 2) -> dict:
    """``router_topk`` over T tokens of a router of E experts, top-K
    (Mixtral's E8 K2 unless given; capacity from the model's formula)
    beside its plain version and its bound."""
    from repro_torch.core.device import expert_capacity
    from repro_torch.kernels.router_topk import router_topk, router_topk_plain
    cap = expert_capacity(T, E, K, 1.25)
    logits = (torch.randn(T, E, generator=g) * 2).to(dev)
    nbytes = T * E * 4 + T * K * (4 + 4 + 4 + 1)
    ops = T * E * (5 + K)         # max, sub, exp, add, div; a compare a pick
    ms = graph_ms(lambda: router_topk(logits, K, cap))
    eager = time_ms(lambda: router_topk(logits, K, cap))
    plain = time_ms(lambda: router_topk_plain(logits, K, cap))
    row = kernel_row(name, "router_topk", "src/repro/kernels/router_topk.py:26",
                     launches, err, ms, plain, nbytes / HBM_BYTES_PER_S * 1e3,
                     ops / F32_FLOPS * 1e3, None)
    say(f"[time] {name} T{T} E{E} K{K}: {ms:.4f} ms on the device (CUDA "
        f"graph), {eager:.4f} ms per eager call, plain {plain:.4f} ms, bound "
        f"{row['bound_ms']:.6f} ms ({row['bound_by']}, {nbytes} B) on {card}")
    return row


# (kernel, T, E, K): the router at decode (T 8, the engine's max_batch),
# at the longest prompt one block takes whole (512), at the median and the
# longest prompt of phase 5 and at 2048, and at wide routers (E 256 top-8;
# Kimi-K2's E 384 top-8); the route at the hybrid's microbatch (phase 4)
# and at phase 3's T
ROUTE_TIMES = [("router_topk", 8, 8, 2), ("router_topk", 512, 8, 2),
               ("router_topk", 1859, 8, 2),
               ("router_topk", 2048, 8, 2), ("router_topk", 5000, 8, 2),
               ("router_topk", 2048, 256, 8), ("router_topk", 5000, 384, 8),
               ("a2a_route", 512, 8, 1), ("a2a_route", 4096, 8, 1)]
# the one-block kernels that the multi-block ones replaced (one block of 512
# threads walking the token tiles in order), recorded before the redesign
# at the same shapes in the same harness (tools/time_routing.py --src on an
# unpacked copy of that tree; NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md
# section 6).  Printed as recorded numbers, not measured in this run.
ONE_BLOCK_MS = {("router_topk", 8, 8, 2): 0.0042,
                ("router_topk", 512, 8, 2): 0.0066,
                ("router_topk", 1859, 8, 2): 0.0216,
                ("router_topk", 2048, 8, 2): 0.0224,
                ("router_topk", 5000, 8, 2): 0.0538,
                ("router_topk", 2048, 256, 8): 2.7112,
                ("router_topk", 5000, 384, 8): 10.1374,
                ("a2a_route", 512, 8, 1): 0.0042,
                ("a2a_route", 4096, 8, 1): 0.0236}


def empty_kernel_ms() -> float:
    """The latency floor of a kernel in :func:`graph_ms`: a kernel that
    does nothing (``torch.cuda._sleep(0)``), timed the same way."""
    return graph_ms(lambda: torch.cuda._sleep(0))


def route_time(dev: torch.device, name: str, T: int, E: int, K: int) -> dict:
    """One routing kernel's device time (CUDA graph, so a multi-block
    call's workspace fill is in it) on logits at scale 2 with the model's
    capacity (1.25x the mean load), its plain version's time per eager
    call and its byte bound."""
    from repro_torch.core.device import expert_capacity
    from repro_torch.kernels.a2a_fused import a2a_route, a2a_route_plain
    from repro_torch.kernels.router_topk import router_topk, router_topk_plain
    g = torch.Generator().manual_seed(T + E + K)
    logits = (torch.randn(T, E, generator=g) * 2).to(dev)
    cap = expert_capacity(T, E, K, 1.25)
    if name == "router_topk":
        ms = graph_ms(lambda: router_topk(logits, K, cap))
        plain = time_ms(lambda: router_topk_plain(logits, K, cap), reps=3,
                        iters=5)
        nbytes = T * E * 4 + T * K * (4 + 4 + 4 + 1)
    else:
        ms = graph_ms(lambda: a2a_route(logits, cap))
        plain = time_ms(lambda: a2a_route_plain(logits, cap), reps=3,
                        iters=5)
        nbytes = T * E * 4 + T * (4 + 4 + 1)
    return {"name": name, "T": T, "E": E, "K": K, "ms": ms,
            "plain_ms": plain, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def time_routes(dev: torch.device, card: str) -> list:
    """:data:`ROUTE_TIMES`, each beside its grid, its byte bound, the empty
    kernel's time and the one-block kernel's recorded time at that shape."""
    from repro_torch.kernels.router_topk import launch_plan
    floor = empty_kernel_ms()
    say(f"[time] empty kernel (torch.cuda._sleep(0)), the latency floor: "
        f"{floor:.4f} ms on the device (CUDA graph) on {card}")
    out = []
    for case in ROUTE_TIMES:
        r = route_time(dev, *case)
        plan = launch_plan(r["T"], r["E"], r["K"])
        r["grid"] = (f"{plan.blocks} blocks x {plan.threads} threads "
                     f"({plan.tokens_per_block} tokens a block)")
        say(f"[time] {r['name']} T{r['T']} E{r['E']} K{r['K']}: "
            f"{r['ms']:.4f} ms on the device (CUDA graph), grid {r['grid']}; "
            f"plain {r['plain_ms']:.4f} ms per eager call; one-block kernel "
            f"before the redesign {ONE_BLOCK_MS[case]:.4f} ms (recorded, "
            f"not measured in this run); bound {r['bound_ms']:.6f} ms "
            f"(bytes, {r['bytes']} B), empty kernel {floor:.4f} ms, on {card}")
        out.append(r)
    return out


def time_ssd(dev: torch.device, name: str, B: int, launches: int, err: float,
             card: str, H: int = 64, G: int = 1, N: int = 64,
             P: int = 64) -> dict:
    """``ssd_scan`` over B sequences of 2048 tokens, chunk 256, in the
    blocks' types (bf16 q/k, f32 v, log_a and y) with the final state: by
    default Zamba2's Mamba2 layer (64 heads, one group of q/k, N = P = 64;
    B1 is phase 5b's prefill, B4 phase 5c's training batch) as
    ``models/ssm.py`` calls it; xLSTM's mLSTM layer is H = G = 4,
    N = P = 384 (numerator) or P = 1 (normaliser), as ``models/xlstm.py``
    calls it."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    g = torch.Generator().manual_seed(7)
    S, Q = 2048, 256
    q, k, v, la = ssd_inputs(g, dev, B, H, G, S, N, P, "model")
    f32 = torch.float32
    ms = graph_ms(lambda: ssd_scan(q, k, v, la, Q, out_dtype=f32,
                                   return_state=True))
    eager = time_ms(lambda: ssd_scan(q, k, v, la, Q, out_dtype=f32,
                                     return_state=True))
    plain = time_ms(lambda: ssd_scan_plain(q, k, v, la, Q, out_dtype=f32),
                    reps=3, iters=5)
    chunk_heads = -(-S // Q) * B * H
    # the causal half (pairs s <= t) of the scores q.k, a product of two
    # bf16 inputs, exact in fp32, so the tensor cores' bf16 rate; then the
    # causal half of the decay-weighted sum over f32 v and the two
    # (Q,N)x(N,P)-sized products with the fp32 state.  Those keep fp32
    # accuracy as 3xTF32 on the tensor cores (the kernel's way, and the
    # fastest the card has): three TF32 products each, at the TF32 rate
    score_flops = chunk_heads * Q * (Q + 1) * N
    f32_flops = chunk_heads * (Q * (Q + 1) * P + 4 * Q * N * P)
    qk_rate = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    flops = score_flops + f32_flops
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, la)) \
        + B * H * S * P * 4 + B * H * N * P * 4          # y, state (f32)
    row = kernel_row(name, "ssd_scan", "src/repro/kernels/ssd_scan.py:26",
                     launches, err, ms, plain, nbytes / HBM_BYTES_PER_S * 1e3,
                     (score_flops / qk_rate + 3 * f32_flops / TF32_FLOPS)
                     * 1e3, None)
    say(f"[time] {name} B{B} H{H}/G{G} S{S} N{N} P{P} chunk {Q} (bf16 "
        f"q/k, f32 v/y): {ms:.4f} ms on the device (CUDA graph), "
        f"{eager:.4f} ms per eager call, plain {plain:.4f} ms, bound "
        f"{row['bound_ms']:.6f} ms ({row['bound_by']}: {score_flops:.4g} "
        f"FLOP of bf16 scores, {f32_flops:.4g} FLOP with an f32 operand as "
        f"3xTF32, {nbytes} B); "
        f"{flops / ms / 1e9:.1f} TFLOP/s on {card}")
    return row


def a2a_rows(dev: torch.device, T: int, cap: int, launches: dict,
             errs: dict, card: str, suffix: str = "") -> list:
    """``a2a_route`` and ``a2a_combine`` over T tokens of phase 3's
    widths (one-hot router logits with its skewed load, the (E, T, D)
    expert stack) at capacity ``cap``, beside their plain versions and
    their bounds; rows named ``a2a_route<suffix>``, ``a2a_combine<suffix>``
    with ``launches`` of the path they report."""
    from repro_torch.kernels.a2a_fused import (a2a_combine, a2a_combine_plain,
                                               a2a_route, a2a_route_plain)
    E, D = N_EXPERTS, D_MODEL
    g = torch.Generator().manual_seed(2)
    e = torch.randint(0, E, (T,), generator=g)
    e[: T // 4] = 0                          # the skewed load of phase 3
    logits = torch.nn.functional.one_hot(e, E).float().to(dev)
    ys = torch.randn(E, T, D, generator=g).to(torch.bfloat16).to(dev)
    idx, _pos, keep = a2a_route(logits, cap)
    kept = int(keep.sum())
    rows = []
    route_bytes = T * E * 4 + T * (4 + 4 + 1)
    route_ops = T * E * 5                    # sub, exp, add, div, compare
    combine_bytes = T * (4 + 1) + kept * D * 2 + T * D * 2
    for name, kern, plain, args, nbytes, ops in (
            ("a2a_route", a2a_route, a2a_route_plain, (logits, cap),
             route_bytes, route_ops),
            ("a2a_combine", a2a_combine, a2a_combine_plain, (ys, idx, keep),
             combine_bytes, 0)):
        ms = graph_ms(lambda: kern(*args))
        eager_ms = time_ms(lambda: kern(*args))
        plain_ms = time_ms(lambda: plain(*args))
        rows.append(kernel_row(
            name + suffix, "a2a_fused", "src/repro/kernels/a2a_fused.py:48",
            launches[name], errs[name], ms, plain_ms,
            nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3, None))
        say(f"[time] {name + suffix} T{T} cap {cap}: {ms:.4f} ms on the "
            f"device (CUDA graph), {eager_ms:.4f} ms per eager call, plain "
            f"{plain_ms:.4f} ms per eager call, bound "
            f"{rows[-1]['bound_ms']:.6f} ms ({rows[-1]['bound_by']}, "
            f"{nbytes} B) on {card}")
    return rows


def phase_times(dev: torch.device, main: dict, card: str) -> list:
    from repro_torch.core import CompileConfig
    from repro_torch.core.compiler import make_device_batched
    from repro_torch.core import perf_model
    T = T_TOKENS
    rows = a2a_rows(dev, T, main["cap"], main["launches"],
                    main["kernels"]["max_abs_err"], card)
    runner = build_graph(main["fns"]).compile(config=CompileConfig(
        plan=main["plan"], mode="device"))
    runner.run(main["stream"])
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run(main["stream"])
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    batched, _ = make_device_batched(build_graph(main["fns"]), main["plan"])
    seg_ms = time_ms(lambda: batched(main["xs"], 0), reps=3, iters=2)
    say(f"[time] main path lossless: {T / wall:.1f} items/s "
        f"({wall * 1e3:.1f} ms for {T} items, median of 3); the fused "
        f"device segment alone on resident tokens {seg_ms:.1f} ms, the rest "
        f"({wall * 1e3 - seg_ms:.1f} ms) is the host side of the boundary "
        f"(stack, copies, per-item results) on {card}")
    say(f"[time] CUDA dispatch (tiny kernel, back to back): "
        f"{perf_model.measure_cuda_dispatch() * 1e6:.2f} us on {card}")
    return rows


# ---------------------------------------------------------------------------
# phase 7: the accelerator and the process tier in front of the kernels
# ---------------------------------------------------------------------------
ACC_TASKS, ACC_TOKENS, ACC_INFLIGHT = 32, 2048, 8


def phase_accelerator(plan, cfg, tasks: int = ACC_TASKS,
                      tokens: int = ACC_TOKENS, check_launches: bool = True,
                      card: str = "the CPU") -> dict:
    """``TorchAccelerator`` offloading one MoE block of ``cfg`` (Mixtral-
    8x7B: d_model 4096, 8 experts of 14336 top-2, ``router_topk`` on the
    card), weights from a torch.Generator seeded 0: ``tasks`` tasks of
    ``tokens`` bf16 hidden states each from pinned host memory, at most
    ``ACC_INFLIGHT`` in flight.  Fails unless the results equal a
    synchronous loop of the same calls bit for bit (or, where they do not,
    lie within what two synchronous loops differ by, which is printed), the
    host offloads all tasks in less than the device time of their blocks,
    and ``router_topk`` launched once a task in the accelerator's run."""
    from repro_torch.core import FF_EOS, TorchAccelerator
    from repro_torch.kernels.router_topk import router_topk
    from repro_torch.models.moe import moe_block, moe_defs
    from repro_torch.models.params import init_params
    dev = plan.device
    cuda = dev.type == "cuda"
    p = init_params(moe_defs(cfg), torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator().manual_seed(12)
    xs = []
    for _ in range(tasks):
        x = torch.randn(1, tokens, cfg.d_model, generator=g) \
            .to(torch.bfloat16)
        xs.append(x.pin_memory() if cuda else x)

    def block(x):
        return moe_block(x, p, cfg, losses=False)[0]

    def sync_loop():
        """y = f(x) task by task, the host waiting for each; the device
        seconds of the blocks (CUDA events, the copy in left out)."""
        outs, device_ms = [], 0.0
        t0 = time.perf_counter()
        for x in xs:
            xd = x.to(dev)
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
            outs.append(block(xd))
            if cuda:
                b.record()
                b.synchronize()
                device_ms += a.elapsed_time(b)
        return outs, time.perf_counter() - t0, device_ms / 1e3

    block(xs[0].to(dev))            # warm-up: cuBLAS's kernels, the pool
    sync(dev)
    want, sync_s, device_s = sync_loop()
    router_topk.launches = 0
    acc = TorchAccelerator(block, max_inflight=ACC_INFLIGHT, device=dev)
    acc.run_then_freeze()
    t0 = time.perf_counter()
    for x in xs:
        acc.offload(x)
    acc.offload(FF_EOS)
    offload_s = time.perf_counter() - t0
    got = []
    while True:
        ok, r = acc.load_result(timeout=300)
        if not ok:
            break
        got.append(r)
    sync(dev)
    acc_s = time.perf_counter() - t0
    launches = router_topk.launches
    if acc.wait(60) != 0:
        fail(f"accelerator: the offloaded block raised {acc.error!r}")
    if len(got) != tasks:
        fail(f"accelerator: {len(got)} results for {tasks} tasks")
    if check_launches and launches != tasks:
        fail(f"accelerator: router_topk launched {launches} times for "
             f"{tasks} tasks")
    if not all(bool(torch.isfinite(r.float()).all()) for r in got):
        fail("accelerator: non-finite outputs")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    match = "bit for bit"
    if not same:
        want2, _, _ = sync_loop()
        noise = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(want, want2))
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        if err > noise:
            fail(f"accelerator: results differ from the synchronous loop "
                 f"by {err}, two synchronous loops by {noise}")
        match = (f"within {err} (two synchronous loops differ by {noise}: "
                 f"cuBLAS's bf16 products and the fp32 combine)")
    if cuda and not offload_s < device_s:
        fail(f"accelerator: the host took {offload_s * 1e3:.1f} ms to "
             f"offload {tasks} tasks, the device {device_s * 1e3:.1f} ms to "
             f"run them")
    say(f"[accelerator] {describe(cfg)} MoE block, {tasks} tasks of "
        f"{tokens} tokens from pinned memory, max_inflight {ACC_INFLIGHT}: "
        f"equal to the synchronous loop {match}; router_topk launched "
        f"{launches} times; host offload {offload_s * 1e3:.1f} ms against "
        f"{device_s * 1e3:.1f} ms of device time (CUDA events); "
        f"{tasks / acc_s:.1f} tasks/s offloaded against {tasks / sync_s:.1f} "
        f"tasks/s in the synchronous loop ({sync_s / acc_s:.2f}x) on {card}")
    return {"launches": launches, "offload_s": offload_s,
            "device_s": device_s, "acc_tasks_s": tasks / acc_s,
            "sync_tasks_s": tasks / sync_s, "bitwise": same}


PROC_WORKERS = 4
FEATURE_CHUNK = 512


def featurise(x):
    """The host featuriser in front of the hop: each 512-wide chunk of a
    token standardised, in a Python loop over numpy slices (GIL-bound, as
    host featurisers are).  Numpy only: it runs in forked workers."""
    import numpy as np
    y = np.empty_like(x)
    for c in range(0, x.shape[-1], FEATURE_CHUNK):
        s = x[c:c + FEATURE_CHUNK]
        y[c:c + FEATURE_CHUNK] = (s - s.mean()) / (s.std() + np.float32(1e-3))
    return y


def process_graph(fns: dict):
    """``pipeline(farm(featurise, n=4), pre, all_to_all(...), post)``."""
    from repro_torch.core import all_to_all, farm, pipeline
    hop = all_to_all([fns["left"]] * N_LEFT, fns["experts"],
                     router=fns["router"])
    return pipeline(farm(featurise, n=PROC_WORKERS), fns["pre"], hop,
                    fns["post"])


def phase_process_hop(main: dict, check_launches: bool = True,
                      card: str = "the CPU") -> dict:
    """Phase 3's hop behind a farm of 4 featuriser workers, once on host
    threads and once as a ``host_process`` farm forked from this process
    (CUDA up), microbatch 512 and 4 in flight, in turns (threads,
    processes, processes, threads).  Fails unless the process run equals
    the hop run on the featurised stream in stream order (within
    ``REL_TOL``) and the thread run byte for byte as a multiset (a thread
    farm's collector is arrival-ordered), and the a2a kernels launched in
    the process run.  Prints items/s of both and the calibrated shm hop."""
    import numpy as np
    from repro_torch.core import CompileConfig, perf_model
    from repro_torch.kernels.a2a_fused import a2a_combine, a2a_route
    fns, plan, stream = main["fns"], main["plan"], main["stream"]
    want = build_graph(fns).compile(config=CompileConfig(
        plan=plan, mode="device")).run([featurise(x) for x in stream])
    outs, rates, launches = {}, {"host": [], "host_process": []}, None
    for k, tier in enumerate(("host", "host_process", "host_process",
                              "host")):
        # normalize would fold ``pre`` into the farm as its collector, a
        # host stage; here it opens the device segment
        runner = process_graph(fns).compile(config=CompileConfig(
            plan=plan, placements={0: tier, 1: "device", 2: "device",
                                   3: "device"},
            microbatch=512, inflight=4, normalize=False))
        where = [p.target for _, p in runner.placements]
        if where != [tier, "device", "device", "device"]:
            fail(f"process hop placed as {where}")
        if k == 1:
            a2a_route.launches = a2a_combine.launches = 0
        t0 = time.perf_counter()
        outs[tier] = runner.run(stream, timeout=600)
        rates[tier].append(len(stream) / (time.perf_counter() - t0))
        if k == 1:
            launches = {"a2a_route": a2a_route.launches,
                        "a2a_combine": a2a_combine.launches}
    if check_launches and not all(launches.values()):
        fail(f"process hop: the a2a kernels did not launch: {launches}")
    proc, thr = outs["host_process"], outs["host"]
    if len(proc) != len(stream) or len(thr) != len(stream):
        fail(f"process hop: {len(proc)} / {len(thr)} items for "
             f"{len(stream)}")
    err = compare("process hop vs the hop on the featurised stream", proc,
                  torch.from_numpy(np.stack(want)).to(plan.device))
    if sorted(x.tobytes() for x in proc) != sorted(x.tobytes() for x in thr):
        fail("process hop: the process run's items differ from the thread "
             "run's")
    calib = perf_model.calibrate(cache=False)
    say(f"[process] pipeline(farm(featurise, n={PROC_WORKERS}), pre, "
        f"all_to_all, post), {len(stream)} tokens of {D_MODEL}: the "
        f"farm forked after CUDA init; in stream order within {err:.3g} of "
        f"the hop on the featurised stream, byte-equal to the thread run "
        f"as a multiset; a2a launches in the process run {launches}; "
        f"{max(rates['host']):.1f} items/s on threads, "
        f"{max(rates['host_process']):.1f} items/s on processes (best of "
        f"2 each, in turns: {[round(r, 1) for r in rates['host']]} / "
        f"{[round(r, 1) for r in rates['host_process']]}); shm hop "
        f"{calib.proc_hop_s * 1e6:.2f} us an item, batched "
        f"{calib.shm_batched_hop_s * 1e6:.2f} us, arena "
        f"{calib.arena_bw_gbs:.2f} GB/s (perf_model.calibrate) on {card}")
    return {"launches": launches, "threads_items_s": max(rates["host"]),
            "process_items_s": max(rates["host_process"]),
            "proc_hop_s": calib.proc_hop_s,
            "shm_batched_hop_s": calib.shm_batched_hop_s,
            "process_out": proc, "want": want}


# the reference's heterogeneous 2 x 2 all_to_all (tests/test_process_a2a.py):
# numpy workers and router, which run in forked workers
A2A_ITEMS = 2000


def a2a_l_scale(x):
    return x * 10.0


def a2a_l_shift(x):
    return x + 1.0


def a2a_r_dec(y):
    return y - 1.0


def a2a_r_double(y):
    return y * 2.0


def a2a_route_by_value(y, n_right):
    # numpy in the process workers, a torch tensor under the device
    # lowering's vmap
    if isinstance(y, torch.Tensor):
        return y.to(torch.int32) % n_right
    return y.astype("int32") % n_right


def a2a_expected(n: int, lefts: list, rights: list, router) -> list:
    """What the hop gives, in input order: item s goes to left worker
    s % nL, then to the routed right worker (round-robin per left worker
    without a router, as every backend's feeder does)."""
    import numpy as np
    out, rr = [], [i % len(rights) for i in range(len(lefts))]
    for seq in range(n):
        i = seq % len(lefts)
        y = lefts[i](np.float32(seq + 1))
        if router is not None:
            j = int(router(y, len(rights))) % len(rights)
        else:
            j, rr[i] = rr[i], (rr[i] + 1) % len(rights)
        out.append(float(rights[j](y)))
    return out


def phase_process_a2a(plan, n: int = A2A_ITEMS,
                      card: str = "the CPU") -> None:
    """The reference's 2 x 2 heterogeneous ``all_to_all`` on the port's
    process tier: two left and two right worker processes over the shm grid,
    so each right worker ends only after one EOS from every left worker
    (the multi-left EOS fan-out of ``ProcessA2ANode``, which the CPU tests,
    cut to one left worker, do not reach).  Once routed by value, once
    round-robin, ``n`` items each (past the grid's 32-slot segments).
    Fails unless each process run equals the expected outputs in input
    order, and the thread run (and, routed, the run on the device) the same
    multiset."""
    import numpy as np
    from repro_torch.core import CompileConfig, ProcessRunner, all_to_all
    lefts, rights = [a2a_l_scale, a2a_l_shift], [a2a_r_dec, a2a_r_double]
    xs = [np.float32(i) for i in range(1, n + 1)]
    secs = {}
    for label, router in (("routed", a2a_route_by_value),
                          ("round_robin", None)):
        want = a2a_expected(n, lefts, rights, router)
        r = all_to_all(lefts, rights, router=router).compile(
            config=CompileConfig(mode="process"))
        if not isinstance(r, ProcessRunner) or \
                [p.width for _, p in r.placements] != [4]:
            fail(f"2 x 2 process a2a ({label}) compiled to "
                 f"{type(r).__name__} {r.placements}")
        t0 = time.perf_counter()
        got = [float(v) for v in r.run(xs, timeout=120)]
        secs[label] = time.perf_counter() - t0
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            fail(f"2 x 2 process a2a ({label}): {len(got)} items for {n}, "
                 f"{len(bad)} differ, the first at {bad[:1]}")
        host = all_to_all(lefts, rights, router=router).compile(
            config=CompileConfig(mode="host")).run(xs, timeout=120)
        if sorted(float(v) for v in host) != sorted(want):
            fail(f"2 x 2 a2a ({label}): the thread run's items differ")
        if router is not None:
            dev = all_to_all(lefts, rights, router=router).compile(
                config=CompileConfig(plan=plan, mode="device")).run(xs)
            if sorted(float(v) for v in dev) != sorted(want):
                fail(f"2 x 2 a2a ({label}): the device run's items differ")
    say(f"[process] all_to_all 2 x 2 (the reference's heterogeneous "
        f"workers) on 4 worker processes, {n} items routed by value and "
        f"round-robin: each in input order, equal to the expected outputs; "
        f"the thread runs (and the routed run on {plan.device}) the same "
        f"multisets; {n / secs['routed']:.1f} / "
        f"{n / secs['round_robin']:.1f} items/s on {card}")


def augment(batch: dict, vocab: int) -> dict:
    """The data pipeline's compute stage: every 16th token, by a hash of
    its position and value, replaced by (7 t + 3) mod vocab.  Numpy only:
    it runs in forked workers."""
    import numpy as np
    t = batch["tokens"]
    pos = np.arange(t.size, dtype=np.int64).reshape(t.shape)
    hit = (pos * 2654435761 + t) % 16 == 0
    return {"tokens": np.where(hit, (t.astype(np.int64) * 7 + 3) % vocab,
                               t).astype(np.int32)}


class _NoCheckpoint:
    """Stands in for the driver's checkpoint manager where a run compares
    data and losses only (phase 5c holds the checkpoint)."""

    def wait(self) -> None:
        pass

    def save(self, *args, **kw) -> None:
        pass

    save_async = save


class _Recorded:
    """The pipeline as the driver sees it, keeping a host copy of every
    batch ``get()`` delivers."""

    def __init__(self, pipe):
        self.pipe, self.batches = pipe, []
        self.source = pipe.source

    def state(self) -> dict:
        return self.pipe.state()

    def get(self, timeout=None):
        b = self.pipe.get(timeout)
        if b is not None:
            self.batches.append({k: v.cpu() for k, v in b.items()})
        return b


def process_train_run(plan, cfg, batch: int, seq: int, steps: int,
                      workers: int, adaptive: bool = False) -> dict:
    """One ``TrainDriver`` run of ``cfg`` fed by ``make_pipeline(...,
    compute=augment, compute_workers=workers, adaptive=adaptive)``: its
    losses, the batches it delivered, its train tokens/s, the kernels'
    launches a step and, adaptive, the Supervisor's events and stats."""
    import functools
    import gc
    from repro_torch.data import SyntheticLMSource, make_pipeline
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime.driver import DriverConfig, TrainDriver
    from repro_torch.runtime.steps import init_state, make_train_step
    dev = plan.device
    state = init_state(cfg, plan, torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(cfg, plan, cosine_warmup(
        TRAIN_PEAK_LR, TRAIN_WARMUP, steps))
    pipe = _Recorded(make_pipeline(
        SyntheticLMSource(cfg.vocab, seq, batch, seed=0), plan,
        n_batches=steps, compute=functools.partial(augment, vocab=cfg.vocab),
        compute_workers=workers, adaptive=adaptive))
    driver = TrainDriver(step, state, pipe, DriverConfig(
        total_steps=steps, ckpt_every=steps + 1, log_every=steps + 1))
    driver.ckpt = _NoCheckpoint()
    del state
    kernels = zero_launches()
    sync(dev)
    out = driver.run()
    pipe.pipe.stop()                 # joins an adaptive run's Supervisor
    want = train_launches_per_step(cfg)
    per_step = {name: kernels[name].launches / steps for name in want}
    dts = [h["dt"] for h in out["history"]]
    med = sorted(dts[1:])[len(dts[1:]) // 2]
    res = {"losses": [h["loss"] for h in out["history"]],
           "batches": pipe.batches, "tok_s": batch * seq / med,
           "per_step": per_step, "want": want,
           "launches": {k: kernels[k].launches for k in want},
           "placements": [p.target for _, p in pipe.pipe.placements],
           "reasons": [p.reason for _, p in pipe.pipe.placements],
           "events": pipe.pipe.replacement_events(),
           "supervisor": pipe.pipe.stats().get("supervisor")}
    del driver, pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_process_train(plan, cfg, batch: int = 4, seq: int = 2048,
                        steps: int = 3, check_launches: bool = True,
                        card: str = "the CPU") -> dict:
    """``TrainDriver`` on ``cfg`` (Zamba2-1.2B at full width: ``ssd_scan``
    and ``flash_attention`` on the training path) for ``steps`` steps, fed
    by a data pipeline whose compute stage is a ``host_process`` farm of
    ``PROC_WORKERS`` workers, against two runs fed by one compute stage,
    all from the same seeds.  Fails unless every batch the farm delivered
    equals the single stage's bit for bit, the losses lie as close to the
    first single-stage run's as the second one's do, and the kernels
    launched twice a block a step."""
    a = process_train_run(plan, cfg, batch, seq, steps, 1)
    b = process_train_run(plan, cfg, batch, seq, steps, 1)
    c = process_train_run(plan, cfg, batch, seq, steps, PROC_WORKERS)
    if c["placements"][1] != "host_process" or a["placements"][1] != "host":
        fail(f"process-fed training placed as {c['placements']} / "
             f"{a['placements']}")
    if len(c["batches"]) != steps or len(a["batches"]) != steps:
        fail(f"process-fed training delivered {len(c['batches'])} / "
             f"{len(a['batches'])} batches for {steps} steps")
    for i, (x, y) in enumerate(zip(c["batches"], a["batches"])):
        if x.keys() != y.keys() or not all(torch.equal(x[k], y[k])
                                           for k in x):
            fail(f"process-fed training: batch {i} differs from the single "
                 f"compute stage's")
    noise = max(abs(p - q) for p, q in zip(a["losses"], b["losses"]))
    diff = max(abs(p - q) for p, q in zip(c["losses"], a["losses"]))
    if not all(math.isfinite(x) for x in c["losses"]) or diff > noise:
        fail(f"process-fed training: losses {c['losses']} against "
             f"{a['losses']} (two single-stage runs differ by {noise})")
    if check_launches and c["per_step"] != c["want"]:
        fail(f"process-fed training: kernel launches per step "
             f"{c['per_step']}, expected {c['want']}")
    say(f"[process] {describe(cfg)} TrainDriver B{batch} x S{seq}, {steps} "
        f"steps fed by make_pipeline(compute_workers={PROC_WORKERS}) (a "
        f"host_process farm forked after CUDA init): {steps} batches equal "
        f"compute_workers=1's bit for bit; losses "
        f"{' -> '.join(f'{x:.4f}' for x in c['losses'])}, "
        f"{diff} from the single stage's (two single-stage runs: {noise}); "
        f"kernel launches per step {c['per_step']}; "
        f"{c['tok_s']:.1f} train tokens/s against {a['tok_s']:.1f} / "
        f"{b['tok_s']:.1f} with one compute stage on {card}")
    return {"launches": c["launches"], "tok_s": c["tok_s"],
            "tok_s_single": (a["tok_s"], b["tok_s"]), "loss_diff": diff,
            "loss_noise": noise, "batches": c["batches"],
            "losses": c["losses"]}


# ---------------------------------------------------------------------------
# phase 8: the adaptive runtime in front of the kernels
# ---------------------------------------------------------------------------
ADAPT_INTERVAL = 0.02            # the Supervisor's sampling interval (s)
ADAPT_PENDING = 8                # the adaptive engine's max_pending


def show_events(events: list) -> str:
    return "; ".join(str(e) for e in events) or "none"


def phase_adaptive_hop(main: dict, hop: dict, check_launches: bool = True,
                       card: str = "the CPU") -> dict:
    """Phase 7's graph compiled with ``adaptive=True``: the featuriser farm
    an ``AdaptiveFarmNode`` starting on host threads, the hop on the device
    (microbatch 512, 4 in flight), run under ``Supervisor(runner,
    interval=ADAPT_INTERVAL)``.  Fails unless the Supervisor migrated the
    farm to ``host_process`` while the stream ran, the output is in stream
    order and byte-equal to phase 7's static process run (and within
    ``REL_TOL`` of the hop on the featurised stream), and the a2a kernels
    launched.  Then the compiler's annotate and place passes run on the
    same graph with no placement override and no sample: the featuriser's
    cost must come from the observed table."""
    import numpy as np
    from repro_torch.core import CompileConfig, Supervisor
    from repro_torch.core.compiler import _top_stages, annotate, place
    from repro_torch.kernels.a2a_fused import a2a_combine, a2a_route
    fns, plan, stream = main["fns"], main["plan"], main["stream"]
    runner = process_graph(fns).compile(config=CompileConfig(
        plan=plan, placements={0: "host", 1: "device", 2: "device",
                               3: "device"},
        microbatch=512, inflight=4, normalize=False, adaptive=True))
    where = [p.target for _, p in runner.placements]
    if where != ["host", "device", "device", "device"] or \
            "adaptive" not in runner.placements[0][1].reason:
        fail(f"adaptive hop placed as {runner.placements}")
    sup = Supervisor(runner, interval=ADAPT_INTERVAL)
    a2a_route.launches = a2a_combine.launches = 0
    sup.start()
    t_wall, t0 = time.time(), time.perf_counter()
    out = runner.run(stream, timeout=600)
    secs = time.perf_counter() - t0
    sup.stop()
    launches = {"a2a_route": a2a_route.launches,
                "a2a_combine": a2a_combine.launches}
    moves = [e for e in sup.events if e.kind == "migrate"]
    failed = [e for e in moves if "failed" in e.detail]
    swaps = runner.replacement_events()      # the node's own, timed inside
    if failed or not any(e.detail.startswith("-> host_process")
                         for e in moves) or not swaps:
        fail(f"adaptive hop: no live thread -> process migration: "
             f"{show_events(sup.events)}")
    if check_launches and not all(launches.values()):
        fail(f"adaptive hop: the a2a kernels did not launch: {launches}")
    static = hop["process_out"]
    if len(out) != len(stream) or any(a.tobytes() != b.tobytes()
                                      for a, b in zip(out, static)):
        fail("adaptive hop: the output differs from phase 7's static "
             "process run (stream order, bytes)")
    err = compare("adaptive hop vs the hop on the featurised stream", out,
                  torch.from_numpy(np.stack(hop["want"])).to(plan.device))
    first = swaps[0]
    st = sup.stats()
    say(f"[adaptive] pipeline(farm(featurise, n={PROC_WORKERS}), pre, "
        f"all_to_all, post), {len(stream)} tokens, compile(adaptive=True), "
        f"the farm on host threads under Supervisor(interval="
        f"{ADAPT_INTERVAL}): migrated {first.detail} {first.t - t_wall:.3f} "
        f"s after the stream started, the swap (drain + fork of "
        f"{PROC_WORKERS} workers) {first.latency_ms:.1f} ms; in stream "
        f"order, byte-equal to phase 7's process run, within {err:.3g} of "
        f"the hop on the featurised stream; a2a launches {launches}; "
        f"{len(stream) / secs:.1f} items/s supervised against phase 7's "
        f"{hop['threads_items_s']:.1f} on threads and "
        f"{hop['process_items_s']:.1f} on processes "
        f"({len(stream) / secs / hop['process_items_s']:.0%} of the "
        f"process rate); Supervisor {st['ticks']} ticks, loop "
        f"{st['loop_time_s'] * 1e3:.1f} ms in all, {st['observed_facts']} "
        f"observed facts; events: {show_events(sup.events)} on {card}")
    g = process_graph(fns)
    annotate(g)
    place(g, plan)
    farm = _top_stages(g)[0]
    if farm.cost.source != "observed":
        fail(f"adaptive hop: after the Supervisor stopped, the featuriser's "
             f"cost came from {farm.cost.source!r}, not the observed table")
    say(f"[adaptive] recompiled without overrides or sample=: featuriser "
        f"cost {farm.cost.t_task * 1e6:.1f} us an item from the observed "
        f"table (releases_gil {farm.cost.releases_gil}); place() put the "
        f"farm on {farm.placement.target} x{farm.placement.width} "
        f"({farm.placement.reason})")
    return {"launches": launches}


def phase_adaptive_serve(plan, cfg, prompts: list, tokens0: list,
                         max_new: int = SERVE_NEW,
                         max_batch: int = SERVE_BATCH,
                         cache_len: int = SERVE_CACHE,
                         check_launches: bool = True,
                         card: str = "the CPU") -> dict:
    """``InferenceEngine(adaptive=True, max_pending=ADAPT_PENDING)`` on
    ``cfg`` (phase 5's Mixtral), weights from seed 0, its Supervisor
    sampling every ``ADAPT_INTERVAL`` s, under a burst of ``prompts``
    (phase 5's).  Fails unless the Supervisor's events show a pressure
    change (degrade or shed) and a later restore, every request ends as a
    ``Request`` or an ``Overloaded``, request 0 (admitted at level 0) gives
    phase 5's ``tokens0``, and ``flash_attention`` and ``router_topk``
    launched."""
    import gc
    from repro_torch.runtime.steps import make_model
    from repro_torch.serving import InferenceEngine, Overloaded, Request
    dev = plan.device
    params = make_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    eng = InferenceEngine(cfg, plan, params, max_batch=max_batch,
                          cache_len=cache_len, adaptive=True,
                          max_pending=ADAPT_PENDING)
    eng.supervisor.interval = ADAPT_INTERVAL
    kernels = zero_launches()
    t0 = time.perf_counter()
    with eng:
        handles = [eng.submit(Request(prompt=p, max_new_tokens=max_new))
                   for p in prompts]
        outs = [h.result(timeout=900) for h in handles]
    wall = time.perf_counter() - t0
    launches = {n: kernels[n].launches
                for n in ("flash_attention", "router_topk")}
    events = eng.replacement_events()
    kinds = [e.kind for e in events]
    pressed = [i for i, k in enumerate(kinds) if k in ("degrade", "shed")]
    if not pressed or "restore" not in kinds[pressed[0]:]:
        fail(f"adaptive serve: no pressure change and later restore: "
             f"{show_events(events)}")
    if not all(isinstance(o, (Request, Overloaded)) for o in outs):
        fail(f"adaptive serve: outcomes {[type(o).__name__ for o in outs]}")
    first = outs[0]
    if not isinstance(first, Request) or first.degraded or \
            first.tokens != tokens0:
        fail(f"adaptive serve: request 0 gave {first!r}, phase 5 "
             f"{tokens0}")
    if check_launches and not all(launches.values()):
        fail(f"adaptive serve: kernels did not launch: {launches}")
    served = [o for o in outs if isinstance(o, Request)]
    shed = len(outs) - len(served)
    degraded = sum(o.degraded for o in served)
    n_tok = sum(len(o.tokens) for o in served)
    st = eng.stats()["supervisor"]
    say(f"[adaptive] {cfg.name} at {cfg.n_layers} layers, InferenceEngine("
        f"adaptive=True, max_pending={ADAPT_PENDING}), a burst of "
        f"{len(prompts)} of phase 5's requests: {len(served)} served "
        f"({degraded} degraded to {eng._slo.policy.degrade_tokens} tokens), "
        f"{shed} shed; {n_tok} tokens in {wall:.2f} s ({n_tok / wall:.1f} "
        f"generated tokens/s); request 0 equals phase 5's {len(tokens0)} "
        f"tokens; launches {launches}; Supervisor {st['ticks']} ticks; "
        f"events: {show_events(events)} on {card}")
    del eng, params, handles, outs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches}


def phase_adaptive_train(plan, cfg, ptrain: dict, batch: int = 4,
                         seq: int = 2048, steps: int = 3,
                         check_launches: bool = True,
                         card: str = "the CPU") -> dict:
    """``TrainDriver`` on ``cfg`` (Zamba2-1.2B whole) fed by
    ``make_pipeline(compute_workers=PROC_WORKERS, adaptive=True)``: fails
    unless the compute farm became an adaptive stage, its batches and the
    losses equal phase 7's process-fed run's bit for bit and the kernels
    launched twice a block a step.  Then ``launch/train.py --adaptive``
    trains ff-tiny on ``plan``'s device for a few steps."""
    import contextlib
    import io
    import shutil
    from repro_torch.launch import train as train_launcher
    d = process_train_run(plan, cfg, batch, seq, steps, PROC_WORKERS,
                          adaptive=True)
    if d["placements"][1] != "host_process" or \
            "adaptive" not in d["reasons"][1]:
        fail(f"adaptive-fed training placed as {d['placements']} "
             f"{d['reasons']}")
    if len(d["batches"]) != steps:
        fail(f"adaptive-fed training delivered {len(d['batches'])} batches")
    for i, (x, y) in enumerate(zip(d["batches"], ptrain["batches"])):
        if x.keys() != y.keys() or not all(torch.equal(x[k], y[k])
                                           for k in x):
            fail(f"adaptive-fed training: batch {i} differs from phase 7's")
    if d["losses"] != ptrain["losses"]:
        fail(f"adaptive-fed training: losses {d['losses']}, phase 7's "
             f"{ptrain['losses']}")
    if check_launches and d["per_step"] != d["want"]:
        fail(f"adaptive-fed training: kernel launches per step "
             f"{d['per_step']}, expected {d['want']}")
    say(f"[adaptive] {describe(cfg)} TrainDriver B{batch} x S{seq}, {steps} "
        f"steps fed by make_pipeline(compute_workers={PROC_WORKERS}, "
        f"adaptive=True): batches and losses "
        f"{' -> '.join(f'{x:.4f}' for x in d['losses'])} bit for bit "
        f"phase 7's process-fed run; kernel launches per step "
        f"{d['per_step']}; {d['tok_s']:.1f} train tokens/s against "
        f"{ptrain['tok_s']:.1f} in phase 7; Supervisor {d['supervisor']}; "
        f"events: {show_events(d['events'])} on {card}")
    ckpt = ROOT / "build" / "train_ckpt_adaptive"
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            train_launcher.main(["--device", str(plan.device), "--steps",
                                 "6", "--adaptive", "--ckpt-dir", str(ckpt),
                                 "--ckpt-every", "100"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    lines = buf.getvalue().splitlines()
    final = [ln for ln in lines if ln.startswith("final step 6")]
    report = [ln for ln in lines if ln.startswith("re-placement events")]
    if not final or not report:
        fail("launch/train.py --adaptive did not finish: "
             + " | ".join(lines[-5:]))
    say(f"[adaptive] launch/train.py --adaptive --device {plan.device} "
        f"(ff-tiny, 6 steps): {final[0]}; {report[0]}")
    return {"launches": d["launches"]}


# ---------------------------------------------------------------------------
# phase 9: the remote tier in front of the kernels, the boundary measured
# ---------------------------------------------------------------------------
REMOTE_POOLS = 4                 # loopback worker pools (one per farm worker)
REMOTE_DEMO_ITEMS = 5            # items the worker CLI serves in 9c


def remote_farm(runner):
    """The runner's ``RemoteFarmNode`` stage."""
    from repro_torch.core import RemoteFarmNode
    nodes = [st for st in runner._top_members()
             if isinstance(st, RemoteFarmNode)]
    if len(nodes) != 1:
        fail(f"remote hop: {len(nodes)} RemoteFarmNode stages in "
             f"{[type(st).__name__ for st in runner._top_members()]}")
    return nodes[0]


def compile_remote(fns: dict, plan, addrs: list, credit: int = 32):
    """Phase 7's graph with the featuriser farm on the remote pools and the
    hop on the device (microbatch 512, 4 in flight).  A farm stage mixed
    with device stages runs in the hybrid runner (an all-host graph with a
    remote farm would be a ``RemoteRunner``); the farm is one
    ``RemoteFarmNode`` stage of it."""
    from repro_torch.core import CompileConfig
    runner = process_graph(fns).compile(config=CompileConfig(
        plan=plan, placements={0: "host_remote", 1: "device", 2: "device",
                               3: "device"},
        remote_workers=addrs, net_credit=credit, microbatch=512, inflight=4,
        normalize=False))
    where = [(p.target, p.width) for _, p in runner.placements]
    if where[0] != ("host_remote", REMOTE_POOLS) or \
            [t for t, _ in where[1:]] != ["device"] * 3:
        fail(f"remote hop placed as {where}")
    if type(runner).__name__ != "HybridRunner":
        fail(f"remote hop compiled to {type(runner).__name__}")
    return runner


def same_bytes(out: list, want: list) -> bool:
    return len(out) == len(want) and all(a.tobytes() == b.tobytes()
                                         for a, b in zip(out, want))


def serve_worker_cli(card: str) -> dict:
    """9c: ``python -m repro_torch.launch.worker --listen 127.0.0.1:0`` as a
    subprocess; one lane of ``demo_fn`` with 5 items and EOS must come back
    squared, in order, with a ``WorkerStats`` record of 5 items."""
    from repro_torch.core import EOS, NetLane
    from repro_torch.core.net import parse_addr
    from repro_torch.core.shm import WorkerStats
    from repro_torch.launch.worker import demo_fn
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.worker", "--listen",
         "127.0.0.1:0"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env)
    try:
        line = proc.stdout.readline().strip()
        if not line.startswith("listening "):
            fail(f"worker CLI: first line {line!r}")
        up = time.perf_counter() - t0
        host, port = parse_addr(line.split()[1])
        lane = NetLane.connect(host, port, timeout=30.0)
        try:
            lane.push_fn(demo_fn)
            for i in range(REMOTE_DEMO_ITEMS):
                lane.push(float(i), timeout=10.0, seq=i)
            lane.push_eos()
            got, stats = {}, None
            while True:
                item, seq = lane.pop_seq(timeout=60.0)
                if item is EOS:
                    break
                if isinstance(item, WorkerStats):
                    stats = item
                    continue
                got[seq] = item
        finally:
            lane.shutdown()
    finally:
        proc.terminate()
        proc.wait(timeout=10.0)
    want = {i: float(i) * float(i) for i in range(REMOTE_DEMO_ITEMS)}
    if got != want or stats is None or stats.items != REMOTE_DEMO_ITEMS:
        fail(f"worker CLI: results {got}, stats {stats}")
    say(f"[remote] 9c: python -m repro_torch.launch.worker --listen "
        f"127.0.0.1:0 up in {up:.2f} s ({line}); one lane of demo_fn, "
        f"{REMOTE_DEMO_ITEMS} items and EOS: results {got}, {stats} on "
        f"{card}")
    return {"stats": stats}


def hybrid_prediction(main: dict, calib) -> dict:
    """``place()``'s per-item cost of phase 4's device segment (pre, the
    hop, post: one fused run of 3, microbatch 512) under the constants
    ``calib``: ``device_item_time``, what ``place`` charges a device
    candidate, for each of the three, whatever ``place`` would choose.  Each
    declares the work a lossless device run does (the SwiGLU experts on
    every token, the norms) and the item's 16 KiB float32 that crosses the
    boundary each way.  The synchronous boundary hides nothing: the same
    sum at ``overlap_eff`` 0.  A prediction to print; nothing fails on
    it."""
    import dataclasses
    from repro_torch.core.compiler import (CostEstimate, _top_stages,
                                           annotate, device_item_time)
    fns, item = main["fns"], D_MODEL * 4
    costs = {fns["pre"]: CostEstimate(flops=D_MODEL, bytes=item),
             fns["post"]: CostEstimate(flops=D_MODEL, bytes=item),
             # two left workers: RMSNorm each, half the item's bytes each
             fns["left"]: CostEstimate(flops=4 * D_MODEL, bytes=item / 2)}
    for e in fns["experts"]:
        costs[e] = CostEstimate(flops=6 * D_MODEL * D_FF, bytes=0.0)
    g = build_graph(fns, host_stages=True)
    annotate(g, costs=costs)
    segment = _top_stages(g)[1:4]
    serial = dataclasses.replace(calib, overlap_eff=0.0)
    return {key: sum(device_item_time(s.cost, c, len(segment), 1,
                                      HYBRID_MICROBATCH) for s in segment)
            for key, c in (("overlap_s", calib), ("sync_s", serial))}


def phase_remote(main: dict, hop: dict, hybrid: dict,
                 check_launches: bool = True, card: str = "the CPU") -> dict:
    """9a: phase 7's graph with ``farm(featurise, n=4)`` on 4 loopback worker
    pools forked after CUDA init (``host_remote`` x4, the hop on the device,
    microbatch 512, 4 in flight): the output in stream order and byte-equal
    to phase 7's static process run, the a2a kernels launched.  9b: the same
    graph again under ``Supervisor(runner, migrate=False)``: the output
    again equal, the calibration ``observed`` with a net hop moved from the
    measured one, and the featuriser's observed record refreshed; then
    ``annotate`` and ``place`` with ``remote_pool`` and no override.  9c:
    the worker CLI serving a lane.  9d: the boundary's constants measured on
    the card (``calibrate``) and ``place()``'s prediction for phase 4's
    segment under the defaults and under them, beside phase 4's times."""
    from repro_torch.core import Supervisor, perf_model, spawn_loopback_pool
    from repro_torch.core.compiler import _top_stages, annotate, place
    from repro_torch.kernels.a2a_fused import a2a_combine, a2a_route
    fns, plan, stream = main["fns"], main["plan"], main["stream"]
    static = hop["process_out"]
    t_phase = time.perf_counter()
    calib = perf_model.calibrate(cache=False)
    if plan.device.type == "cuda":
        torch.cuda.synchronize()         # no stream runs across the fork
    t0 = time.perf_counter()
    addrs, procs = spawn_loopback_pool(REMOTE_POOLS)
    pools_up = time.perf_counter() - t0
    try:
        # -- 9a: the static remote farm --------------------------------------
        runner = compile_remote(fns, plan, addrs)
        node = remote_farm(runner)
        a2a_route.launches = a2a_combine.launches = 0
        t0 = time.perf_counter()
        out = runner.run(stream, timeout=600)
        secs = time.perf_counter() - t0
        launches = {"a2a_route": a2a_route.launches,
                    "a2a_combine": a2a_combine.launches}
        if check_launches and not all(launches.values()):
            fail(f"remote hop: the a2a kernels did not launch: {launches}")
        if not same_bytes(out, static):
            fail("remote hop: the output differs from phase 7's static "
                 "process run (stream order, bytes)")
        st = node.node_stats()
        rate = len(stream) / secs
        say(f"[remote] 9a: pipeline(farm(featurise, n={PROC_WORKERS}), pre, "
            f"all_to_all, post), {len(stream)} tokens of {D_MODEL}, the farm "
            f"host_remote x{REMOTE_POOLS} on loopback pools forked after CUDA "
            f"init ({pools_up:.2f} s to come up): in stream order, "
            f"byte-equal to phase 7's process run; a2a launches {launches}; "
            f"{rate:.1f} items/s against phase 7's "
            f"{hop['threads_items_s']:.1f} on threads and "
            f"{hop['process_items_s']:.1f} on processes "
            f"({rate / hop['process_items_s']:.0%} of the process rate); "
            f"calibrated net hop {calib.net_hop_s * 1e6:.2f} us an item "
            f"(shm {calib.proc_hop_s * 1e6:.2f} us); node_stats: routed "
            f"per worker "
            f"{st['routed_per_worker']}, svc_cpu_ema_s "
            f"{st['svc_cpu_ema_s']:.3g}, hop_ema_s {st['hop_ema_s']:.3g}, "
            f"max lane depth {st['max_lane_depth']} on {card}")
        wide = compile_remote(fns, plan, addrs, credit=64)
        t0 = time.perf_counter()
        out64 = wide.run(stream, timeout=600)
        rate64 = len(stream) / (time.perf_counter() - t0)
        if not same_bytes(out64, static):
            fail("remote hop (net_credit 64): the output differs from phase "
                 "7's process run")
        depth64 = remote_farm(wide).node_stats()["max_lane_depth"]
        say(f"[remote] 9a: net_credit 64: {rate64:.1f} items/s, byte-equal "
            f"(max lane depth {depth64}) on {card}")
        # -- 9b: cluster autoscaling and the feedback loop --------------------
        key = perf_model.fn_key(featurise)
        before = perf_model.lookup_observed(key)
        c0 = perf_model.get_calibration(measure=False)
        runner = compile_remote(fns, plan, addrs)
        sup = Supervisor(runner, interval=ADAPT_INTERVAL, migrate=False)
        sup.start()
        t0 = time.perf_counter()
        try:
            out = runner.run(stream, timeout=600)
        finally:
            sup.stop()
        rate_sup = len(stream) / (time.perf_counter() - t0)
        if not same_bytes(out, static):
            fail("supervised remote hop: the output differs from 9a's")
        c1 = perf_model.get_calibration(measure=False)
        after = perf_model.lookup_observed(key)
        if c1.source != "observed" or c1.net_hop_s == c0.net_hop_s:
            fail(f"supervised remote hop: calibration {c1.source}, net hop "
                 f"{c1.net_hop_s} (was {c0.net_hop_s})")
        if after is None or after == before:
            fail(f"supervised remote hop: observed record for {key} "
                 f"{before} -> {after}")
        st = sup.stats()
        say(f"[remote] 9b: the same graph under Supervisor(interval="
            f"{ADAPT_INTERVAL}, migrate=False): {rate_sup:.1f} items/s, "
            f"byte-equal to 9a; events: {show_events(sup.events)}; "
            f"{st['ticks']} ticks, {st['observed_facts']} observed facts; "
            f"calibration {c1.source}: net hop {c0.net_hop_s * 1e6:.2f} -> "
            f"{c1.net_hop_s * 1e6:.2f} us; observed {key}: {before} -> "
            f"{after} on {card}")
        g = process_graph(fns)
        annotate(g)
        place(g, plan, remote_pool=addrs)
        farm = _top_stages(g)[0]
        say(f"[remote] 9b: annotate + place(remote_pool={REMOTE_POOLS} "
            f"pools), no override: featuriser cost "
            f"{farm.cost.t_task * 1e6:.1f} us an item ({farm.cost.source}, "
            f"releases_gil {farm.cost.releases_gil}) -> "
            f"{farm.placement.target} "
            f"x{farm.placement.width} ({farm.placement.reason})")
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(timeout=10.0)
    # -- 9c: the worker CLI --------------------------------------------------
    serve_worker_cli(card)
    # -- 9d: the boundary measured -------------------------------------------
    default = hybrid_prediction(main, perf_model.DEFAULT_CALIBRATION)
    measured = hybrid_prediction(main, calib)
    n = len(stream)
    seen = {k: hybrid[k] / n for k in ("overlap_s", "sync_s")}
    say(f"[remote] 9d: calibrate(): fused_segment_s "
        f"{calib.fused_segment_s * 1e6:.3f} us, h2d {calib.h2d_bw_gbs:.3f} "
        f"GB/s, d2h {calib.d2h_bw_gbs:.3f} GB/s, overlap_eff "
        f"{calib.overlap_eff:.3f}, dispatch "
        f"{calib.device_dispatch_s * 1e6:.3f} us; net hop "
        f"{calib.net_hop_s * 1e6:.3f} us, shm hop "
        f"{calib.proc_hop_s * 1e6:.3f} us, batched "
        f"{calib.shm_batched_hop_s * 1e6:.3f} us on {card}")
    say(f"[remote] 9d: place()'s per-item cost of phase 4's segment: "
        f"defaults {default['overlap_s'] * 1e6:.3f} us overlapped / "
        f"{default['sync_s'] * 1e6:.3f} us synchronous "
        f"({default['overlap_s'] / default['sync_s']:.3f}x); measured "
        f"constants {measured['overlap_s'] * 1e6:.3f} / "
        f"{measured['sync_s'] * 1e6:.3f} us "
        f"({measured['overlap_s'] / measured['sync_s']:.3f}x); phase 4 "
        f"measured {seen['overlap_s'] * 1e6:.3f} us overlapped / "
        f"{seen['sync_s'] * 1e6:.3f} us synchronous "
        f"({seen['overlap_s'] / seen['sync_s']:.3f}x) on {card}")
    say(f"[remote] phase 9 {time.perf_counter() - t_phase:.1f} s on {card}")
    return {"launches": launches, "calib": calib, "default": default,
            "measured": measured}


def path_rows(rows: list, paths: list) -> list:
    """Rows for kernels on a path whose shapes rows above already time:
    ``(name, row timed at the same shape, launches on the path)``."""
    by = {r["name"]: r for r in rows}
    return [dict(by[src], name=name, launches=n) for name, src, n in paths]


def main() -> int:
    import gc
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    # the cost model's cache (calibration, observed costs) inside the
    # checkout, fresh for the run: phase 8 writes the observed table
    cache = ROOT / "build" / "ff_cache"
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["REPRO_FF_CACHE"] = str(cache)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = phase_card()
    kernels = phase_kernels(dev)
    main = phase_main_path(dev)
    main["kernels"] = kernels
    hyb = phase_hybrid(main)
    from repro_torch.core.plan import single_device_plan
    cfg = serve_config()
    serve = phase_serve(single_device_plan(), cfg, serve_prompts(cfg.vocab))
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.configs import get
    hcfg = get("zamba2-1.2b")                # full width, full depth
    hybrid = phase_serve(single_device_plan(), hcfg,
                         serve_prompts(hcfg.vocab))
    train = phase_train_all(dev)
    gc.collect()
    torch.cuda.empty_cache()
    fams = phase_families(single_device_plan())
    fronts = phase_front_ends(single_device_plan())
    errs = kernels["max_abs_err"]
    rows = phase_times(dev, main, card["card"])
    rows += time_serving_kernels(dev, serve, hybrid, errs, card["card"])
    rows.append(time_ssd(dev, "ssd_scan", 1, hybrid["launches"]["ssd_scan"],
                         errs["ssd_scan"], card["card"]))
    rows += time_train_kernels(dev, train, errs, card["card"])
    rows += time_family_kernels(dev, fams, errs, card["card"])
    rows += time_front_end_kernels(dev, fronts, errs, card["card"])
    time_routes(dev, card["card"])
    gc.collect()
    torch.cuda.empty_cache()
    t7 = time.perf_counter()
    acc = phase_accelerator(single_device_plan(), get("mixtral-8x7b"),
                            card=card["card"])
    hop = phase_process_hop(main, card=card["card"])
    phase_process_a2a(single_device_plan(), card=card["card"])
    ptrain = phase_process_train(single_device_plan(), get("zamba2-1.2b"),
                                 card=card["card"])
    rows += a2a_rows(dev, 512, 512, hop["launches"], errs, card["card"],
                     "_process")
    rows += path_rows(rows, [
        ("router_topk_accelerator", "router_topk", acc["launches"]),
        ("flash_attention_process_train", "flash_attention_train_d64",
         ptrain["launches"]["flash_attention"]),
        ("ssd_scan_process_train", "ssd_scan_train",
         ptrain["launches"]["ssd_scan"])])
    say(f"[process] phase 7 {time.perf_counter() - t7:.1f} s on "
        f"{card['card']}")
    t8 = time.perf_counter()
    ahop = phase_adaptive_hop(main, hop, card=card["card"])
    aserve = phase_adaptive_serve(single_device_plan(), cfg,
                                  serve_prompts(cfg.vocab), serve["tokens0"],
                                  card=card["card"])
    atrain = phase_adaptive_train(single_device_plan(), get("zamba2-1.2b"),
                                  ptrain, card=card["card"])
    rows += path_rows(rows, [
        ("a2a_route_adaptive", "a2a_route_process",
         ahop["launches"]["a2a_route"]),
        ("a2a_combine_adaptive", "a2a_combine_process",
         ahop["launches"]["a2a_combine"]),
        ("flash_attention_adaptive_serve", "flash_attention",
         aserve["launches"]["flash_attention"]),
        ("router_topk_adaptive_serve", "router_topk",
         aserve["launches"]["router_topk"]),
        ("flash_attention_adaptive_train", "flash_attention_train_d64",
         atrain["launches"]["flash_attention"]),
        ("ssd_scan_adaptive_train", "ssd_scan_train",
         atrain["launches"]["ssd_scan"])])
    say(f"[adaptive] phase 8 {time.perf_counter() - t8:.1f} s on "
        f"{card['card']}")
    remote = phase_remote(main, hop, hyb, card=card["card"])
    rows += path_rows(rows, [
        ("a2a_route_remote", "a2a_route_process",
         remote["launches"]["a2a_route"]),
        ("a2a_combine_remote", "a2a_combine_process",
         remote["launches"]["a2a_combine"])])
    say(f"[done] {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(card["card"])
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
