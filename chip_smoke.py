#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. card — its name and power limit; the CUDA kernels built from the sources
   in ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a, one nvcc per
   source, all started together; each kernel's registers and spill bytes
   (``-Xptxas -v``) are printed, and an attention or ``ssd_scan``
   instance that spills fails the run; ``cuobjdump -sass`` must find HGMMA
   (``wgmma``) instructions in every bf16 ``flash_fwd_kernel_wgmma`` (D
   16-256) and in every ``ssd_scan_kernel_wgmma`` (the bf16-q/k
   recurrence: P tiles of 64 and 8, f32 and bf16 v), and no flash kernel
   with HMMA (``mma.sync``) alone (the count per kernel is printed); phase
   13's traces run in a process of their own
   beside phases 1-2;
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
   15, 17, 63, 65, 127-129, 255-257, q_offset off the tile, windows whose
   edge falls inside a tile, a group of 6, one query against 65 keys
   without a mask; D 16-256, f32 and bf16), and where the bf16 kernel
   splits the keys (Sq 1, 32 and 64 against 1500 and 4096 keys, a split
   every key of which is masked for some rows, an uneven last split); at
   Mixtral's D128 S2048, Whisper's encoder,
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
   bf16 step, 2**-7 relative, more); its backward kernel ``ssd_scan_bwd``
   against its plain backward at every training shape (Zamba2's B4, xLSTM's
   numerator and normaliser on 4 heads and a rank's 2) and at ragged S, S
   under a chunk, G < H, N and P off a tile, f32 and bf16 (f32 gradients
   within 1e-4 of their scale, bf16 within 2**-7 of it), two calls bit for
   bit and, at the training shapes, a CUDA graph's replay too
   (:data:`SSD_BWD_CASES`); ``gelu_stepwise`` and
   ``silu_stepwise``, forward and backward, against their plain versions
   bit for bit (NaN equal to NaN) at :data:`GELU_CASES` and
   :data:`SILU_CASES`: the models' activations (Whisper, a rank's half of
   it, Gemma-7B's prefill, Mixtral's and Kimi-K2's experts, Zamba2's
   gates), decode steps, f32, sizes off the 16-byte vectors, an
   unaligned view and magnitudes from 2**-140 to 2**100;
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
   Gemma-7B at full width cut to 2 of its 28 layers at B2 x S2048 and
   Whisper-medium whole at B8 clips of 1500 frames and 187 decoder tokens
   (``ClipSource``; its attention drawn as :func:`tf_tame` draws it),
   weights from seed 0.  The loss must be finite at every step and lower at
   the last than at the first; each kernel of the path must launch twice
   per block per step (forward and recompute: Zamba2 ``ssd_scan`` 76 and
   ``flash_attention`` 10, Mixtral ``flash_attention`` and ``router_topk``
   2) and each backward kernel once (Zamba2 ``ssd_scan_bwd`` 38; Gemma
   ``gelu_stepwise_bwd`` 2, Whisper 48, Zamba2 ``silu_stepwise_bwd`` 76);
   the peak must stay within the card's 80 GB; the driver's final
   checkpoint (under ``build/``, deleted after) must restore bit for bit.
   Prints the train tokens/s (the batch's tokens, and frames, over the
   median step after the first), each step's forward, backward and
   optimizer ms (CUDA events), the peak memory, the checkpoint's bytes and
   seconds, and a profile of one step with attention's recompute backward
   and ``ssd_scan``'s backward kernel (their ``record_function`` ranges)
   on their own.  Then one
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
   training shapes (and ``ssd_scan_bwd`` at Zamba2's B4, beside the plain
   recompute it replaced), phase 5d's (attention at Gemma's D256, B1 H16 S2048,
   beside ``scaled_dot_product_attention``; Kimi's router at E384 K8;
   ``ssd_scan`` at xLSTM's B1 H4 S2048 N = P = 384 and P = 1), phase 5e's
   (attention at Qwen2-VL's group of 6, Whisper's encoder and its cross
   attention at Sq 32 and 1, beside ``scaled_dot_product_attention``),
   ``gelu_stepwise`` and ``silu_stepwise`` forward and backward at
   Whisper's B8 x 1500 x 4096, Gemma's 2567 x 24576, Mixtral's experts at
   a 5000-token prefill and Zamba2's Mamba2 gate at B4 x S2048 (beside
   ``F.gelu``, ``F.silu`` and ``aten.gelu_backward`` /
   ``aten.silu_backward``), and the phase-3 items/s; then the
   routing kernels at :data:`ROUTE_TIMES` (``router_topk`` at decode's T 8,
   prefill's T 1859-5000 and wide routers; ``a2a_route`` at T 512 and 4096),
   each with its grid, beside an empty kernel's time (the latency floor)
   and the one-block kernel's time at the same shape;
7. the accelerator and the process tier — ``TorchAccelerator`` offloading
   one Mixtral-8x7B MoE block (d_model 4096, 8 experts top-2 of 14336,
   ``router_topk`` on the card): 32 tasks of 2048 tokens from pinned
   memory, 8 in flight, equal to a synchronous loop of the same calls bit
   for bit, offloaded in less host time than the blocks' device time (both
   timed warm: the accelerator after an untimed round of the tasks),
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
   ``node_stats()``;
10. the multi-device plan — ranks spawned with the *spawn* start method
   (``core.spmd.launch``), each on ``cuda:0``, importing ``repro_torch``
   only; their results and kernel launches come back to this process.
   10a, one rank over NCCL: Mixtral-8x7B at 1 of 32 layers (phase 5c's
   configuration, batches and schedule), 3 one-device steps in two
   micro-batches (10b's reference), then 2 steps of ``make_train_step`` on
   a (data=1, model=1) mesh with ``fsdp_params``: losses and parameters
   bit for bit phase 5c's after its first 2 steps; its state saved as a
   checkpoint.  10b, two ranks sharing the card over gloo: the same model
   and global batch through ``TrainDriver`` on (data=2, model=1), 3 steps
   with ``fsdp_params`` (each rank holding half of every fsdp-split leaf
   before and after), then 1 step replicated: losses within 2e-2 and every
   leaf's update within 0.45 (``tests/test_torch_train.py``'s bf16 bounds)
   of the one-rank run in two micro-batches, which routes each row apart
   as the ranks route theirs (phase 5c's losses are printed beside);
   ``flash_attention`` and ``router_topk`` launched in both ranks.  10c:
   10a's checkpoint restored onto the two ranks by ``reshard_state``: every
   block, and every parameter gathered back whole, bit for bit.  10d:
   ``pipeline_shard`` of 4 Mixtral blocks on 2 stages, M = 4 microbatches
   of B1 x S2048, equal to the blocks run serially; ``a2a_dispatch(mesh=
   data=2)`` at phase 3's shapes byte-equal to the one-rank hop (the a2a
   kernels launched in both ranks); the vocab-parallel embedding and loss
   at model=2 over Mixtral's 32000 x 4096, B2 x S2048, against the lookup
   and ``cross_entropy``; ``flash_decode_combine`` over a 4096-slot cache
   split in two, against the whole cache; ``tensor_map`` gather and reduce
   over a Llama-3.2-3B MLP against ``mlp`` (tolerances ``MD_TOL``).  Prints
   train tokens/s, each step's forward, backward, collective and optimizer
   ms, each rank's peak memory, the pipeline's ms a microbatch and the
   collectives each transport carried (calls and host seconds);
11. the model sharded over the model axis — the one-device runs it is
   held to first, in this process (Mixtral-8x7B at 1 layer served,
   Kimi-K2 at 1 layer's prefill), then two ranks
   spawned once, sharing the card over gloo on a (data 1, model 2) mesh,
   each drawing its blocks of the seed-0 weights (``init_blocks``).  11a:
   phase 5c's Mixtral at 1 of 32 layers, 2 steps of ``make_train_step``
   on its batches: losses within 2e-3 of phase 5c's first two, every
   leaf's update on the rank's block within ``TP_UPDATE_TOL`` of phase
   5c's after the same steps, and the same steps without the gradient sum
   over the model axis past it.  11b: the same model, a B1 x S2048 prefill and 16 decode
   steps fed the one-device run's tokens: the logits gathered over the
   model axis and the cache blocks (head_dim halves) within 2e-2 of the
   one-device run's scale, the greedy tokens equal but at a near tie.
   11c: Zamba2-1.2B whole, prefill and 16 greedy decode steps through the
   steps (timed), then again with every block's input and output kept:
   each block held alone against the one-device block on that input, the
   gathered logits against the one-device blocks' and each greedy token
   against their argmax, but at a near tie (``WALK_TOL``).  11d: Kimi-K2 at
   1 of 61 layers, expert-parallel (192 experts a rank), a B1 x S2048
   prefill: the block output of the tokens neither run dropped within
   ``MODEL_TOL`` of the one-device run's, both drop counts printed.  Each
   of 11a-11d fails unless its kernels launched on both ranks
   (``flash_attention`` and ``router_topk``; ``ssd_scan`` for Zamba2).
   Prints train and prefill tokens/s, decode ms a step (host and device),
   each step's forward / backward / collective / optimizer ms, the peak
   memory a rank, the collectives' calls and host seconds, the kernels'
   local shapes, and the kernels' times at those shapes.
13. the dry run held to the card — ``repro_torch.launch.dryrun.dry_step``
   (the sweep's core) traces each cell's step on fake ``cuda:0`` tensors
   (every kernel's launches counted by the trace's recorder, none
   launched; in a spawned process beside phases 1-2, which time nothing,
   as the traces take the host's CPU), then the card runs the same step on real tensors, once
   and then ``DRY_STEPS`` times: phase 5c's
   Zamba2-1.2B whole at B4 x S2048 and Mixtral-8x7B at 1 of 32 layers at
   B2 x S2048 (train steps), and phase 5's Mixtral at 4 layers through a
   B1 x S2048 prefill and a decode step at the engine's B8 against its
   4096-slot cache.  Fails unless each
   kernel's launches in the trace equal the card's ``launches`` counters
   for the first timed step and ``expected_launches``, the roofline's step
   time (H100 SXM data sheet) is no more than the median timed step, and
   the traced peak is within ``DRY_PEAK_TOL`` of
   ``torch.cuda.max_memory_allocated`` over that first timed step (the
   step's arguments included).  Prints each
   cell's compute, memory and collective terms, the dominant one, its
   FLOPs and bytes, and the measured step time and peak.

The last line of standard output is a JSON object with ``"ok": true`` and
the device; the line before it the card's name and power limit, and the
line before that the ``kernels`` record.  Without a CUDA
device, or without the ``src/repro_torch`` package beside this file, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import threading
import time
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# phase 1: the card and the build
# ---------------------------------------------------------------------------
def card_name(fallback: str = "nvidia-smi unavailable") -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else fallback


def tool_start(ap) -> tuple:
    """The timing tools' start (``tools/time_*.py``): ``--src DIR`` times
    the ``repro_torch`` package under ``DIR/src`` instead of this
    checkout's (an unpacked copy of another commit, built into its own
    ``build/``), so two trees can run in one call in turns.  Parses ``ap``
    with that option added, fails without a GPU, and returns ``(args,
    card, package root)``."""
    ap.add_argument("--src", help="a checkout whose src/repro_torch to time")
    args = ap.parse_args()
    if args.src:
        sys.path.insert(0, str(pathlib.Path(args.src).resolve() / "src"))
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from repro_torch.kernels import backend
    card = card_name(torch.cuda.get_device_name(0))
    pkg = pathlib.Path(backend.__file__).parents[2]
    say(f"[card] {card}; package {pkg}")
    return args, card, pkg


def phase_card() -> dict:
    from repro_torch.kernels import backend
    card = card_name()
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
    of the attention kernels (its D 256 layout is chosen not to) or of the
    recurrence spills.  A library built before this run has no report."""
    if "flash_attention" not in backend.PTXAS_REPORT:
        say("[build] flash_attention: built before this run, no ptxas report")
    for name in sorted(backend.PTXAS_REPORT):
        usage = ptxas_usage(backend.PTXAS_REPORT[name])
        say(f"[build] {name}: (registers, spill store B, spill load B) per "
            f"kernel {usage}")
        spilled = {fn: u for fn, u in usage.items()
                   if fn.startswith(NO_SPILL) and (u[1] or u[2])}
        if spilled:
            fail(f"{name}: instances that spill: {spilled}")


# the kernels whose instances may not spill
NO_SPILL = ("flash_fwd_kernel", "ssd_scan_kernel")
# the kernels that must run on the tensor cores: (library, name prefix,
# count of instantiations, instructions of which one must be there): the
# bf16 flash kernel for each head dim on wgmma (HGMMA), the recurrence with
# bf16 q/k (template <PT, V_BF16>: P tiles of 64 and 8, f32 and bf16 v) on
# wgmma; and the library whose kernels may not run on mma.sync alone (a
# flash kernel with HMMA and no HGMMA is the old design)
TENSOR_CORE_KERNELS = (("flash_attention", "flash_fwd_kernel_wgmma<", 5,
                        ("HGMMA",)),
                       ("ssd_scan", "ssd_scan_kernel_wgmma<", 4,
                        ("HGMMA",)))
HGMMA_ONLY = ("flash_attention", "flash_fwd_kernel")


def sass_mma_counts(lib: pathlib.Path) -> dict:
    """HMMA and HGMMA instructions per kernel of a built library, by
    ``cuobjdump -sass``: ``{kernel: {"HMMA": n, "HGMMA": n}}``, keyed by
    the kernels' names with their template arguments as mangled
    (``ILi64EE`` -> ``<64>``)."""
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
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
            continue
        m = re.search(r"\b(HG?MMA)\b", line)
        if fn is not None and m:
            counts[fn][m.group(1)] += 1
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
    holds one of its instructions (HGMMA), or if a flash kernel holds HMMA
    without HGMMA; print the counts per kernel."""
    for name, symbol, n, need in TENSOR_CORE_KERNELS:
        counts = sass_mma_counts(backend.library_path(name))
        say(f"[build] {name}: HMMA/HGMMA per kernel {counts}")
        tc = {fn: c for fn, c in counts.items() if fn.startswith(symbol)}
        if len(tc) != n or not all(any(c[i] for i in need)
                                   for c in tc.values()):
            fail(f"{name}: expected {n} instantiations of {symbol} with "
                 f"{' or '.join(need)} instructions, found {tc}")
        if name == HGMMA_ONLY[0]:
            old = {fn: c for fn, c in counts.items()
                   if fn.startswith(HGMMA_ONLY[1]) and c["HMMA"]
                   and not c["HGMMA"]}
            if old:
                fail(f"{name}: flash kernels on mma.sync alone: {old}")


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
    err["router_topk"], err["router_topk_e384"], rows, n_router = \
        check_router(dev)
    err.update(rows)
    err["ssd_scan"], rows, n_ssd = check_ssd(dev)
    err.update(rows)
    err["ssd_scan_bwd"], rows, n_ssd_bwd = check_ssd_bwd(dev)
    err.update(rows)
    stepwise, n_stepwise = check_stepwise(dev)
    err.update(stepwise)
    return {"checks": checks + n_flash + n_router + n_ssd + n_ssd_bwd
            + n_stepwise,
            "max_abs_err": err}


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py
# (B, H, Hkv, Sq, Sk, D, causal, window, dtypes): Mixtral's attention at the
# serving shapes, then the grid of tests/test_kernels.py:22-30
BF16, F32 = (torch.bfloat16,), (torch.float32, torch.bfloat16)
# (B, H, Hkv, Sq, Sk, causal, window) at the edges of the kernels' tiles
# (the f32 kernel's 64 rows, the bf16 kernel's 128 query rows in two
# warpgroups of 64 and its 128-key tiles, 64 at D 256) and 16-row
# fragments: lengths of 1, 15, 17, 63, 65, 127-129 and 255-257, q_offset =
# Sk - Sq off the tile, windows whose edge falls inside a tile
FLASH_EDGES = [(1, 2, 2, 1, 1, True, 0), (2, 4, 2, 15, 15, True, 0),
               (1, 4, 1, 17, 129, True, 0), (1, 2, 2, 63, 63, False, 0),
               (1, 4, 2, 65, 65, True, 7), (1, 4, 4, 129, 129, True, 100),
               (1, 2, 1, 1, 65, True, 0), (1, 8, 2, 100, 1000, True, 300),
               (2, 2, 2, 65, 129, False, 0), (1, 4, 2, 129, 200, True, 33),
               (1, 12, 2, 65, 129, True, 0),     # a GQA group of 6
               (1, 2, 2, 1, 65, False, 0),       # one query, every key
               (1, 4, 2, 127, 127, True, 0),     # the q tile - 1
               (1, 2, 2, 128, 255, True, 0),     # the q tile, 2 KV tiles - 1
               (1, 4, 1, 129, 257, False, 0),    # the q tile + 1, tiles + 1
               (1, 2, 2, 256, 256, True, 0),     # two q tiles, whole tiles
               (1, 4, 2, 200, 300, True, 90)]    # window edges, keys 11, 139
# (B, H, Hkv, Sq, Sk, D, causal, window) where the bf16 kernel splits the
# keys (launch_plan): Sq 1, 32 and 64 against 1500 and 4096 keys at B8
# H8 (64 blocks, 2 splits) and B1 H16 (6 splits of 2 tiles, 8 of 4);
# causal with Sq 64 against 4128 keys at B1 H4 (33 splits of one tile:
# the last, keys 4096-4127, masked for rows 0-31), the same at D128 with
# Sq 32 against 4112; H20 against 4096 keys (6 splits, the last of 2 tiles
# where the others take 6); D256 at one query (24 splits of 64 keys)
FLASH_SPLITS = [(B, H, H, Sq, Sk, 64, False, 0)
                for B, H in ((8, 8), (1, 16)) for Sq in (1, 32, 64)
                for Sk in (1500, 4096)] + [
    (1, 4, 2, 64, 4128, 64, True, 0),
    (1, 4, 4, 32, 4112, 128, True, 0),
    (1, 20, 4, 32, 4096, 64, False, 0),
    (1, 2, 2, 1, 1500, 256, False, 0)]
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
    (1, 16, 4, 2048, 2048, 128, True, 4096, BF16),   # phase 11 a rank:
    (1, 16, 16, 2048, 2048, 64, True, 4096, BF16),   # Mixtral, Zamba2,
    (1, 32, 4, 2048, 2048, 128, True, 0, BF16),      # Kimi-K2
    (1, 24, 8, 1024, 1024, 128, True, 0, BF16),      # phase 12 a rank:
    (1, 24, 8, 1024, 2048, 128, True, 0, BF16),      # Llama cp, ranks 0, 1
    (1, 12, 2, 1024, 1024, 128, True, 0, BF16),      # Qwen2-VL cp,
    (1, 12, 2, 1024, 2048, 128, True, 0, BF16),      # ranks 0, 1
    (8, 8, 8, 1500, 1500, 64, False, 0, F32),        # Whisper's encoder,
    (8, 8, 8, 32, 1500, 64, False, 0, F32),          # cross prefill,
    (8, 8, 8, 1, 1500, 64, False, 0, F32),           # cross decode,
    (8, 8, 8, 32, 32, 64, True, 0, F32),             # decoder self
] + [(B, H, Hkv, Sq, Sk, D, c, w, F32)
     for B, H, Hkv, Sq, Sk, D in ((1, 2, 2, 128, 128, 64),
                                  (2, 4, 2, 256, 256, 64),
                                  (1, 4, 1, 128, 256, 32),
                                  (1, 2, 2, 128, 128, 128),
                                  (1, 4, 2, 100, 100, 16))
     for c, w in ((True, 0), (True, 64), (False, 0))
] + [(B, H, Hkv, Sq, Sk, D, c, w, F32) for D in (16, 32, 64, 128, 256)
     for B, H, Hkv, Sq, Sk, c, w in FLASH_EDGES
] + [case + (BF16,) for case in FLASH_SPLITS]


# the cases at phase 5e's, 11's and 12's shapes, by the ``kernels`` row
# that reports them
FLASH_ROWS = {(1, 12, 2, 2048, 2048, 128, True, 0): "flash_attention_gqa6",
              (8, 16, 16, 1500, 1500, 64, False, 0):
              "flash_attention_encoder",
              (8, 16, 16, 32, 1500, 64, False, 0):
              "flash_attention_cross_prefill",
              (8, 16, 16, 1, 1500, 64, False, 0):
              "flash_attention_cross_decode",
              (1, 16, 4, 2048, 2048, 128, True, 4096): "flash_attention_tp",
              (1, 16, 16, 2048, 2048, 64, True, 4096):
              "flash_attention_tp_d64",
              (1, 32, 4, 2048, 2048, 128, True, 0):
              "flash_attention_tp_kimi",
              (1, 24, 8, 1024, 1024, 128, True, 0):
              "flash_attention_cp_llama_r0",
              (1, 24, 8, 1024, 2048, 128, True, 0):
              "flash_attention_cp_llama_r1",
              (1, 12, 2, 1024, 1024, 128, True, 0):
              "flash_attention_cp_qwen_r0",
              (1, 12, 2, 1024, 2048, 128, True, 0):
              "flash_attention_cp_qwen_r1",
              (8, 8, 8, 1500, 1500, 64, False, 0):
              "flash_attention_tp_encoder",
              (8, 8, 8, 32, 1500, 64, False, 0):
              "flash_attention_tp_cross_prefill",
              (8, 8, 8, 1, 1500, 64, False, 0):
              "flash_attention_tp_cross_decode",
              (8, 8, 8, 32, 32, 64, True, 0):
              "flash_attention_tp_dec_self"}


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
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     launch_plan)
    for D in FA.HEAD_DIMS:
        plan = launch_plan(1, 1, 1, 1, 1, D)
        tiling = tuple(FA._lib().flash_attention_tiling(D, i)
                       for i in range(4))
        if tiling != (plan.block_q, plan.block_k, plan.stages, plan.smem):
            fail(f"flash_attention: the library's tiling at D {D} (rows, "
                 f"keys, stages, shared bytes) {tiling} is not launch_plan's")
    unsplit = [c for c in FLASH_SPLITS if launch_plan(*c[:6]).splits < 2]
    if unsplit:
        fail(f"flash_attention: FLASH_SPLITS cases the plan does not split: "
             f"{unsplit}")
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
        f"5e's, 11's and 12's shapes {rows}, within 2e-2; f32 within 2e-5); "
        f"bf16 "
        f"within "
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
# gelu calls (Whisper's MLP over B8 x 1500 frames and a decode step, and
# over a rank's 2048 of its 4096 channels on a model axis of 2 (phase 12d),
# Gemma-7B's 2567-token prefill, Zamba2's shared block at its training
# batch, there in f32 as a model with fp32 parameters runs it), then sizes
# under and off the kernel's 16-byte vectors and an unaligned view; a row
# "wide" draws magnitudes from 2**-140 to 2**100 (subnormal products,
# overflow to infinity, rounding carries into the exponent).  Each case
# holds the forward and the backward kernel (its row is the forward row's
# with ``_bwd`` after the kernel's name)
GELU_CASES = [((8, 1500, 4096), torch.bfloat16, 0, "gelu_stepwise"),
              ((8, 1, 4096), torch.bfloat16, 0, None),
              ((8, 1500, 2048), torch.bfloat16, 0, "gelu_stepwise_tp"),
              ((8, 32, 2048), torch.bfloat16, 0, None),
              ((1, 2567, 24576), torch.bfloat16, 0, "gelu_stepwise_gemma"),
              ((4, 2048, 8192), torch.float32, 0, None),
              ((1,), torch.bfloat16, 0, None), ((7,), torch.float32, 0, None),
              ((3, 37, 64), torch.bfloat16, 0, None),
              ((5, 333), torch.bfloat16, 1, None),
              ((5, 333), torch.float32, 1, None),
              ((1 << 20,), torch.bfloat16, 0, "wide"),
              ((1 << 20,), torch.float32, 0, "wide")]
# the same for silu: Mixtral's experts at a 5000-token prefill (E8 x C1568
# x 14336) and a decode step's (8 tokens, top-2: C 8), Zamba2's Mamba2 gates
# at its training batch (B4 x S2048 x 4096) and a decode step, in f32 as
# well, Kimi-K2's experts (E384 top-8 at 2048 tokens: C 56 x 2048), then
# the edges above
SILU_CASES = [((8, 1568, 14336), torch.bfloat16, 0, "silu_stepwise"),
              ((8, 8, 14336), torch.bfloat16, 0, None),
              ((4, 2048, 4096), torch.bfloat16, 0, "silu_stepwise_zamba2"),
              ((4, 2048, 4096), torch.float32, 0, None),
              ((8, 1, 4096), torch.bfloat16, 0, None),
              ((384, 56, 2048), torch.bfloat16, 0, None),
              ((1,), torch.bfloat16, 0, None), ((7,), torch.float32, 0, None),
              ((3, 37, 64), torch.bfloat16, 0, None),
              ((5, 333), torch.bfloat16, 1, None),
              ((5, 333), torch.float32, 1, None),
              ((1 << 20,), torch.bfloat16, 0, "wide"),
              ((1 << 20,), torch.float32, 0, "wide")]


def bwd_row(row: str) -> str:
    """The ``kernels`` row of a forward row's backward kernel."""
    return row.replace("_stepwise", "_stepwise_bwd")


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit, a NaN equal to a NaN (an infinite product times a zero
    difference is NaN in both versions)."""
    nan = got.isnan()
    return torch.equal(nan, want.isnan()) and torch.equal(got[~nan],
                                                          want[~nan])


def check_stepwise(dev: torch.device) -> tuple:
    """``gelu_stepwise`` and ``silu_stepwise``, forward and backward,
    against their plain versions, bit for bit (each step rounds to the
    type in both); the worst error by ``kernels`` row and the number of
    cases."""
    from repro_torch.kernels import gelu_stepwise as G, silu_stepwise as S
    g = torch.Generator().manual_seed(17)
    rows = {}
    kernels = (("gelu", GELU_CASES, G.gelu_stepwise, G.gelu_stepwise_plain,
                G.gelu_stepwise_bwd, G.gelu_stepwise_vjp_plain),
               ("silu", SILU_CASES, S.silu_stepwise, S.silu_stepwise_plain,
                S.silu_stepwise_bwd, S.silu_stepwise_vjp_plain))
    n_cases = 0
    for kernel, cases, fwd, plain, bwd, vjp in kernels:
        for shape, dtype, offset, row in cases:
            n = math.prod(shape)
            x = torch.randn(n + offset, generator=g) * 4
            if row == "wide":
                x = x * torch.exp2(torch.randint(-140, 100, x.shape,
                                                 generator=g).float())
            x = x.to(dtype).to(dev)[offset:].view(shape)
            dy = torch.randn(n + offset, generator=g).to(dtype).to(dev)[
                offset:].view(shape)
            for what, got, want in (("forward", fwd(x), plain(x)),
                                    ("backward", bwd(x, dy), vjp(x, dy))):
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                diff = diff[diff.isfinite()]
                e = float(diff.max()) if diff.numel() else 0.0
                if got.dtype != dtype or not same_bits(got, want):
                    fail(f"{kernel}_stepwise {what} != plain at {shape} "
                         f"{dtype} offset {offset}: max |err| {e}, "
                         f"{int((got != want).sum())} of {n} elements "
                         f"differ")
                if row and row != "wide":
                    rows[row if what == "forward" else bwd_row(row)] = e
                del got, want, diff
            n_cases += 2
            del x, dy
    say(f"[kernels] gelu_stepwise and silu_stepwise equal their plain "
        f"versions bit for bit, forward and backward ({n_cases} cases)")
    return rows, n_cases


# the prompt lengths of phase 5d's requests (serve_prompts at numpy seed 0:
# 8 of 100-3000 tokens), and the length its kernels are timed at
FAMILY_LENS = (2567, 1947, 1582, 882, 993, 218, 318, 147)
# (T, E, K): the serving shapes (decode T = max_batch, prefill T = prompt
# length; 300 and 512 are prompts that one block of many warps takes whole),
# the training batch's 4096 tokens, and wider routers; then Kimi-K2's E384
# top-8 at phase 5d's decode batch, its prefills and the timed 2048, and
# phase 11's 1024 tokens a rank
ROUTER_CASES = [(8, 8, 2), (300, 8, 2), (512, 8, 2), (2048, 8, 2),
                (4096, 8, 2), (5000, 8, 2), (8, 64, 8),
                (2048, 64, 8), (2048, 256, 8), (5000, 256, 4), (5000, 384, 8),
                (8, 384, 8), (2048, 384, 8), (1024, 384, 8)] + [
                    (T, 384, 8) for T in FAMILY_LENS]
# the cases at phase 11's shapes, by the ``kernels`` row that reports them
ROUTER_ROWS = {(2048, 8, 2): "router_topk_tp",
               (1024, 384, 8): "router_topk_tp_e384"}


def check_router(dev: torch.device) -> tuple:
    """The worst weight error over every case, over those at Kimi-K2's E384
    top-8 (the ``router_topk_e384`` row), at each shape of
    :data:`ROUTER_ROWS` (a dict by row), and the number of cases."""
    from repro_torch.core.device import expert_capacity
    from repro_torch.kernels.router_topk import router_topk, router_topk_plain
    g = torch.Generator().manual_seed(4)
    worst, kimi, n = 0.0, 0.0, 0
    rows = {name: 0.0 for name in ROUTER_ROWS.values()}
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
            row = ROUTER_ROWS.get((T, E, K))
            if row:
                rows[row] = max(rows[row], e)
            n += 1
    if worst > 1.2e-7:               # one ulp of a weight near 1
        fail(f"router_topk weights differ from plain by {worst}")
    say(f"[kernels] router_topk equals its plain version ({n} cases: "
        f"experts, positions, keep equal; max |w err| {worst:.3g}, at E384 "
        f"K8 {kimi:.3g}, at phase 11's shapes {rows})")
    return worst, kimi, rows, n


# (B, H, G, S, N, P, chunk, types): Zamba2's prefill (one group of q/k for
# 64 heads, and phase 11's 32 a rank; 8 chunks at S 2048, 20 at S 5000),
# the grid of tests/test_kernels.py:61-66, xLSTM-125m's mLSTM (4 heads of
# N = P = 384, and its P = 1 normaliser, also on a rank's 2) at phase 5d's
# prompt lengths and the timed 2048, and the edges of the bf16 kernel's
# tiling (launch_plan's P tiles of 64 and 8).  Types: "model" is the Mamba2 and mLSTM
# blocks' call (bf16 q/k, f32 v and log_a, f32 y), "f32" and "bf16" give
# every tensor that type.
SSD_ALL = ("model", "f32", "bf16")
SSD_CASES = [
    (1, 64, 1, 2048, 64, 64, 256, SSD_ALL),
    (4, 64, 1, 2048, 64, 64, 256, ("model",)),  # Zamba2's training batch
    (1, 32, 1, 2048, 64, 64, 256, ("model",)),  # Zamba2's heads a rank
    (1, 2, 2, 2048, 384, 384, 256, ("model",)),  # xLSTM's mLSTM heads a
    (1, 2, 2, 2048, 384, 1, 256, ("model",)),    # rank (phase 12c)
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
    # the bf16 kernel's tiling edges: P at a 64-column tile +- 1 and at the
    # 8-column tile +- 1, N 384 at S = chunk +- 1, a chain of 20 chunks
    (1, 2, 2, 300, 64, 63, 256, ("model", "bf16")),
    (1, 2, 2, 300, 64, 65, 256, ("model", "bf16")),
    (1, 2, 2, 300, 64, 7, 256, ("model", "bf16")),
    (1, 2, 2, 300, 64, 9, 256, ("model", "bf16")),
    (1, 2, 2, 255, 384, 384, 256, ("model", "bf16")),
    (1, 2, 2, 257, 384, 384, 256, ("model", "bf16")),
    (1, 2, 2, 1280, 384, 384, 64, ("model",)),
] + [(1, 4, 4, S, 384, P, 256, ("model",))
     for S in (2048,) + FAMILY_LENS for P in (384, 1)]
# the model-type cases at phase 11's and 12's shapes, by the ``kernels``
# row
SSD_ROWS = {(1, 32, 1, 2048, 64, 64): "ssd_scan_tp",
            (1, 2, 2, 2048, 384, 384): "ssd_scan_tp_xlstm",
            (1, 2, 2, 2048, 384, 1): "ssd_scan_tp_xlstm_p1"}
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
    """The worst error over every case, a dict of the worst over the
    model-type cases by timing row (xLSTM's: ``ssd_scan_xlstm`` at P =
    384, ``ssd_scan_xlstm_p1`` at P = 1; :data:`SSD_ROWS`), and the number
    of cases."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    g = torch.Generator().manual_seed(6)
    worst, n = 0.0, 0
    rows = {"ssd_scan_xlstm": 0.0, "ssd_scan_xlstm_p1": 0.0}
    rows.update({name: 0.0 for name in SSD_ROWS.values()})
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
                row = SSD_ROWS.get((B, H, G, S, N, P))
                if N == 384 and row is None:
                    row = "ssd_scan_xlstm" + ("_p1" if P == 1 else "")
                if row and t == "model":
                    rows[row] = max(rows[row], e)
            n += 1
            del q, k, v, la, y, st, py, pst
    say(f"[kernels] ssd_scan equals its plain version ({n} cases, y and "
        f"state; max |err| {worst:.3g}, the model types by row "
        f"{ {r: float(f'{e:.3g}') for r, e in rows.items()} }; f32 within "
        f"1e-4 of the scale, bf16 y within 2**-7)")
    return worst, rows, n


# (B, H, G, S, N, P, chunk, types) of the backward: every training path on
# the card (Zamba2's Mamba2 layer at B4, xLSTM's numerator and P = 1
# normaliser on 4 heads and on a rank's 2), ragged S (a tail of 136, S under
# a chunk, a tail of 5 at chunk 128), G < H (one group and two), N and P
# past a 64 tile, off a tile (63) and at P 1, f32 q/k and bf16 throughout,
# and a chunk of 8192 (every kernel's shared memory past the 48 KB a block
# gets without opting in)
SSD_BWD_CASES = [
    (4, 64, 1, 2048, 64, 64, 256, ("model",)),
    (1, 4, 4, 2048, 384, 384, 256, ("model",)),
    (1, 2, 2, 2048, 384, 384, 256, ("model",)),
    (1, 4, 4, 2048, 384, 1, 256, ("model",)),
    (1, 2, 2, 2048, 384, 1, 256, ("model",)),
    (1, 64, 1, 5000, 64, 64, 256, SSD_ALL),
    (1, 64, 1, 100, 64, 64, 256, SSD_ALL),
    (4, 64, 1, 133, 64, 64, 128, SSD_ALL),
    (1, 4, 2, 300, 64, 63, 256, ("model", "bf16")),
    (1, 2, 1, 200, 72, 130, 96, ("f32", "bf16")),
    (2, 3, 3, 256, 32, 64, 128, ("f32", "bf16")),
    (1, 1, 1, 64, 8, 8, 64, ("f32", "bf16")),
    (1, 2, 2, 257, 384, 384, 256, ("model", "bf16")),
    (1, 2, 1, 8200, 16, 8, 8192, ("f32",)),
]
# the model-type cases at the training paths' shapes, by the ``kernels``
# row; their kernel calls are also replayed in a CUDA graph
SSD_BWD_ROWS = {(4, 64, 1, 2048, 64, 64): "ssd_scan_bwd_train",
                (1, 2, 2, 2048, 384, 384): "ssd_scan_bwd_tp_xlstm",
                (1, 2, 2, 2048, 384, 1): "ssd_scan_bwd_tp_xlstm_p1"}


def ssd_bwd_inputs(g: torch.Generator, dev: torch.device, case: tuple,
                   types: str) -> tuple:
    """:func:`ssd_inputs` and the cotangents: dy ``(B,H,S,P)`` in y's type
    (f32 for the model types), the final state's fp32 ``(B,H,N,P)`` (zero
    at the training shapes, whose state is unused, as autograd hands it)."""
    B, H, G, S, N, P = case[:6]
    q, k, v, la = ssd_inputs(g, dev, B, H, G, S, N, P, types)
    y_t = torch.float32 if types == "model" else q.dtype
    gy = torch.randn(B, H, S, P, generator=g).to(y_t).to(dev)
    gs = torch.randn(B, H, N, P, generator=g).to(dev)
    if S == 2048:
        gs.zero_()
    return q, k, v, la, gy, gs


def check_ssd_bwd(dev: torch.device) -> tuple:
    """``ssd_scan_bwd`` against ``ssd_scan_bwd_plain`` at
    :data:`SSD_BWD_CASES`: every gradient finite, of its input's type and
    shape, f32 within ``SSD_TOL["f32"]`` of its scale (sums in other
    orders) and bf16 within ``SSD_TOL["bf16"]`` of it (a group's dq and dk
    sum each head's gradient rounded to bf16, and where the two versions
    round a head to either side of a bf16 step the sum moves by that
    head's step, however small the sum); a second call equal bit for bit, and at
    :data:`SSD_BWD_ROWS` a CUDA graph's replay too.  Returns the worst
    error over the scale, the model-type cases' worst by ``kernels`` row
    and the number of cases."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_bwd_plain
    g = torch.Generator().manual_seed(16)
    worst, n = 0.0, 0
    rows = {name: 0.0 for name in SSD_BWD_ROWS.values()}
    for case in SSD_BWD_CASES:
        B, H, G, S, N, P, chunk, types = case
        for t in types:
            q, k, v, la, gy, gs = ssd_bwd_inputs(g, dev, case, t)
            got = ssd_scan_bwd(q, k, v, la, gy, gs, chunk)
            again = ssd_scan_bwd(q, k, v, la, gy, gs, chunk)
            want = ssd_scan_bwd_plain(q, k, v, la, gy, gs, chunk)
            torch.cuda.synchronize()
            where = f"B{B} H{H}/G{G} S{S} N{N} P{P} chunk {chunk} ({t})"
            row = SSD_BWD_ROWS.get(case[:6])
            if row:
                outs = []
                graph = torch.cuda.CUDAGraph()
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    ssd_scan_bwd(q, k, v, la, gy, gs, chunk)
                torch.cuda.current_stream().wait_stream(side)
                with torch.cuda.graph(graph):
                    outs = ssd_scan_bwd(q, k, v, la, gy, gs, chunk)
                graph.replay()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(outs, got)):
                    fail(f"ssd_scan_bwd: a CUDA graph's replay differs from "
                         f"the eager call at {where}")
                del graph, outs
            for name, a, b, w, src in zip(("dq", "dk", "dv", "dlog_a"), got,
                                          again, want, (q, k, v, la)):
                if a.dtype != src.dtype or a.shape != src.shape:
                    fail(f"ssd_scan_bwd {name} {a.dtype} {tuple(a.shape)} at "
                         f"{where}, input {src.dtype} {tuple(src.shape)}")
                if not torch.equal(a, b):
                    fail(f"ssd_scan_bwd {name}: two calls differ at {where}")
                tol = SSD_TOL["bf16" if a.dtype == torch.bfloat16 else "f32"]
                af, wf = a.float(), w.float()
                e = float((af - wf).abs().max())
                scale = max(float(wf.abs().max()), 1e-30)
                if not bool(torch.isfinite(af).all()) or not torch.allclose(
                        af, wf, rtol=tol, atol=tol * scale):
                    fail(f"ssd_scan_bwd {name} != plain at {where}: max |err| "
                         f"{e}, scale {scale}")
                worst = max(worst, e / scale)
                if row and t == "model":
                    rows[row] = max(rows[row], e)
            n += 1
            del q, k, v, la, gy, gs, got, again, want
    say(f"[kernels] ssd_scan_bwd equals its plain backward ({n} cases; "
        f"worst |err| / scale {worst:.3g}, the model types by row "
        f"{ {r: float(f'{e:.3g}') for r, e in rows.items()} }; f32 within "
        f"1e-4 of the scale, bf16 within 2**-7 of it; two calls and a CUDA "
        f"graph's replay bit-equal)")
    return worst, rows, n


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
    # 10e's stream, which leaves a partial microbatch, at this microbatch
    # and at half of it, a rank's block of it over two ranks (a runner
    # runs once)
    short = {mb: build_graph(main["fns"], host_stages=True).compile(
        config=CompileConfig(plan=main["plan"], placements=placements,
                             microbatch=mb, inflight=4)
    ).run(main["stream"][:GRAPH_HYBRID_ITEMS])
        for mb in (HYBRID_MICROBATCH, HYBRID_MICROBATCH // 2)}
    if any(len(s) != GRAPH_HYBRID_ITEMS for s in short.values()):
        fail(f"the hybrid over {GRAPH_HYBRID_ITEMS} items lost items")
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
    return {"overlap_s": times[True], "sync_s": times[False],
            "short": short}


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
    """The kernel wrappers, each with its launch count."""
    from repro_torch.kernels import wrappers
    return wrappers()


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


def expected_launches(cfg, prefills: int, steps: int,
                      backward: int = 0) -> dict:
    """Launches a model path must make over ``prefills`` prefills (or
    forward passes), ``steps`` decode steps and ``backward`` backward
    passes: attention once per attention block per prefill (decode's
    self-attention is plain; a ``dec`` block adds its cross attention,
    which runs the kernel at every decode step too), the router once per
    MoE layer per prefill and decode step, the recurrence once per Mamba2
    layer and twice per mLSTM layer (numerator and normaliser) per prefill
    (decode runs the plain step) and its backward kernel as often per
    backward pass; the MLP's activation (gelu or silu, the
    config's) once per dense MLP per prefill and decode step (the
    encoder's at prefill only), and silu besides once per MoE layer (the
    experts; twice with a shared expert) and twice per Mamba2 (``xi``,
    ``z``) and mLSTM (its two gates) layer per prefill and decode step;
    each activation's backward kernel once per backward pass for each of
    its prefill launches."""
    n = {}
    for kind, count in cfg.segments:
        n[kind] = n.get(kind, 0) + count
    dense = n.get("dense", 0) + n.get("shared_attn", 0)
    enc, dec, moe = n.get("enc", 0), n.get("dec", 0), n.get("moe", 0)
    want = {"flash_attention": (dense + moe + enc + 2 * dec) * prefills
            + dec * steps}
    if moe:
        want["router_topk"] = moe * (prefills + steps)
    if n.get("mamba2") or n.get("mlstm"):
        ssd = n.get("mamba2", 0) + 2 * n.get("mlstm", 0)
        want["ssd_scan"] = ssd * prefills
        if backward:
            want["ssd_scan_bwd"] = ssd * backward
    per = {}                      # (calls a prefill, calls a decode step)
    if dense + enc + dec:
        per[f"{cfg.act}_stepwise"] = (dense + enc + dec, dense + dec)
    gates = moe * (1 + bool(cfg.n_shared_experts)) \
        + 2 * (n.get("mamba2", 0) + n.get("mlstm", 0))
    if gates:
        a, b = per.get("silu_stepwise", (0, 0))
        per["silu_stepwise"] = (a + gates, b + gates)
    for name, (pre, per_step) in per.items():
        want[name] = pre * prefills + per_step * steps
        if backward:
            want[f"{name}_bwd"] = pre * backward
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
                   ("ssd_scan_bwd", ("ssd_bwd_",)),
                   ("flash_attention", ("flash_fwd_kernel",)),
                   ("gelu_stepwise", ("GeluFwd",)),
                   ("gelu_stepwise_bwd", ("GeluBwd",)),
                   ("silu_stepwise", ("SiluFwd",)),
                   ("silu_stepwise_bwd", ("SiluBwd",)),
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
    over the range's calls and every op under them; for a range whose
    only kernel is launched through ctypes, which the profiler ties to no
    op, the range's own device-side record) goes into ``out`` as (ms,
    calls); those kernels are counted in the families too."""
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
            # the device-side record spans from the range's first kernel
            # to its last, others' between included: read only where the
            # range's own kernels are not tied to it
            if named.get(e.key, (1.0,))[0] == 0.0 and e.device_type == \
                    torch.autograd.DeviceType.CUDA:
                named[e.key] = (e.self_device_time_total / 1e3,
                                named[e.key][1])
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
TRAIN_GEMMA_LAYERS = 2           # of 28: 1.34 B parameters, 13.4 GB of state
TRAIN_WHISPER_FRAMES = 1500      # a clip's frames; Whisper-medium whole
# configs whose seed-0 draw trains from :func:`tf_tame`'s attention: at
# Whisper-medium's depth the draw's encoder gradients reach 1e24, their
# squares overflow the fp32 global norm and the clip zeroes every update
TRAIN_TAMED = ("whisper-medium",)
CARD_GB = 80
RECOMPUTE_RANGES = ("flash_attention.recompute_backward",
                    "ssd_scan.backward", "router_topk.backward",
                    "gelu_stepwise.backward", "silu_stepwise.backward")


def train_configs() -> list:
    """(config, batch, seq): Zamba2-1.2B whole at B4 x S2048, Mixtral-8x7B
    cut to 1 of its 32 layers at B2 x S2048, Gemma-7B cut to 2 of its 28
    at B2 x S2048, Whisper-medium whole at B8 clips of 1500 frames (seq;
    the decoder's tokens as ``configs.batch_specs`` sizes them)."""
    import dataclasses
    from repro_torch.configs import get
    return [(get("zamba2-1.2b"), 4, 2048),
            (dataclasses.replace(get("mixtral-8x7b"),
                                 n_layers=TRAIN_MIXTRAL_LAYERS), 2, 2048),
            (dataclasses.replace(get("gemma-7b"),
                                 n_layers=TRAIN_GEMMA_LAYERS), 2, 2048),
            (get("whisper-medium"), 8, TRAIN_WHISPER_FRAMES)]


class ClipSource:
    """Whisper's training batches: ``SyntheticLMSource``'s tokens as the
    decoder's, at the length ``configs.batch_specs`` gives a train cell of
    ``frames`` frames, and the encoder's frames (the stub front end's
    output, as ``batch_specs`` has it) N(0, 0.1²) in fp32 from a Philox
    counter at the same index; the state is the token source's."""

    def __init__(self, cfg, frames: int, batch: int, seed: int = 0):
        from repro_torch.configs import batch_specs
        from repro_torch.data import SyntheticLMSource
        dec = batch_specs(cfg, "train_4k", batch=batch,
                          seq=frames)["tokens"].shape[1]
        self.tokens = SyntheticLMSource(cfg.vocab, dec, batch, seed=seed)
        self.shape = (batch, frames, cfg.d_model)

    def next_batch(self) -> dict:
        import numpy as np
        at = self.tokens.state()
        rng = np.random.Generator(np.random.Philox(key=at["seed"] + 1,
                                                   counter=at["index"]))
        out = self.tokens.next_batch()
        out["frames"] = rng.standard_normal(self.shape, np.float32) * 0.1
        return out

    def state(self) -> dict:
        return self.tokens.state()

    def restore(self, state: dict) -> None:
        self.tokens.restore(state)


def train_source(cfg, batch: int, seq: int, seed: int = 0):
    """The training data of ``cfg``: tokens, and frames for an encdec."""
    from repro_torch.data import SyntheticLMSource
    if cfg.family == "encdec":
        return ClipSource(cfg, seq, batch, seed)
    return SyntheticLMSource(cfg.vocab, seq, batch, seed=seed)


def train_launches_per_step(cfg) -> dict:
    """Each kernel of the path runs twice a step: in the forward, and again
    when activation checkpointing recomputes its block for the backward;
    each activation's backward kernel once."""
    return expected_launches(cfg, 2, 0, 1)


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


class SnapshotPipeline:
    """A data pipeline that keeps host copies of the driver's parameters
    once ``after`` steps have run: taken as the next batch is asked for,
    outside the step's time."""

    def __init__(self, pipe, after: int):
        self.pipe, self.after, self.asked = pipe, after, 0
        self.driver, self.params = None, None

    def get(self):
        if self.asked == self.after:
            self.params = host_params(self.driver.state["params"])
        self.asked += 1
        return self.pipe.get()

    def state(self):
        return self.pipe.state()


def phase_train(plan, cfg, batch: int, seq: int, steps: int = TRAIN_STEPS,
                check_launches: bool = True,
                snapshot_after: Optional[int] = None) -> dict:
    """Train ``cfg`` for ``steps`` steps through ``TrainDriver``, its data
    from ``make_pipeline(SyntheticLMSource)``; fail unless the loss is
    finite at every step and lower at the last than at the first, the
    kernels launched :func:`train_launches_per_step` times a step, and the
    driver's final checkpoint (written under ``build/``, deleted after)
    restores bit for bit.  With ``snapshot_after``, the result keeps host
    copies of the parameters after that many steps (``params_at``).
    ``check_launches=False`` is for a rehearsal on the CPU."""
    import shutil
    from repro_torch.core.tree import jax_leaves
    from repro_torch.data import make_pipeline
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
    if cfg.name in TRAIN_TAMED:
        tf_tame(cfg, state["params"])
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
    pipe = make_pipeline(train_source(cfg, batch, seq), plan,
                         n_batches=steps)
    if snapshot_after is not None:
        pipe = SnapshotPipeline(pipe, snapshot_after)
    ckpt_dir = ROOT / "build" / f"train_ckpt_{cfg.name}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    driver = TrainDriver(clock.wrap(step) if clock else step, state, pipe,
                         DriverConfig(total_steps=steps, ckpt_every=steps + 1,
                                      ckpt_dir=str(ckpt_dir), keep=1,
                                      log_every=1))
    if snapshot_after is not None:
        pipe.driver = driver
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
        launches = {name: kernels[name].launches if name in kernels else 0
                    for name in want}
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
        if peak_gb > CARD_GB:
            fail(f"{cfg.name}: peak memory {peak_gb:.2f} GB over the card's "
                 f"{CARD_GB} GB")
        med = sorted(dts[1:])[len(dts[1:]) // 2]
        # tokens a batch: B x S, and an encdec's frames besides its tokens
        n_tok = sum(v.shape[0] * v.shape[1] for v in
                    train_source(cfg, batch, seq).next_batch().values())
        tok_s = n_tok / med
        say(f"[train] {cfg.name}: {tok_s:.1f} train tokens/s ({n_tok} a "
            f"batch over the median step after the first, synchronised: "
            f"{med * 1e3:.1f} ms; first step {dts[0] * 1e3:.1f} ms); peak "
            f"memory {peak_gb:.2f} GB of {CARD_GB} ({peak_gb - base_gb:.2f} "
            f"GB above the {base_gb:.2f} GB earlier phases hold); driver run "
            f"{wall:.1f} s with the final checkpoint")
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
            one = {k: torch.as_tensor(v, device=dev) for k, v in
                   train_source(cfg, batch, seq, seed=1).next_batch().items()}

            def one_step():
                driver.state, _ = step(driver.state, one)
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
            "restore_s": restore_s, "losses": losses, "ranges": ranges,
            "params_at": pipe.params if snapshot_after is not None else None}


def loss_and_grads(cfg, params, tokens: torch.Tensor) -> tuple:
    """``LM.loss`` and the gradient of every parameter leaf."""
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from repro_torch.models.lm import LM
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = LM(cfg).loss(tree_unflatten(params, leaves), {"tokens": tokens})
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


# the card's kernels sum in another order than the CPU's plain versions
# (the attention kernel in 128-key tiles, P V from P's two bf16 halves), so
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
    for i, (cfg, batch, seq) in enumerate(train_configs()):
        gc.collect()
        torch.cuda.empty_cache()
        # Mixtral's parameters after phase 10a's steps, which 10a equals
        out[cfg.name] = phase_train(single_device_plan(), cfg, batch, seq,
                                    snapshot_after=MD_STEPS_A if i == 1
                                    else None)
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
               ms: float, plain_ms: float, work, library_ms) -> dict:
    """One entry of the ``kernels`` line; the bound is the kernel module's
    ``work()`` (``kernels/backend.py:Work``, the count the dry run sums):
    the larger of the bytes over the memory rate and the operations over
    the peak rate for their type."""
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{cu}.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": work.bound_s * 1e3,
            "bound_by": work.bound_by, "library_ms": library_ms}


def time_flash(dev: torch.device, g: torch.Generator, name: str, shape: tuple,
               launches: int, err: float, card: str, sq: int = None,
               causal: bool = True) -> dict:
    """``flash_attention`` over bf16 q (B, H, Sq, D) and k, v (B, Hkv, S, D),
    Sq = ``sq`` or S, causal with the window of ``shape`` (4096, which does
    not bind, or none) or with every key visible, beside its plain version
    and ``scaled_dot_product_attention``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     work)
    B, H, Hkv, S, D, W = shape
    Sq = sq or S
    q = torch.randn(B, H, Sq, D, generator=g).to(torch.bfloat16).to(dev)
    k = torch.randn(B, Hkv, S, D, generator=g).to(torch.bfloat16).to(dev)
    v = torch.randn(B, Hkv, S, D, generator=g).to(torch.bfloat16).to(dev)
    # q.k and p.v over the pairs the mask admits; q, k, v read, o written
    w = work(q.shape, Hkv, S, q.dtype, causal, W)
    flops, nbytes = w.flops, w.bytes
    ms = graph_ms(lambda: flash_attention(q, k, v, causal, W))
    eager = time_ms(lambda: flash_attention(q, k, v, causal, W))
    plain = time_ms(lambda: flash_attention_plain(q, k, v, causal, W),
                    reps=3, iters=5)
    # SDPA's causal mask is aligned to the start of the keys: only Sq == S
    lib = graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal and Sq == S, enable_gqa=True))
    row = kernel_row(name, "flash_attention",
                     "src/repro/kernels/flash_attention.py:35", launches, err,
                     ms, plain, w, lib)
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
    rows.append(time_stepwise(dev, g, "silu", "silu_stepwise",
                              SILU_CASES[0][0],
                              serve["launches"]["silu_stepwise"],
                              errs["silu_stepwise"], card))
    return rows


def time_train_kernels(dev: torch.device, train: dict, errs: dict,
                       card: str) -> list:
    """The training path's kernels at its shapes (phase 5c), each with its
    launches in that phase's driver run: the activations' backward kernels
    (silu at Mixtral's experts of a 5000-token prefill, as phase 5's
    forward row, and at Zamba2's Mamba2 gates at B4 x S2048, forward too;
    gelu at Whisper's B8 x 1500 x 4096 and Gemma-7B's 2567 x 24576, as the
    forward rows of phases 5d and 5e), attention over Zamba2's B4 x S2048
    (D64) and Mixtral's B2 x S2048 (D128), the router over Mixtral's 4096
    tokens, ``ssd_scan`` and its backward kernel over Zamba2's B4."""
    zamba, mixtral, gemma, whisper = (train[cfg.name]["launches"]
                                      for cfg, _, _ in train_configs())
    g = torch.Generator().manual_seed(9)
    time_recompute_backward(dev, g, train, card)
    zgate = SILU_CASES[2][0]
    return [time_stepwise(dev, g, "silu", "silu_stepwise_bwd",
                          SILU_CASES[0][0], mixtral["silu_stepwise_bwd"],
                          errs["silu_stepwise_bwd"], card, backward=True),
            time_stepwise(dev, g, "silu", "silu_stepwise_zamba2", zgate,
                          zamba["silu_stepwise"],
                          errs["silu_stepwise_zamba2"], card),
            time_stepwise(dev, g, "silu", "silu_stepwise_bwd_zamba2", zgate,
                          zamba["silu_stepwise_bwd"],
                          errs["silu_stepwise_bwd_zamba2"], card,
                          backward=True),
            time_stepwise(dev, g, "gelu", "gelu_stepwise_bwd",
                          GELU_CASES[0][0], whisper["gelu_stepwise_bwd"],
                          errs["gelu_stepwise_bwd"], card, backward=True),
            time_stepwise(dev, g, "gelu", "gelu_stepwise_bwd_gemma",
                          GELU_CASES[4][0], gemma["gelu_stepwise_bwd"],
                          errs["gelu_stepwise_bwd_gemma"], card,
                          backward=True),
            time_flash(dev, g, "flash_attention_train_d64",
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
                     errs["ssd_scan"], card),
            time_ssd_bwd(dev, "ssd_scan_bwd_train", 4, zamba["ssd_scan_bwd"],
                         errs["ssd_scan_bwd_train"], card)]


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
            time_stepwise(dev, g, "gelu", "gelu_stepwise_gemma",
                          (1, 2567, 24576),
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
            time_stepwise(dev, g, "gelu", "gelu_stepwise",
                          (WHISPER_B, WHISPER_FRAMES, 4096),
                          clip["prefill"]["gelu_stepwise"]
                          + clip["decode"]["gelu_stepwise"],
                          errs["gelu_stepwise"], card)]


# (module, its forward's one PyTorch call, its backward's, the plain
# versions' eager op counts, where the reference calls the activation)
STEPWISE = {
    "gelu": ("gelu_stepwise",
             lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
             lambda x, dy: torch.ops.aten.gelu_backward(dy, x,
                                                        approximate="tanh"),
             (9, 21), "src/repro/models/layers.py:71"),
    "silu": ("silu_stepwise", torch.nn.functional.silu,
             lambda x, dy: torch.ops.aten.silu_backward(dy, x), (5, 10),
             "src/repro/models/moe.py:106"),
}


def time_stepwise(dev: torch.device, g: torch.Generator, kernel: str,
                  name: str, shape: tuple, launches: int, err: float,
                  card: str, backward: bool = False) -> dict:
    """``gelu_stepwise`` or ``silu_stepwise`` (``kernel``), forward or
    ``backward``, over bf16 activations of ``shape`` beside its plain
    version and the one PyTorch call for it (``F.gelu``'s tanh form or
    ``F.silu``; ``aten.gelu_backward`` / ``aten.silu_backward``: each
    rounds once, so it is not the same function to the last bit).  Bound:
    the bytes, each element read (x, and dy backward) and written once;
    the fp32 operations (``work``) are far under it."""
    import importlib
    module, lib_fwd, lib_bwd, ops, replaces = STEPWISE[kernel]
    K = importlib.import_module(f"repro_torch.kernels.{module}")
    x = (torch.randn(*shape, generator=g) * 4).to(torch.bfloat16).to(dev)
    if backward:
        dy = torch.randn(*shape, generator=g).to(torch.bfloat16).to(dev)
        run = lambda: getattr(K, f"{module}_bwd")(x, dy)
        plain = lambda: getattr(K, f"{module}_vjp_plain")(x, dy)
        lib = lambda: lib_bwd(x, dy)
    else:
        run = lambda: getattr(K, module)(x)
        plain = lambda: getattr(K, f"{module}_plain")(x)
        lib = lambda: lib_fwd(x)
    ms = graph_ms(run)
    plain_ms = time_ms(plain, reps=3, iters=5)
    lib_ms = graph_ms(lib)
    w = K.work(x.numel(), x.dtype, backward)
    row = kernel_row(name, module, replaces, launches, err, ms, plain_ms, w,
                     lib_ms)
    say(f"[time] {name} {tuple(shape)} bf16 "
        f"{'backward' if backward else 'forward'}: {ms:.4f} ms on the "
        f"device (CUDA graph), plain ({ops[backward]} eager ops) "
        f"{plain_ms:.4f} ms, one PyTorch call {lib_ms:.4f} ms, bound "
        f"{row['bound_ms']:.6f} ms ({row['bound_by']}: {w.bytes:.0f} B), "
        f"{row['bound_ms'] / ms:.1%} of the bound on {card}")
    del x
    return row


def time_recompute_backward(dev: torch.device, g: torch.Generator,
                            train: dict, card: str) -> dict:
    """Each kernel's backward on the training path (attention's recompute
    through its plain version and its VJP, the port of
    ``kernels/ops.py``'s VJP rule; ``ssd_scan``'s backward kernel,
    ``ssd_scan_bwd``; the router's VJP of its renormalised weights) at
    phase 5c's shapes: ms per call (CUDA events around
    ``torch.autograd.grad``, eager, median of 3 x 3), and per step (one
    call a block a step)."""
    from repro_torch.core.device import expert_capacity
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.router_topk import router_topk
    from repro_torch.kernels.ssd_scan import ssd_scan
    (zcfg, zb, zs), (mcfg, mb, ms_) = train_configs()[:2]
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
    from repro_torch.kernels.router_topk import (router_topk,
                                                 router_topk_plain, work)
    cap = expert_capacity(T, E, K, 1.25)
    logits = (torch.randn(T, E, generator=g) * 2).to(dev)
    w = work(T, E, K)             # max, sub, exp, add, div; a compare a pick
    nbytes = w.bytes
    ms = graph_ms(lambda: router_topk(logits, K, cap))
    eager = time_ms(lambda: router_topk(logits, K, cap))
    plain = time_ms(lambda: router_topk_plain(logits, K, cap))
    row = kernel_row(name, "router_topk", "src/repro/kernels/router_topk.py:26",
                     launches, err, ms, plain, w, None)
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
    from repro_torch.kernels.a2a_fused import (a2a_route, a2a_route_plain,
                                               route_work)
    from repro_torch.kernels.router_topk import (router_topk,
                                                 router_topk_plain, work)
    g = torch.Generator().manual_seed(T + E + K)
    logits = (torch.randn(T, E, generator=g) * 2).to(dev)
    cap = expert_capacity(T, E, K, 1.25)
    if name == "router_topk":
        ms = graph_ms(lambda: router_topk(logits, K, cap))
        plain = time_ms(lambda: router_topk_plain(logits, K, cap), reps=3,
                        iters=5)
        w = work(T, E, K)
    else:
        ms = graph_ms(lambda: a2a_route(logits, cap))
        plain = time_ms(lambda: a2a_route_plain(logits, cap), reps=3,
                        iters=5)
        w = route_work(T, E)
    return {"name": name, "T": T, "E": E, "K": K, "ms": ms,
            "plain_ms": plain, "bytes": w.bytes,
            "bound_ms": w.bytes_s * 1e3}


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
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain, work
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
    # the causal half of the bf16 scores at the bf16 rate, the products
    # with an f32 operand as two or three TF32 products (the kernel
    # module's work())
    w = work(B, H, G, S, N, P, Q, q.dtype, v.dtype, la.dtype, f32)
    flops, nbytes = w.flops, w.bytes
    chunk_heads = -(-S // Q) * B * H
    score_flops = chunk_heads * Q * (Q + 1) * N
    f32_flops = flops - score_flops
    row = kernel_row(name, "ssd_scan", "src/repro/kernels/ssd_scan.py:26",
                     launches, err, ms, plain, w, None)
    say(f"[time] {name} B{B} H{H}/G{G} S{S} N{N} P{P} chunk {Q} (bf16 "
        f"q/k, f32 v/y): {ms:.4f} ms on the device (CUDA graph), "
        f"{eager:.4f} ms per eager call, plain {plain:.4f} ms, bound "
        f"{row['bound_ms']:.6f} ms ({row['bound_by']}: {score_flops:.4g} "
        f"FLOP of bf16 scores, {f32_flops:.4g} FLOP with an f32 operand in "
        f"TF32 parts, {nbytes} B); "
        f"{flops / ms / 1e9:.1f} TFLOP/s on {card}")
    return row


def ssd_recompute(q, k, v, la, gy, gs, chunk: int) -> tuple:
    """The backward ``ssd_scan_bwd`` replaced: ``ssd_scan_plain`` run again
    under autograd and differentiated (``torch.autograd.grad``)."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v, la)]
    with torch.enable_grad():
        y, state = ssd_scan_plain(*leaves, chunk, out_dtype=gy.dtype)
        return torch.autograd.grad((y, state), leaves, (gy, gs))


def time_ssd_bwd(dev: torch.device, name: str, B: int, launches: int,
                 err: float, card: str, H: int = 64, G: int = 1, N: int = 64,
                 P: int = 64) -> dict:
    """``ssd_scan_bwd`` over B sequences of 2048 tokens, chunk 256, in the
    blocks' types (dy f32, the final state's cotangent zero, as training
    hands them; Zamba2's Mamba2 layer by default, xLSTM's mLSTM at H = G,
    N = 384 and P 384 or 1): in a CUDA graph and eager, beside its plain
    version (``ssd_scan_bwd_plain``), the plain recompute it replaced
    (:func:`ssd_recompute`) and its bound (``work_backward``)."""
    from repro_torch.kernels.ssd_scan import (ssd_scan_bwd,
                                              ssd_scan_bwd_plain,
                                              work_backward)
    g = torch.Generator().manual_seed(8)
    S, Q = 2048, 256
    args = ssd_bwd_inputs(g, dev, (B, H, G, S, N, P), "model") + (Q,)
    ms = graph_ms(lambda: ssd_scan_bwd(*args))
    eager = time_ms(lambda: ssd_scan_bwd(*args))
    plain = time_ms(lambda: ssd_scan_bwd_plain(*args), reps=3, iters=3)
    recompute = time_ms(lambda: ssd_recompute(*args), reps=3, iters=3)
    q, _, v, la, gy, _, _ = args
    w = work_backward(B, H, G, S, N, P, Q, q.dtype, v.dtype, la.dtype,
                      gy.dtype)
    row = kernel_row(name, "ssd_scan_bwd", "src/repro/kernels/ops.py:59",
                     launches, err, ms, plain, w, None)
    say(f"[time] {name} B{B} H{H}/G{G} S{S} N{N} P{P} chunk {Q} (bf16 q/k, "
        f"f32 v/dy): {ms:.4f} ms on the device (CUDA graph), {eager:.4f} ms "
        f"per eager call, its plain version {plain:.4f} ms, the plain "
        f"recompute it replaced {recompute:.4f} ms ({ms / recompute:.3f} of "
        f"it), bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
        f"{w.flops:.4g} FLOP, {w.bytes:.0f} B; "
        f"{row['bound_ms'] / ms:.1%} of the bound) on {card}")
    return row


def a2a_rows(dev: torch.device, T: int, cap: int, launches: dict,
             errs: dict, card: str, suffix: str = "") -> list:
    """``a2a_route`` and ``a2a_combine`` over T tokens of phase 3's
    widths (one-hot router logits with its skewed load, the (E, T, D)
    expert stack) at capacity ``cap``, beside their plain versions and
    their bounds; rows named ``a2a_route<suffix>``, ``a2a_combine<suffix>``
    with ``launches`` of the path they report."""
    from repro_torch.kernels.a2a_fused import (a2a_combine, a2a_combine_plain,
                                               a2a_route, a2a_route_plain,
                                               combine_work, route_work)
    E, D = N_EXPERTS, D_MODEL
    g = torch.Generator().manual_seed(2)
    e = torch.randint(0, E, (T,), generator=g)
    e[: T // 4] = 0                          # the skewed load of phase 3
    logits = torch.nn.functional.one_hot(e, E).float().to(dev)
    ys = torch.randn(E, T, D, generator=g).to(torch.bfloat16).to(dev)
    idx, _pos, keep = a2a_route(logits, cap)
    kept = int(keep.sum())
    rows = []
    for name, kern, plain, args, w in (
            ("a2a_route", a2a_route, a2a_route_plain, (logits, cap),
             route_work(T, E)),
            ("a2a_combine", a2a_combine, a2a_combine_plain, (ys, idx, keep),
             combine_work(T, D * 2, kept))):
        ms = graph_ms(lambda: kern(*args))
        eager_ms = time_ms(lambda: kern(*args))
        plain_ms = time_ms(lambda: plain(*args))
        rows.append(kernel_row(
            name + suffix, "a2a_fused", "src/repro/kernels/a2a_fused.py:48",
            launches[name], errs[name], ms, plain_ms, w, None))
        say(f"[time] {name + suffix} T{T} cap {cap}: {ms:.4f} ms on the "
            f"device (CUDA graph), {eager_ms:.4f} ms per eager call, plain "
            f"{plain_ms:.4f} ms per eager call, bound "
            f"{rows[-1]['bound_ms']:.6f} ms ({rows[-1]['bound_by']}, "
            f"{w.bytes} B) on {card}")
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


def device_segments(dev: torch.device) -> int:
    """The caching allocator's count of device allocations (cudaMalloc
    calls) so far; 0 off the card."""
    if dev.type != "cuda":
        return 0
    return torch.cuda.memory_stats(dev).get("num_device_alloc", 0)


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
    and ``router_topk`` launched once a task in the accelerator's run.
    Both sides are timed warm: the loop after one untimed block, the
    accelerator after one untimed round of the same tasks, whose time and
    new device segments (the dispatcher thread's one-off set-up: its
    streams, their allocator pools grown while results are held, its
    cuBLAS state) are printed beside the check."""
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
    acc = TorchAccelerator(block, max_inflight=ACC_INFLIGHT, device=dev)
    acc.run_then_freeze()
    segs = device_segments(dev)
    t0 = time.perf_counter()
    for x in xs:                    # warm-up: the dispatcher's first round
        acc.offload(x)
    for _ in xs:
        if not acc.load_result(timeout=300)[0]:
            fail(f"accelerator: the warm-up round failed ({acc.error!r})")
    sync(dev)
    warm_s = time.perf_counter() - t0
    warm_segs = device_segments(dev) - segs
    router_topk.launches = 0
    segs = device_segments(dev)
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
    timed_segs = device_segments(dev) - segs
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
        f"{device_s * 1e3:.1f} ms of device time (CUDA events), "
        f"{timed_segs} new device segments, after an untimed round of "
        f"{warm_s * 1e3:.1f} ms and {warm_segs} new segments; "
        f"{tasks / acc_s:.1f} tasks/s offloaded against {tasks / sync_s:.1f} "
        f"tasks/s in the synchronous loop ({sync_s / acc_s:.2f}x) on {card}")
    return {"launches": launches, "offload_s": offload_s,
            "device_s": device_s, "warm_s": warm_s, "timed_segs": timed_segs,
            "acc_tasks_s": tasks / acc_s, "sync_tasks_s": tasks / sync_s,
            "bitwise": same}


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


# ---------------------------------------------------------------------------
# phase 10: the multi-device plan on the card
# ---------------------------------------------------------------------------
MD_DIR = ROOT / "build" / "multi_device"
MD_STEPS_A = 2                   # 10a: steps on the (data=1, model=1) mesh
MD_STEPS_FSDP = 3                # 10b: steps with fsdp_params, then one
MD_ONE_STEPS = 3                 # the one-rank run 10b is held to
# 10b against the one-rank run: tests/test_torch_train.py's bounds for a
# bf16 train step (each step's loss relative; each leaf's update over the
# steps, L2 norm of the difference over the reference's)
MD_LOSS_RTOL, MD_UPDATE_TOL = 2e-2, 0.45
PIPE_LAYERS, PIPE_MICRO = 4, 4   # 10d: 2 stages of 2 Mixtral blocks, M = 4
FD_B, FD_SLOTS = 8, 4096         # 10d: flash-decode batch and cache slots
LLAMA_D, LLAMA_FF = 3072, 8192   # 10d: Llama-3.2-3B's MLP widths
# 10d tolerances, of each output's scale, from the reduction order that
# changes: the whole-cache decode attention in f32 against its two halves
# combined by logsumexp (sums split in two); the vocab-parallel loss in
# f32 (the max, the sum of exponentials and the label logit over two vocab
# blocks) and its input gradient in bf16 (one rounding of the x gradient's
# two partials); tensor_map's gather (each column of the product from a
# half-width GEMM, which cuBLAS may tile differently: one bf16 rounding)
# and reduce (two bf16 partials summed in bf16: two more roundings)
MD_TOL = {"flash_decode": 1e-5, "vp_loss": 1e-5, "vp_grad": 2.0 ** -6,
          "tm_gather": 2.0 ** -7, "tm_reduce": 2.0 ** -6}
MD_KERNELS = ("flash_attention", "router_topk")
# 10b's peak memory a rank with fsdp_params before the use-site gather
# (the step gathered the whole tree over the data axis before the
# forward): the parent tree's phase 10 run alone, `python3
# tools/phase10_alone.py --src <parent checkout>`, read once
PARENT_10B_PEAK_GB = 17.59
PARENT_10B_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def md_setup() -> torch.device:
    from repro_torch.core import spmd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return spmd.current_device()


def md_config():
    return train_configs()[1][0]     # Mixtral-8x7B at 1 of 32 layers


def md_batches(cfg, n: int) -> list:
    """Phase 5c's batches: B2 x S2048 from SyntheticLMSource seeded 0."""
    from repro_torch.data import SyntheticLMSource
    src = SyntheticLMSource(cfg.vocab, 2048, 2, seed=0)
    return [src.next_batch() for _ in range(n)]


def md_schedule():
    from repro_torch.optim.schedules import cosine_warmup
    return cosine_warmup(TRAIN_PEAK_LR, TRAIN_WARMUP, TRAIN_STEPS)


def host_params(params) -> list:
    """Host copies of the leaves (the step updates the state in place)."""
    from repro_torch.core.tree import jax_leaves
    return [t.detach().to("cpu", copy=True) for t in jax_leaves(params)]


class RankClock(PhaseClock):
    """:class:`PhaseClock` with the step's start and its gradient
    collective (``runtime.steps.reduce_grads``: the sums the use-site
    gathers' backward did not reduce-scatter).  The weights' gathers run
    inside the forward and the backward's recompute (``gather_fsdp``), so
    those parts include them; ``collective`` is the time before the
    forward and the reduce."""

    def wrap(self, step):
        def timed_step(state, batch):
            self.steps.append({})
            self.mark_here("start")
            out = step(state, batch)
            self.mark_here("end")
            return out
        return timed_step

    @contextlib.contextmanager
    def timing(self):
        import repro_torch.runtime.steps as steps
        reduce = steps.reduce_grads

        def timed_reduce(*a, **k):
            self.mark_here("reduce")
            return reduce(*a, **k)

        steps.reduce_grads = timed_reduce
        try:
            with super().timing():
                yield
        finally:
            steps.reduce_grads = reduce

    def mark_here(self, phase: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1][phase] = (ev, time.perf_counter())

    def mark(self, phase: str) -> None:
        self.mark_here(phase)            # the step opened in ``wrap``

    def split(self) -> list:
        """Per step, the device ms of each part, and the host ms of the
        forward (``forward_host``)."""
        out = []
        for s in self.steps:
            e = lambda a, b: s[a][0].elapsed_time(s[b][0])
            out.append({"forward": e("forward", "backward"),
                        "backward": e("backward", "reduce"),
                        "collective": e("start", "forward")
                        + e("reduce", "optimizer"),
                        "optimizer": e("optimizer", "end"),
                        "forward_host": (s["backward"][1]
                                         - s["forward"][1]) * 1e3})
        return out


def md_rank_one(out_dir: str) -> dict:
    """10a, one rank over NCCL: the one-rank run 10b is held to (phase 5c's
    step in two micro-batches for ``MD_ONE_STEPS`` steps, the parameters
    after steps 1 and 3 written for 10b), then ``MD_STEPS_A`` steps on the
    (data=1, model=1) mesh with fsdp_params, whose state is saved as a
    checkpoint: the parent holds its losses and parameters to phase 5c's
    one-device steps, and 10c restores it."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.core import spmd
    from repro_torch.core.plan import ShardingPlan, single_device_plan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.driver import host_metrics
    from repro_torch.runtime.steps import init_state, make_train_step
    dev = md_setup()
    cfg = md_config()
    batches = [{"tokens": torch.as_tensor(b["tokens"], device=dev)}
               for b in md_batches(cfg, MD_ONE_STEPS)]
    gen = lambda: torch.Generator(device=dev).manual_seed(0)
    # 10b's reference: the whole batch in two micro-batches of one row,
    # which route their tokens apart as the two ranks do (each rank sizes
    # its expert lanes by its own tokens)
    one = single_device_plan(dev)
    state = init_state(cfg, one, gen())
    step = make_train_step(cfg, one, md_schedule(), n_micro=2)
    losses_micro, snaps = [], {}
    for i in range(MD_ONE_STEPS):
        state, m = step(state, batches[i])
        losses_micro.append(host_metrics(m)["loss"])
        if i + 1 in (1, MD_ONE_STEPS):
            snaps[i + 1] = host_params(state["params"])
    del state, step
    gc_cuda()
    torch.save({"losses_micro": losses_micro, "p1_micro": snaps[1],
                "p3_micro": snaps[MD_ONE_STEPS]},
               pathlib.Path(out_dir) / "one_rank.pt")
    del snaps
    plan = ShardingPlan(make_host_mesh(data=1))
    state = init_state(cfg, plan, gen())
    step = make_train_step(cfg, plan, md_schedule())
    kernels = zero_launches()
    losses = []
    for i in range(MD_STEPS_A):
        state, m = step(state, batches[i])
        losses.append(host_metrics(m)["loss"])
    launches = {n: kernels[n].launches for n in MD_KERNELS}
    t0 = time.perf_counter()
    save_checkpoint(pathlib.Path(out_dir) / "ckpt", MD_STEPS_A, state)
    save_s = time.perf_counter() - t0
    return {"losses": losses, "launches": launches,
            "backend": spmd.backend(), "routes": dict(spmd.ROUTES),
            "save_s": save_s, "mesh": plan.mesh.shape}


def md_params_equal(out_dir: str, cfg, params_at: list,
                    dev: torch.device) -> tuple:
    """10a's saved parameters against phase 5c's after the same steps, bit
    for bit (the checkpoint widens bf16 to fp32 exactly): (equal, leaves)."""
    import warnings
    import numpy as np
    from repro_torch.checkpoint import host_state
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.core.tree import jax_leaves
    from repro_torch.launch.mesh import make_host_mesh
    host = host_state(pathlib.Path(out_dir) / "ckpt", cfg,
                      ShardingPlan(make_host_mesh(device=dev)))
    saved = jax_leaves(host["params"])
    equal = len(saved) == len(params_at)
    for a, b in zip(saved, params_at):
        with warnings.catch_warnings():      # a read-only memory map
            warnings.simplefilter("ignore", UserWarning)
            got = torch.from_numpy(np.asarray(a)).to(dev).to(b.dtype)
        equal &= torch.equal(got, b.to(dev))
    return equal, len(saved)


def gc_cuda() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def update_sq(p_got: torch.Tensor, p0: torch.Tensor,
              p_want: torch.Tensor) -> torch.Tensor:
    """(|d_got - d_want|^2, |d_want|^2) of a leaf's update d = p - p0, or of
    a block of it: summed over the blocks, the two squared L2 norms whose
    ratio's root ``tests/test_torch_train.py`` bounds."""
    d_want = p_want.float() - p0.float()
    d_got = p_got.float() - p0.float()
    return torch.stack([(d_got - d_want).square().sum(),
                        d_want.square().sum()])


def md_train(cfg, plan, dev, one: dict, steps: int, fsdp: bool,
             losses5c: list) -> dict:
    """``steps`` steps of ``cfg`` through ``TrainDriver`` over
    ``make_train_step`` on ``plan``, fed phase 5c's batches by
    ``make_pipeline``; held to the one-rank run ``one``, leaf by leaf on
    this rank's blocks (the squared norms summed over the ranks that split
    a leaf), and its losses printed beside phase 5c's ``losses5c``."""
    from repro_torch.core import spmd
    from repro_torch.core.tree import jax_leaves
    from repro_torch.data import SyntheticLMSource, make_pipeline
    from repro_torch.models.lm import LM
    from repro_torch.models.params import walk_defs
    from repro_torch.runtime.driver import DriverConfig, TrainDriver
    from repro_torch.runtime.steps import (init_state, make_train_step,
                                           state_shardings)
    state = init_state(cfg, plan, torch.Generator(device=dev).manual_seed(0))
    sh = jax_leaves(state_shardings(cfg, plan)["params"])
    defs = jax_leaves(LM(cfg).param_defs())
    split_of = [any("data" in axes for axes in s.shard_dims().values())
                for s in sh]

    def halves(params) -> bool:
        """Each leaf split over data holds half of the whole, others all."""
        return all(t.numel() == math.prod(d.shape) // (2 if split else 1)
                   for t, d, split in zip(jax_leaves(params), defs, split_of))
    held0 = halves(state["params"])
    clock = RankClock()
    step = make_train_step(cfg, plan, md_schedule())
    pipe = make_pipeline(SyntheticLMSource(cfg.vocab, 2048, 2, seed=0),
                         plan, n_batches=steps)
    driver = TrainDriver(clock.wrap(step), state, pipe,
                         DriverConfig(total_steps=steps, ckpt_every=steps + 1,
                                      log_every=steps + 1))
    driver.ckpt = _NoCheckpoint()    # 10c holds the restore
    del state
    kernels = zero_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    from repro_torch.core.plan import FSDP_GATHERED, reset_fsdp_gathered
    reset_fsdp_gathered()
    with clock.timing():
        out = driver.run()
    launches = {n: kernels[n].launches for n in MD_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    gathered = dict(FSDP_GATHERED)
    losses = [h["loss"] for h in out["history"]]
    dts = [h["dt"] for h in out["history"]]
    held = halves(driver.state["params"])
    # each leaf's update against the one-rank run's, on this rank's blocks
    p0 = jax_leaves(LM(cfg).init(torch.Generator(device=dev).manual_seed(0)))
    want = one["p3_micro" if steps == MD_ONE_STEPS else "p1_micro"]
    names = ["/".join(path) for path, _ in sorted(walk_defs(
        LM(cfg).param_defs()))]
    errs = []
    for t, s, a, w, split in zip(jax_leaves(driver.state["params"]), sh, p0,
                                 want, split_of):
        sq = update_sq(t, s.local_block(a), s.local_block(w).to(dev))
        if split:
            sq = spmd.all_sum(sq, plan.mesh, ("data",))
        errs.append(float(sq[0].sqrt() / sq[1].sqrt().clamp(min=1e-30)))
    del p0, driver
    worst = sorted(zip(errs, names), reverse=True)[:3]
    rel = lambda ref: max(abs(a / b - 1) for a, b in zip(losses, ref))
    return {"losses": losses, "dts": dts, "launches": launches,
            "peak_gb": peak_gb, "gathered": gathered,
            "split": clock.split()[:steps],
            "held_before": held0, "held_after": held,
            "n_split": sum(split_of), "n_leaves": len(sh), "fsdp": fsdp,
            "rank": spmd.rank(), "update_err": worst[0][0],
            "worst": [(n, round(v, 4)) for v, n in worst],
            "loss_err": rel(one["losses_micro"]),
            "loss_err_5c": rel(losses5c)}


def md_restore(cfg, plan, dev, out_dir: str) -> dict:
    """10c: 10a's checkpoint placed onto the data=2 mesh by reshard_state:
    every block equal to its chunk of the saved array, bit for bit; then
    the parameters gathered back whole (as on one rank) equal to the saved
    arrays.  The optimizer moments' blocks are held above; gathering their
    17.2 GB back too would take gloo about 25 s more."""
    import warnings
    import numpy as np
    from repro_torch.checkpoint import host_state, reshard_state
    from repro_torch.core.tree import jax_leaves
    from repro_torch.runtime.steps import state_shardings
    t0 = time.perf_counter()
    host = host_state(pathlib.Path(out_dir) / "ckpt", cfg, plan)
    state = reshard_state(cfg, host, plan)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    sh = state_shardings(cfg, plan)

    def saved(a) -> torch.Tensor:
        with warnings.catch_warnings():      # a read-only memory map
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(np.asarray(a))
    blocks_equal = whole_equal = True
    n = 0
    for t, s, a in zip(jax_leaves(state), jax_leaves(sh), jax_leaves(host)):
        want = saved(a)                      # nothing read yet
        for d in s.shard_dims():
            i, k = s.block(d)
            want = want.chunk(k, dim=d)[i]
        blocks_equal &= torch.equal(t, want.to(dev).to(t.dtype))
        n += 1
    t1 = time.perf_counter()
    for t, s, a in zip(jax_leaves(state["params"]), jax_leaves(sh["params"]),
                       jax_leaves(host["params"])):
        whole_equal &= torch.equal(s.gather(t), saved(a).to(dev).to(t.dtype))
    return {"blocks_equal": blocks_equal, "whole_equal": whole_equal,
            "n_leaves": n, "n_params": len(jax_leaves(state["params"])),
            "place_s": place_s, "check_s": t1 - t0 - place_s,
            "gather_s": time.perf_counter() - t1}


def md_pipeline(dev, mesh) -> dict:
    """10d: ``pipeline_shard`` over the data axis, each stage 2 Mixtral
    blocks (attention and MoE), M = 4 microbatches of B1 x S2048, against
    the 4 blocks run serially in this rank."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.core import device as D
    from repro_torch.core.tree import tree_map
    from repro_torch.models.lm import LM, _layers, apply_block
    cfg = dataclasses.replace(get("mixtral-8x7b"), n_layers=PIPE_LAYERS)
    S = mesh.shape["data"]
    stack = LM(cfg).init(torch.Generator(device=dev).manual_seed(1)
                         )["stacks"]["moe"]
    per = PIPE_LAYERS // S
    staged = tree_map(lambda t: t.reshape((S, per) + t.shape[1:]), stack)
    g = torch.Generator(device=dev).manual_seed(2)
    x_mb = torch.randn(PIPE_MICRO, 1, 2048, cfg.d_model, generator=g,
                       device=dev).to(torch.bfloat16)
    pos = torch.arange(2048, device=dev)[None]

    def blocks(layers, x):
        for p in layers:
            x, _, _ = apply_block("moe", x, p, cfg, positions=pos)
        return x

    def stage_fn(p, x):
        return blocks(_layers(p), x)

    run = D.pipeline_shard(stage_fn, mesh, "data", PIPE_MICRO)
    kernels = zero_launches()
    with torch.no_grad():
        run(staged, x_mb)                     # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(staged, x_mb)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {n: kernels[n].launches for n in MD_KERNELS}
        want = torch.stack([blocks(_layers(stack), x_mb[i])
                            for i in range(PIPE_MICRO)])
    return {"equal": torch.equal(got, want), "steps": PIPE_MICRO + S - 1,
            "ms": ms, "ms_micro": ms / PIPE_MICRO, "launches": launches,
            "finite": bool(torch.isfinite(got).all())}


def md_a2a(dev, mesh) -> dict:
    """10d: ``a2a_dispatch(mesh=data=2)`` at phase 3's shapes, lossless,
    against the one-rank hop on the whole batch: byte-equal."""
    from repro_torch.core import device as D
    from repro_torch.kernels.a2a_fused import a2a_combine, a2a_route
    model = make_model(dev, seed=0)
    fns = make_fns(model)
    g = torch.Generator().manual_seed(3)
    xs = torch.randn(T_TOKENS, D_MODEL, generator=g).to(dev).to(
        torch.bfloat16)
    t_idx = torch.arange(T_TOKENS, device=dev, dtype=torch.int32)
    lefts = [fns["left"]] * N_LEFT
    a2a_route.launches = a2a_combine.launches = 0
    got = D.a2a_dispatch(lefts, fns["experts"], router=fns["router"],
                         mesh=mesh, axis="data")(xs, t_idx)
    launches = {"a2a_route": a2a_route.launches,
                "a2a_combine": a2a_combine.launches}
    want = D.a2a_dispatch(lefts, fns["experts"], router=fns["router"])(
        xs, t_idx)
    return {"equal": torch.equal(got, want), "launches": launches,
            "max_abs": float((got.float() - want.float()).abs().max())}


def md_vocab(dev, mesh) -> dict:
    """10d: ``vocab_parallel_embed`` / ``vocab_parallel_ce`` at model=2 over
    Mixtral's 32000 x 4096 at B2 x S2048, against the one-rank lookup and
    ``cross_entropy`` (loss and input gradient)."""
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.models.lm import (cross_entropy, vocab_parallel_ce,
                                       vocab_parallel_embed)
    plan = ShardingPlan(mesh)
    V, d, B, S = 32000, D_MODEL, 2, 2048
    g = torch.Generator(device=dev).manual_seed(4)
    emb = (torch.randn(V, d, generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    tok = torch.randint(0, V, (B, S), generator=g, device=dev)
    e_eq = torch.equal(vocab_parallel_embed(tok, emb, plan),
                       emb[tok].to(torch.bfloat16))
    x = torch.randn(B, S, d, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(d, V, generator=g, device=dev) * d ** -0.5).to(
        torch.bfloat16)
    lab = torch.roll(tok, -1, 1)
    mask = torch.ones(B, S, device=dev)
    mask[:, -1] = 0.0
    out = {}
    for name, fn in (("vp", lambda x: vocab_parallel_ce(x, w, lab, mask,
                                                        plan)),
                     ("one", lambda x: cross_entropy(x, w, lab, mask))):
        xx = x.detach().requires_grad_(True)
        loss = fn(xx)
        (gx,) = torch.autograd.grad(loss, [xx])
        out[name] = (loss.detach(), gx)
    loss_err = abs(float(out["vp"][0]) / float(out["one"][0]) - 1)
    gx_err = float((out["vp"][1].float() - out["one"][1].float()).abs().max()
                   / out["one"][1].float().abs().max())
    return {"embed_equal": e_eq, "loss_err": loss_err, "grad_err": gx_err,
            "loss": float(out["vp"][0])}


def md_flash_decode(dev, mesh) -> dict:
    """10d: ``flash_decode_combine`` on Mixtral's decode attention (B8,
    32/8 heads of 128) over a 4096-slot cache split in two along S,
    against the whole-cache decode attention."""
    from repro_torch.core import device as D
    from repro_torch.core import spmd
    from repro_torch.core.plan import P
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(FD_B, 32, 128, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(FD_B, FD_SLOTS, 8, 128, generator=g, device=dev).to(
        torch.bfloat16)
    v = torch.randn(FD_B, FD_SLOTS, 8, 128, generator=g, device=dev).to(
        torch.bfloat16)

    def scores(q, kl):
        kh = kl.float().repeat_interleave(4, dim=2)          # GQA group 4
        return torch.einsum("bhd,bkhd->bhk", q.float(), kh) / 128 ** 0.5

    def local(q, kl, vl):
        s = scores(q, kl)
        m = torch.amax(s, -1)
        p = torch.exp(s - m[..., None])
        o = torch.einsum("bhk,bkhd->bhd", p,
                         vl.float().repeat_interleave(4, dim=2)) / \
            p.sum(-1)[..., None]
        return D.flash_decode_combine(o, torch.log(p.sum(-1)) + m, "model")
    kv = P(None, "model", None, None)
    got = spmd.shard_map(local, mesh, (P(), kv, kv), P())(q, k, v)
    p = torch.softmax(scores(q, k), -1)
    want = torch.einsum("bhk,bkhd->bhd", p,
                        v.float().repeat_interleave(4, dim=2))
    return {"err": float((got - want).abs().max() / want.abs().max())}


def md_tensor_map(dev, mesh) -> dict:
    """10d: ``tensor_map`` over a Llama-3.2-3B MLP (d 3072, ff 8192) at B1 x
    S2048, gather (column-parallel wi/wg, h gathered, then wo) and reduce
    (row-parallel wo, partials psummed), against the one-rank ``mlp``."""
    from repro_torch.core import device as D
    from repro_torch.core.plan import P
    from repro_torch.models.layers import mlp, mm, silu_stepwise
    g = torch.Generator(device=dev).manual_seed(6)
    r = lambda *s, sc: (torch.randn(*s, generator=g, device=dev) * sc).to(
        torch.bfloat16)
    x = r(1, 2048, LLAMA_D, sc=1.0)
    p = {"wi": r(LLAMA_D, LLAMA_FF, sc=LLAMA_D ** -0.5),
         "wg": r(LLAMA_D, LLAMA_FF, sc=LLAMA_D ** -0.5),
         "wo": r(LLAMA_FF, LLAMA_D, sc=LLAMA_FF ** -0.5)}
    want = mlp(x, p, "silu")
    col = P(None, "model")
    h = D.tensor_map(lambda x, wi, wg: mm(x, wi) * silu_stepwise(mm(x, wg)),
                     mesh, axis="model", split_spec=(P(), col, col),
                     out_axis=2)(x, p["wi"], p["wg"])
    gathered = mm(h, p["wo"]).to(torch.bfloat16)
    reduced = D.tensor_map(
        lambda x, wi, wg, wo: mm(mm(x, wi) * silu_stepwise(mm(x, wg)),
                                 wo).to(torch.bfloat16),
        mesh, axis="model", split_spec=(P(), col, col, P("model", None)),
        compose="reduce")(x, p["wi"], p["wg"], p["wo"])
    scale = float(want.float().abs().max())
    err = lambda y: float((y.float() - want.float()).abs().max()) / scale
    return {"gather_err": err(gathered), "reduce_err": err(reduced)}


GRAPH_HYBRID_ITEMS = 4000      # 10e: phase 4's stream cut to 7.8 of 512
GRAPH_REFS = "graph_refs.npz"   # phases 3-4's one-rank outputs, for 10e


def save_graph_refs(main: dict, hyb: dict, out_dir: pathlib.Path) -> None:
    """Phase 3's lossless and capacity outputs and phase 4's over its
    first ``GRAPH_HYBRID_ITEMS`` items (one rank; also at half the
    microbatch), which 10e holds its outputs over two ranks to."""
    import numpy as np
    np.savez(out_dir / GRAPH_REFS, lossless=np.stack(main["lossless"]),
             capacity=np.stack(main["capacity"]),
             hybrid=np.stack(hyb["short"][HYBRID_MICROBATCH]),
             hybrid_half=np.stack(hyb["short"][HYBRID_MICROBATCH // 2]))


def md_graph(dev, mesh, out_dir: str) -> dict:
    """10e: phase 3's graph at Mixtral's widths compiled over the (data
    2) mesh, lossless and at ``CAPACITY_FACTOR`` (the ``a2a_dispatch``
    lowering splits the left map, and without a capacity the hop's route
    and combine, over the ranks): every rank's whole output byte-equal to
    phase 3's one-rank outputs.  Then phase 4's hybrid over the first
    ``GRAPH_HYBRID_ITEMS`` items (the last microbatch partial): without a
    capacity each rank runs the experts on its half of a microbatch, and
    cuBLAS picks its GEMM by the rows, so a rank's rows of a whole
    microbatch are held byte for byte to phase 4's one-rank run at half
    the microbatch (whose microbatches are the ranks' blocks), every row
    within ``REL_TOL`` of phase 4's at its own microbatch (the rows that
    differ counted), and the ranks' outputs to each other by their
    digest.  Also the launches of the hop's two kernels, items/s and the
    boundary's seconds."""
    import numpy as np
    from repro_torch.core import CompileConfig
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.kernels.a2a_fused import a2a_combine, a2a_route
    t0 = time.perf_counter()
    refs = np.load(pathlib.Path(out_dir) / GRAPH_REFS, mmap_mode="r")
    fns = make_fns(make_model(dev))
    stream = list(np.random.default_rng(0).standard_normal(
        (T_TOKENS, D_MODEL), dtype=np.float32))
    plan = ShardingPlan(mesh)
    out = {}
    for label, cf in (("lossless", None), ("capacity", CAPACITY_FACTOR)):
        runner = build_graph(fns).compile(config=CompileConfig(
            plan=plan, mode="device", a2a_capacity_factor=cf))
        a2a_route.launches = a2a_combine.launches = 0
        got = runner.run(stream)                  # the first, held
        launches = {"a2a_route": a2a_route.launches,
                    "a2a_combine": a2a_combine.launches}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runner.run(stream)
        dt = time.perf_counter() - t1
        out[label] = {"equal": np.stack(got).tobytes()
                      == refs[label].tobytes(), "launches": launches,
                      "items_s": T_TOKENS / dt, "runner": type(runner).__name__}
    placements = {0: "host", 1: "device", 2: "device", 3: "device",
                  4: "host"}
    runner = build_graph(fns, host_stages=True).compile(config=CompileConfig(
        plan=plan, placements=placements, microbatch=HYBRID_MICROBATCH,
        inflight=4))
    a2a_route.launches = a2a_combine.launches = 0
    t1 = time.perf_counter()
    got = np.stack(runner.run(stream[:GRAPH_HYBRID_ITEMS]))
    dt = time.perf_counter() - t1
    node = [s for s in runner.stats()["graph"]["stages"]
            if s.get("backend") == "device"][0]
    full = GRAPH_HYBRID_ITEMS // HYBRID_MICROBATCH * HYBRID_MICROBATCH
    diff = np.abs(got - refs["hybrid"]).max(axis=1)
    scale = float(np.abs(refs["hybrid"]).max())
    out["hybrid"] = {"equal": got[:full].tobytes()
                     == refs["hybrid_half"][:full].tobytes()
                     and float(diff.max()) <= REL_TOL * scale,
                     "rows_differ": int((diff > 0).sum()),
                     "max_abs": float(diff.max()), "scale": scale,
                     "digest": hashlib.sha1(got.tobytes()).hexdigest(),
                     "launches": {"a2a_route": a2a_route.launches,
                                  "a2a_combine": a2a_combine.launches},
                     "items_s": GRAPH_HYBRID_ITEMS / dt,
                     "runner": type(runner).__name__,
                     "flushes": node["flushes"],
                     "boundary": node["boundary"]}
    out["secs"] = time.perf_counter() - t0
    return out


def md_rank_two(out_dir: str, losses5c: list) -> dict:
    """10b-10e in each of two ranks sharing ``cuda:0`` over gloo."""
    from repro_torch.core import spmd
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    dev = md_setup()
    cfg = md_config()
    # memory-mapped: each rank reads the blocks it holds
    one = torch.load(pathlib.Path(out_dir) / "one_rank.pt", mmap=True)
    mesh = make_host_mesh(data=2)                 # (data=2, model=1)
    mesh_tp = make_mesh((1, 2), ("data", "model"))
    out = {"backend": spmd.backend(), "mesh": mesh.shape}
    t0 = time.perf_counter()
    out["fsdp"] = md_train(cfg, ShardingPlan(mesh), dev, one, MD_STEPS_FSDP,
                           True, losses5c)
    gc_cuda()
    out["dp"] = md_train(cfg, ShardingPlan(mesh, fsdp_params=False), dev,
                         one, 1, False, losses5c)
    del one
    gc_cuda()
    out["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["restore"] = md_restore(cfg, ShardingPlan(mesh), dev, out_dir)
    gc_cuda()
    out["restore_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["pipe"] = md_pipeline(dev, mesh)
    gc_cuda()
    out["a2a"] = md_a2a(dev, mesh)
    gc_cuda()
    out["vocab"] = md_vocab(dev, mesh_tp)
    out["flash_decode"] = md_flash_decode(dev, mesh_tp)
    out["tensor_map"] = md_tensor_map(dev, mesh_tp)
    out["skeletons_s"] = time.perf_counter() - t0
    gc_cuda()
    out["graph"] = md_graph(dev, mesh, out_dir)
    out["routes"] = {k: dict(v) for k, v in spmd.ROUTES.items()}
    out["route_s"] = {k: {t: round(x, 3) for t, x in v.items()}
                      for k, v in spmd.ROUTE_SECONDS.items()}
    return out


def phase_multi_device(card: str, train5c: dict, main: dict,
                       hyb: dict) -> dict:
    """Phase 10: 10a in one spawned rank over NCCL, 10b-10e in two spawned
    ranks sharing ``cuda:0`` over gloo; fails on any check of theirs.
    ``train5c`` is phase 5c's Mixtral result: its losses, and its
    parameters after ``MD_STEPS_A`` steps, which 10a's must equal;
    ``main`` and ``hyb`` phases 3 and 4's, whose outputs 10e's must
    equal (written for the ranks, then cleared)."""
    from repro_torch.core import spmd
    shutil.rmtree(MD_DIR, ignore_errors=True)
    MD_DIR.mkdir(parents=True)
    save_graph_refs(main, hyb, MD_DIR)
    main.clear()                         # phase 10's ranks need the card
    hyb.clear()
    gc_cuda()
    held = torch.cuda.memory_allocated() / 1e9
    want = train5c["losses"][:MD_STEPS_A]
    try:
        t0 = time.perf_counter()
        a = spmd.launch(md_rank_one, 1, str(MD_DIR), timeout_s=600)[0]
        ta = time.perf_counter() - t0
        equal, n = md_params_equal(str(MD_DIR), md_config(),
                                   train5c["params_at"], torch.device("cuda"))
        say(f"[multi] 10a: one rank over {a['backend']}, mesh {a['mesh']}, "
            f"fsdp_params: losses {a['losses']} against phase 5c's "
            f"one-device steps' {want}; parameters "
            f"{'equal' if equal else 'DIFFERENT'} bit for bit ({n} leaves);"
            f" launches {a['launches']}; checkpoint saved in "
            f"{a['save_s']:.1f} s; {ta:.1f} s with the one-rank run 10b is "
            f"held to (the parent holds {held:.2f} GB)")
        if a["backend"] != "nccl":
            fail(f"10a: one rank on the card ran over {a['backend']}, not "
                 "nccl")
        if a["losses"] != want or not equal:
            fail("10a: the mesh step differs from phase 5c's one-device "
                 "step")
        if not all(a["launches"].values()):
            fail(f"10a: a kernel did not launch: {a['launches']}")
        t0 = time.perf_counter()
        ranks = spmd.launch(md_rank_two, 2, str(MD_DIR), train5c["losses"],
                            timeout_s=900)
        tb = time.perf_counter() - t0
    finally:
        shutil.rmtree(MD_DIR, ignore_errors=True)
    return md_report(card, a, ranks, ta, tb, train5c)


def md_report(card: str, a: dict, ranks: list, ta: float, tb: float,
              train5c: dict) -> dict:
    """Print 10b-10d from both ranks, then fail on any of their checks."""
    faults = []
    launches = {n: a["launches"][n] for n in MD_KERNELS}
    for r, res in enumerate(ranks):
        for mode in ("fsdp", "dp"):
            t = res[mode]
            med = sorted(t["dts"])[len(t["dts"]) // 2]
            say(f"[multi] 10b rank {r} {'fsdp_params' if t['fsdp'] else 'replicated'}"
                f" over {res['backend']}, mesh {res['mesh']}: losses "
                f"{t['losses']}; against the one-rank run in two "
                f"micro-batches (each row routed apart, as the ranks route "
                f"theirs): loss within {t['loss_err']:.2e} relative "
                f"(limit {MD_LOSS_RTOL}), worst leaf updates "
                f"{t['worst']} (limit {MD_UPDATE_TOL}); phase 5c's losses "
                f"(the whole batch routed at once) within "
                f"{t['loss_err_5c']:.2e} (printed); "
                f"{t['n_split']} of {t['n_leaves']} leaves "
                f"split, held as halves before/after: {t['held_before']}/"
                f"{t['held_after']}; launches {t['launches']}; peak "
                f"{t['peak_gb']:.2f} GB"
                + (f" (the whole-tree gather before this change: "
                   f"{PARENT_10B_PEAK_GB} GB, read once on {PARENT_10B_CARD},"
                   f" not in this run); the use-site gathers "
                   f"{t['gathered']['gathers']} over {len(t['dts'])} steps,"
                   f" {t['gathered']['bytes'] / 1e9:.2f} GB, at most "
                   f"{t['gathered']['peak'] / 1e9:.3f} GB alive"
                   if t["fsdp"] else "")
                + f"; {2 * 2048 / med:.1f} train tokens/s "
                f"(B2 x S2048 over the median step, {med * 1e3:.1f} ms) on "
                f"{card}")
            for i, s in enumerate(t["split"]):
                say(f"[multi] 10b rank {r} {mode} step {i}: forward "
                    f"{s['forward']:.1f} ms (host {s['forward_host']:.1f} "
                    f"ms), backward {s['backward']:.1f} ms,"
                    f" collective {s['collective']:.1f} ms, optimizer "
                    f"{s['optimizer']:.1f} ms (CUDA events)")
            if t["loss_err"] > MD_LOSS_RTOL \
                    or t["update_err"] > MD_UPDATE_TOL:
                faults.append(f"10b rank {r} {mode}: off the one-rank run")
            if t["fsdp"] and not (t["held_before"] and t["held_after"]):
                faults.append(f"10b rank {r}: a rank does not hold half of each "
                     "fsdp-sharded leaf")
            if not all(t["launches"].values()):
                faults.append(f"10b rank {r} {mode}: a kernel did not launch: "
                     f"{t['launches']}")
            for n in MD_KERNELS:
                launches[n] += t["launches"][n]
        c = res["restore"]
        say(f"[multi] 10c rank {r}: reshard_state of 10a's checkpoint "
            f"({c['n_leaves']} leaves) in {c['place_s']:.1f} s (the blocks' "
            f"check {c['check_s']:.1f} s, the {c['n_params']} parameters "
            f"gathered back {c['gather_s']:.1f} s): blocks "
            f"{'equal' if c['blocks_equal'] else 'DIFFERENT'}, parameters "
            f"gathered back {'equal' if c['whole_equal'] else 'DIFFERENT'} "
            f"bit for bit")
        if not (c["blocks_equal"] and c["whole_equal"]):
            faults.append(f"10c rank {r}: the restore is not bit for bit")
        p, h = res["pipe"], res["a2a"]
        say(f"[multi] 10d rank {r}: pipeline_shard of {PIPE_LAYERS} Mixtral "
            f"blocks on 2 stages, M = {PIPE_MICRO} of B1 x S2048: "
            f"{p['steps']} steps, {p['ms']:.1f} ms, {p['ms_micro']:.1f} ms a "
            f"microbatch, {'equal' if p['equal'] else 'DIFFERENT'} to the "
            f"serial blocks; launches {p['launches']}")
        say(f"[multi] 10d rank {r}: a2a_dispatch(mesh=data=2) T{T_TOKENS}: "
            f"{'byte-equal' if h['equal'] else 'DIFFERENT'} to the one-rank "
            f"hop (max |diff| {h['max_abs']}); launches {h['launches']}")
        v, f, m = res["vocab"], res["flash_decode"], res["tensor_map"]
        say(f"[multi] 10d rank {r}: vocab-parallel at model=2: embedding "
            f"{'equal' if v['embed_equal'] else 'DIFFERENT'}, loss "
            f"{v['loss']:.6f} within {v['loss_err']:.2e} (limit "
            f"{MD_TOL['vp_loss']}), input gradient {v['grad_err']:.2e} of "
            f"its scale (limit {MD_TOL['vp_grad']}); flash_decode_combine "
            f"{f['err']:.2e} (limit {MD_TOL['flash_decode']}); tensor_map "
            f"gather {m['gather_err']:.2e} (limit {MD_TOL['tm_gather']}), "
            f"reduce {m['reduce_err']:.2e} (limit {MD_TOL['tm_reduce']})")
        if not (p["equal"] and p["finite"] and h["equal"]
                and v["embed_equal"]):
            faults.append(f"10d rank {r}: a skeleton differs from its one-rank form")
        for key, got in (("vp_loss", v["loss_err"]), ("vp_grad", v["grad_err"]),
                         ("flash_decode", f["err"]),
                         ("tm_gather", m["gather_err"]),
                         ("tm_reduce", m["reduce_err"])):
            if not got <= MD_TOL[key]:
                faults.append(f"10d rank {r}: {key} {got} over {MD_TOL[key]}")
        if not all(p["launches"].values()) or not all(h["launches"].values()):
            faults.append(f"10d rank {r}: a kernel did not launch")
        for n in MD_KERNELS:
            launches[n] += p["launches"][n]
        for n in ("a2a_route", "a2a_combine"):
            launches[n] = launches.get(n, 0) + h["launches"][n]
        say(f"[multi] rank {r}: train {res['train_s']:.1f} s, restore "
            f"{res['restore_s']:.1f} s, skeletons {res['skeletons_s']:.1f} s;"
            f" collectives by transport (calls) {res['routes']}, host "
            f"seconds {res['route_s']}")
    fsdp = [r["fsdp"] for r in ranks]
    dts = sorted(fsdp[0]["dts"])
    tok_fsdp = 2 * 2048 / dts[len(dts) // 2]
    say(f"[multi] train tokens/s: two ranks on one card with fsdp_params "
        f"{tok_fsdp:.1f}, replicated "
        f"{2 * 2048 / ranks[0]['dp']['dts'][0]:.1f} (one step, the first), "
        f"one device (phase 5c) {train5c['tok_s']:.1f}")
    for r, res in enumerate(ranks):
        gr = res["graph"]
        for label in ("lossless", "capacity", "hybrid"):
            x = gr[label]
            held = ("byte-equal to the one-rank outputs in stream order"
                    if label != "hybrid" else
                    f"its whole microbatches' rows byte-equal to phase 4's "
                    f"one-rank run at microbatch {HYBRID_MICROBATCH // 2} "
                    f"(a rank's block), every row within "
                    f"{x['max_abs'] / x['scale']:.2e} of the scale of phase "
                    f"4's at {HYBRID_MICROBATCH} (limit {REL_TOL}; "
                    f"{x['rows_differ']} of {GRAPH_HYBRID_ITEMS} rows "
                    f"differ), in stream order")
            say(f"[multi] 10e rank {r} {label}: phase "
                f"{'4' if label == 'hybrid' else '3'}'s graph over (data 2)"
                f", {x['runner']}: "
                f"{held if x['equal'] else 'DIFFERENT: ' + held}; launches "
                f"{x['launches']}; {x['items_s']:.1f} items/s a rank "
                + (f"({GRAPH_HYBRID_ITEMS} items, microbatch "
                   f"{HYBRID_MICROBATCH}, {x['flushes']} flushes; boundary "
                   f"{x['boundary']})" if label == "hybrid" else
                   f"(T{T_TOKENS}, the second run)") + f" on {card}")
            if not x["equal"]:
                faults.append(f"10e rank {r} {label}: differs from the "
                              "one-rank run")
            if not all(x["launches"].values()):
                faults.append(f"10e rank {r} {label}: a kernel did not "
                              f"launch: {x['launches']}")
            for n, k in x["launches"].items():
                launches[n + "_graph"] = launches.get(n + "_graph", 0) + k
        say(f"[multi] 10e rank {r}: {gr['secs']:.1f} s")
    if len({res["graph"]["hybrid"]["digest"] for res in ranks}) != 1:
        faults.append("10e: the ranks' hybrid outputs differ")
    say(f"[multi] phase 10: 10a {ta:.1f} s, 10b-10e {tb:.1f} s on {card}")
    if faults:
        fail("; ".join(faults))
    return {"launches": launches, "tok_s": tok_fsdp}


def path_rows(rows: list, paths: list) -> list:
    """Rows for kernels on a path whose shapes rows above already time:
    ``(name, row timed at the same shape, launches on the path)``."""
    by = {r["name"]: r for r in rows}
    return [dict(by[src], name=name, launches=n) for name, src, n in paths]


def multi_device_rows(dev: torch.device, card: str, errs: dict, rows: list,
                      train5c: dict, main: dict, hyb: dict) -> list:
    """Phase 10 and its kernels' rows, with the launches summed over its
    ranks: 10b's per-rank attention (B1 x S2048 D128) and router (2048
    tokens) run at phase 5's serving shapes, so their rows take those
    times; the a2a hop per rank (T 2048 at capacity 4096) is timed here,
    and 10e's graph over the ranks takes that row's time (its lossless
    hop's per-rank shape)."""
    t0 = time.perf_counter()
    md = phase_multi_device(card, train5c, main, hyb)
    out = path_rows(rows, [
        ("flash_attention_multi_rank", "flash_attention",
         md["launches"]["flash_attention"]),
        ("router_topk_multi_rank", "router_topk",
         md["launches"]["router_topk"])])
    out += a2a_rows(dev, T_TOKENS // 2, T_TOKENS,
                    {n: md["launches"][n] for n in ("a2a_route",
                                                    "a2a_combine")},
                    errs, card, "_multi_rank")
    out += path_rows(out, [
        ("a2a_route_graph_ranks", "a2a_route_multi_rank",
         md["launches"]["a2a_route_graph"]),
        ("a2a_combine_graph_ranks", "a2a_combine_multi_rank",
         md["launches"]["a2a_combine_graph"])])
    say(f"[multi] phase 10 {time.perf_counter() - t0:.1f} s on {card}")
    return out


# ---------------------------------------------------------------------------
# phase 11: the model sharded over the model axis
# ---------------------------------------------------------------------------
TP_DIR = ROOT / "build" / "tensor_parallel"
TP_STEPS = 2                     # 11a: train steps, held to phase 5c's
TP_S, TP_NEW = 2048, 16          # 11b-11d: prompt, and decode steps
TP_LOSS_RTOL = 2e-3              # 11a: each step's loss, relative
# 11a: each leaf's update against phase 5c's (L2, as MD_UPDATE_TOL), set
# between two readings on the card (NVIDIA H100 80GB HBM3, 700.00 W): the
# sound steps' worst leaf, 0.3899 (attention's wk: 5.4% of its bf16
# elements take another update than on one device, the forward rounding
# the row-parallel sums once in fp32), and the same steps without the
# gradient sum over the model axis, 0.7856 (the lesser of the two ranks'
# worst; every run reads it too); 1.41x over the one, 1.43x under the other
TP_UPDATE_TOL = 0.55
# 11b: the gathered logits and the cache blocks against the one-device
# run, of their scale (one layer: the row-parallel bf16 partials summed in
# fp32 and rounded once where the one device rounds the whole product once)
TP_SERVE_TOL = 2e-2
TP_KERNELS = {"11a": ("flash_attention", "router_topk"),
              "11b": ("flash_attention", "router_topk"),
              "11c": ("flash_attention", "ssd_scan"),
              "11d": ("flash_attention", "router_topk")}


def tp_kimi_config():
    """Kimi-K2 at 1 of its 61 layers (34.2 GB of bf16 weights)."""
    return family_config("kimi-k2-1t-a32b", 1)


def tp_prompt(cfg, dev: torch.device, seed: int = 21) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (1, TP_S), generator=g,
                         dtype=torch.int32).to(dev)


def tp_pos(t: int, dev: torch.device) -> torch.Tensor:
    """Decode step ``t``'s position, after the prompt."""
    return torch.tensor(TP_S + t, dtype=torch.int32, device=dev)


def tp_references(dev: torch.device) -> None:
    """The one-device runs phase 11 is held to, written under ``TP_DIR``:
    Mixtral-8x7B at 1 layer, a B1 x S2048 prefill and ``TP_NEW`` greedy
    decode steps (each step's logits, the tokens, the caches after the
    prefill and after the steps); Kimi-K2 at 1 layer, a prefill's block
    output and which tokens the router dropped.  Weights from seed 0, as each rank
    draws its blocks of them."""
    from repro_torch.core.plan import single_device_plan
    from repro_torch.core.tree import jax_leaves
    from repro_torch.models.lm import LM
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    one = single_device_plan(dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        cfg = md_config()
        params = LM(cfg).init(gen())
        prompt = tp_prompt(cfg, dev)
        logits, caches = make_prefill_step(cfg, one, TP_S + TP_NEW)(
            params, {"tokens": prompt})
        ref = {"prompt": prompt.cpu(), "logits": [logits.float().cpu()],
               "prefill_cache": [t.to("cpu", copy=True)
                                 for t in jax_leaves(caches)]}
        decode = make_decode_step(cfg, one, TP_S + TP_NEW)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        toks = [tok.cpu()]
        for t in range(TP_NEW):
            tok, logits, caches = decode(params, caches, {
                "token": tok, "pos": tp_pos(t, dev)})
            ref["logits"].append(logits.float().cpu())
            toks.append(tok.cpu())
        ref["tokens"] = toks
        ref["decode_cache"] = [t.cpu() for t in jax_leaves(caches)]
        torch.save(ref, TP_DIR / "mixtral_serve.pt")
        del params, caches, ref
        gc_cuda()
        cfg = tp_kimi_config()
        params = LM(cfg).init(gen())
        seen = TpCapture()
        try:
            logits, _ = make_prefill_step(cfg, one, TP_S)(
                params, {"tokens": tp_prompt(cfg, dev)})
        finally:
            seen.undo()
        torch.save({"hidden": seen.hidden.cpu(), "kept": seen.kept().cpu(),
                    "logits": logits.float().cpu()}, TP_DIR / "kimi.pt")
        del params, logits, seen
    gc_cuda()


class TpCapture:
    """While alive: the last ``LM._run_segments`` output (the blocks' last
    output, before the final norm) and, per routed token, whether every
    one of its top-K entries kept its lane (``router_topk``'s ``keep``).
    ``undo()`` restores both functions."""

    def __init__(self):
        from repro_torch.models import lm as L
        from repro_torch.models import moe
        self._run, self._route = L.LM._run_segments, moe.router_topk
        self.hidden, self.keeps = None, []
        cap = self

        def run(model, *a, **k):
            out = cap._run(model, *a, **k)
            cap.hidden = out[0]
            return out

        def route(*a, **k):
            out = cap._route(*a, **k)
            cap.keeps.append(out[3])
            return out
        L.LM._run_segments, moe.router_topk = run, route

    def kept(self) -> torch.Tensor:
        return torch.cat([k.all(-1) for k in self.keeps])

    def undo(self) -> None:
        from repro_torch.models import lm as L
        from repro_torch.models import moe
        L.LM._run_segments, moe.router_topk = self._run, self._route


class TpShapes:
    """While alive: the shapes each kernel wrapper is called with from the
    model's blocks (q, k, v of ``flash_attention`` and ``ssd_scan``; the
    logits of ``router_topk``; x of ``gelu_stepwise``) and, in ``counts``,
    its launches at each, by default from the attention, MoE and Mamba2
    blocks, else from the (module, name) pairs of ``targets``: a kernel
    wrapper's name where the model calls it, or (module, name, kernel) for
    a function of the kernel's own module that launches it (the backward's
    ``_launch_bwd``), its launches counted under ``kernel``."""

    def __init__(self, targets=None):
        from repro_torch.kernels import wrappers
        from repro_torch.models import attention, moe, ssm
        self.seen = {}
        self._orig = [(m, n) for m, n, *_ in targets or [
            (attention, "flash_attention"), (moe, "router_topk"),
            (ssm, "ssd_scan")]]
        kernels = [t[2] if len(t) > 2 else t[1] for t in targets or
                   self._orig]
        self.counts = {}             # kernel -> shapes -> launches
        self._fns = [getattr(m, n) for m, n in self._orig]
        for (m, n), fn, kn in zip(self._orig, self._fns, kernels):
            def wrap(*a, _fn=fn, _n=kn, _c=wrappers()[kn], **k):
                key = tuple(tuple(t.shape) for t in a[:3]
                            if isinstance(t, torch.Tensor))
                self.seen.setdefault(_n, set()).add(key)
                before = _c.launches
                out = _fn(*a, **k)
                by = self.counts.setdefault(_n, {})
                by[key] = by.get(key, 0) + _c.launches - before
                return out
            setattr(m, n, wrap)

    def undo(self) -> dict:
        for (m, n), fn in zip(self._orig, self._fns):
            setattr(m, n, fn)
        return {n: sorted(v) for n, v in self.seen.items()}


def tp_routes() -> dict:
    """A copy of the collectives' calls and host seconds so far."""
    from repro_torch.core import spmd
    return {"calls": {k: dict(v) for k, v in spmd.ROUTES.items()},
            "secs": {k: dict(v) for k, v in spmd.ROUTE_SECONDS.items()}}


def tp_routes_since(before: dict) -> dict:
    """The collectives' calls and host seconds since ``before``."""
    now = tp_routes()
    out = {}
    for op, by in now["calls"].items():
        for route, n in by.items():
            n0 = before["calls"].get(op, {}).get(route, 0)
            s = now["secs"].get(op, {}).get(route, 0.0) \
                - before["secs"].get(op, {}).get(route, 0.0)
            if n > n0:
                out[f"{op}/{route}"] = (n - n0, round(s, 3))
    return out


def tp_updates(cfg, plan, dev, params, ref, prep=None) -> list:
    """Each leaf's update on this rank's block against phase 5c's
    one-device update after the same steps (the sums summed over the ranks
    that split a leaf): (relative L2 error, share of the elements whose
    update differs, leaf), worst first.  ``prep(cfg, params)`` is what was
    done to the drawn parameters before the steps."""
    from repro_torch.core import spmd
    from repro_torch.core.tree import jax_leaves
    from repro_torch.models import params as pp
    from repro_torch.models.lm import LM
    from repro_torch.models.params import walk_defs
    from repro_torch.runtime.steps import state_shardings
    defs = LM(cfg).param_defs()
    sh = jax_leaves(state_shardings(cfg, plan)["params"])
    p0 = pp.init_blocks(defs, torch.Generator(device=dev).manual_seed(0),
                        plan)
    if prep is not None:
        prep(cfg, p0)
    p0 = jax_leaves(p0)
    names = ["/".join(path) for path, _ in sorted(walk_defs(defs))]
    out = []
    for t, s, a, w, d, name in zip(jax_leaves(params), sh, p0,
                                   ref["params_at"], jax_leaves(defs),
                                   names):
        w = s.local_block(w).to(dev)
        # the two squared norms, the elements whose update differs, all
        sq = torch.cat([update_sq(t, a, w).double(), torch.tensor(
            [float((t != w).sum()), float(t.numel())],
            dtype=torch.float64, device=dev)])
        if plan.model_split(d.shape, d.axes):
            sq = spmd.all_sum(sq, plan.mesh, ("model",))
        out.append((float(sq[0].sqrt() / sq[1].sqrt().clamp(min=1e-30)),
                    float(sq[2] / sq[3]), name))
    return sorted(out, reverse=True)


def tp_train(plan, dev, out_dir: str) -> dict:
    """11a: Mixtral-8x7B at 1 of 32 layers, :func:`train_pair` over (data
    1, model 2) on phase 5c's batches and schedule from its seed, held to
    phase 5c's one-device parameters after the same steps."""
    out = train_pair(plan, dev, md_config(), torch.load(
        pathlib.Path(out_dir) / "train5c.pt", mmap=True))
    out["launches"] = {n: out["launches"].get(n, 0)
                       for n in TP_KERNELS["11a"]}
    return out


def train_pair(plan, dev, cfg, ref, prep=None, shapes=None) -> dict:
    """``TP_STEPS`` steps of ``make_train_step`` from the seed-0 draw (then
    ``prep(cfg, params)``) on phase 5c's batches and schedule: the losses,
    the grad norms, the host times and their split, each kernel's launches
    (and, where ``shapes`` makes a :class:`TpShapes`, its launches by
    shape, ``by_shape``), and each leaf's update on this rank's block
    against the one-device steps' ``ref`` (:func:`tp_updates`); then the
    same steps with the gradient sum over the model axis removed
    (``reduce_grads`` without its ``replicated`` axes), the fault the
    update limit must see."""
    from repro_torch.core.tree import jax_leaves
    from repro_torch.models.lm import LM
    from repro_torch.runtime import steps as st
    from repro_torch.runtime.steps import init_state, make_train_step

    def fresh():
        state = init_state(cfg, plan,
                           torch.Generator(device=dev).manual_seed(0))
        if prep is not None:
            prep(cfg, state["params"])
        return state
    state = fresh()
    split = [bool(plan.model_split(d.shape, d.axes))
             for d in jax_leaves(LM(cfg).param_defs())]
    batches = [{"tokens": torch.as_tensor(b["tokens"], device=dev)}
               for b in md_batches(cfg, TP_STEPS)]
    clock = RankClock()
    step = clock.wrap(make_train_step(cfg, plan, md_schedule()))
    kernels = zero_launches()
    routes0 = tp_routes()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, norms, dts = [], [], []
    seen = shapes() if shapes else None
    try:
        with clock.timing():
            for b in batches:
                sync(dev)
                t0 = time.perf_counter()
                state, m = step(state, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                dts.append(time.perf_counter() - t0)
    finally:
        if seen:
            seen.undo()
    launches = read_launches(kernels)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    routes = tp_routes_since(routes0)
    worst = tp_updates(cfg, plan, dev, state["params"], ref, prep)
    del state
    gc_cuda()
    state = fresh()
    reduce_grads = st.reduce_grads
    st.reduce_grads = lambda g, s, axes, replicated=(): reduce_grads(g, s,
                                                                     axes)
    try:
        step = make_train_step(cfg, plan, md_schedule())
        for b in batches:
            state, _ = step(state, b)
    finally:
        st.reduce_grads = reduce_grads
    fault = tp_updates(cfg, plan, dev, state["params"], ref, prep)
    del state
    show = lambda ws: [(n, round(e, 4), round(f, 4)) for e, f, n in ws[:3]]
    return {"losses": losses, "want": list(ref["losses"][:TP_STEPS]),
            "loss_err": max(abs(a / b - 1) for a, b in
                            zip(losses, ref["losses"])),
            "norms": norms, "want_norms": list(ref.get("norms", []))[
                :TP_STEPS],
            "update_err": worst[0][0], "worst": show(worst),
            "fault_err": fault[0][0], "fault": show(fault),
            "n_split": sum(split), "n_leaves": len(split),
            "launches": launches, "peak_gb": peak_gb,
            "by_shape": seen.counts if seen else {},
            "split": clock.split(), "dts": dts, "routes": routes}


def tp_serve(plan, dev, out_dir: str) -> dict:
    """11b: Mixtral-8x7B at 1 layer, a B1 x S2048 prefill and ``TP_NEW``
    decode steps over (data 1, model 2), the decode steps fed the
    one-device run's tokens: each step's logits gathered over the model
    axis against the one-device run's, the greedy tokens against its
    tokens, the cache blocks against its caches' head_dim slices."""
    from repro_torch.core.tree import jax_leaves
    from repro_torch.models import params as pp
    from repro_torch.models.lm import LM
    from repro_torch.runtime.steps import (gather_logits, make_decode_step,
                                           make_prefill_step)
    cfg = md_config()
    ref = torch.load(pathlib.Path(out_dir) / "mixtral_serve.pt")
    params = pp.init_blocks(LM(cfg).param_defs(),
                            torch.Generator(device=dev).manual_seed(0), plan)
    prompt = ref["prompt"].to(dev)
    prefill = make_prefill_step(cfg, plan, TP_S + TP_NEW)
    decode = make_decode_step(cfg, plan, TP_S + TP_NEW)
    gather = lambda t: gather_logits(t, plan, cfg, 1)
    shapes = TpShapes()
    kernels = zero_launches()
    routes0 = tp_routes()
    with torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": prompt})
        sync(dev)
        prefill_s = time.perf_counter() - t0
        errs = [scale_err(gather(logits), ref["logits"][0].to(dev))]
        cache_errs = [tp_cache_err(t, w, plan, dev) for t, w in zip(
            jax_leaves(caches), ref["prefill_cache"])]
        toks, host_ms, dev_ms = [], [], []
        for t in range(TP_NEW):
            tok_in = ref["tokens"][t].to(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            sync(dev)
            h0 = time.perf_counter()
            start.record()
            nt, logits, caches = decode(params, caches, {
                "token": tok_in, "pos": tp_pos(t, dev)})
            end.record()
            sync(dev)
            host_ms.append((time.perf_counter() - h0) * 1e3)
            dev_ms.append(start.elapsed_time(end))
            whole = gather(logits)
            errs.append(scale_err(whole, ref["logits"][t + 1].to(dev)))
            want = int(ref["tokens"][t + 1])
            got = int(nt[0, 0])
            row = ref["logits"][t + 1][0, -1]
            tie = float(row[got]) >= float(row.max()) - TP_SERVE_TOL * max(
                1.0, float(row.abs().max()))
            toks.append((got, want, got == want or tie))
        cache_errs += [tp_cache_err(t, w, plan, dev) for t, w in zip(
            jax_leaves(caches), ref["decode_cache"])]
    launches = {n: kernels[n].launches for n in TP_KERNELS["11b"]}
    del params, caches
    return {"prefill_s": prefill_s, "tok_s": TP_S / prefill_s,
            "logit_err": max(errs), "cache_err": max(cache_errs),
            "tokens": toks, "host_ms": host_ms, "dev_ms": dev_ms,
            "launches": launches, "shapes": shapes.undo(),
            "routes": tp_routes_since(routes0)}


def tp_cache_err(got: torch.Tensor, want: torch.Tensor, plan, dev) -> float:
    """A cache block against the one-device cache's slice of this rank
    (head_dim split over the model axis)."""
    from repro_torch.core.plan import TorchSharding
    from repro_torch.models.attention import _cache_axes
    cfg = md_config()
    spec = plan.spec_for_shape(want.shape, ("layers",) + _cache_axes(cfg))
    return scale_err(got, TorchSharding(plan.mesh, spec).local_block(
        want).to(dev))


def tp_zamba(plan, dev, out_dir: str) -> dict:
    """11c: Zamba2-1.2B whole over (data 1, model 2): a B1 x S2048 prefill
    and ``TP_NEW`` greedy decode steps through ``make_prefill_step``/
    ``make_decode_step`` (timed, kernels counted), then the same again with
    every block's input and output kept and held to the one-device blocks
    on those inputs (:func:`tf_front`: each block's output, the gathered
    logits, the cache and state blocks, each greedy token against the
    one-device logits' argmax or a near tie)."""
    from repro_torch.configs import get
    cfg = get("zamba2-1.2b")
    out = tf_front(plan, dev, cfg, {"tokens": tp_prompt(cfg, dev)},
                   [{"pos": tp_pos(t, dev)} for t in range(TP_NEW)],
                   TP_S + TP_NEW, shapes=TpShapes())
    out["launches"] = {n: out["launches"].get(n, 0)
                       for n in TP_KERNELS["11c"]}
    out["tok_s"] = TP_S / out["prefill_s"]
    return out


def tp_kimi(plan, dev, out_dir: str) -> dict:
    """11d: Kimi-K2 at 1 of 61 layers, expert-parallel over the model axis
    (192 experts a rank), a B1 x S2048 prefill: the block output of the
    tokens that neither this run nor the one-device run dropped (any of
    their top-8 entries over its lane's capacity) against the one-device
    run's, and both drop counts."""
    from repro_torch.core import spmd
    from repro_torch.models import params as pp
    from repro_torch.models.lm import LM
    from repro_torch.runtime.steps import make_prefill_step
    cfg = tp_kimi_config()
    ref = torch.load(pathlib.Path(out_dir) / "kimi.pt")
    t0 = time.perf_counter()
    params = pp.init_blocks(LM(cfg).param_defs(),
                            torch.Generator(device=dev).manual_seed(0), plan)
    sync(dev)
    init_s = time.perf_counter() - t0
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    shapes = TpShapes()
    seen = TpCapture()
    kernels = zero_launches()
    routes0 = tp_routes()
    try:
        with torch.no_grad():
            sync(dev)
            t0 = time.perf_counter()
            prefill_step = make_prefill_step(cfg, plan, TP_S)
            logits, _ = prefill_step(params, {"tokens": tp_prompt(cfg, dev)})
            sync(dev)
            prefill_s = time.perf_counter() - t0
    finally:
        seen.undo()
    launches = {n: kernels[n].launches for n in TP_KERNELS["11d"]}
    with spmd.manual(plan.mesh, plan.mesh.axis_names):
        hidden = plan.seq_gather(seen.hidden, True)
        kept = spmd.all_gather(seen.kept()[None].to(torch.uint8), "model",
                               axis_dim=1)[0].bool()
    both = kept.cpu() & ref["kept"]
    err = scale_err(hidden[0][both.to(dev)], ref["hidden"][0][both].to(dev))
    del params, hidden
    return {"prefill_s": prefill_s, "tok_s": TP_S / prefill_s,
            "init_s": init_s, "held_gb": held_gb,
            "dropped": int((~kept).sum()), "dropped_one": int(
                (~ref["kept"]).sum()), "compared": int(both.sum()),
            "err": err, "launches": launches, "shapes": shapes.undo(),
            "routes": tp_routes_since(routes0)}


def tp_rank(out_dir: str) -> dict:
    """11a-11d in each of two ranks sharing ``cuda:0`` over gloo, on a
    (data 1, model 2) mesh."""
    from repro_torch.core import spmd
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.launch.mesh import make_mesh
    dev = md_setup()
    plan = ShardingPlan(make_mesh((1, 2), ("data", "model")))
    out = {"backend": spmd.backend(), "rank": spmd.rank()}
    for tag, fn in (("11a", tp_train), ("11b", tp_serve), ("11c", tp_zamba),
                    ("11d", tp_kimi)):
        t0 = time.perf_counter()
        out[tag] = fn(plan, dev, out_dir)
        gc_cuda()
        out[tag]["secs"] = time.perf_counter() - t0
    return out


def phase_tensor_parallel(card: str, train5c: dict) -> dict:
    """Phase 11: the one-device references (:func:`tp_references`), then
    11a-11d in two spawned ranks sharing ``cuda:0`` over gloo
    (:func:`tp_rank`); fails on any of their checks."""
    from repro_torch.core import spmd
    dev = torch.device("cuda")
    gc_cuda()
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        torch.save({"losses": train5c["losses"][:TP_STEPS],
                    "params_at": train5c["params_at"]}, TP_DIR / "train5c.pt")
        tp_references(dev)
        tr = time.perf_counter() - t0
        t1 = time.perf_counter()
        ranks = spmd.launch(tp_rank, 2, str(TP_DIR), timeout_s=900)
        tl = time.perf_counter() - t1
    finally:
        shutil.rmtree(TP_DIR, ignore_errors=True)
    return tp_report(card, ranks, tr, tl)


def tp_report(card: str, ranks: list, tr: float, tl: float) -> dict:
    """Print 11a-11d from both ranks, then fail on any of their checks."""
    faults = []
    launches = {}
    for r, res in enumerate(ranks):
        a, b, c, d = res["11a"], res["11b"], res["11c"], res["11d"]
        last = a["dts"][-1]
        say(f"[tp] 11a rank {r} over {res['backend']}, mesh (data 1, model "
            f"2): Mixtral-8x7B 1 of 32 layers, B2 x S2048: losses "
            f"{a['losses']} against phase 5c's {a['want']} (within "
            f"{a['loss_err']:.2e} relative, limit {TP_LOSS_RTOL}); worst leaf"
            f" updates against phase 5c's (leaf, L2 error, share of the "
            f"elements whose update differs) {a['worst']} (limit "
            f"{TP_UPDATE_TOL}); without the gradient sum over the model "
            f"axis {a['fault']} (must exceed the limit); {a['n_split']} of "
            f"{a['n_leaves']} leaves "
            f"split over the model axis; launches {a['launches']}; peak "
            f"{a['peak_gb']:.2f} GB; {2 * 2048 / last:.1f} train tokens/s "
            f"(the second step, {last * 1e3:.1f} ms; the first "
            f"{a['dts'][0] * 1e3:.1f} ms) on {card}")
        for i, s in enumerate(a["split"]):
            say(f"[tp] 11a rank {r} step {i}: forward {s['forward']:.1f} ms "
                f"(host {s['forward_host']:.1f} ms), backward "
                f"{s['backward']:.1f} ms, collective (the gradients' reduce) "
                f"{s['collective']:.1f} ms, optimizer "
                f"{s['optimizer']:.1f} ms (CUDA events) on {card}")
        say(f"[tp] 11a rank {r} collectives (calls, host s): {a['routes']}")
        if a["loss_err"] > TP_LOSS_RTOL or a["update_err"] > TP_UPDATE_TOL:
            faults.append(f"11a rank {r}: off phase 5c's one-device steps")
        if a["fault_err"] <= TP_UPDATE_TOL:
            faults.append(f"11a rank {r}: the update limit does not see the "
                          f"gradient sum over the model axis removed")
        bad = [t for t in b["tokens"] if not t[2]]
        say(f"[tp] 11b rank {r}: Mixtral-8x7B 1 layer, prefill B1 x S2048 "
            f"{b['prefill_s'] * 1e3:.1f} ms ({b['tok_s']:.0f} tokens/s), "
            f"{TP_NEW} decode steps host {min(b['host_ms']):.2f}-"
            f"{max(b['host_ms']):.2f} ms (median "
            f"{sorted(b['host_ms'])[TP_NEW // 2]:.2f}), device median "
            f"{sorted(b['dev_ms'])[TP_NEW // 2]:.2f} ms a step on {card}; "
            f"gathered logits within {b['logit_err']:.2e} of the one-device "
            f"run's scale, cache blocks {b['cache_err']:.2e} (limit "
            f"{TP_SERVE_TOL}); greedy tokens {[t[0] for t in b['tokens']]} "
            f"against {[t[1] for t in b['tokens']]}; launches "
            f"{b['launches']}; kernel shapes {b['shapes']}")
        say(f"[tp] 11b rank {r} collectives (calls, host s): {b['routes']}")
        if max(b["logit_err"], b["cache_err"]) > TP_SERVE_TOL or bad:
            faults.append(f"11b rank {r}: off the one-device run ({bad})")
        bad_c = [t for t in c["tokens"] if not t[2]]
        say(f"[tp] 11c rank {r}: Zamba2-1.2B whole, prefill B1 x S2048 "
            f"{c['prefill_s'] * 1e3:.1f} ms ({c['tok_s']:.0f} tokens/s), "
            f"decode host median {sorted(c['host_ms'])[TP_NEW // 2]:.2f} ms "
            f"a step on {card}; the steps' blocks held to the one-device "
            f"blocks on their inputs: worst {c['walk_err']:.4f} of the "
            f"scale over {c['walk_blocks']} block outputs, the gathered "
            f"logits {c['logit_err']:.4f}, the cache and state blocks "
            f"{c['cache_err']:.4f} (limit {WALK_TOL}); greedy tokens "
            f"{[t[0] for t in c['tokens']]} against the one-device logits' "
            f"argmax {[t[1] for t in c['tokens']]}; launches "
            f"{c['launches']}; kernel shapes {c['shapes']}")
        say(f"[tp] 11c rank {r} collectives (calls, host s): {c['routes']}")
        if max(c["walk_err"], c["logit_err"], c["cache_err"]) > WALK_TOL \
                or bad_c:
            faults.append(f"11c rank {r}: off the one-device blocks "
                          f"({bad_c})")
        say(f"[tp] 11d rank {r}: Kimi-K2 1 of 61 layers, expert-parallel "
            f"(192 experts a rank), {d['held_gb']:.1f} GB held after drawing"
            f" its blocks in {d['init_s']:.1f} s; prefill B1 x S2048 "
            f"{d['prefill_s'] * 1e3:.1f} ms ({d['tok_s']:.0f} tokens/s) on "
            f"{card}; dropped tokens {d['dropped']} (one device "
            f"{d['dropped_one']}); over the {d['compared']} tokens neither "
            f"dropped the block output within {d['err']:.2e} of the scale "
            f"(limit {MODEL_TOL}); launches {d['launches']}; kernel shapes "
            f"{d['shapes']}")
        say(f"[tp] 11d rank {r} collectives (calls, host s): {d['routes']}")
        if d["err"] > MODEL_TOL or d["compared"] < TP_S // 2:
            faults.append(f"11d rank {r}: off the one-device run")
        for tag in ("11a", "11b", "11c", "11d"):
            got = res[tag]["launches"]
            if not all(got.values()):
                faults.append(f"{tag} rank {r}: a kernel did not launch: "
                              f"{got}")
            for n, k in got.items():
                key = {"11a": n, "11b": n, "11c": f"{n}_zamba",
                       "11d": f"{n}_kimi"}[tag]
                launches[key] = launches.get(key, 0) + k
        say(f"[tp] rank {r}: 11a {a['secs']:.1f} s, 11b {b['secs']:.1f} s, "
            f"11c {c['secs']:.1f} s, 11d {d['secs']:.1f} s")
    say(f"[tp] phase 11: references {tr:.1f} s, ranks {tl:.1f} s on {card}")
    if faults:
        fail("; ".join(faults))
    return {"launches": launches}


def tensor_parallel_rows(dev: torch.device, card: str, errs: dict,
                         train5c: dict) -> list:
    """Phase 11 and its kernels' rows at a rank's shapes, the launches
    summed over the ranks: Mixtral's attention at H16/Hkv4 (D128, S2048)
    and Zamba2's at H16/16 (D64), Kimi-K2's at H32/Hkv4 (D128); the router
    over Mixtral's 2048 gathered tokens (E8 K2; 11a's 4096 a step in
    training) and Kimi-K2's 1024 local ones (E384 K8); ``ssd_scan`` over
    Zamba2's 32 local heads."""
    t0 = time.perf_counter()
    tp = phase_tensor_parallel(card, train5c)
    n = tp["launches"]
    g = torch.Generator().manual_seed(13)
    rows = [time_flash(dev, g, "flash_attention_tp", (1, 16, 4, 2048, 128,
                                                      4096),
                       n["flash_attention"], errs["flash_attention_tp"],
                       card),
            time_flash(dev, g, "flash_attention_tp_d64",
                       (1, 16, 16, 2048, 64, 4096),
                       n["flash_attention_zamba"],
                       errs["flash_attention_tp_d64"], card),
            time_flash(dev, g, "flash_attention_tp_kimi",
                       (1, 32, 4, 2048, 128, 0),
                       n["flash_attention_kimi"],
                       errs["flash_attention_tp_kimi"], card),
            time_router(dev, g, "router_topk_tp", 2048, n["router_topk"],
                        errs["router_topk_tp"], card),
            time_router(dev, g, "router_topk_tp_e384", 1024,
                        n["router_topk_kimi"], errs["router_topk_tp_e384"],
                        card, E=384, K=8),
            time_ssd(dev, "ssd_scan_tp", 1, n["ssd_scan_zamba"],
                     errs["ssd_scan_tp"], card, H=32)]
    say(f"[tp] phase 11 with its kernels' rows "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    return rows


# ---------------------------------------------------------------------------
# phase 12: the encdec, vlm and ssm families and context-parallel attention
# over the model axis
# ---------------------------------------------------------------------------
TF_DIR = ROOT / "build" / "tp_families"
# the train steps' depth, B2 x S2048: Llama-3.2-3B at 2 of its 28 layers,
# xLSTM-125m at its first 4 of 12 blocks (3 mLSTM, 1 sLSTM); cut for the
# check, not for memory (random full-width models are chaotic), and their
# attention's q/k/v drawn at the fan-in of d_model (:func:`tf_tame`).
# Each leaf's update against the one-device steps' read on the card
# (NVIDIA H100 80GB HBM3, 700.00 W) with the default draw 1.48 at Llama's
# 14 layers with the model-axis gradient sum and 1.48 without it (the fault
# the check must see), 0.87 and 0.96-1.28 at 2 layers, 0.535 at xLSTM's
# 12 blocks: the draw's fan-in of the heads (24) makes q.k a few hundred,
# softmax one-hot, and a one-ulp difference of q moves a score by O(1).
TF_TRAIN_DEPTH = {"llama3.2-3b": (2, None),
                  "xlstm-125m": (4, [("mlstm", 3), ("slstm", 1)])}
# 12a: each leaf's update against the one-device steps', L2, set between
# two readings on the card of the tamed draw at 2 layers: the sound steps'
# worst leaf, 0.0435 (grad norms within 7.2e-05), and the same steps
# without the gradient sum over the model axis, 0.3906 (the lesser of the
# two ranks' worst; every run reads it); 5.7x over the one, 1.56x under
# the other.  12c takes phase 11a's TP_UPDATE_TOL (0.55): xLSTM's sound
# steps read 0.2284 at 4 blocks, and its fault is not held
TF_UPDATE_TOL = 0.25
TF_KERNELS = {"12a": ("flash_attention",), "12b": ("flash_attention",),
              "12c": ("ssd_scan",),
              "12d": ("flash_attention", "gelu_stepwise")}


def tf_shapes():
    """A :class:`TpShapes` over the kernels of phase 12's blocks: the
    attention's, the mLSTM's ``ssd_scan``, the MLP's gelu."""
    from repro_torch.models import attention, layers, xlstm
    return TpShapes([(attention, "flash_attention"), (xlstm, "ssd_scan"),
                     (layers, "gelu_stepwise")])


class TfBlocks:
    """While alive: every block call of ``LM._run_segments`` outside
    training, grouped into passes (``next_pass()`` before each prefill or
    decode step): the kind, the block's input and output whole over the
    sequence (gathered over the model axis where it is sequence-sharded),
    and what the one-device walk needs to replay it (positions, M-RoPE
    ids, the write slot, whether it decodes; the encoder's whole output
    once a pass), on the host; of a ``dec`` block also the whole outputs
    of its three sublayers (``parts``: self-attention, cross attention,
    MLP), which the walk holds one by one.  ``undo()`` restores what it
    patched."""

    SUBLAYERS = (("self", "attention"), ("cross", "cross_attention"),
                 ("mlp", "mlp"))

    def __init__(self):
        from repro_torch.models import lm as L
        self._apply = L.apply_block
        self._subs = {fn: getattr(L, fn) for _, fn in self.SUBLAYERS}
        self._parts = None
        self.passes = []

        def host(t):
            return t.cpu() if isinstance(t, torch.Tensor) else t

        def apply(kind, x, p, cfg, **kw):
            self._parts = {} if kind == "dec" else None
            y, cache, aux = self._apply(kind, x, p, cfg, **kw)
            tp, sp = kw.get("plan"), kw.get("sp", False)
            whole = (lambda t: tp.seq_gather(t, sp)) if tp is not None \
                else (lambda t: t)
            calls, ctx = self.passes[-1]
            if kw.get("enc_out") is not None and "enc_out" not in ctx:
                ctx["enc_out"] = kw["enc_out"].cpu()
            calls.append((kind, whole(x).cpu(), whole(y).cpu(), {
                "positions": host(kw.get("positions")),
                "mrope": host(kw.get("mrope_positions")),
                "pos_offset": host(kw.get("pos_offset", 0)),
                "decode": isinstance(kw.get("cache"), dict),
                "parts": self._parts}))
            self._parts = None
            return y, cache, aux

        def sublayer(tag, fn, plan_at):
            def run(*args, **kw):
                out = fn(*args, **kw)
                if self._parts is not None:
                    o = out[0] if isinstance(out, tuple) else out
                    plan = kw.get("plan", args[plan_at]
                                  if len(args) > plan_at else None)
                    sp = kw.get("sp", args[plan_at + 1]
                                if len(args) > plan_at + 1 else False)
                    if plan is not None:
                        o = plan.seq_gather(o, sp)
                    self._parts[tag] = o.cpu()
                return out
            return run
        # where ``plan`` sits among each sublayer's positional arguments
        at = {"attention": 99, "cross_attention": 4, "mlp": 3}
        L.apply_block = apply
        for tag, fn in self.SUBLAYERS:
            setattr(L, fn, sublayer(tag, self._subs[fn], at[fn]))

    def next_pass(self) -> None:
        self.passes.append(([], {}))

    def undo(self) -> None:
        from repro_torch.models import lm as L
        L.apply_block = self._apply
        for fn, f in self._subs.items():
            setattr(L, fn, f)


def tf_walk(cfg, params, seen: TfBlocks, dev, cache_len: int) -> dict:
    """The one-device blocks on the whole weights, each fed the input the
    sharded steps gave it (``seen``): every block output's error against
    the sharded one, of its scale; the logits after each pass (the last
    position of the prefill, each decode step's row); the caches after
    the prefill and after the last pass, on the host."""
    import dataclasses
    from repro_torch.core.tree import tree_map
    from repro_torch.models import lm as L
    from repro_torch.models.layers import apply_norm, unembed
    cfg = dataclasses.replace(cfg, cache_len=min(cache_len, cfg.window)
                              if cfg.attn_kind == "swa" else cache_len)
    layers = {k: L._layers(v) for k, v in params["stacks"].items()}
    on = lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t
    errs, logits, caches, first = [], [], {}, None
    kinds, parts = [], {}
    for calls, ctx in seen.passes:
        count, pieces = {}, {}
        for kind, x, y_got, kw in calls:
            li = count.get(kind, 0)
            count[kind] = li + 1
            cache = tree_map(lambda c: c[li], caches[kind]) \
                if kw["decode"] else "init"
            pl = params["shared"] if kind == "shared_attn" \
                else layers[kind][li]
            y, nc, _ = L.apply_block(
                kind, x.to(dev), pl, cfg, cache=cache,
                positions=on(kw["positions"]),
                pos_offset=on(kw["pos_offset"]),
                mrope_positions=on(kw["mrope"]),
                enc_out=on(ctx.get("enc_out")))
            errs.append(scale_err(y_got.to(dev), y))
            kinds.append(kind)
            if kw.get("parts"):
                for tag, e in dec_part_errs(
                        cfg, x.to(dev), pl, cache if kw["decode"] else None,
                        kw, on(ctx.get("enc_out")),
                        {k: v.to(dev) for k, v in kw["parts"].items()},
                        dev).items():
                    parts.setdefault(tag, []).append(e)
            if not kw["decode"] and nc is not None:
                pieces.setdefault(kind, []).append(nc)
        if pieces:
            caches = {k: tree_map(lambda *ls: torch.stack(ls), *cs)
                      for k, cs in pieces.items()}
            first = tree_map(lambda t: t.to("cpu", copy=True), caches)
        last = y[:, -1:]
        logits.append(unembed(apply_norm(last, params["final_norm"],
                                         cfg.norm), params["embed"])
                      .float().cpu())
    return {"errs": errs, "kinds": kinds, "parts": parts, "logits": logits,
            "prefill_cache": first,
            "decode_cache": tree_map(lambda t: t.cpu(), caches)}


def dec_part_errs(cfg, x, p, cache, kw, enc_out, got: dict, dev) -> dict:
    """Each sublayer of a Whisper decoder block on one device against the
    sharded block's own output of it, each fed the sharded block's input
    to it (the block input, then the residual after each sublayer the
    sharded block computed): the errors of the self-attention, the cross
    attention and the MLP, of their scales.  ``cache`` is the walk's
    decode cache of the layer (the token's slot already written, with the
    same values), ``None`` at prefill."""
    from repro_torch.models import attention as A
    from repro_torch.models.layers import apply_norm, mlp, mlp_defs
    on = lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t
    xn = apply_norm(x, p["ln1"], cfg.norm)
    a, _ = A.attention(xn, p["attn"], cfg, positions=on(kw["positions"]),
                       causal=True, window=0,
                       cache=cache["self"] if cache is not None else None,
                       cache_pos=on(kw["pos_offset"]))
    x1 = x + got["self"]
    ckv = cache["cross"] if cache is not None else A.cross_kv(enc_out,
                                                               p["xattn"])
    c = A.cross_attention(apply_norm(x1, p["ln_x"], cfg.norm), p["xattn"],
                          ckv, cfg)
    x2 = x1 + got["cross"]
    m = mlp(apply_norm(x2, p["ln2"], cfg.norm), p["mlp"], cfg.act, None,
            False, mlp_defs(cfg.d_model, cfg.d_ff)["wo"])
    return {"self": scale_err(got["self"], a),
            "cross": scale_err(got["cross"], c), "mlp": scale_err(got["mlp"],
                                                                  m)}


def tf_cache_err(cfg, plan, got, want, B: int, cache_len: int) -> float:
    """Each cache or state block of this rank against its block of the
    one-device walk's whole cache (``LM.cache_shardings``), of the scale:
    the worst."""
    from repro_torch.core.tree import jax_leaves
    from repro_torch.models.lm import LM
    sh = jax_leaves(LM(cfg).cache_shardings(B, cache_len, plan))
    return max(scale_err(g.float(), s.local_block(w).float())
               for g, s, w in zip(jax_leaves(got), sh, jax_leaves(want)))


def tf_hold_tokens(tokens: list, logits: list) -> list:
    """Each greedy token row against the walk's logits before it: (token,
    the argmax, whether it is the argmax or within ``WALK_TOL`` of the
    scale below the maximum)."""
    out = []
    for tok, lg in zip(tokens, logits):
        for b in range(lg.shape[0]):
            row, t = lg[b, -1], int(tok[b])
            tie = float(row[t]) >= float(row.max()) - WALK_TOL * max(
                1.0, float(row.abs().max()))
            out.append((t, int(row.argmax()), tie))
    return out


def tf_serve_check(cfg, plan, dev, seen, tokens, caches, cache_len: int,
                   B: int) -> dict:
    """The walk (:func:`tf_walk`) on the whole seed-0 weights, drawn once
    the rank's own blocks are freed, and the serving checks: every block,
    the gathered logits, the cache blocks after the prefill and after the
    decode steps, the greedy tokens."""
    from repro_torch.models.lm import LM
    with torch.no_grad():
        whole = LM(cfg).init(torch.Generator(device=dev).manual_seed(0))
        ref = tf_walk(cfg, whole, seen, dev, cache_len)
    del whole
    gc_cuda()
    got_logits = caches["logits"]
    by_kind = {}
    for k, e in zip(ref["kinds"], ref["errs"]):
        by_kind[k] = max(by_kind.get(k, 0.0), e)
    by_kind.update({f"dec {t}": max(es) for t, es in ref["parts"].items()})
    return {"walk_err": max(ref["errs"]), "walk_blocks": len(ref["errs"]),
            "walk_by_kind": by_kind,
            "logit_err": max(scale_err(a, b) for a, b in zip(
                got_logits, ref["logits"])),
            "cache_err": max(
                tf_cache_err(cfg, plan, caches["prefill"],
                             ref["prefill_cache"], B, cache_len),
                tf_cache_err(cfg, plan, caches["decode"],
                             ref["decode_cache"], B, cache_len)),
            "tokens": tf_hold_tokens(tokens, ref["logits"])}


def tf_steps(plan, cfg, params, batch, steps: list, cache_len: int,
             seen: Optional[TfBlocks] = None, feed=None) -> dict:
    """A prefill and the decode steps (``steps``: each step's batch but its
    token, which is the greedy one before it, or ``feed[i]``) through
    ``make_prefill_step`` / ``make_decode_step``: the host times, the
    greedy tokens, and, with a capture, the gathered logits and host
    copies of the caches after the prefill and after the last step."""
    from repro_torch.core.tree import tree_map
    from repro_torch.runtime.steps import (gather_logits, make_decode_step,
                                           make_prefill_step)
    dev = plan.device
    B = next(iter(batch.values())).shape[0]
    if "mrope_positions" in batch:
        B = batch["mrope_positions"].shape[1]
    prefill = make_prefill_step(cfg, plan, cache_len)
    decode = make_decode_step(cfg, plan, cache_len)
    gather = lambda t: gather_logits(t, plan, cfg, B)
    out = {"host_ms": [], "logits": []}
    with torch.no_grad():
        if seen is not None:
            seen.next_pass()
        sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill(params, batch)
        sync(dev)
        out["prefill_s"] = time.perf_counter() - t0
        whole = gather(logits)
        tok = torch.argmax(whole[:, -1], -1).to(torch.int32)[:, None]
        toks = [tok.cpu()[:, 0]]
        if seen is not None:
            out["logits"].append(whole.float().cpu())
            out["prefill"] = tree_map(lambda t: t.to("cpu", copy=True),
                                      caches)
        for i, st in enumerate(steps):
            if feed is not None:
                tok = feed[i]
            if seen is not None:
                seen.next_pass()
            sync(dev)
            h0 = time.perf_counter()
            tok, logits, caches = decode(params, caches, dict(st, token=tok))
            sync(dev)
            out["host_ms"].append((time.perf_counter() - h0) * 1e3)
            toks.append(tok.cpu()[:, 0])
            if seen is not None:
                out["logits"].append(gather(logits).float().cpu())
        if seen is not None:
            out["decode"] = tree_map(lambda t: t.cpu(), caches)
    out["tokens"] = toks
    return out


def tf_engine(plan, cfg, params, prompt: torch.Tensor) -> dict:
    """One request of ``prompt`` and ``TP_NEW`` decode steps through the
    lock-step ``InferenceEngine`` (max_batch 1): its tokens, the request's
    wall time and the prefill's (timed inside the engine)."""
    from repro_torch.serving.engine import InferenceEngine, Request
    eng = InferenceEngine(cfg, plan, params, max_batch=1,
                          cache_len=TP_S + TP_NEW + 1)
    lock = eng._lockstep
    inner, spent = lock._prefill, []

    def timed(p, tokens):
        sync(plan.device)
        t0 = time.perf_counter()
        out = inner(p, tokens)
        sync(plan.device)
        spent.append(time.perf_counter() - t0)
        return out
    lock._prefill = timed
    t0 = time.perf_counter()
    with eng:
        res = eng.submit(Request(prompt.cpu().numpy()[0],
                                 max_new_tokens=TP_NEW + 1, id=0)
                         ).result(timeout=600)
    wall = time.perf_counter() - t0
    return {"tokens": list(res.tokens), "reason": res.finish_reason,
            "wall_s": wall, "prefill_s": spent[0], "steps": eng.steps}


def tf_tame(cfg, params) -> None:
    """Every attention's wq, wk and wv in ``params`` (the whole tree or a
    rank's blocks) scaled, in place, to the fan-in of the d_model they
    contract, where the draw takes that of the heads (tests/
    test_torch_tp.py draws them so): scores of order one, not hundreds."""
    n_q = cfg.padded_heads or cfg.n_heads
    for block in list(params["stacks"].values()) + [params.get("shared")]:
        for name in ("attn", "xattn"):
            a = (block or {}).get(name)
            if a is not None:
                a["wq"].mul_(math.sqrt(n_q / cfg.d_model))
                a["wk"].mul_(math.sqrt(cfg.n_kv_heads / cfg.d_model))
                a["wv"].mul_(math.sqrt(cfg.n_kv_heads / cfg.d_model))


def tf_train_config(name: str):
    """``name`` at its :data:`TF_TRAIN_DEPTH`."""
    import dataclasses
    from repro_torch.configs import get
    layers, segments = TF_TRAIN_DEPTH[name]
    return dataclasses.replace(get(name), n_layers=layers,
                               segments_spec=segments or get(name)
                               .segments_spec)


def tf_train(plan, dev, out_dir: str, arch: str, shapes=None) -> dict:
    """12a/12c's training: :func:`train_pair` at ``arch``'s
    :data:`TF_TRAIN_DEPTH`, from the seed-0 draw with :func:`tf_tame`,
    held to the one-device steps of :func:`tf_references` (launches by
    shape where ``shapes`` makes a :class:`TpShapes`)."""
    return train_pair(plan, dev, tf_train_config(arch), torch.load(
        pathlib.Path(out_dir) / f"{arch}_train.pt", mmap=True), tf_tame,
        shapes)


def tf_served(plan, dev, cfg) -> dict:
    """12a/12c's serving: a B1 x S2048 prompt and ``TP_NEW`` decode steps,
    through the lock-step engine (kernels counted there), then
    again through the steps fed the engine's tokens with every block kept,
    and the checks of :func:`tf_serve_check` (the engine's tokens against
    the walk's logits)."""
    from repro_torch.models import params as pp
    from repro_torch.models.lm import LM
    params = pp.init_blocks(LM(cfg).param_defs(),
                            torch.Generator(device=dev).manual_seed(0), plan)
    prompt = tp_prompt(cfg, dev)
    shapes = tf_shapes()
    kernels = zero_launches()
    routes0 = tp_routes()
    try:
        run = tf_engine(plan, cfg, params, prompt)
    finally:
        got_shapes = shapes.undo()
    launches = read_launches(kernels)
    routes = tp_routes_since(routes0)
    cache_len = TP_S + TP_NEW + 1
    steps = [{"pos": tp_pos(t, dev)} for t in range(TP_NEW)]
    seen = TfBlocks()
    try:
        feed = [torch.tensor([[t]], dtype=torch.int32, device=dev)
                for t in run["tokens"]]
        capt = tf_steps(plan, cfg, params, {"tokens": prompt}, steps,
                        cache_len, seen, feed)
    finally:
        seen.undo()
    del params
    gc_cuda()
    out = tf_serve_check(cfg, plan, dev, seen, [
        torch.tensor([t]) for t in run["tokens"]], capt, cache_len, 1)
    out.update(engine=run, launches=launches, shapes=got_shapes,
               by_shape=shapes.counts, routes=routes)
    return out


def tf_llama(plan, dev, out_dir: str) -> dict:
    """12a: Llama-3.2-3B whole (context-parallel attention) served through
    the lock-step engine (:func:`tf_served`), then trained at its
    :data:`TF_TRAIN_DEPTH` (:func:`tf_train`)."""
    from repro_torch.configs import get
    out = tf_served(plan, dev, get("llama3.2-3b"))
    gc_cuda()
    out["train"] = tf_train(plan, dev, out_dir, "llama3.2-3b")
    return out


def tf_xlstm(plan, dev, out_dir: str) -> dict:
    """12c: xLSTM-125m whole, served through the lock-step engine, then
    trained at its :data:`TF_TRAIN_DEPTH`."""
    from repro_torch.configs import get
    from repro_torch.kernels import ssd_scan as ssd_module
    out = tf_served(plan, dev, get("xlstm-125m"))
    gc_cuda()
    out["train"] = tf_train(plan, dev, out_dir, "xlstm-125m", lambda: TpShapes(
        [(ssd_module, "_launch_bwd", "ssd_scan_bwd")]))
    return out


def tf_front(plan, dev, cfg, batch: dict, steps: list, cache_len: int,
             inside=(), shapes=None) -> dict:
    """11c/12b/12d: a prefill and the decode steps through the steps
    (timed; kernels counted, their shapes by ``shapes`` (a
    :class:`TpShapes`, phase 12's by default), and within the ``inside``
    calls of :func:`launches_inside`), then again fed the same tokens with
    every block kept, and :func:`tf_serve_check`."""
    from repro_torch.models import params as pp
    from repro_torch.models.lm import LM
    params = pp.init_blocks(LM(cfg).param_defs(),
                            torch.Generator(device=dev).manual_seed(0), plan)
    shapes = shapes or tf_shapes()
    kernels = zero_launches()
    routes0 = tp_routes()
    try:
        with contextlib.ExitStack() as stack:
            parts = {tag: stack.enter_context(launches_inside(*how))
                     for tag, how in inside}
            run = tf_steps(plan, cfg, params, batch, steps, cache_len)
    finally:
        got_shapes = shapes.undo()
    launches = read_launches(kernels)
    routes = tp_routes_since(routes0)
    seen = TfBlocks()
    try:
        capt = tf_steps(plan, cfg, params, batch, steps, cache_len, seen,
                        [t[:, None].to(dev) for t in run["tokens"]])
    finally:
        seen.undo()
    del params
    gc_cuda()
    B = run["tokens"][0].shape[0]
    out = tf_serve_check(cfg, plan, dev, seen, run["tokens"], capt,
                         cache_len, B)
    out.update(prefill_s=run["prefill_s"], host_ms=run["host_ms"],
               launches=launches, inside={k: v[0] for k, v in parts.items()},
               shapes=got_shapes, by_shape=shapes.counts, routes=routes)
    return out


def tf_qwen(plan, dev, out_dir: str) -> dict:
    """12b: Qwen2-VL-2B whole through the steps: a B1 x S2048 prompt of
    vision-language embeddings with M-RoPE ids (``VLM_TEXT`` text tokens,
    a ``VLM_GRID`` x ``VLM_GRID`` grid, text), then ``TP_NEW`` decode steps
    each with its embedding and the next text id."""
    from repro_torch.configs import get
    cfg = get("qwen2-vl-2b")
    S = TP_S
    g = torch.Generator(device=dev).manual_seed(1)
    embeds = (torch.randn(1, S + TP_NEW, cfg.d_model, generator=g,
                          device=dev) * 0.1).to(torch.bfloat16)
    ids, _ = mrope_ids(1, S + TP_NEW, VLM_TEXT, VLM_GRID, VLM_GRID, dev)
    steps = [{"pos": tp_pos(t, dev), "embeds": embeds[:, S + t:S + t + 1],
              "mrope_positions": ids[:, :, S + t:S + t + 1]}
             for t in range(TP_NEW)]
    return tf_front(plan, dev, cfg, {"embeds": embeds[:, :S],
                                     "mrope_positions": ids[:, :, :S]},
                    steps, TP_S + TP_NEW + 1)


def tf_whisper(plan, dev, out_dir: str) -> dict:
    """12d: Whisper-medium whole through the steps: B8 clips of 1500
    frames and 32-token prompts (the encoder over the frames' sequence
    blocks, its output gathered once for the decoder's cross k/v), then
    ``TP_NEW`` greedy decode steps on the nested cache; the attention's
    launches inside the encoder and inside the cross attention read
    apart."""
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import lm as L
    cfg = get("whisper-medium")
    B = WHISPER_B
    g = torch.Generator(device=dev).manual_seed(2)
    frames = (torch.randn(B, WHISPER_FRAMES, cfg.d_model, generator=g,
                          device=dev) * 0.1).to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (B, WHISPER_PROMPT), generator=g,
                           device=dev, dtype=torch.int32)
    steps = [{"pos": torch.tensor(WHISPER_PROMPT + t, dtype=torch.int32,
                                  device=dev)} for t in range(TP_NEW)]

    def encoder(model, *args, segments=None, **kw):
        return segments is not None and segments[0][0] == "enc"
    return tf_front(plan, dev, cfg, {"frames": frames, "tokens": tokens},
                    steps, WHISPER_CACHE, inside=(
                        ("encoder", (L.LM, "_run_segments", flash_attention,
                                     encoder)),
                        ("cross", (L, "cross_attention", flash_attention))))


def tf_references(dev: torch.device) -> None:
    """The one-device train steps 12a and 12c are held to, written under
    ``TF_DIR``: ``TP_STEPS`` steps of Llama-3.2-3B and xLSTM-125m at their
    :data:`TF_TRAIN_DEPTH` from seed 0 on phase 5c's batches and schedule:
    the losses, the grad norms and host copies of the parameters (the
    seed-0 draw with :func:`tf_tame`)."""
    from repro_torch.core.plan import single_device_plan
    from repro_torch.runtime.steps import init_state, make_train_step
    one = single_device_plan(dev)
    for arch in TF_TRAIN_DEPTH:
        cfg = tf_train_config(arch)
        state = init_state(cfg, one, torch.Generator(device=dev).manual_seed(0))
        tf_tame(cfg, state["params"])
        step = make_train_step(cfg, one, md_schedule())
        losses, norms = [], []
        for b in md_batches(cfg, TP_STEPS):
            state, m = step(state, {"tokens": torch.as_tensor(
                b["tokens"], device=dev)})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        torch.save({"losses": losses, "norms": norms,
                    "params_at": host_params(state["params"])},
                   TF_DIR / f"{arch}_train.pt")
        del state, step
        gc_cuda()


def tf_rank(out_dir: str) -> dict:
    """12a-12d in each of two ranks sharing ``cuda:0`` over gloo, on a
    (data 1, model 2) mesh."""
    from repro_torch.core import spmd
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.launch.mesh import make_mesh
    dev = md_setup()
    plan = ShardingPlan(make_mesh((1, 2), ("data", "model")))
    out = {"backend": spmd.backend(), "rank": spmd.rank()}
    for tag, fn in (("12a", tf_llama), ("12b", tf_qwen), ("12c", tf_xlstm),
                    ("12d", tf_whisper)):
        t0 = time.perf_counter()
        out[tag] = fn(plan, dev, out_dir)
        gc_cuda()
        out[tag]["secs"] = time.perf_counter() - t0
    return out


def phase_tp_families(card: str) -> dict:
    """Phase 12: the one-device train references (:func:`tf_references`),
    then 12a-12d in two spawned ranks sharing ``cuda:0`` over gloo
    (:func:`tf_rank`); fails on any of their checks."""
    from repro_torch.core import spmd
    dev = torch.device("cuda", 0)
    gc_cuda()
    shutil.rmtree(TF_DIR, ignore_errors=True)
    TF_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        tf_references(dev)
        tr = time.perf_counter() - t0
        t1 = time.perf_counter()
        ranks = spmd.launch(tf_rank, 2, str(TF_DIR), timeout_s=900)
        tl = time.perf_counter() - t1
    finally:
        shutil.rmtree(TF_DIR, ignore_errors=True)
    return tf_report(card, ranks, tr, tl)


def tf_serving_line(tag: str, r: int, what: str, x: dict, card: str) -> tuple:
    """Print one serving sub-phase of one rank; its faults."""
    bad = [t for t in x["tokens"] if not t[2]]
    say(f"[tp-families] {tag} rank {r}: {what} on {card}; the steps' blocks "
        f"held to the one-device blocks on their inputs: worst "
        f"{x['walk_err']:.4f} of the scale over {x['walk_blocks']} block "
        f"outputs, the gathered logits {x['logit_err']:.4f}, the cache and "
        f"state blocks {x['cache_err']:.4f} (limit {WALK_TOL}); greedy "
        f"tokens {[t[0] for t in x['tokens']]} against the one-device "
        f"logits' argmax {[t[1] for t in x['tokens']]}; launches "
        f"{x['launches']}; kernel shapes and launches {x['by_shape']}")
    say(f"[tp-families] {tag} rank {r}: the worst block by kind "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            x["walk_by_kind"].items()))
        + " of the scale (a decoder block's sublayers each on the sharded "
        f"block's own input to it) on {card}")
    say(f"[tp-families] {tag} rank {r} collectives (calls, host s): "
        f"{x['routes']}")
    faults = []
    if max(x["walk_err"], x["logit_err"], x["cache_err"]) > WALK_TOL or bad:
        faults.append(f"{tag} rank {r}: off the one-device blocks ({bad})")
    missing = [n for n in TF_KERNELS[tag] if not x["launches"].get(n)]
    if missing:
        faults.append(f"{tag} rank {r}: {missing} did not launch: "
                      f"{x['launches']}")
    return faults


def tf_train_line(tag: str, r: int, what: str, t: dict, card: str,
                  tol: float, fault_must_miss: bool) -> list:
    say(f"[tp-families] {tag} rank {r}: {what}, B2 x S2048: losses "
        f"{t['losses']} against the one-device steps' {t['want']} (within "
        f"{t['loss_err']:.2e} relative, limit {TP_LOSS_RTOL}); grad norms "
        f"{t['norms']} against {t['want_norms']}; worst leaf "
        f"updates against theirs (leaf, L2 error, share of the elements "
        f"whose update differs) {t['worst']} (limit {tol}); "
        f"without the gradient sum over the model axis {t['fault']}; peak "
        f"{t['peak_gb']:.2f} GB; {2 * 2048 / t['dts'][-1]:.1f} train "
        f"tokens/s (the second step, {t['dts'][-1] * 1e3:.1f} ms; the "
        f"first {t['dts'][0] * 1e3:.1f} ms) on {card}")
    faults = []
    if t["loss_err"] > TP_LOSS_RTOL or t["update_err"] > tol:
        faults.append(f"{tag} rank {r}: off the one-device train steps")
    if fault_must_miss and t["fault_err"] <= tol:
        faults.append(f"{tag} rank {r}: the update limit does not see the "
                      f"gradient sum over the model axis removed")
    return faults


def tf_report(card: str, ranks: list, tr: float, tl: float) -> dict:
    """Print 12a-12d from both ranks, then fail on any of their checks;
    the launches by ``kernels`` row, summed over the ranks (each cp rank's
    prefix block under its own row)."""
    faults, launches = [], {}

    def add(row, n):
        launches[row] = launches.get(row, 0) + n
    for r, res in enumerate(ranks):
        a, b, c, d = res["12a"], res["12b"], res["12c"], res["12d"]
        for tag, x, name in (("12a", a, "Llama-3.2-3B whole (cp)"),
                             ("12c", c, "xLSTM-125m whole")):
            e = x["engine"]
            steps = max(e["steps"], 1)
            faults += tf_serving_line(
                tag, r, f"{name}, the lock-step engine: B1 x S2048 prompt "
                f"and {TP_NEW} decode steps in {e['wall_s'] * 1e3:.1f} ms "
                f"(prefill {e['prefill_s'] * 1e3:.1f} ms, "
                f"{TP_S / e['prefill_s']:.0f} tokens/s; then "
                f"{(e['wall_s'] - e['prefill_s']) / steps * 1e3:.2f} ms a "
                f"decode step over {e['steps']} steps; {e['reason']})", x,
                card)
            if len(e["tokens"]) != TP_NEW + 1:
                faults.append(f"{tag} rank {r}: the engine gave "
                              f"{len(e['tokens'])} tokens")
        faults += tf_train_line("12a", r, f"Llama-3.2-3B at "
                                f"{TF_TRAIN_DEPTH['llama3.2-3b'][0]} of 28 "
                                f"layers", a["train"], card, TF_UPDATE_TOL,
                                True)
        faults += tf_train_line("12c", r, f"xLSTM-125m at "
                                f"{TF_TRAIN_DEPTH['xlstm-125m'][0]} of 12 "
                                f"blocks", c["train"], card, TP_UPDATE_TOL,
                                False)
        # the mLSTM's two backward calls a layer, numerator and normaliser,
        # each under its own row by v's P
        bwd = {}
        for key, k in c["train"]["by_shape"].get("ssd_scan_bwd", {}).items():
            row = tf_row("12c", "ssd_scan_bwd", key)
            bwd[row] = bwd.get(row, 0) + k
        for row in ("ssd_scan_bwd_tp_xlstm", "ssd_scan_bwd_tp_xlstm_p1"):
            if not bwd.get(row):
                faults.append(f"12c rank {r}: {row} never launched in "
                              f"training")
            add(row, bwd.get(row, 0))
        for tag, x, what in (
                ("12b", b, "Qwen2-VL-2B whole through the steps, B1 x S2048 "
                 f"embeddings with M-RoPE ids over a {VLM_GRID} x "
                 f"{VLM_GRID} grid"),
                ("12d", d, f"Whisper-medium whole through the steps, "
                 f"B{WHISPER_B} x {WHISPER_FRAMES} frames and "
                 f"{WHISPER_PROMPT}-token prompts")):
            rate = (f"{WHISPER_B * WHISPER_FRAMES / x['prefill_s']:.1f} "
                    f"encoder frames/s" if tag == "12d" else
                    f"{TP_S / x['prefill_s']:.0f} tokens/s")
            faults += tf_serving_line(
                tag, r, f"{what}: prefill {x['prefill_s'] * 1e3:.1f} ms "
                f"({rate}), {TP_NEW} decode steps host median "
                f"{sorted(x['host_ms'])[TP_NEW // 2]:.2f} ms "
                f"({min(x['host_ms']):.2f}-{max(x['host_ms']):.2f}); "
                f"launches inside {x['inside']}", x, card)
        for tag, x in (("12a", a), ("12b", b), ("12c", c), ("12d", d)):
            for n, by in x["by_shape"].items():
                for key, k in by.items():
                    row = tf_row(tag, n, key)
                    if row:
                        add(row, k)
        say(f"[tp-families] rank {r}: 12a {a['secs']:.1f} s, 12b "
            f"{b['secs']:.1f} s, 12c {c['secs']:.1f} s, 12d "
            f"{d['secs']:.1f} s")
    say(f"[tp-families] phase 12: references {tr:.1f} s, ranks {tl:.1f} s "
        f"on {card}; launches by row {launches}")
    if faults:
        fail("; ".join(faults))
    return {"launches": launches}


def tf_row(tag: str, kernel: str, key: tuple):
    """The ``kernels`` row a launch at ``key`` (the wrapper's argument
    shapes) of phase 12 counts under: the cp ranks' prefix blocks apart,
    Whisper's encoder, cross attention at prefill and decode and decoder
    self-attention, the mLSTM's two scans and their backward calls, every
    gelu of 12d."""
    if kernel == "gelu_stepwise":
        return "gelu_stepwise_tp"
    if kernel in ("ssd_scan", "ssd_scan_bwd"):
        return kernel + "_tp_xlstm" + ("_p1" if key[2][-1] == 1 else "")
    (B, H, Sq, D), (_, Hkv, Sk, _) = key[0], key[1]
    if tag in ("12a", "12b"):
        model = "llama" if tag == "12a" else "qwen"
        return f"flash_attention_cp_{model}_r{0 if Sk == Sq else 1}"
    if Sk == WHISPER_FRAMES:
        return {WHISPER_FRAMES: "flash_attention_tp_encoder",
                WHISPER_PROMPT: "flash_attention_tp_cross_prefill",
                1: "flash_attention_tp_cross_decode"}[Sq]
    return "flash_attention_tp_dec_self"


def tp_families_rows(dev: torch.device, card: str, errs: dict) -> list:
    """Phase 12 and its kernels' rows at a rank's shapes, the launches
    summed over the ranks: the cp prefix blocks of Llama-3.2-3B (H24/Hkv8
    D128) and Qwen2-VL (H12/2), rank 0's Sq 1024 against Sk 1024, rank 1's
    against Sk 2048; Whisper's at 8 of 16 heads (the encoder over 1500
    frames, the cross attention at Sq 32 and 1 against them, the decoder's
    causal 32); the mLSTM's ``ssd_scan`` and its backward kernel on 2 of 4
    heads (P 384 and 1);
    the gelu over a rank's 2048 of Whisper's 4096 channels."""
    t0 = time.perf_counter()
    n = phase_tp_families(card)["launches"]
    g = torch.Generator().manual_seed(14)
    S = TP_S
    rows = []
    for model, H, Hkv in (("llama", 24, 8), ("qwen", 12, 2)):
        for r, sk in ((0, S // 2), (1, S)):
            name = f"flash_attention_cp_{model}_r{r}"
            rows.append(time_flash(dev, g, name, (1, H, Hkv, sk, 128, 0),
                                   n.get(name, 0), errs[name], card,
                                   sq=S // 2))
    for name, sq, causal, sk in (
            ("flash_attention_tp_encoder", None, False, WHISPER_FRAMES),
            ("flash_attention_tp_cross_prefill", WHISPER_PROMPT, False,
             WHISPER_FRAMES),
            ("flash_attention_tp_cross_decode", 1, False, WHISPER_FRAMES),
            ("flash_attention_tp_dec_self", None, True, WHISPER_PROMPT)):
        rows.append(time_flash(dev, g, name, (WHISPER_B, 8, 8, sk, 64, 0),
                               n.get(name, 0), errs[name], card, sq=sq,
                               causal=causal))
    for name, P in (("ssd_scan_tp_xlstm", 384), ("ssd_scan_tp_xlstm_p1", 1)):
        rows.append(time_ssd(dev, name, 1, n.get(name, 0), errs[name], card,
                             H=2, G=2, N=384, P=P))
        bwd = name.replace("ssd_scan", "ssd_scan_bwd")
        rows.append(time_ssd_bwd(dev, bwd, 1, n.get(bwd, 0), errs[bwd], card,
                                 H=2, G=2, N=384, P=P))
    rows.append(time_stepwise(dev, g, "gelu", "gelu_stepwise_tp",
                              (WHISPER_B, WHISPER_FRAMES, 2048),
                              n.get("gelu_stepwise_tp", 0),
                              errs["gelu_stepwise_tp"], card))
    say(f"[tp-families] phase 12 with its kernels' rows "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    return rows


# ---------------------------------------------------------------------------
# phase 13: the dry run held to the card's own step
# ---------------------------------------------------------------------------
DRY_PEAK_TOL = 0.02              # the traced peak against the card's
DRY_DECODE_POS = 2048            # the decode step's position in its cache
DRY_STEPS = 3                    # timed steps of a cell, after one


def dry_cells() -> list:
    """(tag, config, mode, batch, seq): phase 5c's two training cells, and
    phase 5's Mixtral at 4 layers through one prefill and one decode step
    at the engine's batch against its cache (``seq`` the cache's length)."""
    (z, zb, zs), (m, mb, ms) = train_configs()[:2]
    return [("zamba2-1.2b train", z, "train", zb, zs),
            ("mixtral-8x7b 1L train", m, "train", mb, ms),
            ("mixtral-8x7b 4L prefill", serve_config(), "prefill", 1, 2048),
            ("mixtral-8x7b 4L decode", serve_config(), "decode",
             SERVE_BATCH, SERVE_CACHE)]


def dry_real_args(cfg, mode: str, B: int, S: int, plan, params=None):
    """(step, args) on the card, shaped as ``dry_step`` shapes them: the
    train state of ``init_state``, or the parameters (``params`` when
    given) and, for decode, zero caches of ``cache_specs``; tokens from a
    seed."""
    from repro_torch.configs import cache_specs
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.dryrun import LR
    from repro_torch.models.lm import LM
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.steps import (init_state, make_decode_step,
                                           make_prefill_step, make_train_step)
    dev = plan.device
    gen = torch.Generator(device=dev).manual_seed(0)
    tok = lambda *shape: torch.randint(0, cfg.vocab, shape, generator=gen,
                                       device=dev, dtype=torch.int32)
    if mode == "train":
        opt = make_optimizer(cfg.optimizer)
        return (make_train_step(cfg, plan, LR, opt),
                (init_state(cfg, plan, gen, opt), {"tokens": tok(B, S)}))
    params = params if params is not None else LM(cfg).init(gen)
    if mode == "prefill":
        return (make_prefill_step(cfg, plan, cache_len=S),
                (params, {"tokens": tok(B, S)}))
    caches = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                            device=dev),
                      cache_specs(cfg, B, S))
    pos = torch.tensor(DRY_DECODE_POS, dtype=torch.int32, device=dev)
    return (make_decode_step(cfg, plan, cache_len=S),
            (params, caches, {"token": tok(B, 1), "pos": pos}))


def dry_traces() -> tuple:
    """Phase 13's traces: ``dry_step`` of every cell on fake ``cuda:0``
    tensors of a one-card plan.  Returns ``({tag: trace}, seconds)``."""
    import importlib
    from repro_torch.core.plan import single_device_plan
    from repro_torch.launch.dryrun import dry_step
    importlib.import_module("torch._dynamo")   # the first checkpoint's
    t0 = time.perf_counter()
    plan = single_device_plan()
    res = {tag: dry_step(cfg, mode, B, S, plan)
           for tag, cfg, mode, B, S in dry_cells()}
    return res, time.perf_counter() - t0


def _dry_traces_into(out) -> None:
    try:
        out.put(dry_traces())
    except Exception:                         # noqa: BLE001 - sent back
        import traceback
        out.put((None, traceback.format_exc()))


def start_dry_traces():
    """Start :func:`dry_traces` in a spawned process, beside phases 1-2
    (the build and the kernels' checks time nothing), so the traces take
    no timed phase's host and the script's process never holds a fake
    tensor."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_dry_traces_into, args=(out,), daemon=True)
    proc.start()
    return proc, out


def finish_dry_traces(handle, timeout_s: float = 600.0) -> tuple:
    """The traces' results and seconds, the process stopped; a trace that
    failed fails the run."""
    import queue
    proc, out = handle
    t0 = time.perf_counter()
    try:
        res, secs = out.get(timeout=timeout_s)
    except queue.Empty:
        res, secs = None, f"no result in {timeout_s} s"
    finally:
        proc.join(30)
        if proc.is_alive():
            proc.terminate()
            proc.join(10)
    if res is None:
        fail(f"dry run traces failed:\n{secs}")
    say(f"[dry-run] the traces (dry_step on fake cuda:0 tensors, their own "
        f"process beside phases 1-2): {secs:.1f} s; waited "
        f"{time.perf_counter() - t0:.1f} s for them")
    return res, secs


def dry_cell(plan, tag: str, cfg, mode: str, B: int, S: int, dry: dict,
             card: str, params=None) -> dict:
    """One cell of phase 13: the card's step beside its trace ``dry``.
    One step first (the first call's one-off allocations and
    initialisation), then ``DRY_STEPS`` timed steps: the first of them
    gives the launches and the peak, their median the step time."""
    import dataclasses
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.dryrun import roofline_of
    dev = plan.device
    gc_cuda()
    step, args = dry_real_args(dataclasses.replace(cfg), mode, B, S, plan,
                               params)
    step(*args)
    sync(dev)
    # what the card holds besides the step's arguments (they count, as the
    # trace counts them)
    base = torch.cuda.memory_allocated(dev) - sum(
        t.untyped_storage().nbytes() for t in
        {id(t.untyped_storage()): t for t in tree_leaves(args)
         if isinstance(t, torch.Tensor)}.values())
    kernels = zero_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(DRY_STEPS):
        t0 = time.perf_counter()
        out = step(*args)
        sync(dev)
        times.append(time.perf_counter() - t0)
        del out
        if i == 0:
            peak = torch.cuda.max_memory_allocated(dev) - base
            card_launches = read_launches(kernels)
    secs = statistics.median(times)
    n = cfg.n_params_active()
    tokens = B * S if mode != "decode" else B
    terms = roofline_of(dry, 1, (6.0 if mode == "train" else 2.0) * n
                        * tokens)
    want = nonzero(expected_launches(cfg, {"train": 2, "prefill": 1}.get(
        mode, 0), int(mode == "decode"), int(mode == "train")))
    pred = dry["mem"]["peak_bytes"]
    off = pred / peak - 1
    say(f"[dry-run] {tag} on {card}: roofline (H100 SXM data sheet) "
        f"compute {terms.compute_s * 1e3:.3f} ms, memory "
        f"{terms.memory_s * 1e3:.3f} ms, collective "
        f"{terms.collective_s * 1e3:.3f} ms, dominant {terms.dominant}; "
        f"{dry['flops']:.6g} FLOP ({dry['flops_kernels']:.6g} in kernels), "
        f"{dry['bytes']:.6g} B ({dry['bytes_kernels']:.6g} in kernels); "
        f"measured step {secs * 1e3:.1f} ms (median of {DRY_STEPS} after "
        f"one; the first {times[0] * 1e3:.1f} ms) (the roofline "
        f"{terms.step_time_s / secs:.1%} of it); peak traced "
        f"{pred / 1e9:.3f} GB, measured {peak / 1e9:.3f} GB ({off:+.1%}; "
        f"arguments {dry['mem']['argument_bytes'] / 1e9:.3f} GB); launches "
        f"traced {dry['kernel_launches']}, card {card_launches}, expected "
        f"{want}; traced in {dry['trace_s']:.1f} s")
    if not dry["kernel_launches"] == card_launches == want:
        fail(f"dry run {tag}: launches traced {dry['kernel_launches']}, on "
             f"the card {card_launches}, expected {want}")
    if terms.step_time_s > secs:
        fail(f"dry run {tag}: the roofline's step {terms.step_time_s:.4f} s "
             f"exceeds the measured {secs:.4f} s: the count is wrong")
    if abs(off) > DRY_PEAK_TOL:
        fail(f"dry run {tag}: traced peak {pred / 1e9:.3f} GB against "
             f"{peak / 1e9:.3f} GB measured ({off:+.1%})")
    return {"step_s": secs, "roofline_s": terms.step_time_s, "peak": peak,
            "traced_peak": pred, "launches": card_launches,
            "trace_s": dry["trace_s"],
            "params": args[0] if mode == "prefill" else None}


def phase_dry_run(card: str, traces=None) -> dict:
    """Phase 13 (see the module's docstring).  ``traces`` are
    :func:`dry_traces`' results, taken beside phases 1-2; without them the
    traces run here."""
    from repro_torch.core.plan import single_device_plan
    t0 = time.perf_counter()
    if traces is None:
        traces = dry_traces()
        say(f"[dry-run] the traces (dry_step on fake cuda:0 tensors, here):"
            f" {traces[1]:.1f} s")
    dry = traces[0]
    plan = single_device_plan()
    out, params = {}, None
    for tag, cfg, mode, B, S in dry_cells():
        out[tag] = dry_cell(plan, tag, cfg, mode, B, S, dry[tag], card,
                            params)
        params = out[tag].pop("params")       # the prefill's, for decode
    gc_cuda()
    say(f"[dry-run] phase 13 {time.perf_counter() - t0:.1f} s on {card}")
    return out


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
    laps = [t0]

    def lap(phases: str) -> None:
        laps.append(time.perf_counter())
        say(f"[phases] {phases} {laps[-1] - laps[-2]:.1f} s")
    traces = start_dry_traces()
    card = phase_card()
    kernels = phase_kernels(dev)
    traces = finish_dry_traces(traces)
    lap("1-2")
    main = phase_main_path(dev)
    main["kernels"] = kernels
    hyb = phase_hybrid(main)
    lap("3-4")
    from repro_torch.core.plan import single_device_plan
    cfg = serve_config()
    serve = phase_serve(single_device_plan(), cfg, serve_prompts(cfg.vocab))
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.configs import get
    hcfg = get("zamba2-1.2b")                # full width, full depth
    hybrid = phase_serve(single_device_plan(), hcfg,
                         serve_prompts(hcfg.vocab))
    lap("5-5b")
    train = phase_train_all(dev)
    lap("5c")
    gc.collect()
    torch.cuda.empty_cache()
    fams = phase_families(single_device_plan())
    fronts = phase_front_ends(single_device_plan())
    lap("5d-5e")
    errs = kernels["max_abs_err"]
    rows = phase_times(dev, main, card["card"])
    rows += time_serving_kernels(dev, serve, hybrid, errs, card["card"])
    rows.append(time_ssd(dev, "ssd_scan", 1, hybrid["launches"]["ssd_scan"],
                         errs["ssd_scan"], card["card"]))
    rows += time_train_kernels(dev, train, errs, card["card"])
    rows += time_family_kernels(dev, fams, errs, card["card"])
    rows += time_front_end_kernels(dev, fronts, errs, card["card"])
    time_routes(dev, card["card"])
    lap("6")
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
    rows += multi_device_rows(dev, card["card"], errs, rows,
                              train[train_configs()[1][0].name], main, hyb)
    rows += tensor_parallel_rows(dev, card["card"], errs,
                                 train[train_configs()[1][0].name])
    rows += tp_families_rows(dev, card["card"], errs)
    phase_dry_run(card["card"], traces)
    say(f"[done] {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(card["card"])
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
