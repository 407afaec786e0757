"""The dry run: every (architecture x input shape x mesh) cell's step,
traced rank by rank on fake tensors, against the H100 roofline.

Counterpart of ``src/repro/launch/dryrun.py``, with its CLI and its JSON.
The reference compiles each cell with ``jax.jit(...).lower(...).compile()``
over ``ShapeDtypeStruct`` stand-ins, reads memory, FLOPs and bytes from
XLA, parses the collectives out of the HLO text and corrects for ``while``
bodies counted once with per-layer probe programs (its ``dryrun.py:87-190``
and ``:268-337``).  Eager PyTorch has no compiled program to read; the port
runs its *own* step once instead, on fake tensors (a shape, a type and a
device, nothing allocated), as one rank of the production world:

* **the world** — one process joins torch's ``fake`` process group as rank
  ``--rank`` of 256 (16 x 16) or 512 (2 x 16 x 16) (``spmd.init_fake``),
  so ``make_production_mesh`` is live and every group, coordinate and
  collective takes its real code path; a collective moves nothing;
* **the state** — this rank's block of every leaf of ``state_structs``
  (training) or of the parameters' ``shape_structs`` and
  ``configs.cache_specs`` (serving), at its ``TorchSharding``'s local
  shape; the batch from ``configs.batch_specs``, at its global shape (the
  steps take the global batch on every rank);
* **the step** — ``make_train_step`` / ``make_prefill_step`` /
  ``make_decode_step`` run once under ``launch/hlo_analysis.py``'s
  recorders.  Eager unrolls every layer and microbatch, and the backward's
  activation-checkpoint recompute runs and is counted (as XLA's remat is),
  so each op is seen exactly as often as it runs: no probes, no loop
  correction;
* **the kernels** — the CUDA path by default: each hand-written kernel's
  wrapper, given a fake CUDA tensor, launches nothing and hands the
  recorder the launch it stands in for and its ``work()``
  (``kernels/backend.py``).  A torch built without
  CUDA has no device for autograd to take a fake CUDA tensor's gradient
  on; there the trace runs on fake CPU tensors inside
  ``backend.fake_cuda()``, which take the same branch.  ``--device cpu``
  traces the plain path (the tests hold it to real CPU ranks);
* **the roofline** — ``perf_model.roofline`` on the H100 SXM: FLOPs over
  the bf16 peak, bytes over HBM, and the collectives' link bytes over
  NVLink inside a node of 8 cards and over the network (InfiniBand, 50
  GB/s a card) for a group whose ranks span nodes; the peak of live
  storage against the card's 80 GB.

``dry_step`` is the cell-independent core: ``run_cell``, the tests and
``chip_smoke.py``'s phase 13 (which holds it to the card's own step) call
it.  Results go to ``results/dryrun_torch/``, one JSON per cell,
resumable; the reference's ``results/dryrun/`` is never written.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
  python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape prefill_32k --rank 15
  python -m repro_torch.launch.dryrun --all            # resumable sweep
  python -m repro_torch.launch.dryrun --all --multi-pod
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import pathlib
import time
import traceback
from typing import Any, Optional

import torch

from ..configs import ASSIGNED, SHAPES, batch_specs, cache_specs, get
from ..core import spmd
from ..core.perf_model import H100_SXM, roofline
from ..core.plan import ShardingPlan
from ..core.tree import tree_map
from ..kernels import backend
from ..models import params as pp
from ..models.lm import LM
from ..optim import make_optimizer
from ..optim.schedules import cosine_warmup
from ..runtime.steps import (make_decode_step, make_prefill_step,
                             make_train_step, state_structs)
from .hlo_analysis import StepAnalysis, count_kinds, total_link_bytes
from .mesh import make_production_mesh

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" \
    / "dryrun_torch"
# a shape cell of each mode, for batch_specs at a batch and length of one's
# own
MODE_SHAPE = {"train": "train_4k", "prefill": "prefill_32k",
              "decode": "decode_32k"}
LR = cosine_warmup(3e-4, 100, 10000)     # the reference dry run's schedule


# ---------------------------------------------------------------------------
# the world and the fake state
# ---------------------------------------------------------------------------
def trace_device(device: str = "cuda") -> torch.device:
    """The fake tensors' device: ``cuda:0`` where torch has a CUDA device,
    else the CPU (the CUDA path is then taken inside
    ``backend.fake_cuda``); the CPU for ``device="cpu"``."""
    if device == "cuda" and torch.cuda.is_available():
        return torch.device("cuda", 0)
    return torch.device("cpu")


@contextlib.contextmanager
def fake_world(rank: int, world: int, device: torch.device):
    """Inside, this process is ``rank`` of a fake ``world``."""
    spmd.init_fake(rank, world, device)
    try:
        yield
    finally:
        spmd.finish()


def _sharded(plan) -> bool:
    return getattr(plan.mesh, "live", False)


def _local(structs, device: torch.device, whole: bool = False):
    """A fake tensor for every meta leaf of ``structs``, at the local shape
    of its ``sharding`` (the whole shape without one, or with ``whole``);
    inside a ``FakeTensorMode``."""
    def leaf(t):
        sh = None if whole else getattr(t, "sharding", None)
        shape = sh.local_shape(t.shape) if sh is not None else t.shape
        return torch.empty(shape, dtype=t.dtype, device=device)
    return tree_map(leaf, structs)


def _params(cfg, plan, device):
    specs = plan if _sharded(plan) else None
    return _local(pp.shape_structs(LM(cfg).param_defs(), specs), device)


def _train_state(cfg, plan, device, opt):
    if _sharded(plan):
        return _local(state_structs(cfg, plan, opt), device)
    params = _params(cfg, plan, device)       # as init_state builds it
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def dry_step(cfg, mode: str, batch: int, seq: int, plan,
             cuda_path: Optional[bool] = None) -> dict:
    """Run ``mode``'s step (``train``, ``prefill`` or ``decode`` against a
    cache of ``seq``) once on fake tensors: this rank's state on
    ``plan``'s device (one device, or a live mesh of a fake world), the
    global batch of ``batch`` x ``seq``.  ``cuda_path`` (default: the
    plan's device is CUDA) takes the kernels' CUDA path on fake CPU
    tensors.  Returns the step's FLOPs and bytes (aten ops and kernels
    apart), its collectives in order, each kernel's launches and work,
    and its memory: the state's and the batch's bytes and the peak of
    live storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    # the first activation checkpoint imports torch._dynamo: paid here,
    # once a process, and not traced (its import makes tensors)
    import torch._dynamo  # noqa: F401
    device = plan.device
    if cuda_path is None:
        cuda_path = device.type == "cuda"
    opt = make_optimizer(cfg.optimizer)
    stat = StepAnalysis(cuda_temps=cuda_path)
    specs = plan if _sharded(plan) else None
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(FakeTensorMode(allow_non_fake_inputs=True))
        if cuda_path and device.type == "cpu":
            stack.enter_context(backend.fake_cuda())
        inputs = _local(batch_specs(cfg, MODE_SHAPE[mode], specs,
                                    batch=batch, seq=seq), device, whole=True)
        if mode == "train":
            state = _train_state(cfg, plan, device, opt)
            step = make_train_step(cfg, plan, LR, opt)
            args = (state, inputs)
        else:
            state = {"params": _params(cfg, plan, device)}
            if mode == "prefill":
                step = make_prefill_step(cfg, plan, cache_len=seq)
                args = (state["params"], inputs)
            else:
                state["caches"] = _local(cache_specs(cfg, batch, seq, specs),
                                         device)
                step = make_decode_step(cfg, plan, cache_len=seq)
                args = (state["params"], state["caches"], inputs)
        state_bytes = stat.hold(state)
        batch_bytes = stat.hold(inputs)
        with stat.recording():
            out = step(*args)
        del out, args, state, inputs
    trace_s = time.perf_counter() - t0
    # on the plain path the kernels' work ran as aten ops, counted there
    k_flops, k_bytes = stat.kernel_totals() if cuda_path else (0, 0)
    return {
        "flops_aten": stat.flops, "flops_kernels": k_flops,
        "flops": stat.flops + k_flops,
        "bytes_aten": stat.bytes, "bytes_kernels": k_bytes,
        "bytes": stat.bytes + k_bytes,
        "flops_by_op": dict(stat.flops_by_op),
        "bytes_by_op": dict(stat.bytes_by_op),
        "collectives": stat.collectives,
        "kernel_launches": dict(stat.launches),
        "kernel_work": stat.kernels,
        "mem": {"state_bytes": state_bytes, "batch_bytes": batch_bytes,
                "argument_bytes": state_bytes + batch_bytes,
                "peak_bytes": stat.peak},
        "trace_s": trace_s,
    }


def roofline_of(step: dict, n_cards: int, model_flops: float = 0.0):
    """The H100 roofline of a rank's step, as the reference prices a cell:
    the rank's FLOPs and bytes times the cards, its link bytes a card."""
    nvlink, net = total_link_bytes(step["collectives"])
    return roofline(step["flops"] * n_cards, step["bytes"] * n_cards,
                    nvlink, n_cards, coll_bytes_net_per_card=net,
                    model_flops=model_flops)


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------
def cp_ranks(cfg) -> tuple:
    """The ranks a cell is traced at: rank 0, and for context-parallel
    attention also the model axis's last rank (its prefix block does the
    most work)."""
    return (0, 15) if cfg.attn_parallel == "cp" else (0,)


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             plan_overrides=None, tag: str = "", verbose: bool = True,
             cfg_overrides=None, rank: int = 0, device: str = "cuda"
             ) -> dict:
    cfg = get(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    sh = SHAPES[shape]
    mode = sh["mode"]
    if not cfg.supports(shape):
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "skipped": True, "reason": cfg.skip_reason(shape)}
    n_dev = 512 if multi_pod else 256
    B, S = sh["batch"], sh["seq"]
    result = {"arch": arch, "shape": shape, "mesh": "2x16x16" if multi_pod
              else "16x16", "multi_pod": multi_pod, "mode": mode, "tag": tag,
              "batch": B, "seq": S, "chips": n_dev, "rank": rank,
              "device": device, "hardware": H100_SXM.name}
    t_start = time.time()
    dev = trace_device(device)
    try:
        with fake_world(rank, n_dev, dev):
            plan = ShardingPlan(mesh=make_production_mesh(
                multi_pod=multi_pod))
            for k, v in (plan_overrides or {}).items():
                setattr(plan, k, v)
            result["coords"] = {a: plan.mesh.coord(a)
                                for a in plan.mesh.axis_names}
            step = dry_step(cfg, mode, B, S, plan,
                            cuda_path=device == "cuda")
    except Exception as e:  # noqa: BLE001 - the cell's result records it
        result["ok"] = False
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-3000:]
        return result

    colls = step["collectives"]
    nvlink, net = total_link_bytes(colls)
    mem = step.pop("mem")
    result.update({
        "trace_s": round(step.pop("trace_s"), 2),
        "mem": {"state_gib": mem["state_bytes"] / 2**30,
                "batch_gib": mem["batch_bytes"] / 2**30,
                "argument_gib": mem["argument_bytes"] / 2**30,
                "peak_gib": mem["peak_bytes"] / 2**30},
        "flops_per_dev": step["flops"], "bytes_per_dev": step["bytes"],
        "flops_aten": step["flops_aten"],
        "flops_kernels": step["flops_kernels"],
        "bytes_aten": step["bytes_aten"],
        "bytes_kernels": step["bytes_kernels"],
        "collectives": count_kinds(colls),
        "coll_nvlink_per_dev": nvlink, "coll_net_per_dev": net,
        "coll_net_calls": sum(c["net"] for c in colls),
        "top_collectives": sorted(colls, key=lambda c: -c["link_bytes"])[:8],
        "kernel_launches": step["kernel_launches"],
        "kernel_work": step["kernel_work"],
        "flops_by_op": step["flops_by_op"], "bytes_by_op": step["bytes_by_op"],
    })
    mf = cfg.model_flops(shape)
    terms = roofline_of(step, n_dev, mf)
    result["roofline"] = {
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "dominant": terms.dominant,
        "step_time_s": terms.step_time_s,
        "model_flops": mf, "model_flops_s": terms.model_flops_s,
        "useful_flops_ratio": mf / max(step["flops"] * n_dev, 1.0),
        "roofline_fraction": terms.roofline_fraction,
    }
    result["fits_hbm"] = mem["peak_bytes"] <= H100_SXM.hbm_bytes
    result["ok"] = True   # the trace is the dry run's gate; HBM noted
    result["wall_s"] = round(time.time() - t_start, 1)
    if verbose:
        r = result["roofline"]
        print(f"[{arch} x {shape} x {result['mesh']} r{rank}{tag}] ok "
              f"trace={result['trace_s']}s "
              f"peak={result['mem']['peak_gib']:.2f}GiB "
              f"terms(c/m/n)={r['compute_s']:.4f}/{r['memory_s']:.4f}/"
              f"{r['collective_s']:.4f}s dom={r['dominant']} "
              f"frac={r['roofline_fraction']:.3f}", flush=True)
    return result


def cell_path(arch, shape, multi_pod, tag="", rank: int = 0):
    m = "mp" if multi_pod else "sp"
    t = f"__{tag}" if tag else ""
    r = f"__r{rank}" if rank else ""
    return RESULTS_DIR / f"{arch}__{shape}__{m}{r}{t}.json"


def _value(v: str) -> Any:
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--seq-parallel", dest="sp", default=None,
                    choices=["on", "off"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    metavar="key=value",
                    help="Config override, e.g. --set n_microbatches=8")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank traced (default 0)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the kernels' path (default); cpu: the "
                         "plain path")
    args = ap.parse_args(argv)
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)

    overrides = {}
    if args.sp == "off":
        overrides["sequence_parallel"] = False
    if args.no_fsdp:
        overrides["fsdp_params"] = False
    cfg_overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        cfg_overrides[k] = _value(v)

    if args.all:
        cells = [(a, s, mp, r) for a in ASSIGNED for s in SHAPES
                 for mp in ((True,) if args.multi_pod else (False, True))
                 for r in cp_ranks(get(a))]
        # single-pod first (roofline table), then multi-pod
        cells.sort(key=lambda c: (c[2], c[0], c[1], c[3]))
        t0 = time.time()
        for a, s, mp, r in cells:
            p = cell_path(a, s, mp, args.tag, r)
            if p.exists() and not args.force:
                continue
            res = run_cell(a, s, mp, plan_overrides=overrides, tag=args.tag,
                           cfg_overrides=cfg_overrides, rank=r,
                           device=args.device)
            p.write_text(json.dumps(res, indent=1, default=str))
            gc.collect()
        print(f"[sweep] {len(cells)} cells in {time.time() - t0:.1f} s",
              flush=True)
        return

    res = run_cell(args.arch, args.shape, args.multi_pod,
                   plan_overrides=overrides, tag=args.tag,
                   cfg_overrides=cfg_overrides, rank=args.rank,
                   device=args.device)
    p = cell_path(args.arch, args.shape, args.multi_pod, args.tag, args.rank)
    p.write_text(json.dumps(res, indent=1, default=str))
    if not res.get("ok", False) and not res.get("skipped"):
        print(res.get("error"))
        print(res.get("traceback", "")[-2000:])
        raise SystemExit(1)


if __name__ == "__main__":
    main()
