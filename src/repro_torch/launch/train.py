"""Training launcher: the whole-stack driver behind ``--arch``, on the GPU
unless ``--device`` names another device.

Port of ``src/repro/launch/train.py``.  A config other than ``ff-tiny``
runs reduced, as the reference launcher runs it; full width is reached
through the library (``chip_smoke.py`` trains Zamba2-1.2B whole).  Weights
are random, drawn on the device from seed 0.  ``--tuned`` re-execs once
with tcmalloc preloaded (where installed) and one intra-op thread
(``launch/tuned.py``); ``--adaptive`` attaches the runtime Supervisor to
the data pipeline and prints its re-placement events.

Under ``torchrun`` with ``WORLD_SIZE > 1`` every process is one rank of a
``(data=world, model=1)`` mesh and the step is data-parallel with FSDP
(``ShardingPlan(make_host_mesh(data=world))``, as the reference builds it
over more than one device): each rank feeds the same global batch and
keeps its shards of the state; NCCL across GPUs, gloo on the CPU or when
the ranks share a GPU.  Each rank checkpoints its own shards under
``<ckpt-dir>/rank<r>``; rank 0 prints.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch zamba2-1.2b --steps 4 --batch 2 --seq 32
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --device cpu --steps 4 --batch 4 --seq 32
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ..configs import get
from ..core import spmd
from ..core.plan import ShardingPlan, single_device_plan
from ..core.tree import tree_leaves
from ..data import SyntheticLMSource, make_pipeline
from ..optim.schedules import cosine_warmup
from ..runtime.driver import DriverConfig, TrainDriver
from ..runtime.steps import init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="ff-tiny")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized reduction of the arch")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive data pipeline: a runtime Supervisor "
                         "re-places eligible farm stages live and feeds "
                         "observed costs back into the calibration cache")
    ap.add_argument("--tuned", action="store_true",
                    help="tuned host runtime: tcmalloc LD_PRELOAD when "
                         "installed, one OpenMP/MKL thread a process "
                         "(re-execs once; see repro_torch.launch.tuned)")
    args = ap.parse_args(argv)
    if args.tuned:
        from .tuned import apply_tuned
        apply_tuned()

    cfg = get(args.arch)
    if args.reduced or args.arch != "ff-tiny":
        cfg = cfg.reduced()
    n_ranks = int(os.environ.get("WORLD_SIZE", "1"))
    if n_ranks > 1:
        from .mesh import make_host_mesh
        spmd.init_from_env(args.device)
        plan = ShardingPlan(make_host_mesh(data=n_ranks))
        args.ckpt_dir = os.path.join(args.ckpt_dir, f"rank{spmd.rank()}")
    else:
        plan = single_device_plan(args.device)
    try:
        return _train(args, cfg, plan, n_ranks)
    finally:
        if n_ranks > 1:
            spmd.finish()


def _train(args, cfg, plan, n_ranks: int) -> int:
    say = print if spmd.rank() == 0 else (lambda *a, **k: None)
    state = init_state(cfg, plan,
                       torch.Generator(device=plan.device).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    say(f"arch={cfg.name} params={n_params/1e6:.2f}M device={plan.device}"
        + (f" ranks={n_ranks} ({spmd.backend()}; the count is rank 0's "
           f"shards)" if n_ranks > 1 else ""))

    src = SyntheticLMSource(cfg.vocab, args.seq, args.batch, seed=0)
    pipe = make_pipeline(src, plan, n_batches=args.steps + 8,
                         adaptive=args.adaptive)
    say(f"data graph: {pipe.graph.describe()}")
    for desc, p in pipe.placements:
        say(f"  [{p.target:6s}] {desc}")
    step = make_train_step(cfg, plan, cosine_warmup(args.lr, 20, args.steps))
    driver = TrainDriver(step, state, pipe,
                         DriverConfig(total_steps=args.steps,
                                      ckpt_every=args.ckpt_every,
                                      ckpt_dir=args.ckpt_dir, log_every=10))
    out = driver.run()
    losses = [h["loss"] for h in out["history"]]
    say(f"final step {out['final_step']}: loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}; restarts={out['restarts']} "
        f"stragglers={out['stragglers']}")
    say("data graph stats (svc-time EMA / items / lane depths):")
    say("  " + json.dumps(pipe.stats(), default=str))
    if args.adaptive:
        pipe.stop()                 # joins the supervisor, persists observe()
        events = pipe.replacement_events()
        say(f"re-placement events: {len(events)}")
        for e in events:
            say(f"  {e}")
    return 0


if __name__ == "__main__":
    main()
