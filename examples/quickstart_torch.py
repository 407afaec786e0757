"""Quickstart: train a tiny LM with the PyTorch port's full stack.

The twin of ``examples/quickstart.py``: the paper's "skeleton program"
abstraction end to end — data pipeline (pipeline skeleton) -> train step
(farm over the mesh) -> fault-tolerant driver (supervising farm with
feedback) — on the GPU unless ``--device`` names another device.

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 30]
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get
from repro_torch.core.plan import single_device_plan
from repro_torch.core.tree import tree_leaves
from repro_torch.data import SyntheticLMSource, make_pipeline
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.runtime.driver import DriverConfig, TrainDriver
from repro_torch.runtime.steps import init_state, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--arch", default="ff-tiny")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args()

    cfg = get(args.arch).reduced() if args.arch != "ff-tiny" else get(args.arch)
    plan = single_device_plan(args.device)
    state = init_state(cfg, plan,
                       torch.Generator(device=plan.device).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M")

    src = SyntheticLMSource(cfg.vocab, args.seq, args.batch, seed=0)
    pipe = make_pipeline(src, plan, n_batches=args.steps + 5)
    step = make_train_step(cfg, plan, cosine_warmup(3e-3, 10, args.steps))

    with tempfile.TemporaryDirectory(prefix="repro_quickstart_ckpt") as d:
        driver = TrainDriver(step, state, pipe,
                             DriverConfig(total_steps=args.steps,
                                          ckpt_every=10, ckpt_dir=d,
                                          log_every=5))
        out = driver.run()
    losses = [h["loss"] for h in out["history"]]
    print(f"done: steps={out['final_step']} loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f} (restarts={out['restarts']})")
    if not losses[-1] < losses[0]:
        raise SystemExit("loss should decrease")


if __name__ == "__main__":
    main()
