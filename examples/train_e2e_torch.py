"""End-to-end training through the PyTorch port: train a small LM for a
few hundred steps through the whole stack — data pipeline, train step,
checkpointing, fault-tolerant driver, straggler watchdog — with an
optional injected failure to show checkpoint/restart recovery.  The twin of
``examples/train_e2e.py``; it runs on the GPU unless ``--device`` names
another device.

    PYTHONPATH=src python examples/train_e2e_torch.py --steps 200
    PYTHONPATH=src python examples/train_e2e_torch.py --device cpu \\
        --steps 40 --inject-failure 30
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import Config
from repro_torch.core.plan import single_device_plan
from repro_torch.core.tree import tree_leaves
from repro_torch.data import SyntheticLMSource, make_pipeline
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.runtime.driver import DriverConfig, TrainDriver
from repro_torch.runtime.steps import init_state, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("--full-100m", action="store_true",
                    help="~100M params (slow on CPU)")
    ap.add_argument("--inject-failure", type=int, default=None,
                    help="raise at this step once to demo restart")
    args = ap.parse_args()

    if args.full_100m:
        cfg = Config(name="ff-100m", family="dense", n_layers=12,
                     d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
                     d_ff=3072, vocab=32768, act="gelu",
                     attn_parallel="heads", n_kv_eff=12,
                     q_block=128, kv_block=128)
    else:
        cfg = Config(name="ff-20m", family="dense", n_layers=4,
                     d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
                     d_ff=1536, vocab=8192, act="gelu",
                     attn_parallel="heads", n_kv_eff=6,
                     q_block=128, kv_block=128)

    plan = single_device_plan(args.device)
    state = init_state(cfg, plan,
                       torch.Generator(device=plan.device).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq} "
          f"device={plan.device}")

    src = SyntheticLMSource(cfg.vocab, args.seq, args.batch, seed=0)
    pipe = make_pipeline(src, plan, n_batches=args.steps + 16)
    step = make_train_step(cfg, plan, cosine_warmup(3e-3, 20, args.steps))

    fail_at = args.inject_failure
    fired = [False]

    def fault_hook(s):
        if fail_at is not None and s == fail_at and not fired[0]:
            fired[0] = True
            raise RuntimeError("injected node failure (preemption)")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        driver = TrainDriver(
            step, state, pipe,
            DriverConfig(total_steps=args.steps, ckpt_every=25,
                         ckpt_dir=ckpt_dir, log_every=20),
            fault_hook=fault_hook)
        t0 = time.time()
        out = driver.run()
        wall = time.time() - t0
    losses = [h["loss"] for h in out["history"]]
    toks = args.batch * args.seq * out["final_step"]
    print(f"done in {wall:.1f}s: loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"{toks/wall/1e3:.1f}k tok/s, restarts={out['restarts']}, "
          f"stragglers={out['stragglers']}")
    assert losses[-1] < losses[0]
    if fail_at is not None and fail_at < args.steps:
        assert out["restarts"] == 1


if __name__ == "__main__":
    main()
