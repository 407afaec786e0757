"""FastFlow *software accelerator* mode (paper Sec. 9) with a CUDA device as
the accelerator, two ways — the twin of ``examples/accelerator_offload.py``
for the PyTorch port:

1. raw TorchAccelerator: offload f(x) tasks (here: batched products) and
   retrieve results asynchronously — the paper's offload/load_result
   pattern verbatim, with a CUDA stream as the offload queue;
2. InferenceEngine: continuous-batching LM serving behind the typed
   client API — ``submit`` returns a ``RequestHandle``, ``results()``
   iterates outcomes, the engine is a context manager.

It runs on ``cuda:0`` unless ``--device`` names another device.

    PYTHONPATH=src python examples/accelerator_offload_torch.py
    PYTHONPATH=src python examples/accelerator_offload_torch.py --device cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.core import FF_EOS, TorchAccelerator
from repro_torch.core.plan import single_device_plan
from repro_torch.runtime.steps import init_state
from repro_torch.serving import InferenceEngine, Request


def demo_raw_accelerator(device) -> int:
    print("== raw accelerator: offloaded product stream ==")
    acc = TorchAccelerator(lambda x: (x @ x.T).sum(dim=1), max_inflight=8,
                           device=device)
    acc.run_then_freeze()
    xs = [np.random.default_rng(i).normal(size=(256, 256)).astype(np.float32)
          for i in range(20)]
    t0 = time.perf_counter()
    for x in xs:
        acc.offload(x)          # returns at once: queued on the stream
    acc.offload(FF_EOS)
    n = 0
    while True:
        ok, r = acc.load_result()
        if not ok:
            break
        n += 1
    if acc.device.type == "cuda":
        torch.cuda.synchronize(acc.device)
    acc.wait()
    print(f"offloaded+retrieved {n} tasks on {acc.device} in "
          f"{(time.perf_counter()-t0)*1e3:.1f} ms")
    assert n == len(xs) and acc.error is None
    return n


def demo_serving(device) -> int:
    print("== inference engine: continuous batching ==")
    cfg = get("ff-tiny").reduced()
    plan = single_device_plan(device)
    params = init_state(cfg, plan, torch.Generator(device=plan.device)
                        .manual_seed(0))["params"]
    rng = np.random.default_rng(0)
    with InferenceEngine(cfg, plan, params, max_batch=2,
                         cache_len=64) as eng:
        for _ in range(5):
            eng.submit(Request(prompt=rng.integers(0, cfg.vocab, 8,
                                                   dtype=np.int32),
                               max_new_tokens=8))
    # leaving the with-block drained the engine; outcomes replay in
    # completion order
    done = 0
    for req in eng.results():
        done += 1
        print(f"request {req.id}: {len(req.tokens)} tokens "
              f"[{req.finish_reason}] "
              f"({(req.finish_t-req.submit_t)*1e3:.0f} ms) {req.tokens[:8]}")
    assert done == 5
    print(f"engine decode steps: {eng.steps} (continuous batching: "
          f"fewer than sequential 5x8={5*8})")
    return eng.steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    demo_raw_accelerator(args.device)
    demo_serving(args.device)


if __name__ == "__main__":
    main()
