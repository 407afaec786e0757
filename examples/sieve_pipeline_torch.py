"""The paper's Sieve of Eratosthenes (FastFlow tutorial Secs. 6-7) through
the PyTorch port's building-blocks graph API: the twin of
``examples/sieve_pipeline.py``, the same structure and output — a Generate
source, N Sieve stages, a Printer sink, composed with ``pipeline(...)``
and run through the port's staged graph compiler (every stage is
stateful, so ``place()`` pins the whole network to host threads, and no
device is touched: ``--device`` is accepted for the twins' common
interface and names where a device stage would run).

    PYTHONPATH=src python examples/sieve_pipeline_torch.py 7 50
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import FFNode, GO_ON, pipeline
from repro_torch.core.plan import single_device_plan


class Generate(FFNode):
    def __init__(self, n):
        super().__init__()
        self.task, self.streamlen = 1, n

    def svc_init(self):
        print(f"Sieve started. Generating a stream of {self.streamlen} "
              f"elements, starting with 2")
        return 0

    def svc(self, _):
        self.task += 1
        return self.task if self.task <= self.streamlen else None


class Sieve(FFNode):
    def __init__(self):
        super().__init__()
        self.filter = 0

    def svc(self, t):
        if self.filter == 0:
            self.filter = t
            return GO_ON
        return GO_ON if t % self.filter == 0 else t

    def svc_end(self):
        print(f"Prime({self.filter})")


class Printer(FFNode):
    def __init__(self):
        super().__init__()
        self.first = 0

    def svc_init(self):
        print("Printer started")
        return 0

    def svc(self, t):
        if self.first == 0:
            self.first = t
        return GO_ON

    def svc_end(self):
        print(f"Sieve terminating, prime numbers found up to {self.first}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("nstages", type=int, nargs="?", default=7)
    ap.add_argument("streamlen", type=int, nargs="?", default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args()
    plan = single_device_plan(args.device)
    graph = pipeline(Generate(args.streamlen),
                     *[Sieve() for _ in range(args.nstages)], Printer())
    runner = graph.compile(plan)   # normalize -> annotate -> place -> emit
    for desc, p in runner.placements:
        print(f"  [{p.target:6s}] {desc}")
    if runner.run_and_wait_end() < 0:
        raise SystemExit("running pipeline failed")
    print(f"DONE, pipe time = {runner.ffTime():.3f} (ms)")


if __name__ == "__main__":
    main()
