"""The paper's map-on-a-farm-template (FastFlow tutorial Sec. 12.1) through
the PyTorch port: the twin of ``examples/map_matmul.py``, matrix multiply
as Split -> workers -> Compose at both levels the port provides:

1. host level: the literal ff_map structure (Split emitter partitions
   C = A x B into row tasks, workers compute rows, Compose rebuilds C),
   built with the graph API's ``ffmap`` block and host-lowered;
2. device level: the same skeleton through ``core/device.py``'s
   ``tensor_map`` — Split = a spec over the ``model`` axis (the port's
   ``PartitionSpec``), Compose = ``psum`` — plus the SAME ``farm`` graph
   lowered host-side and device-side through the one ``lower(plan)``
   entry point, producing identical rows, and an ``all_to_all`` through
   the staged compiler on both sides.

On the GPU unless ``--device`` names another device.

    PYTHONPATH=src python examples/map_matmul_torch.py
    PYTHONPATH=src python examples/map_matmul_torch.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import (FF_EOS, CompileConfig, FFNode, GO_ON,
                              all_to_all, farm, ffmap)
from repro_torch.core.device import tensor_map
from repro_torch.core.plan import P, single_device_plan


# --- host-level ff_map (paper code structure) ---------------------------------
class Split(FFNode):
    """Emitter: one task per output row (the paper's finer-grain c_ij
    variant works too; rows keep the demo fast)."""
    def svc(self, task):
        A, B, C = task
        for i in range(A.shape[0]):
            self.ff_send_out(("row", i, A[i], B, C))
        return None


class Worker(FFNode):
    def svc(self, t):
        _, i, a_row, B, C = t
        return ("res", i, a_row @ B, C)


class Compose(FFNode):
    def __init__(self, n_rows):
        super().__init__()
        self.remaining = n_rows

    def svc(self, t):
        _, i, row, C = t
        C[i] = row
        self.remaining -= 1
        return GO_ON


def host_map_matmul(A, B, nworkers=4):
    C = np.zeros((A.shape[0], B.shape[1]), A.dtype)
    m = ffmap(Split(), [Worker() for _ in range(nworkers)],
              Compose(A.shape[0])).lower()
    m.run_then_freeze()
    m.offload((A, B, C))
    m.offload(FF_EOS)
    m.wait()
    return C


def _rows(out):
    return np.stack([np.asarray(torch.as_tensor(y).cpu()) for y in out])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    A = rng.normal(size=(64, 32)).astype(np.float32)
    B = rng.normal(size=(32, 48)).astype(np.float32)

    C_host = host_map_matmul(A, B)
    np.testing.assert_allclose(C_host, A @ B, rtol=1e-5)
    print("host-level ff_map matmul: OK")

    # --- device-level map skeleton ------------------------------------------
    plan = single_device_plan(args.device)
    dev = plan.device
    f = tensor_map(lambda a, b: a @ b, plan.mesh, axis="model",
                   split_spec=(P(None, "model"), P("model", None)),
                   compose="reduce")
    C_dev = f(torch.from_numpy(A).to(dev), torch.from_numpy(B).to(dev))
    np.testing.assert_allclose(C_dev.cpu().numpy(), A @ B, rtol=1e-4,
                               atol=1e-5)
    print("device-level tensor_map matmul: OK (Split=spec over the model "
          "axis, Compose=psum)")

    # --- one graph, two lowerings -------------------------------------------
    Bh, Bd = torch.from_numpy(B), torch.from_numpy(B).to(dev)
    g = farm(lambda row: row @ (Bd if row.device == dev else Bh), n=2)
    rows_host = g.lower().run(list(torch.from_numpy(A)))
    rows_dev = g.lower(plan).run(list(A))
    # one row against B and a batch's GEMM sum the 32 products in
    # different orders: f32 rounding, to an ulp of the sum's terms
    np.testing.assert_allclose(np.sort(_rows(rows_host), axis=0),
                               np.sort(_rows(rows_dev), axis=0), rtol=1e-5,
                               atol=1e-5)
    print("graph farm lower() parity: host threads == device farm")

    # --- ff_a2a through the staged compiler ---------------------------------
    # rows are routed to one of two "experts" (scale vs negate) by the sign
    # of the first transformed element; the device lowering is MoE-style
    # dispatch/combine (the a2a_route and a2a_combine kernels on the card)
    lefts = [lambda row: row @ (Bd if row.device == dev else Bh)]
    rights = [lambda y: y * 2.0, lambda y: -y]
    router = lambda y, n: (y[0] > 0).to(torch.int32) % n

    def build():
        return all_to_all(lefts, rights, router=router)
    out_host = build().compile(config=CompileConfig(mode="host")).run(
        list(torch.from_numpy(A)))
    out_dev = build().compile(config=CompileConfig(
        plan=plan, mode="device")).run(list(A))
    np.testing.assert_allclose(np.sort(_rows(out_host), axis=0),
                               np.sort(_rows(out_dev), axis=0), rtol=1e-5,
                               atol=1e-5)
    print("graph a2a compile() parity: host MPMC grid == MoE dispatch/"
          "combine")


if __name__ == "__main__":
    main()
