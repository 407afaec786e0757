"""The JAX package's side of ``tests/test_torch_graph_spmd.py``, run as one
subprocess over 2 fake XLA CPU devices:

    python tests/graph_spmd_reference.py INPUTS.npz OUT.npz

Compiles every graph of ``tests/graph_spmd_cases.py`` over a plan whose
``data`` axis spans the two devices (the reference puts each fused
segment's microbatch on the mesh and pads a partial one to a multiple of
the devices) and saves each graph's outputs over the same numpy stream as
the port's ranks.  The reference's host farm collects in arrival order,
so the hybrid graph's rows may come back in another order.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import graph_spmd_cases as C  # noqa: E402
import repro.core as J  # noqa: E402
from repro.core.plan import ShardingPlan  # noqa: E402


def main(inp_path, out_path):
    stream = list(np.load(inp_path)["stream"])
    plan = ShardingPlan(Mesh(np.array(jax.devices()[:2]), ("data",)))
    out = {}
    for name in C.CASES:
        g, kw = C.build(name, "jax")
        runner = g.compile(config=J.CompileConfig(plan=plan, **kw))
        out[name] = np.stack([np.asarray(y) for y in runner.run(stream)])
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
