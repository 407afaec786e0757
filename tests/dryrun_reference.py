"""The JAX package's side of ``tests/test_torch_dryrun.py``, run as one
subprocess over 512 fake XLA CPU devices:

    python tests/dryrun_reference.py OUT.json

For every config of ``ASSIGNED``, every shape cell and both production
meshes (16 x 16 and 2 x 16 x 16) it writes the reference's input specs —
``batch_specs`` of the cell and, for the decode cells, ``cache_specs`` —
each leaf's global shape, type and per-device shard shape
(``sharding.shard_shape``), and the bytes of one device's shard of every
leaf of ``state_structs``.  Nothing is compiled or allocated.
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ASSIGNED, SHAPES, batch_specs, cache_specs, get  # noqa: E402
from repro.core.plan import ShardingPlan  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.runtime.steps import state_structs  # noqa: E402


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _spec(sds):
    return [list(sds.shape), str(np.dtype(sds.dtype)),
            list(sds.sharding.shard_shape(sds.shape))]


def main(out_path):
    out = {"batch": {}, "cache": {}, "state": {}}
    for multi_pod in (False, True):
        mesh_tag = "mp" if multi_pod else "sp"
        plan = ShardingPlan(mesh=make_production_mesh(multi_pod=multi_pod))
        for arch in ASSIGNED:
            cfg = get(arch)
            for shape, sh in SHAPES.items():
                key = f"{arch}|{shape}|{mesh_tag}"
                out["batch"][key] = {p: _spec(s) for p, s in _leaves(
                    batch_specs(cfg, shape, plan))}
                if sh["mode"] == "decode":
                    out["cache"][key] = {p: _spec(s) for p, s in _leaves(
                        cache_specs(cfg, sh["batch"], sh["seq"], plan))}
            total = 0
            for _, s in _leaves(state_structs(cfg, plan)):
                total += int(np.prod(s.sharding.shard_shape(s.shape))) \
                    * np.dtype(s.dtype).itemsize
            out["state"][f"{arch}|{mesh_tag}"] = total
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
