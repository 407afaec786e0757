"""The JAX package's side of ``tests/test_torch_fsdp_gather.py``, run as one
subprocess over 2 fake XLA CPU devices:

    python tests/fsdp_gather_reference.py INPUTS.npz OUT.npz

For every config of ``tests/fsdp_gather_cases.py``, on the same numpy
inputs as the port's ranks and a (``data`` 2, ``model`` 1) mesh with
``fsdp_params``: two train steps jitted with XLA's excess precision off
(as ``tests/spmd_reference.py`` runs them), their losses and the whole
parameters after them, and a prefill's whole logits.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import fsdp_gather_cases as C  # noqa: E402
from repro.configs import get  # noqa: E402
from repro.core.plan import ShardingPlan  # noqa: E402
from repro.models.lm import LM  # noqa: E402
from repro.optim import make_optimizer  # noqa: E402
from repro.optim.schedules import cosine_warmup  # noqa: E402
from repro.runtime.steps import (make_prefill_step,  # noqa: E402
                                 make_train_step, state_shardings)

NO_EXCESS = {"xla_allow_excess_precision": False}


def _params(inp, name, like):
    def walk(d, path):
        if isinstance(d, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in d.items()}
        return jnp.asarray(inp[path], jnp.float32)
    return walk(like, C.prefix(name))


def run_config(inp, name, mesh, out):
    cfg = get(name).reduced()
    pre = C.prefix(name)
    plan = ShardingPlan(mesh)
    params = _params(inp, name, LM(cfg).param_defs())
    opt = make_optimizer(cfg.optimizer)
    sh = state_shardings(cfg, plan)
    state = jax.device_put({"params": params, "opt": opt.init(params),
                            "step": jnp.zeros((), jnp.int32)}, sh)
    tok = lambda i: jnp.asarray(inp[f"{pre}_train"][i])
    bsh = {"tokens": NamedSharding(mesh, P("data", None))}
    step = make_train_step(cfg, plan, cosine_warmup(C.TRAIN_LR, 20,
                                                    C.TRAIN_STEPS))
    f = jax.jit(step, in_shardings=(sh, bsh)).lower(
        state, {"tokens": tok(0)}).compile(compiler_options=NO_EXCESS)
    losses = []
    for i in range(C.TRAIN_STEPS):
        state, m = f(state, {"tokens": tok(i)})
        state = jax.device_put(state, sh)
        losses.append(float(m["loss"]))
    out[f"{pre}/losses"] = np.asarray(losses)
    for path, a in C._paths(state["params"]):
        out[f"{pre}/params{path}"] = np.asarray(a, np.float32)
    placed = jax.device_put(params, sh["params"])
    logits, _ = jax.jit(make_prefill_step(cfg, plan, C.CACHE_LEN))(
        placed, {"tokens": jnp.asarray(inp[f"{pre}_prompt"])})
    out[f"{pre}/prefill_logits"] = np.asarray(logits, np.float32)


def main(inp_path, out_path):
    inp = dict(np.load(inp_path))
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(C.MESH),
                ("data", "model"))
    out = {}
    for name in C.CONFIGS:
        run_config(inp, name, mesh, out)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])
