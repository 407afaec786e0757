"""The JAX package's side of ``tests/test_torch_tp.py``, run as one
subprocess over 4 fake XLA CPU devices:

    python tests/tp_reference.py INPUTS.npz OUT.npz [DATAxMODEL]

For every case (of the one mesh named, else of every mesh) of ``tests/tp_cases.py`` (a reduced config on a
``(data, model)`` mesh of 4 devices) it runs, from the same numpy inputs
as the port's ranks: two train steps (``make_train_step`` jitted with the
state's shardings and XLA's excess precision off, as
``tests/spmd_reference.py`` runs them), a prefill and ``DECODE_STEPS``
decode steps (``make_prefill_step``/``make_decode_step`` jitted over the
plan).  It saves the losses, the grad norms, the whole parameters after
the steps, and per device the addressable shard of the prefill logits, of
every cache and decode-state leaf after the prefill and after the last
decode step, and of each decode step's logits, beside the
``NamedSharding`` shard shapes of the parameters, the optimizer state and
the caches.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import tp_cases as C  # noqa: E402
from repro.configs import get  # noqa: E402
from repro.core.plan import ShardingPlan  # noqa: E402
from repro.models.lm import LM  # noqa: E402
from repro.optim import make_optimizer  # noqa: E402
from repro.optim.schedules import cosine_warmup  # noqa: E402
from repro.runtime.steps import (make_decode_step,  # noqa: E402
                                 make_prefill_step, make_train_step,
                                 state_shardings)

NO_EXCESS = {"xla_allow_excess_precision": False}


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{pre}/{i}")
    else:
        yield pre, tree


def _params(inp, prefix, like):
    def walk(d, path):
        if isinstance(d, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in d.items()}
        return jnp.asarray(inp[path], jnp.float32)
    return walk(like, prefix)


def _shards(out, tag, tree):
    """Each leaf's addressable shard per device, and its shard shape."""
    for path, a in _paths(tree):
        for s in a.addressable_shards:
            out[f"{tag}{path}@{s.device.id}"] = np.asarray(s.data,
                                                           np.float32)


def run_case(inp, case, out):
    name, shape = case
    cfg = C.config(get, name)
    key = C.key(case)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))
    plan = ShardingPlan(mesh)
    prefix = C.prefix(name)
    params = _params(inp, prefix, LM(cfg).param_defs())
    opt = make_optimizer(cfg.optimizer)
    sh = state_shardings(cfg, plan)
    for path, s in _paths(sh["params"]):
        out[f"{key}/pshape{path}"] = np.asarray(
            s.shard_shape(_leaf(params, path).shape))

    # two train steps
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    state = jax.device_put(state, sh)
    for path, a in _paths(state["opt"]):
        out[f"{key}/oshape{path}"] = np.asarray(a.sharding.shard_shape(
            a.shape))
    bsh = {"tokens": NamedSharding(mesh, P("data", None))}
    step = make_train_step(cfg, plan, cosine_warmup(C.TRAIN_LR, 20,
                                                    C.TRAIN_STEPS))
    tok = inp[f"{prefix}_train"]
    f = jax.jit(step, in_shardings=(sh, bsh)).lower(
        state, {"tokens": jnp.asarray(tok[0])}).compile(
        compiler_options=NO_EXCESS)
    losses, norms = [], []
    for i in range(C.TRAIN_STEPS):
        state, m = f(state, {"tokens": jnp.asarray(tok[i])})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[f"{key}/losses"] = np.asarray(losses)
    out[f"{key}/grad_norms"] = np.asarray(norms)
    for path, a in _paths(state["params"]):
        out[f"{key}/params{path}"] = np.asarray(a, np.float32)
    del state, f

    # prefill, then decode steps on the given tokens
    params = jax.device_put(params, sh["params"])
    prompt = jnp.asarray(inp[f"{prefix}_prompt"])
    prefill = jax.jit(make_prefill_step(cfg, plan, C.CACHE_LEN))
    logits, caches = prefill(params, {"tokens": prompt})
    _shards(out, f"{key}/prefill_logits", logits)
    _shards(out, f"{key}/prefill_cache", caches)
    for path, a in _paths(caches):
        out[f"{key}/cshape{path}"] = np.asarray(a.sharding.shard_shape(
            a.shape))
    decode = jax.jit(make_decode_step(cfg, plan, C.CACHE_LEN))
    S = prompt.shape[1]
    toks = []
    for i in range(C.DECODE_STEPS):
        batch = {"token": jnp.asarray(inp[f"{prefix}_decode"][i]),
                 "pos": jnp.asarray(S + i, jnp.int32)}
        nt, logits, caches = decode(params, caches, batch)
        toks.append(np.asarray(nt))
        _shards(out, f"{key}/decode{i}_logits", logits)
    out[f"{key}/decode_tokens"] = np.stack(toks)
    _shards(out, f"{key}/decode_cache", caches)


def _leaf(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


def main(inp_path, out_path, mesh=None):
    inp = dict(np.load(inp_path))
    out = {}
    for case in C.CASES:
        if mesh is None or mesh == "{}x{}".format(*case[1]):
            run_case(inp, case, out)
    np.savez(out_path, **{k: np.asarray(v, np.float32)
                          for k, v in out.items()})


if __name__ == "__main__":
    main(*sys.argv[1:4])
