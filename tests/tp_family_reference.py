"""The JAX package's side of ``tests/test_torch_tp_families.py``, run as one
subprocess over 4 fake XLA CPU devices:

    python tests/tp_family_reference.py INPUTS.npz OUT.npz [DATAxMODEL]

For every case (of the one mesh named, else of every mesh) of
``tests/tp_family_cases.py`` it runs what ``tests/tp_reference.py`` runs
for ``tests/tp_cases.py``, from the same numpy inputs as the port's ranks:
two train steps, a prefill and ``DECODE_STEPS`` decode steps jitted over
the plan, the batch's frames, embeddings and M-RoPE ids beside the tokens
(each split over ``data`` on its batch dim); it saves the losses, the
grad norms, the whole parameters after the steps, each device's
addressable shard of the logits and of every cache and decode-state leaf,
and the ``NamedSharding`` shard shapes.  An mLSTM or sLSTM state leaf is
also saved whole, and its shard shape is that of its declared axes
(``mlstm_state_defs``/``slstm_state_defs``): where the heads do not divide
the model axis GSPMD leaves the scan's state unconstrained and tiles it
its own way (2 heads over 4 devices, a head on each), where the axes keep
it whole.
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

import tp_family_cases as C  # noqa: E402
from repro.configs import get  # noqa: E402
from repro.core.plan import ShardingPlan  # noqa: E402
from repro.models.lm import LM  # noqa: E402
from repro.optim import make_optimizer  # noqa: E402
from repro.optim.schedules import cosine_warmup  # noqa: E402
from repro.runtime.steps import (make_decode_step,  # noqa: E402
                                 make_prefill_step, make_train_step,
                                 state_shardings)
from tp_reference import NO_EXCESS, _leaf, _paths, _shards  # noqa: E402

# each batch input's spec: split over data on its batch dim
SPECS = {"tokens": P("data", None), "frames": P("data", None, None),
         "embeds": P("data", None, None),
         "mrope_positions": P(None, "data", None)}


def _params(inp, name, like):
    pre = C.prefix(name)

    def walk(d, path):
        if isinstance(d, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in d.items()}
        a = jnp.asarray(inp[path], jnp.float32)
        return a.astype(d.dtype) if C.bf16_params(name) else a
    return walk(like, pre)


def _batch(tokens, more):
    b = {"tokens": jnp.asarray(tokens)}
    b.update({k: jnp.asarray(v) for k, v in more.items()})
    return b


def _fit(spec, shape, sizes) -> tuple:
    """``spec``'s mesh axes fitted to ``shape`` (an axis that does not
    divide what is left of its dim dropped), as ``spec_for_shape`` fits a
    parameter's."""
    out = []
    for e, n in zip(tuple(spec) + (None,) * (len(shape) - len(spec)), shape):
        keep, prod = [], 1
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            if n % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        out.append(None if not keep else keep[0] if len(keep) == 1
                   else tuple(keep))
    return tuple(out)


def _fitted(sh, opt_state, mesh):
    """The reference's state shardings with each optimizer moment's spec
    fitted to the moment's shape: ``state_shardings`` resolves the moments'
    axes without their shapes, and ``device_put`` refuses a spec that does
    not divide (xLSTM's wi/wf moments, (d_inner, 2) over a model axis of
    4).  The step's arithmetic does not depend on the state's layout."""
    sizes = dict(mesh.shape)
    o_sh = jax.tree.map(lambda s, a: NamedSharding(
        mesh, P(*_fit(s.spec, a.shape, sizes))), sh["opt"], opt_state)
    return dict(sh, opt=o_sh)


def run_case(inp, case, out):
    name, shape = case
    cfg = C.config(get, name)
    key = C.key(case)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))
    plan = ShardingPlan(mesh)
    pre = C.prefix(name)
    params = _params(inp, name, LM(cfg).param_defs())
    opt = make_optimizer(cfg.optimizer)
    sh = _fitted(state_shardings(cfg, plan), opt.init(params), mesh)
    for path, s in _paths(sh["params"]):
        out[f"{key}/pshape{path}"] = np.asarray(
            s.shard_shape(_leaf(params, path).shape))

    if name not in C.SERVE_ONLY:
        state = {"params": params, "opt": opt.init(params),
                 "step": jnp.zeros((), jnp.int32)}
        state = jax.device_put(state, sh)
        for path, a in _paths(state["opt"]):
            out[f"{key}/oshape{path}"] = np.asarray(a.sharding.shard_shape(
                a.shape))
        b0 = _batch(inp[f"{pre}_train"][0], C.extras(inp, name, "train", 0))
        bsh = {k: NamedSharding(mesh, SPECS[k]) for k in b0}
        step = make_train_step(cfg, plan, cosine_warmup(C.train_lr(name), 20,
                                                        C.TRAIN_STEPS))
        f = jax.jit(step, in_shardings=(sh, bsh)).lower(state, b0).compile(
            compiler_options=NO_EXCESS)
        losses, norms = [], []
        for i in range(C.TRAIN_STEPS):
            state, m = f(state, _batch(inp[f"{pre}_train"][i],
                                       C.extras(inp, name, "train", i)))
            # GSPMD may hand the state back in other layouts (the cross
            # attention's replicated kv heads): the next call's ones
            state = jax.device_put(state, sh)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[f"{key}/losses"] = np.asarray(losses)
        out[f"{key}/grad_norms"] = np.asarray(norms)
        for path, a in _paths(state["params"]):
            out[f"{key}/params{path}"] = np.asarray(a, np.float32)
        del state, f

    params = jax.device_put(params, sh["params"])
    prefill = jax.jit(make_prefill_step(cfg, plan, C.CACHE_LEN))
    logits, caches = prefill(params, _batch(inp[f"{pre}_prompt"],
                                            C.extras(inp, name, "prompt")))
    _shards(out, f"{key}/prefill_logits", logits)
    _shards(out, f"{key}/prefill_cache", caches)
    declared = LM(cfg).cache_defs(C.B_PROMPT, C.CACHE_LEN)
    for path, a in _paths(caches):
        out[f"{key}/cshape{path}"] = np.asarray(a.sharding.shard_shape(
            a.shape))
        if _state(path):
            axes = _leaf(declared, path)[2]
            out[f"{key}/cshape{path}"] = np.asarray(NamedSharding(
                mesh, plan.spec_for_shape(a.shape, axes)).shard_shape(
                    a.shape))
            out[f"{key}/prefill_cache_whole{path}"] = np.asarray(
                a, np.float32)
    decode = jax.jit(make_decode_step(cfg, plan, C.CACHE_LEN))
    toks = []
    for i in range(C.DECODE_STEPS):
        batch = {"token": jnp.asarray(inp[f"{pre}_decode"][i]),
                 "pos": jnp.asarray(C.s_prompt(name) + i, jnp.int32)}
        nt, logits, caches = decode(params, caches, batch)
        toks.append(np.asarray(nt))
        _shards(out, f"{key}/decode{i}_logits", logits)
    out[f"{key}/decode_tokens"] = np.stack(toks)
    _shards(out, f"{key}/decode_cache", caches)
    for path, a in _paths(caches):
        if _state(path):
            out[f"{key}/decode_cache_whole{path}"] = np.asarray(a,
                                                                np.float32)


def _state(path: str) -> bool:
    return path.split("/")[1] in ("mlstm", "slstm")


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
