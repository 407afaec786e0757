"""The rank side of ``tests/test_torch_tp.py``: every case runs in each of
four gloo ranks on the CPU (``core.spmd.launch``), on the inputs the test
wrote with numpy, and returns what the test holds against the JAX
package's side (``tests/tp_reference.py``, which imports this module for
the case list).  Imports only torch, numpy and the port, so a rank starts
without JAX.

A case is a reduced config on a ``(data, model)`` mesh of the four ranks,
``(2, 2)`` or ``(1, 4)``: two train steps, a prefill and ``DECODE_STEPS``
decode steps through ``make_train_step``/``make_prefill_step``/
``make_decode_step`` from the same fp32 parameters, and this rank's block
of everything they return.  Three mutants run beside them, each with one
transition of the sharded model broken (``MUTANTS``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TRAIN_STEPS, TRAIN_LR = 2, 1e-6
B_TRAIN, S_TRAIN = 4, 16
B_PROMPT, S_PROMPT, CACHE_LEN, DECODE_STEPS = 2, 16, 32, 4
# reduced ff-tiny with 16 kv heads (32 q heads), so that the KV cache takes
# the heads layout of ``_cache_axes`` (n_kv_heads % 16 == 0), as Zamba2's
# 32 do at full width; every other reduced config keeps 2 kv heads and
# the head_dim layout
KV16 = {"n_heads": 32, "n_kv_heads": 16}
CONFIGS = ("ff-tiny", "mixtral-8x7b", "kimi-k2-1t-a32b", "zamba2-1.2b",
           "kv16")
MESHES = ((2, 2), (1, 4))
CASES = [(name, shape) for shape in MESHES for name in CONFIGS]
# (mutant, case it runs on): a psum where the psum_scatter belongs at the
# blocks' exit; the gradient sum over the model axis removed; each rank's
# kv heads off by one group
MUTANTS = (("psum_for_scatter", ("ff-tiny", (1, 4))),
           ("no_model_grad_sum", ("mixtral-8x7b", (2, 2))),
           ("kv_off_by_one_group", ("ff-tiny", (1, 4))))


def config(get, name):
    """The reduced config of a case (either package's ``get``)."""
    if name == "kv16":
        return dataclasses.replace(get("ff-tiny").reduced(), **KV16)
    cfg = get(name).reduced()
    if name == "kimi-k2-1t-a32b":           # tests/spmd_cases.py:kimi_wide
        cfg = dataclasses.replace(cfg, d_model=128, moe_d_ff=128, d_ff=256)
    return cfg


def prefix(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def key(case) -> str:
    name, shape = case
    return f"{prefix(name)}@{shape[0]}x{shape[1]}"


def _np(t):
    t = t.detach()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).cpu())


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{pre}/{i}")
    else:
        yield pre, tree


def _params(inp, pre, like):
    def walk(d, path):
        if isinstance(d, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in d.items()}
        return torch.from_numpy(np.array(inp[path], dtype=np.float32))
    return walk(like, pre)


def _state(cfg, plan, whole):
    from repro_torch.core.tree import tree_map
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.steps import param_shards, state_shardings
    opt = make_optimizer(cfg.optimizer)
    sh = state_shardings(cfg, plan, opt)
    local = tree_map(lambda t, s: s.local_block(t).clone(), whole,
                     sh["params"])
    return opt, {"params": local,
                 "opt": opt.init(local, param_shards(cfg, plan, opt)),
                 "step": torch.zeros((), dtype=torch.int32)}


def _train(inp, cfg, plan, pre, out, tag, steps=TRAIN_STEPS):
    from repro_torch.checkpoint import gather_state
    from repro_torch.models.lm import LM
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime.steps import make_train_step
    whole = _params(inp, pre, LM(cfg).param_defs())
    opt, state = _state(cfg, plan, whole)
    for path, t in _paths(state["params"]):
        out[f"{tag}/pshape{path}"] = np.asarray(t.shape)
    for path, t in _paths(state["opt"]):
        out[f"{tag}/oshape{path}"] = np.asarray(t.shape)
    step = make_train_step(cfg, plan, cosine_warmup(TRAIN_LR, 20,
                                                    TRAIN_STEPS))
    losses, norms = [], []
    for i in range(steps):
        state, m = step(state, {"tokens": torch.from_numpy(
            inp[f"{pre}_train"][i])})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[f"{tag}/losses"] = np.asarray(losses)
    out[f"{tag}/grad_norms"] = np.asarray(norms)
    full = gather_state(cfg, state, plan, opt)
    for path, t in _paths(full["params"]):
        out[f"{tag}/params{path}"] = _np(t)


def _serve(inp, cfg, plan, pre, out, tag, rank, decode=True):
    from repro_torch.models.lm import LM
    from repro_torch.runtime.steps import (make_decode_step,
                                           make_prefill_step)
    whole = _params(inp, pre, LM(cfg).param_defs())
    _, state = _state(cfg, plan, whole)
    params = state["params"]
    prompt = torch.from_numpy(inp[f"{pre}_prompt"])
    logits, caches = make_prefill_step(cfg, plan, CACHE_LEN)(
        params, {"tokens": prompt})
    out[f"{tag}/prefill_logits@{rank}"] = _np(logits)
    for path, t in _paths(caches):
        out[f"{tag}/prefill_cache{path}@{rank}"] = _np(t)
        out[f"{tag}/cshape{path}"] = np.asarray(t.shape)
    if not decode:
        return
    step = make_decode_step(cfg, plan, CACHE_LEN)
    toks = []
    for i in range(DECODE_STEPS):
        batch = {"token": torch.from_numpy(inp[f"{pre}_decode"][i]),
                 "pos": torch.tensor(S_PROMPT + i, dtype=torch.int32)}
        nt, logits, caches = step(params, caches, batch)
        toks.append(_np(nt))
        out[f"{tag}/decode{i}_logits@{rank}"] = _np(logits)
    out[f"{tag}/decode_tokens"] = np.stack(toks)
    for path, t in _paths(caches):
        out[f"{tag}/decode_cache{path}@{rank}"] = _np(t)
        out[f"{tag}/dshape{path}"] = np.asarray(t.shape)


def _mutant(name: str):
    """Patch one transition of the sharded model; returns the undo."""
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.core import spmd
    from repro_torch.models import attention
    from repro_torch.runtime import steps
    if name == "psum_for_scatter":
        orig = ShardingPlan.compose

        def compose(self, o, sp, w):
            if sp and self.model_split(w.shape, w.axes):
                return spmd.psum(o, self.model_axis())
            return orig(self, o, sp, w)
        ShardingPlan.compose = compose
        return lambda: setattr(ShardingPlan, "compose", orig)
    if name == "no_model_grad_sum":
        orig = steps.reduce_grads
        steps.reduce_grads = lambda g, s, axes, replicated=(): orig(g, s,
                                                                  axes)
        return lambda: setattr(steps, "reduce_grads", orig)
    orig = attention._kv_for_heads

    def shifted(k, v, q_off, n_q, group, k_off):
        # the q heads of the next group (the kv heads whole, as in the
        # case it runs on)
        return orig(k, v, (q_off + group) % (k.shape[2] * group), n_q,
                    group, k_off)
    attention._kv_for_heads = shifted
    return lambda: setattr(attention, "_kv_for_heads", orig)


def rank_main(inp_path: str) -> dict:
    """Every case on this rank; returns ``{name: array}``."""
    torch.set_num_threads(1)
    from repro_torch.configs import get
    from repro_torch.core import spmd
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.launch.mesh import make_mesh
    inp = dict(np.load(inp_path))
    rank = spmd.rank()
    meshes = {s: make_mesh(s, ("data", "model"), "cpu") for s in MESHES}
    out = {}
    for case in CASES:
        name, shape = case
        cfg, plan = config(get, name), ShardingPlan(meshes[shape])
        _train(inp, cfg, plan, prefix(name), out, key(case))
        _serve(inp, cfg, plan, prefix(name), out, key(case), rank)
    for mutant, case in MUTANTS:
        name, shape = case
        cfg, plan = config(get, name), ShardingPlan(meshes[shape])
        tag = f"{mutant}/{key(case)}"
        undo = _mutant(mutant)
        try:
            if mutant == "no_model_grad_sum":
                _train(inp, cfg, plan, prefix(name), out, tag)
            else:
                _serve(inp, cfg, plan, prefix(name), out, tag, rank,
                       decode=False)
            out[f"{tag}/raised"] = np.asarray(0)
        except Exception as e:              # noqa: BLE001 - the mutant
            out[f"{tag}/raised"] = np.asarray(1)
            out[f"{tag}/error"] = np.asarray(repr(e)[:200])
        finally:
            undo()
    out["rank"] = np.asarray(rank)
    return out


if __name__ == "__main__":
    raise SystemExit("imported by tests/test_torch_tp.py")
