"""The rank side of ``tests/test_torch_fsdp_gather.py``: every config runs
in each of two gloo ranks on the CPU (``core.spmd.launch``) on a (``data``
2, ``model`` 1) mesh with ``fsdp_params``: two train steps, a prefill and a
decode step from the test's numpy parameters, each weight gathered over
the data axis where the model uses it (``ShardingPlan.gather_fsdp``).  It
returns what the test holds against the JAX package's side
(``tests/fsdp_gather_reference.py``), and the live gathered bytes'
high-water mark and totals of each step (``core.plan.FSDP_GATHERED``).
Imports only torch, numpy and the port, so a rank starts without JAX.
"""

from __future__ import annotations

import numpy as np
import torch

# reduced Mixtral (attention, the MoE body and its router, the untied
# embedding and lm_head), Zamba2 (Mamba2 with wB/wC/wdt, the shared
# attention block, the MLP) and xLSTM (the mLSTM's and sLSTM's weights)
CONFIGS = ("mixtral-8x7b", "zamba2-1.2b", "xlstm-125m")
MESH = (2, 1)
B_TRAIN, S_TRAIN, TRAIN_STEPS, TRAIN_LR = 4, 16, 2, 1e-6
B_PROMPT, S_PROMPT, CACHE_LEN = 2, 16, 32


def prefix(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _np(t):
    t = t.detach()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).cpu())


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


def _params(inp, name, like):
    def walk(d, path):
        if isinstance(d, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in d.items()}
        return torch.from_numpy(np.array(inp[path], dtype=np.float32))
    return walk(like, prefix(name))


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


def _gathered(out, tag):
    """The counter's readings since its reset, under ``tag``."""
    from repro_torch.core.plan import FSDP_GATHERED
    for k in ("peak", "gathers", "bytes"):
        out[f"{tag}/{k}"] = np.asarray(FSDP_GATHERED[k], np.int64)


def _train_one(inp, cfg, name, out):
    """The same steps on one device in two micro-batches of half the batch
    (each routed apart, as each of the two ranks routes its own tokens)."""
    from repro_torch.core.plan import single_device_plan
    from repro_torch.models.lm import LM
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime.steps import make_train_step
    pre = prefix(name)
    params = _params(inp, name, LM(cfg).param_defs())
    opt = make_optimizer(cfg.optimizer)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(cfg, single_device_plan("cpu"), cosine_warmup(
        TRAIN_LR, 20, TRAIN_STEPS), n_micro=2)
    for i in range(TRAIN_STEPS):
        state, _ = step(state, {"tokens": torch.from_numpy(
            inp[f"{pre}_train"][i])})
    for path, t in _paths(state["params"]):
        out[f"{pre}/one/params{path}"] = _np(t)


def run_config(inp, name, plan, out):
    from repro_torch.checkpoint import gather_state
    from repro_torch.configs import get
    from repro_torch.core.plan import reset_fsdp_gathered
    from repro_torch.models.lm import LM
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime.steps import (gather_logits, make_decode_step,
                                           make_prefill_step, make_train_step)
    cfg = get(name).reduced()
    pre = prefix(name)
    whole = _params(inp, name, LM(cfg).param_defs())
    opt, state = _state(cfg, plan, whole)
    out[f"{pre}/local_numel"] = np.asarray(
        [t.numel() for _, t in _paths(state["params"])])
    step = make_train_step(cfg, plan, cosine_warmup(TRAIN_LR, 20,
                                                    TRAIN_STEPS))
    losses = []
    for i in range(TRAIN_STEPS):
        reset_fsdp_gathered()
        state, m = step(state, {"tokens": torch.from_numpy(
            inp[f"{pre}_train"][i])})
        losses.append(float(m["loss"]))
        _gathered(out, f"{pre}/train{i}")
    out[f"{pre}/losses"] = np.asarray(losses)
    full = gather_state(cfg, state, plan, opt)
    for path, t in _paths(full["params"]):
        out[f"{pre}/params{path}"] = _np(t)
    _train_one(inp, cfg, name, out)

    _, state = _state(cfg, plan, whole)
    reset_fsdp_gathered()
    logits, caches = make_prefill_step(cfg, plan, CACHE_LEN)(
        state["params"], {"tokens": torch.from_numpy(inp[f"{pre}_prompt"])})
    _gathered(out, f"{pre}/prefill")
    out[f"{pre}/prefill_logits"] = _np(gather_logits(logits, plan, cfg,
                                                     B_PROMPT))
    reset_fsdp_gathered()
    make_decode_step(cfg, plan, CACHE_LEN)(
        state["params"], caches,
        {"token": torch.from_numpy(inp[f"{pre}_decode"]),
         "pos": torch.tensor(S_PROMPT, dtype=torch.int32)})
    _gathered(out, f"{pre}/decode")


def rank_main(inp_path: str) -> dict:
    """Every config on this rank; returns ``{name: array}``."""
    torch.set_num_threads(1)
    from repro_torch.core import spmd
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.launch.mesh import make_mesh
    inp = dict(np.load(inp_path))
    plan = ShardingPlan(make_mesh(MESH, ("data", "model"), "cpu"))
    out = {"rank": np.asarray(spmd.rank())}
    for name in CONFIGS:
        run_config(inp, name, plan, out)
    return out


if __name__ == "__main__":
    raise SystemExit("imported by tests/test_torch_fsdp_gather.py")
