"""The rank side of ``tests/test_torch_tp_families.py``: every case runs in
each of four gloo ranks on the CPU (``core.spmd.launch``), on the inputs the
test wrote with numpy, and returns what the test holds against the JAX
package's side (``tests/tp_family_reference.py``, which imports this module
for the case list).  Imports only torch, numpy and the port, so a rank
starts without JAX.

A case is a reduced config of the encdec, vlm or ssm family, or of one
with context-parallel attention, on a ``(data, model)`` mesh of the four
ranks, ``(2, 2)`` or ``(1, 4)``: two train steps, a prefill and
``DECODE_STEPS`` decode steps through ``make_train_step``/
``make_prefill_step``/``make_decode_step`` from the same parameters, and
this rank's block of everything they return.  Three mutants run beside
them, each with one piece of the sharded model broken (``MUTANTS``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TRAIN_STEPS = 2
B_TRAIN, S_TRAIN = 4, 16
B_PROMPT, S_PROMPT, CACHE_LEN, DECODE_STEPS = 2, 16, 32, 4
S_ENC = 32                    # Whisper's frames (the reduced enc_len is 64)
# the configs: reduced Whisper (2 kv heads: the self-attention cache in the
# head_dim layout, the cross cache over the kv heads where they divide the
# model axis) and a 16-kv-head Whisper (the heads layout of both, which
# full width takes); reduced Qwen2-VL fed tokens and fed embeddings with
# M-RoPE ids; reduced xLSTM, and at 2 heads (a model axis of 4 splits
# the mLSTM's projection columns within a head: its heads stay whole);
# reduced Llama-3.2-3B (cp), also at a prompt
# of 14, which a model axis of 4 does not divide (the sequence stays
# whole) and one of 2 does; reduced Zamba2 with 2 Mamba2 groups (each
# rank's heads read their own group: the heads split over the model axis,
# wB/wC whole)
CONFIGS = ("whisper-medium", "whisper-kv16", "qwen2-vl-2b", "qwen2-vl-embeds",
           "xlstm-125m", "xlstm-h2", "llama3.2-3b", "llama3.2-3b-s14",
           "zamba2-g2")
KV16 = {"n_heads": 16, "n_kv_heads": 16}
# the configs that only serve: the prompt of 14 (the train step is
# llama3.2-3b's).  xLSTM at 2 heads trains: its wi/wf (d_inner, 2) a
# model axis of 4 leaves whole, and so its AdamW moments (the state's
# shardings fitted to each moment's shape)
SERVE_ONLY = ("llama3.2-3b-s14",)
MESHES = ((2, 2), (1, 4))
CASES = [(name, shape) for shape in MESHES for name in CONFIGS]
# (mutant, case it runs on): cp attention with every key instead of the
# prefix up to the block's last row; the gradient sum over the model axis
# removed (cp's replicated attention weights); the mLSTM state's heads one
# block off (each rank keeps the next rank's)
MUTANTS = (("cp_full_keys", ("llama3.2-3b", (1, 4))),
           ("no_model_grad_sum", ("llama3.2-3b", (2, 2))),
           ("mlstm_heads_one_block_off", ("xlstm-125m", (1, 4))))


def base(name: str) -> str:
    """The registered config a case name reduces."""
    return {"whisper-kv16": "whisper-medium",
            "qwen2-vl-embeds": "qwen2-vl-2b", "xlstm-h2": "xlstm-125m",
            "llama3.2-3b-s14": "llama3.2-3b",
            "zamba2-g2": "zamba2-1.2b"}.get(name, name)


def config(get, name):
    """The reduced config of a case (either package's ``get``)."""
    cfg = get(base(name)).reduced()
    if name == "whisper-kv16":
        cfg = dataclasses.replace(cfg, **KV16)
    if name == "xlstm-h2":
        cfg = dataclasses.replace(cfg, n_heads=2)
    if name == "zamba2-g2":
        cfg = dataclasses.replace(cfg, ssm_groups=2)
    return cfg


def bf16_params(name: str) -> bool:
    """Whisper runs on bf16 parameters: the reference's encdec steps do not
    trace with fp32 ones (the cross attention's fp32 output turns its layer
    scan's bf16 carry to fp32)."""
    return base(name) == "whisper-medium"


def train_lr(name: str) -> float:
    """The peak rate: 1e-6 (an update of about lr x its gradient's sign,
    below every rounding), Whisper's 1e-3, so that the bf16 parameters
    move at all (their ulp is ~1e-3 of an element)."""
    return 1e-3 if bf16_params(name) else 1e-6


def s_prompt(name: str) -> int:
    return 14 if name.endswith("-s14") else S_PROMPT


def prefix(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def key(case) -> str:
    name, shape = case
    return f"{prefix(name)}@{shape[0]}x{shape[1]}"


def extras(inp, name: str, what: str, i=None) -> dict:
    """The batch's inputs besides the tokens (numpy): Whisper's frames,
    the embeddings and M-RoPE ids of ``qwen2-vl-embeds``; ``what`` is
    ``train`` (step ``i``) or ``prompt``."""
    pre = prefix(name)
    out = {}
    for k in ("frames", "embeds", "mrope_positions"):
        a = inp.get(f"{pre}_{what}_{k}")
        if a is not None:
            out[k] = a if i is None else a[i]
    return out


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


def _params(inp, name, like):
    pre = prefix(name)

    def walk(d, path):
        if isinstance(d, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in d.items()}
        t = torch.from_numpy(np.array(inp[path], dtype=np.float32))
        return t.to(d.dtype) if bf16_params(name) else t
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


def _batch(tokens, more) -> dict:
    b = {"tokens": torch.from_numpy(tokens)}
    b.update({k: torch.from_numpy(v) for k, v in more.items()})
    return b


def _train(inp, cfg, plan, name, out, tag):
    from repro_torch.checkpoint import gather_state
    from repro_torch.models.lm import LM
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime.steps import make_train_step
    pre = prefix(name)
    whole = _params(inp, name, LM(cfg).param_defs())
    opt, state = _state(cfg, plan, whole)
    for path, t in _paths(state["params"]):
        out[f"{tag}/pshape{path}"] = np.asarray(t.shape)
    for path, t in _paths(state["opt"]):
        out[f"{tag}/oshape{path}"] = np.asarray(t.shape)
    step = make_train_step(cfg, plan, cosine_warmup(train_lr(name), 20,
                                                    TRAIN_STEPS))
    losses, norms = [], []
    for i in range(TRAIN_STEPS):
        state, m = step(state, _batch(inp[f"{pre}_train"][i],
                                      extras(inp, name, "train", i)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[f"{tag}/losses"] = np.asarray(losses)
    out[f"{tag}/grad_norms"] = np.asarray(norms)
    full = gather_state(cfg, state, plan, opt)
    for path, t in _paths(full["params"]):
        out[f"{tag}/params{path}"] = _np(t)


def _serve(inp, cfg, plan, name, out, tag, rank, decode=True):
    from repro_torch.models.lm import LM
    from repro_torch.runtime.steps import (make_decode_step,
                                           make_prefill_step)
    pre = prefix(name)
    whole = _params(inp, name, LM(cfg).param_defs())
    _, state = _state(cfg, plan, whole)
    params = state["params"]
    logits, caches = make_prefill_step(cfg, plan, CACHE_LEN)(
        params, _batch(inp[f"{pre}_prompt"], extras(inp, name, "prompt")))
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
                 "pos": torch.tensor(s_prompt(name) + i, dtype=torch.int32)}
        nt, logits, caches = step(params, caches, batch)
        toks.append(_np(nt))
        out[f"{tag}/decode{i}_logits@{rank}"] = _np(logits)
    out[f"{tag}/decode_tokens"] = np.stack(toks)
    for path, t in _paths(caches):
        out[f"{tag}/decode_cache{path}@{rank}"] = _np(t)
        out[f"{tag}/dshape{path}"] = np.asarray(t.shape)


def _mutant(name: str):
    """Patch one piece of the sharded model; returns the undo."""
    from repro_torch.core import spmd
    from repro_torch.models import attention, lm, xlstm
    from repro_torch.runtime import steps
    if name == "cp_full_keys":
        orig = attention._causal_prefix
        attention._causal_prefix = lambda tp, k, v, rows: (k, v)
        return lambda: setattr(attention, "_causal_prefix", orig)
    if name == "no_model_grad_sum":
        orig = steps.reduce_grads
        steps.reduce_grads = lambda g, s, axes, replicated=(): orig(g, s,
                                                                  axes)
        return lambda: setattr(steps, "reduce_grads", orig)
    orig = xlstm.mlstm_block

    def shifted(x, p, cfg, *, state=None, plan=None, **kw):
        y, st = orig(x, p, cfg, state=state, plan=plan, **kw)
        if state == "init" and plan is not None:   # the next rank's heads
            m = plan.model_axis()
            n = spmd.axis_size(m)
            perm = [(i, (i - 1) % n) for i in range(n)]
            st = dict(st, C=spmd.ppermute(st["C"], m, perm),
                      n=spmd.ppermute(st["n"], m, perm))
        return y, st
    lm.mlstm_block = shifted
    return lambda: setattr(lm, "mlstm_block", orig)


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
        if name not in SERVE_ONLY:
            _train(inp, cfg, plan, name, out, key(case))
        _serve(inp, cfg, plan, name, out, key(case), rank)
    for mutant, case in MUTANTS:
        name, shape = case
        cfg, plan = config(get, name), ShardingPlan(meshes[shape])
        tag = f"{mutant}/{key(case)}"
        undo = _mutant(mutant)
        try:
            if mutant == "no_model_grad_sum":
                _train(inp, cfg, plan, name, out, tag)
            else:
                _serve(inp, cfg, plan, name, out, tag, rank, decode=False)
            out[f"{tag}/raised"] = np.asarray(0)
        except Exception as e:              # noqa: BLE001 - the mutant
            out[f"{tag}/raised"] = np.asarray(1)
            out[f"{tag}/error"] = np.asarray(repr(e)[:200])
        finally:
            undo()
    out["rank"] = np.asarray(rank)
    return out


if __name__ == "__main__":
    raise SystemExit("imported by tests/test_torch_tp_families.py")
