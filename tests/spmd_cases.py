"""The rank side of ``tests/test_torch_spmd.py``: every case runs in each of
four gloo ranks on the CPU (``core.spmd.launch``), on the inputs the test
wrote with numpy, and returns what the test holds against the JAX
package's side (``tests/spmd_reference.py``).  Imports only torch, numpy
and the port, so a rank starts without JAX.

Meshes, each built on every rank in this order (a ``DeviceMesh`` is a
collective): ``data`` 4 (farm_map), ``stage`` 4 (pipeline_shard),
(``data`` 2, ``model`` 2) (tensor_map, flash_decode_combine, the a2a hop,
the vocab-parallel loss), and two (``data`` 2, ``model`` 1) meshes, ranks
0-1 and 2-3, which run the train steps and the restore side by side.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import time

import numpy as np
import torch

B_TRAIN, S_TRAIN, TRAIN_STEPS, TRAIN_LR = 4, 16, 2, 1e-6
# reduced Kimi-K2 at widths of 128 (d_model, moe_d_ff, d_ff), so that
# Adafactor factors its matrices' second moments (it does from 128 on) and
# fsdp splits the factored dims
KIMI_WIDTHS = (128, 128, 256)


def kimi_wide(get):
    return dataclasses.replace(get("kimi-k2-1t-a32b").reduced(),
                               **dict(zip(("d_model", "moe_d_ff", "d_ff"),
                                          KIMI_WIDTHS)))


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _params(inp, prefix, like):
    """The tree of ``like`` (a def tree) from the ``prefix/...`` arrays."""
    def walk(d, path):
        if isinstance(d, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in d.items()}
        return torch.from_numpy(np.array(inp[path], dtype=np.float32))
    return walk(like, prefix)


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


def _train_one(inp, cfg, prefix, out, tag):
    """The same steps on one device in two micro-batches of half the batch
    (each routed apart, as each of two ranks routes its own tokens)."""
    from repro_torch.core.plan import single_device_plan
    from repro_torch.models.lm import LM
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.optim import make_optimizer
    params = _params(inp, prefix, LM(cfg).param_defs())
    opt = make_optimizer(cfg.optimizer)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    steps = int(inp["train_steps"])
    step = make_train_step(cfg, single_device_plan("cpu"), cosine_warmup(
        float(inp["train_lr"]), 20, steps), n_micro=2)
    for i in range(steps):
        state, _ = step(state, {"tokens": torch.from_numpy(
            inp[f"{prefix}_tok"][i])})
    for path, t in _paths(state["params"]):
        out[f"{tag}/params{path}"] = _np(t)


def _train(inp, cfg, prefix, plan, out, tag):
    """``TRAIN_STEPS`` steps of ``make_train_step`` from the test's fp32
    parameters; the losses, the whole parameters after, and this rank's
    block sizes between steps."""
    from repro_torch.checkpoint import gather_state
    from repro_torch.models.lm import LM
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime.steps import (make_train_step, param_shards,
                                           state_shardings)
    opt = make_optimizer(cfg.optimizer)
    whole = _params(inp, prefix, LM(cfg).param_defs())
    sh = state_shardings(cfg, plan, opt)
    from repro_torch.core.tree import tree_map
    local = tree_map(lambda t, s: s.local_block(t).clone(), whole,
                     sh["params"])
    state = {"params": local,
             "opt": opt.init(local, param_shards(cfg, plan, opt)),
             "step": torch.zeros((), dtype=torch.int32)}
    steps = int(inp["train_steps"])
    step = make_train_step(cfg, plan, cosine_warmup(
        float(inp["train_lr"]), 20, steps))
    losses = []
    for i in range(steps):
        state, m = step(state, {"tokens": torch.from_numpy(
            inp[f"{prefix}_tok"][i])})
        losses.append(float(m["loss"]))
    out[f"{tag}/losses"] = np.asarray(losses)
    out[f"{tag}/local_numel"] = np.asarray(
        [t.numel() for _, t in _paths(state["params"])])
    full = gather_state(cfg, state, plan, opt)
    for path, t in _paths(full["params"]):
        out[f"{tag}/params{path}"] = _np(t)


def rank_main(inp_path: str, ckpt_dir: str) -> dict:
    """Every case on this rank; returns ``{name: array}``."""
    torch.set_num_threads(1)
    from repro_torch.configs import get
    from repro_torch.core import device as D
    from repro_torch.core import spmd
    from repro_torch.core.plan import P, ShardingPlan
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import vocab_parallel_ce, vocab_parallel_embed
    inp = dict(np.load(inp_path))
    rank = spmd.rank()
    t_ = lambda k: torch.from_numpy(np.array(inp[k]))
    out = {}

    m_data = make_mesh((4,), ("data",), "cpu")
    m_stage = make_mesh((4,), ("stage",), "cpu")
    m22 = make_mesh((2, 2), ("data", "model"), "cpu")
    pair_a = make_mesh((2, 1), ("data", "model"), "cpu", ranks=[0, 1])
    pair_b = make_mesh((2, 1), ("data", "model"), "cpu", ranks=[2, 3])

    # farm_map, with and without reduce_outputs
    w = t_("farm_w")
    out["farm"] = _np(D.farm_map(lambda x: torch.tanh(x @ w), m_data)(
        t_("farm_x")))
    out["farm_reduce"] = _np(D.farm_map(
        lambda x: x.sum(0), m_data, reduce_outputs=True)(t_("farm_x")))

    # tensor_map: reduce (col-parallel contributions) and gather
    out["tm_reduce"] = _np(D.tensor_map(
        lambda a, b: a @ b, m22, axis="model",
        split_spec=(P(None, "model"), P("model", None)),
        compose="reduce")(t_("tm_a"), t_("tm_b")))
    out["tm_gather"] = _np(D.tensor_map(
        lambda x, w: x @ w, m22, axis="model",
        split_spec=(P(), P(None, "model")), out_axis=1)(t_("tm_x"), t_("tm_w")))

    # pipeline: 4 stages, 8 microbatches
    run = D.pipeline_shard(lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                           m_stage, "stage", n_microbatches=8)
    out["pipe"] = _np(run({"w": t_("pipe_w"), "b": t_("pipe_b")},
                          t_("pipe_x")))

    # flash-decode combine over the model axis (KV split along S)
    def local_attn(q, kl, vl):
        d = q.shape[-1]
        s = torch.einsum("bhd,bkhd->bhk", q, kl) / np.sqrt(d)
        m = torch.amax(s, -1)
        p = torch.exp(s - m[..., None])
        o = torch.einsum("bhk,bkhd->bhd", p, vl) / torch.clamp(
            p.sum(-1), min=1e-30)[..., None]
        lse = torch.log(p.sum(-1)) + m
        return D.flash_decode_combine(o, lse, "model")
    kv = P(None, "model", None, None)
    out["flash_decode"] = _np(spmd.shard_map(
        local_attn, m22, (P(), kv, kv), P())(t_("fd_q"), t_("fd_k"),
                                             t_("fd_v")))

    # the a2a hop per data shard, lossless
    # the experts' constants as Python floats (a Pallas kernel takes no
    # captured arrays); one rounding each, so XLA has no multiply-add to
    # contract into an FMA
    c, dd = [float(v) for v in inp["a2a_c"]], [float(v) for v in inp["a2a_d"]]
    lefts = [lambda x: x * 2.0 + 1.0, lambda x: x - 3.0]
    rights = [(lambda y, e=e: y * c[e]) if e % 2 else
              (lambda y, e=e: y + dd[e]) for e in range(4)]
    xs = t_("a2a_x")
    hop = D.a2a_dispatch(lefts, rights, mesh=m22, axis="data")
    out["a2a"] = _np(hop(xs, torch.arange(xs.shape[0], dtype=torch.int32)))

    # vocab-parallel embedding and loss at tp 2, with gradients
    plan22 = ShardingPlan(m22)
    emb = t_("vp_emb").requires_grad_(True)
    e = vocab_parallel_embed(t_("vp_tok"), emb, plan22)
    (ge,) = torch.autograd.grad((e.float() ** 2).sum(), [emb])
    out["vp_embed"], out["vp_embed_grad"] = _np(e), _np(ge)
    x = t_("vp_x").requires_grad_(True)
    wv = t_("vp_w").requires_grad_(True)
    loss = vocab_parallel_ce(x, wv, t_("vp_lab"), t_("vp_mask"), plan22)
    gx, gw = torch.autograd.grad(loss, [x, wv])
    out["vp_loss"], out["vp_gx"], out["vp_gw"] = _np(loss), _np(gx), _np(gw)

    # train steps on the two data=2 meshes side by side, then Adafactor
    # (pair a) and the restore of the reference's checkpoint (pair b)
    mix = get("mixtral-8x7b").reduced()
    if pair_a is not None:
        _train(inp, mix, "mix", ShardingPlan(pair_a), out, "train_fsdp")
        _train(inp, kimi_wide(get), "kimi", ShardingPlan(pair_a), out,
               "adafactor")
        if rank == 0:
            _train_one(inp, kimi_wide(get), "kimi", out, "adafactor_one")
        else:
            _train_one(inp, mix, "mix", out, "train_one")
    else:
        _train(inp, mix, "mix", ShardingPlan(pair_b, fsdp_params=False),
               out, "train_dp")
        out.update(_restore(mix, ShardingPlan(pair_b), ckpt_dir))
    out["rank"] = np.asarray(rank)
    return out


def _restore(cfg, plan, ckpt_dir: str) -> dict:
    """The reference's checkpoint placed onto ``plan`` by reshard_state:
    this rank's block of every leaf."""
    from repro_torch.checkpoint import host_state, reshard_state
    done = pathlib.Path(ckpt_dir) / "done"
    t0 = time.monotonic()
    while not done.exists():                 # the reference writes it
        if time.monotonic() - t0 > 120:
            raise TimeoutError("no reference checkpoint")
        time.sleep(0.1)
    state = reshard_state(cfg, host_state(ckpt_dir, cfg, plan), plan)
    return {f"restore{p}": _np(t) for p, t in _paths(state)}


if __name__ == "__main__":
    raise SystemExit("imported by tests/test_torch_spmd.py")
