"""The rank side of ``tests/test_torch_tp_layout.py``: two gloo ranks on the
CPU (``core.spmd.launch``).  Imports only torch, numpy and the port.

* ``one_rank``: on a ``(1, 1)`` mesh over rank 0 alone, the train, prefill
  and decode steps of reduced configs against the same steps on a
  one-device plan, bit for bit;
* ``reshard``: a one-device checkpoint placed onto the ``(1, 2)`` mesh by
  ``reshard_state`` (reduced Mixtral, and in ``reshard_families`` one
  config of each kind the later families add);
* ``lock_step``: an ``InferenceEngine`` per rank over the ``(1, 2)`` mesh,
  the same requests submitted at each rank's own pace; on rank 0, the
  logits of a one-device greedy loop fed the engines' tokens (reduced
  Mixtral, and in ``lock_step_families`` Llama-3.2-3B with
  context-parallel attention, Qwen2-VL fed tokens and xLSTM).
"""

from __future__ import annotations

import pathlib
import random
import time

import numpy as np
import torch

ONE_RANK = ("ff-tiny", "mixtral-8x7b", "zamba2-1.2b", "llama3.2-3b",
            "xlstm-125m")
ENGINE_ARCH, ENGINE_REQUESTS, ENGINE_NEW = "mixtral-8x7b", 6, 5
# the engine over the families served in lock step since the encdec, vlm
# and ssm slice (Whisper goes through the steps)
ENGINE_FAMILIES = ("llama3.2-3b", "qwen2-vl-2b", "xlstm-125m")
# one config of each block kind that slice runs over the model axis
# (enc/dec, cp attention with M-RoPE, mlstm/slstm)
RESHARD_FAMILIES = ("whisper-medium", "qwen2-vl-2b", "xlstm-125m")


def _np(t):
    return np.array((t.float() if t.dtype == torch.bfloat16 else t)
                    .detach().cpu())


def _state(cfg, plan, seed=0):
    from repro_torch.runtime.steps import init_state
    return init_state(cfg, plan, torch.Generator().manual_seed(seed))


def _steps(cfg, plan):
    """Two train steps, a prefill and two decode steps from seed 0:
    every output (losses, parameters, logits, caches, tokens)."""
    from repro_torch.core.tree import jax_leaves
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime.steps import (make_decode_step,
                                           make_prefill_step, make_train_step)
    g = torch.Generator().manual_seed(1)
    state = _state(cfg, plan)
    step = make_train_step(cfg, plan, cosine_warmup(1e-3, 2, 4))
    out = []
    for _ in range(2):
        tok = torch.randint(0, cfg.vocab, (2, 16), generator=g,
                            dtype=torch.int32)
        state, m = step(state, {"tokens": tok})
        out += [m["loss"], m["grad_norm"]]
    params = state["params"]
    out += jax_leaves(params)
    prompt = torch.randint(0, cfg.vocab, (2, 16), generator=g,
                           dtype=torch.int32)
    logits, caches = make_prefill_step(cfg, plan, 32)(params,
                                                      {"tokens": prompt})
    out += [logits] + [t.clone() for t in jax_leaves(caches)]
    decode = make_decode_step(cfg, plan, 32)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    for i in range(2):
        tok, logits, caches = decode(params, caches, {
            "token": tok, "pos": torch.tensor(16 + i, dtype=torch.int32)})
        out += [tok, logits] + [t.clone() for t in jax_leaves(caches)]
    return [_np(t) for t in out]


def one_rank(mesh11) -> dict:
    from repro_torch.configs import get
    from repro_torch.core.plan import ShardingPlan, single_device_plan
    out = {}
    for name in ONE_RANK:
        cfg = get(name).reduced()
        a = _steps(cfg, ShardingPlan(mesh11))
        b = _steps(cfg, single_device_plan("cpu"))
        out[name] = all(x.shape == y.shape and np.array_equal(x, y)
                        for x, y in zip(a, b)) and len(a) == len(b)
    return out


def reshard(plan, ckpt_dir: str, arch: str = "mixtral-8x7b") -> dict:
    """A one-device state of reduced ``arch`` saved by rank 0, placed onto
    ``plan``: (every block equal to its slice of the saved whole, leaves)."""
    from repro_torch.checkpoint import host_state, reshard_state
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get
    from repro_torch.core import spmd
    from repro_torch.core.plan import single_device_plan
    from repro_torch.core.tree import jax_leaves
    from repro_torch.runtime.steps import state_shardings
    cfg = get(arch).reduced()
    whole = _state(cfg, single_device_plan("cpu"), seed=3)
    if spmd.rank() == 0:
        save_checkpoint(ckpt_dir, 0, whole)
    spmd.all_sum(torch.zeros(1), plan.mesh, plan.mesh.axis_names)  # saved
    state = reshard_state(cfg, host_state(ckpt_dir, cfg, plan), plan)
    sh = state_shardings(cfg, plan)
    equal, split = True, 0
    for t, s, w in zip(jax_leaves(state), jax_leaves(sh), jax_leaves(whole)):
        equal &= torch.equal(t, s.local_block(w))
        split += t.shape != w.shape
    return {"equal": equal, "split": split, "leaves": len(jax_leaves(state))}


def lock_step(plan, arch: str = ENGINE_ARCH) -> dict:
    """The same requests on each rank's engine, rank 1 submitting each
    after a random pause (and its engine starting late): the tokens, the
    finish reasons and the decode steps each engine took."""
    from repro_torch.configs import get
    from repro_torch.core import spmd
    from repro_torch.serving.engine import InferenceEngine, Request
    cfg = get(arch).reduced()
    params = _state(cfg, plan)["params"]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, int(n), dtype=np.int32)
               for n in rng.integers(3, 20, ENGINE_REQUESTS)]
    pause = random.Random(spmd.rank() * 101 + 5)
    if spmd.rank() == 1:
        time.sleep(0.3)
    eng = InferenceEngine(cfg, plan, params, max_batch=2, cache_len=64)
    handles = []
    with eng:
        for i, p in enumerate(prompts):
            if spmd.rank() == 1:
                time.sleep(pause.uniform(0.0, 0.05))
            # the last request's deadline has passed when it arrives
            handles.append(eng.submit(Request(
                p, max_new_tokens=ENGINE_NEW, id=i,
                deadline_s=0.0 if i == len(prompts) - 1 else None)))
        outs = [h.result(timeout=120) for h in handles]
    return {"tokens": [list(getattr(o, "tokens", [])) for o in outs],
            "reasons": [getattr(o, "finish_reason", type(o).__name__)
                        for o in outs],
            "steps": eng.steps, "prompts": [p.tolist() for p in prompts]}


def one_device_logits(served: dict, arch: str = ENGINE_ARCH) -> list:
    """Per request the lock-step engines served, the logits a one-device
    greedy loop of ``make_prefill_step``/``make_decode_step`` on the same
    weights (the whole seed-0 draw) gives before each of its tokens, fed
    the engine's tokens: the prefill's last row, then each decode step's."""
    from repro_torch.configs import get
    from repro_torch.core.plan import single_device_plan
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    cfg = get(arch).reduced()
    one = single_device_plan("cpu")
    params = _state(cfg, one)["params"]
    prefill = make_prefill_step(cfg, one, 64)
    decode = make_decode_step(cfg, one, 64)
    out = []
    for prompt, toks in zip(served["prompts"], served["tokens"]):
        if not toks:
            out.append([])
            continue
        logits, caches = prefill(params, {"tokens": torch.tensor(
            prompt, dtype=torch.int32)[None]})
        rows = [_np(logits[0, -1])]
        for i, t in enumerate(toks[:-1]):
            _, logits, caches = decode(params, caches, {
                "token": torch.tensor([[t]], dtype=torch.int32),
                "pos": torch.tensor(len(prompt) + i, dtype=torch.int32)})
            rows.append(_np(logits[0, -1]))
        out.append(rows)
    return out


def backward_thread(plan) -> bool:
    """Reduced Mixtral's loss over the (1, 2) mesh, its gradient taken in
    this thread and again in another one outside every manual region (as
    autograd's device thread runs a CUDA backward, recomputing the
    checkpointed blocks there): equal bit for bit."""
    import threading
    from repro_torch.configs import get
    from repro_torch.core import spmd
    from repro_torch.core.tree import jax_leaves
    from repro_torch.models.lm import LM
    cfg = get("mixtral-8x7b").reduced()
    leaves = jax_leaves(_state(cfg, plan)["params"])
    tok = torch.randint(0, cfg.vocab, (2, 16),
                        generator=torch.Generator().manual_seed(2),
                        dtype=torch.int32)

    def loss():
        ps = [t.detach().requires_grad_(True) for t in leaves]
        params = _state(cfg, plan)["params"]
        from repro_torch.core.tree import jax_unflatten
        with spmd.manual(plan.mesh, plan.mesh.axis_names):
            out, _ = LM(cfg).loss(jax_unflatten(params, ps),
                                  {"tokens": tok}, plan)
        return out, ps
    out, ps = loss()
    here = torch.autograd.grad(out, ps, allow_unused=True)
    out, ps = loss()
    got = {}
    th = threading.Thread(target=lambda: got.update(
        g=torch.autograd.grad(out, ps, allow_unused=True)))
    th.start()
    th.join()
    return all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(here, got["g"]))


def rank_main(ckpt_dir: str) -> dict:
    torch.set_num_threads(1)
    from repro_torch.core import spmd
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.launch.mesh import make_mesh
    mesh11 = make_mesh((1, 1), ("data", "model"), "cpu", ranks=[0])
    mesh12 = make_mesh((1, 2), ("data", "model"), "cpu")
    plan = ShardingPlan(mesh12)
    out = {"one_rank": one_rank(mesh11) if mesh11 is not None else None}
    out["reshard"] = reshard(plan, str(pathlib.Path(ckpt_dir)))
    out["reshard_families"] = {a: reshard(plan, str(pathlib.Path(
        ckpt_dir) / a), a) for a in RESHARD_FAMILIES}
    out["lock_step"] = lock_step(plan)
    out["lock_step_one_device"] = one_device_logits(out["lock_step"]) \
        if spmd.rank() == 0 else None
    out["lock_step_families"] = {}
    for arch in ENGINE_FAMILIES:
        served = lock_step(plan, arch)
        out["lock_step_families"][arch] = (served, one_device_logits(
            served, arch) if spmd.rank() == 0 else None)
    out["backward_thread"] = backward_thread(plan)
    return out


if __name__ == "__main__":
    raise SystemExit("imported by tests/test_torch_tp_layout.py")
