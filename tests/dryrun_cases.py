"""The rank side of ``tests/test_torch_dryrun.py``: one reduced config of
each family through the train, prefill and decode steps on a ``(2, 2)``
``(data, model)`` mesh, run for real on the CPU ranks ``core.spmd.launch``
spawns, with the dry run's recorders on (imports no JAX: a rank starts
without it).

Each step runs once, on parameters drawn from a seed, the global batch
from numpy (the same on every rank), zero caches for decode; under
``torch.utils.flop_counter.FlopCounterMode`` and
``launch.hlo_analysis.StepAnalysis``.  A rank returns, per case, its
collective records in order, each kernel wrapper's calls and work, the
FlopCounterMode total and the analysis's own FLOPs, bytes and memory
peak.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import batch_specs, cache_specs, get
from repro_torch.core.plan import ShardingPlan
from repro_torch.launch.dryrun import LR, MODE_SHAPE
from repro_torch.launch.hlo_analysis import StepAnalysis
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import params as pp
from repro_torch.models.lm import LM
from repro_torch.optim import make_optimizer
from repro_torch.runtime.steps import (init_state, make_decode_step,
                                       make_prefill_step, make_train_step)

# one config a family: dense (heads), moe, hybrid, ssm, encdec, vlm (cp),
# and dense under context-parallel attention
CONFIGS = ("gemma-7b", "mixtral-8x7b", "zamba2-1.2b", "xlstm-125m",
           "whisper-medium", "qwen2-vl-2b", "llama3.2-3b")
MODES = ("train", "prefill", "decode")
MESH = (2, 2)
B, S = 4, 32


def config(name: str):
    return get(name).reduced()


def plan_of(device="cpu") -> ShardingPlan:
    return ShardingPlan(mesh=make_mesh(MESH, ("data", "model"), device))


def batch_of(cfg, mode: str, seed: int = 0) -> dict:
    """The global batch of ``batch_specs``' shapes and types, from numpy:
    tokens in the vocabulary, M-RoPE ids and the decode position inside
    the sequence, embeddings and frames at 0.1."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, t in batch_specs(cfg, MODE_SHAPE[mode], batch=B, seq=S).items():
        shape = tuple(t.shape)
        if k == "pos":
            a = np.full(shape, S // 2, np.int32)
        elif k == "mrope_positions":
            a = rng.integers(0, S, shape, dtype=np.int32)
        elif t.dtype == torch.int32:
            a = rng.integers(0, cfg.vocab, shape, dtype=np.int32)
        else:
            a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        out[k] = torch.from_numpy(a).to(t.dtype)
    return out


def step_args(cfg, mode: str, plan):
    """(step, args) for ``mode`` on this rank's blocks."""
    batch = batch_of(cfg, mode)
    gen = torch.Generator().manual_seed(0)
    if mode == "train":
        opt = make_optimizer(cfg.optimizer)
        return (make_train_step(cfg, plan, LR, opt),
                (init_state(cfg, plan, gen, opt), batch))
    params = pp.init_blocks(LM(cfg).param_defs(), gen, plan)
    if mode == "prefill":
        return make_prefill_step(cfg, plan, cache_len=S), (params, batch)
    caches = cache_specs(cfg, B, S, plan)
    caches = {k: _zeros(v) for k, v in caches.items()}
    return make_decode_step(cfg, plan, cache_len=S), (params, caches, batch)


def _zeros(t):
    if isinstance(t, dict):
        return {k: _zeros(v) for k, v in t.items()}
    return torch.zeros(t.sharding.local_shape(t.shape), dtype=t.dtype)


def record(stat: StepAnalysis) -> list:
    return [(c["kind"], c["operand_bytes"], c["group_size"], c["axis"],
             c["net"]) for c in stat.collectives]


def rank_main() -> dict:
    # torch._dynamo (the first activation checkpoint's import, which makes
    # tensors) imported before any step, as the dry run does
    import torch._dynamo  # noqa: F401
    from torch.utils.flop_counter import FlopCounterMode
    torch.set_num_threads(1)
    plan = plan_of()
    out = {}
    for name in CONFIGS:
        for mode in MODES:
            cfg = config(name)
            step, args = step_args(cfg, mode, plan)
            stat = StepAnalysis()
            stat.hold(args)
            with FlopCounterMode(display=False) as fc, stat.recording():
                step(*args)
            out[(name, mode)] = {
                "collectives": record(stat), "kernels": stat.kernels,
                "flop_counter": fc.get_total_flops(), "flops": stat.flops,
                "bytes": stat.bytes, "peak": stat.peak}
    return out
