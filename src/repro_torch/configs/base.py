"""Architecture config schema and the assigned shape grid.

A copy of ``src/repro/configs/base.py`` (``Config``, ``SHAPES``,
``reduced()``).  Its ``ShapeDtypeStruct`` stand-ins (``_sds``,
``batch_specs``, ``cache_specs``) are meta tensors of the global shape and
type here, each with its ``sharding`` (a
:class:`~repro_torch.core.plan.TorchSharding`), as
``models.params.shape_structs`` makes the parameters'; the dry run
(``launch/dryrun.py``) reads them.  The parameter counts walk the port's own
``ParamDef`` tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch


# the assigned shape grid (LM transformer shapes) -----------------------------
SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k":    {"seq": 4096,   "batch": 256, "mode": "train"},
    "prefill_32k": {"seq": 32768,  "batch": 32,  "mode": "prefill"},
    "decode_32k":  {"seq": 32768,  "batch": 128, "mode": "decode"},
    "long_500k":   {"seq": 524288, "batch": 1,   "mode": "decode"},
}


@dataclasses.dataclass
class Config:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    source: str = ""                 # provenance note

    # attention
    attn_kind: str = "full"          # full | swa
    window: int = 0
    rope_theta: float = 1e4
    use_rope: bool = True
    mrope: bool = False
    attn_parallel: str = "heads"     # heads | cp
    padded_heads: int = 0            # TP head padding (deployment option)
    n_kv_eff: int = 0                # kv heads after TP replication
    cache_len: Optional[int] = None  # set by prefill()/cache_defs()

    # norms / activations
    norm: str = "rms"                # rms | ln
    act: str = "silu"                # silu | gelu

    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_mode: str = "ep"             # ep | tp

    # ssm / linear recurrence
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    gla_chunk: int = 256

    # hybrid (zamba) / encdec (whisper)
    shared_attn_window: int = 0
    segments_spec: Optional[List[Tuple[str, int]]] = None
    enc_layers: int = 0
    dec_layers: int = 0
    enc_len: int = 4096              # cross-attention context at decode

    # training
    tie_embeddings: bool = False
    optimizer: str = "adamw"         # adamw | adafactor
    loss_chunks: int = 1
    n_microbatches: int = 1
    q_block: int = 2048
    kv_block: int = 2048
    use_pallas: bool = False         # read by the reference's dry run only

    def __post_init__(self):
        if self.head_dim == 0:
            self.head_dim = self.d_model // self.n_heads
        if self.n_kv_eff == 0:
            self.n_kv_eff = (max(self.n_kv_heads, 16)
                             if self.attn_parallel == "heads"
                             else self.n_kv_heads)

    # -- structure -----------------------------------------------------------
    @property
    def segments(self) -> List[Tuple[str, int]]:
        if self.segments_spec is not None:
            return self.segments_spec
        if self.family == "encdec":
            return [("enc", self.enc_layers), ("dec", self.dec_layers)]
        if self.family == "moe":
            return [("moe", self.n_layers)]
        return [("dense", self.n_layers)]

    def stack_sizes(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for kind, count in self.segments:
            out[kind] = out.get(kind, 0) + (1 if kind == "shared_attn" else count)
        return out

    @property
    def subquadratic(self) -> bool:
        return (self.family in ("ssm", "hybrid")
                or (self.attn_kind == "swa"))

    def supports(self, shape_name: str) -> bool:
        if shape_name == "long_500k":
            return self.subquadratic
        return True

    def skip_reason(self, shape_name: str) -> str:
        if shape_name == "long_500k" and not self.subquadratic:
            return ("pure full-attention arch: 512k decode needs "
                    "sub-quadratic attention (see DESIGN.md)")
        return ""

    # -- parameter counts for MODEL_FLOPS -------------------------------------
    def n_params(self) -> int:
        from ..models.lm import LM
        from ..models.params import count_params
        return count_params(LM(self).param_defs())

    def n_params_active(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.n_params()
        from ..models.lm import LM
        from ..models.params import walk_defs
        total = 0
        for keys, leaf in walk_defs(LM(self).param_defs()):
            n = math.prod(leaf.shape)
            if any(k in ("wi", "wg", "wo") for k in keys) and \
                    "moe" in keys and "shared" not in keys:
                n = n * self.top_k // self.n_experts
            total += n
        return total

    def model_flops(self, shape_name: str) -> float:
        """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference forward), with
        N = active params, D = tokens processed by the step."""
        sh = SHAPES[shape_name]
        n = self.n_params_active()
        if sh["mode"] == "train":
            tokens = sh["seq"] * sh["batch"]
            return 6.0 * n * tokens
        if sh["mode"] == "prefill":
            tokens = sh["seq"] * sh["batch"]
            return 2.0 * n * tokens
        tokens = sh["batch"]          # one new token per sequence
        return 2.0 * n * tokens

    # -- reduced config for CPU smoke tests ------------------------------------
    def reduced(self) -> "Config":
        r = dataclasses.replace(
            self,
            n_layers=2, d_model=64,
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16, d_ff=128, vocab=256,
            n_kv_eff=min(self.n_kv_heads, 2),
            window=min(self.window, 32) if self.window else 0,
            shared_attn_window=min(self.shared_attn_window, 32)
            if self.shared_attn_window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state or self.family == "ssm" else 64,
            gla_chunk=16,
            enc_layers=min(self.enc_layers, 2),
            dec_layers=min(self.dec_layers, 2),
            enc_len=64,
            loss_chunks=1, q_block=32, kv_block=32,
            segments_spec=self._reduced_segments(),
        )
        return r

    def _reduced_segments(self):
        if self.segments_spec is None:
            return None
        if self.family == "hybrid":
            return [("mamba2", 2), ("shared_attn", 1), ("mamba2", 2)]
        if self.family == "ssm":
            return [("mlstm", 2), ("slstm", 1)]
        return None


# ---------------------------------------------------------------------------
# input specs (meta-tensor stand-ins)
# ---------------------------------------------------------------------------
def _sds(shape, dtype, plan=None, axes=None) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (nothing allocated) whose
    ``sharding`` is ``plan.sharding_for(axes, shape)``, or ``None`` without
    a plan."""
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    t.sharding = None if plan is None else plan.sharding_for(axes, shape)
    return t


def batch_specs(cfg: Config, shape_name: str, plan=None, batch=None,
                seq=None) -> Dict[str, torch.Tensor]:
    """Model-input stand-ins for a shape cell, at the global shape (the
    port's steps take the global batch on every rank).  Front ends are
    stubs: [audio]/[vlm] get precomputed frame/patch embeddings."""
    sh = SHAPES[shape_name]
    B = batch if batch is not None else sh["batch"]
    S = seq if seq is not None else sh["seq"]
    i32, bf16 = torch.int32, torch.bfloat16

    if sh["mode"] in ("train", "prefill"):
        if cfg.family == "encdec":
            dec = max(32, S // 8)
            return {"frames": _sds((B, S, cfg.d_model), bf16, plan,
                                   ("batch", None, None)),
                    "tokens": _sds((B, dec), i32, plan, ("batch", None))}
        out = {"tokens": _sds((B, S), i32, plan, ("batch", None))}
        if cfg.family == "vlm":
            out["embeds"] = _sds((B, S, cfg.d_model), bf16, plan,
                                 ("batch", None, None))
            out["mrope_positions"] = _sds((3, B, S), i32, plan,
                                          (None, "batch", None))
        return out

    # decode: one new token against a cache of length S
    out = {"token": _sds((B, 1), i32, plan, ("batch", None)),
           "pos": _sds((), i32, plan, ())}
    if cfg.family == "vlm":
        out["embeds"] = _sds((B, 1, cfg.d_model), bf16, plan,
                             ("batch", None, None))
        out["mrope_positions"] = _sds((3, B, 1), i32, plan,
                                      (None, "batch", None))
    return out


def cache_specs(cfg: Config, B: int, S: int, plan=None) -> Dict[str, Any]:
    """Stand-ins for the decode caches of ``LM(cfg).cache_defs(B, S)``,
    each with its ``LM.cache_shardings`` sharding."""
    from ..models.lm import LM
    lm = LM(cfg)
    defs = lm.cache_defs(B, S)
    shard = lm.cache_shardings(B, S, plan) if plan is not None else None

    def walk(d, s):
        if isinstance(d, dict):
            return {k: walk(v, None if s is None else s[k])
                    for k, v in d.items()}
        shape, dtype = d
        t = torch.empty(tuple(shape), dtype=dtype, device="meta")
        t.sharding = s
        return t
    return walk(defs, shard)
