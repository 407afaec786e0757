"""Common layers: norms, GLU MLPs, embeddings, RoPE and M-RoPE.

Port of ``src/repro/models/layers.py``: products run in the activations'
type (bf16 for the models) with fp32 normalisation statistics.  On one
device the reference's sharding constraints are no-ops and are dropped;
over a plan's model axis (inside the steps' manual region) :func:`mlp` is
the reference's Megatron MLP: the sequence-parallel gather at its entry,
``wi``/``wg`` column-parallel, ``wo`` row-parallel with its bf16 partials
reduce-scattered back to the sequence block.  Products of
mixed operands (bf16 activations with fp32 parameters) run in the promoted
type, as ``jnp.einsum`` runs them (:func:`mm`, :func:`einsum`); where the
reference asks for a bf16 product (``preferred_element_type``), the port
rounds the product to bf16.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.plan import model_plan
from ..kernels.gelu_stepwise import gelu_stepwise
from ..kernels.silu_stepwise import silu_stepwise
from .params import ParamDef


# -- products ----------------------------------------------------------------
def _promoted(ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted type of the two."""
    if a.dtype != b.dtype:
        a, b = _promoted((a, b))
    return a @ b


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the promoted type of the operands."""
    if any(o.dtype != ops[0].dtype for o in ops):
        ops = _promoted(ops)
    return torch.einsum(eq, *ops)


# -- norms -------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    x = (x - m) * torch.rsqrt(v + eps)
    return (x * w.float() + b.float()).to(dt)


def norm_defs(d_model: int, kind: str = "rms", layers: Optional[int] = None):
    lead = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()
    if kind == "rms":
        return {"w": ParamDef(lead + (d_model,), lax_ + (None,), init="zeros")}
    return {"w": ParamDef(lead + (d_model,), lax_ + (None,), init="ones"),
            "b": ParamDef(lead + (d_model,), lax_ + (None,), init="zeros")}


def apply_norm(x, p, kind: str = "rms"):
    if kind == "rms":
        return rms_norm(x, p["w"])
    return layer_norm(x, p["w"], p["b"])


# -- GLU MLP (SwiGLU / GeGLU) --------------------------------------------------
def mlp_defs(d_model: int, d_ff: int, layers: Optional[int] = None):
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    return {
        "wi": ParamDef(lead + (d_model, d_ff), la + ("fsdp", "tp")),
        "wg": ParamDef(lead + (d_model, d_ff), la + ("fsdp", "tp")),
        "wo": ParamDef(lead + (d_ff, d_model), la + ("tp", "fsdp")),
    }


def activation(g: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu and jax.nn.silu round each of their steps (in bf16);
    # each kernel does so in one pass
    return gelu_stepwise(g) if act == "gelu" else silu_stepwise(g)


def mlp(x, p, act: str = "silu", plan=None, sp: bool = False,
        wo: Optional[ParamDef] = None):
    """The GLU MLP.  With a plan whose model axis is manual, ``x`` is this
    rank's block of the residual (sequence-sharded when ``sp``), ``p`` its
    blocks and ``wo`` the def of the whole ``wo`` (:func:`mlp_defs`), by
    which the plan splits d_ff; the bf16 partial products are composed
    back to the sequence block, as the reference's
    ``preferred_element_type=bf16`` + ``(batch, sp)`` constraint do."""
    tp = model_plan(plan)
    if tp is not None:
        x = tp.seq_gather(x, sp)
    wi = gathered(plan, p["wi"], ("fsdp", "tp"))
    wg = gathered(plan, p["wg"], ("fsdp", "tp"))
    a = mm(x, wi)
    g = activation(mm(x, wg), act)
    o = mm(a * g, gathered(plan, p["wo"], ("tp", "fsdp"))).to(torch.bfloat16)
    return o if tp is None else tp.compose(o, sp, wo)


def gathered(plan, w, axes):
    """The weight ``w`` at its use, whole over the data axes that split
    it (``plan.gather_fsdp``, ZeRO-3 at the layer; ``axes`` its logical
    axes); ``w`` itself without a plan."""
    return w if plan is None else plan.gather_fsdp(w, axes)


# -- embeddings ----------------------------------------------------------------
def embed(tokens: torch.Tensor, p, plan=None) -> torch.Tensor:
    emb = gathered(plan, p["emb"], ("tp", "fsdp"))
    return emb[tokens.long()].to(torch.bfloat16)


def unembed(x: torch.Tensor, p, plan=None) -> torch.Tensor:
    return mm(x, unembedding(p, plan))


def unembedding(p, plan=None) -> torch.Tensor:
    """The (d, V) output matrix: ``unemb``, or the tied embedding's
    transpose, each gathered at its use."""
    w = p.get("unemb")
    if w is None:
        return gathered(plan, p["emb"], ("tp", "fsdp")).T
    return gathered(plan, w, ("fsdp", "tp"))


# -- rotary position embeddings -------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (d/2,)
    ang = positions[..., None].float() * freqs              # (B,S,d/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_thw: torch.Tensor,
                theta: float = 1e4, sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL M-RoPE: head_dim/2 split into (t, h, w) frequency sections,
    each rotated by its own position id.  x: (B, S, H, D); positions_thw:
    (3, B, S) int."""
    d = x.shape[-1]
    half = d // 2
    freqs = rope_freqs(d, theta, x.device)                  # (half,)
    # the sections scaled to half (at head_dim 16: 2, 3, 3), the last
    # taking the remainder
    scaled = [int(round(s / sum(sections) * half)) for s in sections]
    scaled[-1] = half - sum(scaled[:-1])
    # (B,S,half): the t, h or w position stream each frequency takes
    psel = torch.cat([positions_thw[i, ..., None].float().expand(
        *positions_thw.shape[1:], n) for i, n in enumerate(scaled)], -1)
    ang = psel * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)
