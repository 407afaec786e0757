"""GQA attention block and encoder-decoder cross attention on one device.

Port of ``src/repro/models/attention.py`` (``attn_defs``, ``_group``,
``attention``, ``cross_attention``, ``cross_kv``).  Prefill runs the
hand-written ``flash_attention`` kernel (``kernels/flash_attention.py``) on
q, k, v in its (B, H, S, D) layout, where the reference runs its XLA
streaming path; both compute the same blocked softmax.  Decode's
self-attention stays plain torch, as the reference computes it outside any
kernel: the per-row write into the cache, the ring-buffer validity of a
warm sliding-window cache, and the cache roll at prefill.  Cross attention
(Whisper) runs the kernel, non-causal, at prefill and at decode alike, as
the reference runs its streaming path in both; its k/v come from
``cross_kv`` over the encoder's output (cached at prefill).  With
``mrope_positions`` (Qwen2-VL) q and k rotate by M-RoPE's three position
streams; the cache slot and the decode validity mask still take the 1-D
``positions``/``cache_pos``.

One difference from the reference, for memory: decode writes the new k/v
into the cache tensors in place (and returns them), instead of returning
updated copies.  The reference's sharding constraints are no-ops on one
device and are dropped.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_attention import flash_attention
from .layers import apply_mrope, apply_rope, einsum
from .params import ParamDef

NEG_INF = -2.0e38


def attn_defs(cfg, layers: Optional[int] = None):
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    hd = cfg.head_dim
    head_ax = "tp" if cfg.attn_parallel == "heads" else None
    kv_ax = head_ax if cfg.n_kv_heads % 16 == 0 else None
    n_q = cfg.padded_heads or cfg.n_heads   # TP-friendly head padding
    return {
        "wq": ParamDef(lead + (cfg.d_model, n_q, hd),
                       la + ("fsdp", head_ax, None)),
        "wk": ParamDef(lead + (cfg.d_model, cfg.n_kv_heads, hd),
                       la + ("fsdp", kv_ax, None)),
        "wv": ParamDef(lead + (cfg.d_model, cfg.n_kv_heads, hd),
                       la + ("fsdp", kv_ax, None)),
        "wo": ParamDef(lead + (n_q, hd, cfg.d_model),
                       la + (head_ax, None, "fsdp")),
    }


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, kv, group, D)."""
    B, S, H, D = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, D)


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> the kernel's contiguous (B, H, S, D)."""
    return t.transpose(1, 2).contiguous()


def _write_decode(cache: torch.Tensor, new: torch.Tensor,
                  cache_pos) -> None:
    """Write the one-token ``new`` (B, 1, kv, D) at ``cache_pos`` (scalar or
    (B,)) of ``cache`` (B, S, kv, D), in place.  The slot is clamped into
    the cache as ``lax.dynamic_update_slice`` clamps its start."""
    B, S = cache.shape[:2]
    new = new[:, 0].to(cache.dtype)
    if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1:
        rows = torch.arange(B, device=cache.device)
        cache[rows, cache_pos.long().clamp(0, S - 1)] = new
    else:
        cache[:, min(max(int(cache_pos), 0), S - 1)] = new


def attention(x, p, cfg, *, positions, causal=True, window=0, cache=None,
              cache_pos=None, mrope_positions=None):
    """Attention block: projections + grouped SDPA + output projection.

    prefill:  cache=None or 'init' -> (out, None or {k, v} padded to
              ``cfg.cache_len``, rolled into the ring when the prompt
              outgrows a sliding window cache)
    decode:   cache={k, v} (B, S_cache, kv, D) -> (out, the same cache with
              this token written at ``cache_pos``); x is (B, 1, d),
              ``positions`` (B, 1) global positions.

    ``mrope_positions`` (3, B, S): rotate q and k by M-RoPE instead of
    RoPE.
    """
    B, S, _ = x.shape
    n_kv = cfg.n_kv_heads
    decode = isinstance(cache, dict)
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta)
    elif cfg.use_rope:
        pos2d = positions if positions.dim() == 2 else \
            positions[None, :].expand(B, S)
        q = apply_rope(q, pos2d, cfg.rope_theta)
        k = apply_rope(k, pos2d, cfg.rope_theta)

    if decode:
        ck, cv = cache["k"], cache["v"]
        _write_decode(ck, k, cache_pos)
        _write_decode(cv, v, cache_pos)
        new_cache = cache
        Sk = ck.shape[1]
        k_pos = torch.arange(Sk, device=x.device)
        scale = 1.0 / math.sqrt(cfg.head_dim)
        qg = _group(q, n_kv).float() * scale                 # (B,1,kv,g,D)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, ck.float())
        ring = window > 0 and Sk == window
        valid = k_pos[None, None, :] <= positions[:, :, None]
        if window and window > 0 and not ring:
            valid &= k_pos[None, None, :] > (positions[:, :, None] - window)
        if ring:
            # warm ring buffer: every slot holds an in-window entry; the
            # k_pos<=pos test is only exact during warmup (pos < window)
            valid = valid | (positions[:, :, None] >= window)
        s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bqhgk,bkhd->bqhgd", w, cv.float())
        out = out.reshape(B, S, q.shape[2], cfg.head_dim).to(x.dtype)
    else:
        out = flash_attention(_heads_first(q), _heads_first(k),
                              _heads_first(v), causal, window)
        out = out.transpose(1, 2)                             # (B,S,H,D)
        new_cache = None
        if cache == "init":
            ck, cv = k, v
            tgt = getattr(cfg, "cache_len", None) or S
            if cfg.attn_kind == "swa" and tgt == window and S > window:
                shift = S % window
                ck = torch.roll(ck[:, -window:], shift, dims=1)
                cv = torch.roll(cv[:, -window:], shift, dims=1)
            elif tgt > S:
                pad = (0, 0, 0, 0, 0, tgt - S)
                ck = torch.nn.functional.pad(ck, pad)
                cv = torch.nn.functional.pad(cv, pad)
            new_cache = {"k": ck, "v": cv}

    o = einsum("bshk,hkd->bsd", out, p["wo"]).to(torch.bfloat16)
    return o, new_cache


def cross_attention(x, p, enc_kv):
    """Encoder-decoder cross attention (Whisper): q from the decoder's x,
    k/v precomputed from the encoder's output (``cross_kv``, cached at
    prefill), every key visible.  The output stays in the promoted type of
    the product, as the reference's einsum leaves it."""
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    out = flash_attention(_heads_first(q), _heads_first(enc_kv["k"]),
                          _heads_first(enc_kv["v"]), False, 0)
    return einsum("bshk,hkd->bsd", out.transpose(1, 2), p["wo"])


def cross_kv(enc_out, p):
    """The cross attention's k/v, (B, S_enc, kv, D) each, from the
    encoder's output."""
    return {"k": einsum("bsd,dhk->bshk", enc_out, p["wk"]),
            "v": einsum("bsd,dhk->bshk", enc_out, p["wv"])}
