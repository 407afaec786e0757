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

Over a plan's model axis (``attn_parallel="heads"``, inside the steps'
manual region) the block is the reference's Megatron attention on this
rank's blocks: the sequence-parallel gather at its entry; ``wq`` over the
heads; ``wk``/``wv`` over the kv heads only when ``n_kv_heads % 16 == 0``,
else replicated; the kernel on the local q heads and the kv heads those
read (:func:`_kv_for_heads`: a local q head reads its global head's kv
head, which is not the local index over the local group when the kv heads
stay whole); ``wo`` row-parallel, its bf16 partials reduce-scattered back
to the sequence block.  The cache takes ``_cache_axes``' layout: over the
kv heads in the heads layout, over head_dim otherwise, where decode's
q.k products are partial on each rank and summed over the model axis
before the softmax, and P.V's head_dim block reaches ``wo``'s heads block
through an ``all_to_all``.

With ``attn_parallel="cp"`` (context parallelism: Yi-34B, Llama-3.2-3B,
Qwen2-VL, whose heads do not divide the model axis) the weights stay
whole on every rank and the sequence is split instead: ``x`` stays the
rank's sequence block, q, k and v are projected from it and rotated by the
block's own positions, and k and v are gathered over the sequence
(``seq_gather``; the backward reduce-scatters).  The kernel keeps its
contract — queries aligned to the end of the keys — by taking the key
prefix up to the block's last row: exact under the causal mask, which
gives every later key zero weight, and it skips the masked work.  The
output is the rank's block of the residual update (``wo`` whole: no
reduce).  The cache keeps the head_dim block of the gathered k/v
(``_cache_axes``), so decode takes the head_dim-split path above.

Cross attention over a model axis (Whisper) takes q over the heads and
the cross k/v over the kv heads when ``n_kv_heads % 16 == 0``, else whole.
The cross cache keeps the layout the reference's ``cross_kv`` constrains
its k/v to, :data:`CROSS_CACHE_AXES`: the kv heads over the model axis
where they divide it, else every head (not ``_cache_axes``' head_dim
split).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import spmd
from ..core.plan import model_plan
from ..kernels.flash_attention import flash_attention
from .layers import apply_mrope, apply_rope, einsum, gathered
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


def _cache_axes(cfg):
    """Logical axes of the KV cache (B, S_max, n_kv, hd): the kv heads
    when they divide the TP degree, else head_dim."""
    if cfg.attn_parallel == "heads" and cfg.n_kv_heads % 16 == 0:
        return ("batch", None, "tp", None)
    return ("batch", None, None, "tp")


def _kv_for_heads(k, v, q_off: int, n_q: int, group: int, k_off: int):
    """The kv heads that the q heads ``q_off .. q_off + n_q`` (global
    indices; q head h reads kv head h // ``group``) read, out of ``k``/``v``
    (B, S, kv, D) holding the global kv heads from ``k_off``: a slice when
    each of them serves the same number of consecutive q heads (the
    kernel's h // group mapping then reads it right), else one kv head per
    q head."""
    ids = [(q_off + j) // group - k_off for j in range(n_q)]
    first, n = ids[0], ids[-1] - ids[0] + 1
    if n_q % n == 0 and ids == [first + j // (n_q // n) for j in range(n_q)]:
        if first == 0 and n == k.shape[2]:
            return k, v
        return k.narrow(2, first, n), v.narrow(2, first, n)
    idx = torch.tensor(ids, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> the kernel's contiguous (B, H, S, D)."""
    return t.transpose(1, 2).contiguous()


def _write_decode(cache: torch.Tensor, new: torch.Tensor,
                  cache_pos) -> None:
    """Write the one-token ``new`` (B, 1, kv, D) at ``cache_pos`` (an int,
    a scalar tensor or (B,)) of ``cache`` (B, S, kv, D), in place, without
    reading a tensor position on the host.  The slot is clamped into the
    cache as ``lax.dynamic_update_slice`` clamps its start."""
    B, S = cache.shape[:2]
    new = new[:, 0].to(cache.dtype)
    if not isinstance(cache_pos, torch.Tensor):
        cache[:, min(max(int(cache_pos), 0), S - 1)] = new
        return
    slot = cache_pos.long().clamp(0, S - 1)
    if cache_pos.dim() == 1:
        rows = torch.arange(B, device=cache.device)
        cache[rows, slot] = new
    else:                        # one slot for all, read on the device
        cache.index_copy_(1, slot.reshape(1), new[:, None])


def attention(x, p, cfg, *, positions, causal=True, window=0, cache=None,
              cache_pos=None, mrope_positions=None, plan=None, sp=False):
    """Attention block: projections + grouped SDPA + output projection.

    prefill:  cache=None or 'init' -> (out, None or {k, v} padded to
              ``cfg.cache_len``, rolled into the ring when the prompt
              outgrows a sliding window cache)
    decode:   cache={k, v} (B, S_cache, kv, D) -> (out, the same cache with
              this token written at ``cache_pos``); x is (B, 1, d),
              ``positions`` (B, 1) global positions.

    ``mrope_positions`` (3, B, S): rotate q and k by M-RoPE instead of
    RoPE.  With a plan whose model axis is manual, ``x`` is this rank's
    block of the residual (sequence-sharded when ``sp``), ``p`` and the
    cache this rank's blocks, and the output this rank's block of the
    residual update; ``positions`` and ``mrope_positions`` stay whole.
    """
    tp = model_plan(plan)
    cp = tp is not None and cfg.attn_parallel == "cp"
    if cp:                                # the rank's rows of the sequence
        positions = tp.seq_block(positions, sp, 1, "cp")
        if mrope_positions is not None:
            mrope_positions = tp.seq_block(mrope_positions, sp, 2, "cp")
    elif tp is not None:
        x = tp.seq_gather(x, sp)          # SP boundary: the whole sequence
    B, S, _ = x.shape
    n_kv = cfg.n_kv_heads
    decode = isinstance(cache, dict)
    defs = attn_defs(cfg)
    q = einsum("bsd,dhk->bshk", x, gathered(plan, p["wq"], defs["wq"].axes))
    k = einsum("bsd,dhk->bshk", x, gathered(plan, p["wk"], defs["wk"].axes))
    v = einsum("bsd,dhk->bshk", x, gathered(plan, p["wv"], defs["wv"].axes))
    if mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta)
    elif cfg.use_rope:
        pos2d = positions if positions.dim() == 2 else \
            positions[None, :].expand(B, S)
        q = apply_rope(q, pos2d, cfg.rope_theta)
        k = apply_rope(k, pos2d, cfg.rope_theta)
    if cp and not decode:                 # every key of the sequence
        k, v = tp.seq_gather(k, sp), tp.seq_gather(v, sp)

    # the layout over the model axis (one device: every head, whole)
    n_q = cfg.padded_heads or cfg.n_heads
    group = n_q // n_kv
    q_off = k_off = 0
    cache_split = ()
    if tp is not None:
        q_off, k_off = _head_offsets(tp, defs, q.shape[2], k.shape[2])
        cache_split = tp.model_split((B, 1, n_kv, cfg.head_dim),
                                     _cache_axes(cfg))

    if decode:
        ck, cv = cache["k"], cache["v"]
        kd, vd = k, v
        if 3 in cache_split:              # the cache keeps a head_dim block
            kd, vd = tp.block(k, 3), tp.block(v, 3)
        _write_decode(ck, kd, cache_pos)
        _write_decode(cv, vd, cache_pos)
        new_cache = cache
        out = _decode_attend(q, ck, cv, positions, window, cfg, tp,
                             q_off, group, k_off, 3 in cache_split)
        out = out.to(x.dtype)
    else:
        ks, vs = _kv_for_heads(k, v, q_off, q.shape[2], group, k_off)
        if cp and causal:
            ks, vs = _causal_prefix(tp, ks, vs, S)
        out = flash_attention(_heads_first(q), _heads_first(ks),
                              _heads_first(vs), causal, window)
        out = out.transpose(1, 2)                             # (B,S,H,D)
        new_cache = None
        if cache == "init":
            ck, cv = k, v
            S_all = k.shape[1]
            if 3 in cache_split:
                ck, cv = tp.block(ck, 3), tp.block(cv, 3)
            tgt = getattr(cfg, "cache_len", None) or S_all
            if cfg.attn_kind == "swa" and tgt == window and S_all > window:
                shift = S_all % window
                ck = torch.roll(ck[:, -window:], shift, dims=1)
                cv = torch.roll(cv[:, -window:], shift, dims=1)
            elif tgt > S_all:
                pad = (0, 0, 0, 0, 0, tgt - S_all)
                ck = torch.nn.functional.pad(ck, pad)
                cv = torch.nn.functional.pad(cv, pad)
            new_cache = {"k": ck, "v": cv}

    o = einsum("bshk,hkd->bsd", out,
               gathered(plan, p["wo"], defs["wo"].axes)).to(torch.bfloat16)
    if tp is not None and not cp:        # cp: wo whole, o the rank's rows
        o = tp.compose(o, sp, defs["wo"])
    return o, new_cache


def _causal_prefix(tp, k, v, rows: int):
    """The keys that this rank's ``rows`` query rows read under the causal
    mask, when the sequence is split: rank r's rows are [r rows, (r+1)
    rows) of the whole, so the keys up to its last row, which end where
    its queries do (the kernel aligns queries to the end of the keys).
    Every key when the rows are the whole sequence."""
    end = (tp.mesh.coord(tp.model_axis()) + 1) * rows
    if end >= k.shape[1]:
        return k, v
    return k[:, :end], v[:, :end]


def _head_offsets(tp, defs, n_q_local: int, n_kv_local: int):
    """The global index of this rank's first q head and first kv head:
    ``wq``/``wk`` split over the model axis take the rank's block of the
    heads, whole ones start at 0."""
    r = tp.mesh.coord(tp.model_axis())
    q_split = bool(tp.model_split(defs["wq"].shape, defs["wq"].axes))
    k_split = bool(tp.model_split(defs["wk"].shape, defs["wk"].axes))
    return (r * n_q_local if q_split else 0,
            r * n_kv_local if k_split else 0)


def _decode_attend(q, ck, cv, positions, window, cfg, tp, q_off, group,
                   k_off, dim_split):
    """One token's grouped attention over the cache, in fp32: q (B, 1, H,
    D) against ck/cv (B, S_cache, kv, D).  Over a model axis ``q`` holds the
    local heads from global ``q_off`` and the cache the kv heads from
    ``k_off``; with ``dim_split`` the cache holds a head_dim block of every
    kv head instead: the q.k products over it are partial, summed over the
    model axis before the softmax, and P.V gives every head's head_dim
    block, which an ``all_to_all`` turns into the local heads' whole
    rows."""
    B = q.shape[0]
    n_q_all = cfg.padded_heads or cfg.n_heads
    q_local = q.shape[2]
    if dim_split:
        m = tp.model_axis()
        if q_local < n_q_all:            # every head's q, for its block
            q = spmd.all_gather(q, m, axis_dim=2)
        q = tp.block(q, 3)
        ks, vs = ck, cv
    else:
        ks, vs = _kv_for_heads(ck, cv, q_off, q_local, group, k_off)
    Sk = ks.shape[1]
    k_pos = torch.arange(Sk, device=q.device)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    qg = _group(q, ks.shape[2]).float() * scale              # (B,1,kv,g,D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, ks.float())
    if dim_split:
        s = spmd.psum(s, tp.model_axis())
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
    out = torch.einsum("bqhgk,bkhd->bqhgd", w, vs.float())
    out = out.reshape(B, 1, q.shape[2], q.shape[3])
    if dim_split:
        m = tp.model_axis()
        out = spmd.all_to_all(out, m, 2, 3) if q_local < n_q_all \
            else spmd.all_gather(out, m, axis_dim=3)
    return out


def cross_attention(x, p, enc_kv, cfg=None, plan=None, sp=False):
    """Encoder-decoder cross attention (Whisper): q from the decoder's x,
    k/v precomputed from the encoder's output (``cross_kv``, cached at
    prefill), every key visible.  The output stays in the promoted type of
    the product, as the reference's einsum leaves it.  Over a plan's model
    axis ``x`` is the rank's block of the residual, ``enc_kv`` the rank's
    block of the cross k/v (:func:`cross_cache`'s layout at decode), and
    the output the rank's block of the residual update: the sequence
    gathered at the entry, q over the heads, ``wo`` row-parallel."""
    tp = model_plan(plan)
    if tp is not None:
        x = tp.seq_gather(x, sp)
    q = einsum("bsd,dhk->bshk", x, _weight(p, "wq", cfg, plan))
    k, v = enc_kv["k"], enc_kv["v"]
    if tp is not None:
        defs = attn_defs(cfg)
        r = tp.mesh.coord(tp.model_axis())
        q_off = _head_offsets(tp, defs, q.shape[2], k.shape[2])[0]
        k_off = r * k.shape[2] if k.shape[2] < cfg.n_kv_heads else 0
        n_q = cfg.padded_heads or cfg.n_heads
        k, v = _kv_for_heads(k, v, q_off, q.shape[2], n_q // cfg.n_kv_heads,
                             k_off)
    out = flash_attention(_heads_first(q), _heads_first(k),
                          _heads_first(v), False, 0)
    o = einsum("bshk,hkd->bsd", out.transpose(1, 2),
               _weight(p, "wo", cfg, plan))
    return o if tp is None else tp.compose(o, sp, defs["wo"])


def _weight(p, name: str, cfg, plan):
    """``p[name]`` gathered over the data axes at its use, by its def's
    axes (``cfg``'s); as it is without a config (one device)."""
    if cfg is None:
        return p[name]
    return gathered(plan, p[name], attn_defs(cfg)[name].axes)


def cross_kv(enc_out, p, cfg=None, plan=None):
    """The cross attention's k/v, (B, S_enc, kv, D) each, from the
    encoder's whole output (over a model axis the caller gathers it from
    its sequence blocks once for every decoder layer): the rank's kv heads
    where its ``wk``/``wv`` blocks split them, else every head."""
    return {"k": einsum("bsd,dhk->bshk", enc_out,
                        _weight(p, "wk", cfg, plan)),
            "v": einsum("bsd,dhk->bshk", enc_out,
                        _weight(p, "wv", cfg, plan))}


# the cross cache's logical axes (B, S_enc, kv, D): the layout the
# reference's ``cross_kv`` constrains its k/v to
CROSS_CACHE_AXES = ("batch", None, "tp", None)


def cross_cache(ckv, cfg, plan=None):
    """The cross k/v as the decode cache keeps them
    (:data:`CROSS_CACHE_AXES`): over a model axis the rank's block of the
    kv heads where they divide it (``ckv`` holds every head when
    ``wk``/``wv`` stay whole), else every head."""
    tp = model_plan(plan)
    if tp is None or ckv["k"].shape[2] < cfg.n_kv_heads:
        return ckv
    return {n: tp.block(t, 2) for n, t in ckv.items()}
