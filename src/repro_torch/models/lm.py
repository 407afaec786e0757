"""Language-model backbone: the ``dense``, ``moe``, ``mamba2``,
``shared_attn``, ``mlstm``, ``slstm``, ``enc`` and ``dec`` blocks.

Port of ``src/repro/models/lm.py`` (``LM``: ``param_defs``, ``init``,
``_run_segments``, ``loss``, ``prefill``, ``decode_step``,
``_cache_write_pos``, ``cache_defs``; ``_embed_in``, ``_encdec_loss`` and
``_encdec_prefill`` as one :meth:`LM._forward`; ``vocab_parallel_embed``
and ``vocab_parallel_ce``, the Megatron-style ``shard_map`` bodies over the
plan's ``tp`` axis, which ``loss``, ``prefill`` and ``decode_step`` take
when the plan is a :class:`~repro_torch.core.plan.ShardingPlan` whose mesh
has a ``model`` axis, as the reference's do; on a one-device
:class:`~repro_torch.core.plan.TorchPlan` they take :func:`embed` and
:func:`cross_entropy`, which the vocab-parallel forms equal on one model
rank bit for bit).  Parameters
keep the reference's nesting — ``embed``, ``final_norm``, per-kind
``stacks`` whose leaves carry a leading layer dimension, the one unstacked
``shared`` block that every ``shared_attn`` segment calls (Zamba2), and
``enc_norm`` for the encoder-decoder family — so the reference's
initialised tree, carried across with ``core.params.from_numpy``, loads as
it is.  Where the reference scans over the stacked layers, the port loops
over them in Python, each stack's leaves unbound into per-layer views once.

The two families with stub front ends take precomputed embeddings, as the
reference does: ``vlm`` (Qwen2-VL) reads ``batch["embeds"]`` (B, S, d) in
place of the token embedding when it is there, and ``mrope_positions``
(3, B, S) for M-RoPE; ``encdec`` (Whisper) runs ``batch["frames"]``
(B, S_enc, d) through the ``enc`` blocks (non-causal, no cache) and
``enc_norm``, then the tokens through the ``dec`` blocks (self-attention,
cross attention on the encoder's k/v, MLP).  A ``dec`` layer's cache is
nested, ``{"self": {k, v}, "cross": {k, v}}``; decode runs the ``dec``
segment alone on it.

Training runs every block, the shared one included, under non-reentrant
activation checkpointing (``torch.utils.checkpoint``), where the reference
uses ``jax.checkpoint``: a block keeps only its input, and its forward —
kernels included — runs again in the backward pass.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core import spmd
from ..core.plan import P, TorchSharding, model_plan, unbind_marked
from ..core.tree import tree_map
from .attention import (CROSS_CACHE_AXES, attention, attn_defs,
                        cross_attention, cross_cache, cross_kv)
from .layers import (apply_norm, embed, gathered, mlp, mlp_defs, mm,
                     norm_defs, unembed, unembedding)
from .moe import moe_block, moe_defs
from .params import ParamDef, init_params
from .attention import _cache_axes
from .ssm import (MAMBA2_STATE_AXES, mamba2_block, mamba2_defs,
                  mamba2_state_defs)
from .xlstm import (MLSTM_STATE_AXES, SLSTM_STATE_AXES, mlstm_block,
                    mlstm_defs, mlstm_state_defs, slstm_block, slstm_defs,
                    slstm_state_defs)


# ---------------------------------------------------------------------------
# vocab-parallel embedding / cross entropy
# ---------------------------------------------------------------------------
def _tp_axis(plan):
    """The plan's ``tp`` mesh axis, or ``None`` (a one-device plan)."""
    axes = getattr(plan, "axes", None)
    return axes("tp") if axes is not None else None


def _batch_axis(plan, local_b: int):
    """The batch dim's mesh axes, fitted to the global batch: inside a
    ``shard_map`` whose manual axes already split the batch, ``local_b``
    is this rank's block."""
    whole = local_b * spmd.manual_size(plan.axes("batch"))
    return plan._fit_dim(whole, "batch")


def vocab_parallel_embed(tokens, emb, plan):
    """The embedding of ``tokens`` (B, S) with the (V, d) table sharded
    over the model axis: each rank looks up the tokens of its vocab block,
    zeros the others, and the model axis sums (or reduce-scatters over the
    sequence, under sequence parallelism) the bf16 rows."""
    m_ax = _tp_axis(plan)
    if m_ax is None:
        return emb[tokens.long()].to(torch.bfloat16)
    b_ax = _batch_axis(plan, tokens.shape[0])
    tp = plan.tp
    S = tokens.shape[1]
    seq_scatter = (S % tp == 0) and plan.sequence_parallel

    def body(tok, emb_l):
        Vl = emb_l.shape[0]                  # this rank's vocab block
        idx = spmd.axis_index(m_ax)
        loc = tok.long() - idx * Vl
        ok = (loc >= 0) & (loc < Vl)
        e = emb_l[torch.clamp(loc, 0, Vl - 1)] * ok[..., None].to(emb_l.dtype)
        e = e.to(torch.bfloat16)
        if seq_scatter:
            return spmd.psum_scatter(e, m_ax, scatter_dimension=1, tiled=True)
        return spmd.psum(e, m_ax)

    out_spec = P(b_ax, m_ax if seq_scatter else None, None)
    return spmd.shard_map(body, plan.mesh, (P(b_ax, None), P("model", None)),
                          out_spec)(tokens, emb)


def vocab_parallel_ce(x, unemb, labels, mask, plan, chunks: int = 1):
    """Mean CE over masked tokens; logits never materialized beyond a
    (B_loc, S/chunks, V/tp) fp32 tile.  x: (B,S,d); labels (B,S).  The
    max is a ``pmax`` without gradient (exact: the logsumexp is
    shift-invariant); on one model rank the logsumexp is
    ``torch.logsumexp``'s own, so the loss and its gradient are
    :func:`cross_entropy`'s bit for bit."""
    m_ax = _tp_axis(plan)
    if m_ax is None:
        return cross_entropy(x, unemb, labels, mask, chunks)
    tp = plan.tp
    b_ax = _batch_axis(plan, x.shape[0])

    def body(xl, w_l, lab, msk):
        # xl: (B_loc, S or S/tp, d) — gather seq if sp-sharded
        if xl.shape[1] != lab.shape[1]:
            xl = spmd.all_gather(xl, m_ax, axis_dim=1, tiled=True)
        Vl = w_l.shape[1]                    # this rank's vocab block
        lo = spmd.axis_index(m_ax) * Vl
        S = xl.shape[1]
        cs = max(1, S // max(chunks, 1))
        nll_parts = []
        for c0 in range(0, S, cs):
            lg = mm(xl[:, c0:c0 + cs], w_l).float()
            loc = lab[:, c0:c0 + cs].long() - lo
            ok = (loc >= 0) & (loc < Vl)
            ll = lg.gather(-1, torch.clamp(loc, 0, Vl - 1)[..., None])[..., 0]
            ll = spmd.psum(ll * ok.float(), m_ax)
            if tp == 1:
                lse = torch.logsumexp(lg, -1)
            else:
                mx = spmd.pmax(torch.amax(lg, -1), m_ax)
                ssum = spmd.psum(torch.sum(torch.exp(lg - mx[..., None]), -1),
                                 m_ax)
                lse = torch.log(ssum) + mx
            nll_parts.append(lse - ll)
        nll = torch.cat(nll_parts, 1) if len(nll_parts) > 1 else nll_parts[0]
        loss = (nll * msk).sum()
        cnt = msk.sum()
        return spmd.pmean(loss, b_ax), spmd.pmean(cnt, b_ax)

    x_seq_ax = m_ax if (plan.sequence_parallel
                        and x.shape[1] % tp == 0) else None
    loss, cnt = spmd.shard_map(
        body, plan.mesh,
        (P(b_ax, x_seq_ax, None), P(None, "model"), P(b_ax, None),
         P(b_ax, None)), (P(), P()))(x, unemb, labels, mask)
    return loss / torch.clamp(cnt, min=1.0)


def vocab_argmax(logits: torch.Tensor, plan) -> torch.Tensor:
    """The first argmax over the whole vocabulary of the last dim of
    ``logits``, this rank's vocab block when the plan's model axis is
    manual: each rank's maximum and its first index, gathered over the
    axis, and the first rank holding the greatest (ranks hold the vocab in
    order, so that is the first index of the whole), as ``argmax`` over
    the gathered logits would pick."""
    tp = model_plan(plan)
    if tp is None:
        return torch.argmax(logits, dim=-1)
    m = tp.model_axis()
    idx = torch.argmax(logits, dim=-1, keepdim=True)
    mx = logits.gather(-1, idx)
    idx = idx + tp.mesh.coord(m) * logits.shape[-1]
    mxs = spmd.all_gather(mx, m, axis_dim=mx.dim() - 1)
    idxs = spmd.all_gather(idx, m, axis_dim=idx.dim() - 1)
    return idxs.gather(-1, torch.argmax(mxs, dim=-1, keepdim=True))[..., 0]


def cross_entropy(x, unemb, labels, mask, chunks: int = 1):
    """Mean CE over the masked tokens: ``vocab_parallel_ce`` on one device.
    The logits are the product in the activations' type, widened to fp32,
    as ``jnp.einsum(...).astype(f32)`` gives them; ``chunks`` splits the
    sequence as the reference's sharded path does (every token's loss is
    the same either way)."""
    S = x.shape[1]
    cs = max(1, S // max(chunks, 1))
    nll = []
    for c0 in range(0, S, cs):
        logits = mm(x[:, c0:c0 + cs], unemb).float()
        lab = logits.gather(-1, labels[:, c0:c0 + cs, None].long())[..., 0]
        nll.append(torch.logsumexp(logits, -1) - lab)
    nll = torch.cat(nll, 1) if len(nll) > 1 else nll[0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def dense_block(x, p, cfg, *, cache=None, positions=None, pos_offset=0,
                mrope_positions=None, causal=True, window=0, moe=False,
                losses=False, plan=None, sp=False):
    """One pre-norm block; returns (x, new_cache, aux).  ``aux`` holds the
    MoE aux losses when ``losses`` (the loss reads them), else ``{}``.
    Over a plan's model axis the residual ``x`` stays this rank's block
    (sequence-sharded when ``sp``) between the blocks, as the reference's
    ``_residual`` constrains it to ``(batch, sp)``."""
    xn = apply_norm(x, p["ln1"], cfg.norm)
    a, new_cache = attention(xn, p["attn"], cfg, positions=positions,
                             causal=causal, window=window, cache=cache,
                             cache_pos=pos_offset,
                             mrope_positions=mrope_positions, plan=plan,
                             sp=sp)
    x = x + a
    xn = apply_norm(x, p["ln2"], cfg.norm)
    aux = {}
    if moe:
        m, aux = moe_block(xn, p["moe"], cfg, losses=losses, plan=plan,
                           sp=sp)
    else:
        m = mlp(xn, p["mlp"], cfg.act, plan, sp,
                mlp_defs(cfg.d_model, cfg.d_ff)["wo"])
    return x + m, new_cache, aux


def dec_block(x, p, cfg, *, cache=None, positions=None, pos_offset=0,
              enc_out=None, plan=None, sp=False):
    """Whisper's decoder block: causal self-attention, cross attention on
    the encoder's k/v (``cross_kv`` of ``enc_out`` at prefill and in
    training, the cached ``cache["cross"]`` at decode), then the MLP.
    Returns (x, new_cache, {}); ``cache`` is None (training), "init"
    (prefill) or ``{"self": {k, v}, "cross": {k, v}}`` (decode).  Over a
    plan's model axis ``x`` is the rank's block of the residual and
    ``enc_out`` the encoder's whole output; the cross cache keeps
    :func:`~repro_torch.models.attention.cross_cache`'s layout."""
    decode = isinstance(cache, dict)
    xn = apply_norm(x, p["ln1"], cfg.norm)
    a, new_self = attention(xn, p["attn"], cfg, positions=positions,
                            causal=True, window=0,
                            cache=cache["self"] if decode else cache,
                            cache_pos=pos_offset, plan=plan, sp=sp)
    x = x + a
    xn = apply_norm(x, p["ln_x"], cfg.norm)
    ckv = cache["cross"] if decode else cross_kv(enc_out, p["xattn"], cfg,
                                                 plan)
    x = x + cross_attention(xn, p["xattn"], ckv, cfg, plan, sp)
    xn = apply_norm(x, p["ln2"], cfg.norm)
    x = x + mlp(xn, p["mlp"], cfg.act, plan, sp,
                mlp_defs(cfg.d_model, cfg.d_ff)["wo"])
    new_cache = None
    if cache is not None:
        new_cache = {"self": new_self,
                     "cross": ckv if decode else cross_cache(ckv, cfg, plan)}
    return x, new_cache, {}


def apply_block(kind, x, p, cfg, *, cache=None, positions=None,
                pos_offset=0, mrope_positions=None, enc_out=None,
                losses=False, plan=None, sp=False):
    """Uniform block dispatch; returns (x, new_cache, aux).  ``plan`` and
    ``sp`` reach every block (each runs over a model axis)."""
    if kind == "mamba2":
        y, st = mamba2_block(x, p, cfg, state=cache, chunk=cfg.gla_chunk,
                             plan=plan, sp=sp)
        return y, st, {}
    if kind == "mlstm":
        y, st = mlstm_block(x, p, cfg, state=cache, chunk=cfg.gla_chunk,
                            plan=plan, sp=sp)
        return y, st, {}
    if kind == "slstm":
        y, st = slstm_block(x, p, cfg, state=cache, plan=plan, sp=sp)
        return y, st, {}
    if kind == "dec":
        return dec_block(x, p, cfg, cache=cache, positions=positions,
                         pos_offset=pos_offset, enc_out=enc_out, plan=plan,
                         sp=sp)
    if kind == "enc":
        return dense_block(x, p, cfg, positions=positions, causal=False,
                           plan=plan, sp=sp)
    if kind == "shared_attn":
        return dense_block(x, p, cfg, cache=cache, positions=positions,
                           pos_offset=pos_offset,
                           window=cfg.shared_attn_window, plan=plan, sp=sp)
    if kind not in ("dense", "moe"):
        raise ValueError(kind)
    return dense_block(x, p, cfg, cache=cache, positions=positions,
                       pos_offset=pos_offset, mrope_positions=mrope_positions,
                       window=cfg.window if cfg.attn_kind == "swa" else 0,
                       moe=(kind == "moe"), losses=losses, plan=plan, sp=sp)


def _train_block(kind, x, p, cfg, positions, mrope_positions, enc_out,
                 plan=None, sp=False, frames=()):
    """A block as training runs it: no cache, the aux losses kept, in the
    manual regions ``frames`` of its forward (its recompute in the
    backward may run on another thread)."""
    with spmd.within(frames):
        y, _, aux = apply_block(kind, x, p, cfg, positions=positions,
                                mrope_positions=mrope_positions,
                                enc_out=enc_out, losses=True, plan=plan,
                                sp=sp)
    return y, aux


def _layers(stack) -> list:
    """The per-layer trees of a stacked tree.  Each leaf is unbound along
    its layer dimension once, so its gradient is stacked once, where an
    index per layer would add a full-size gradient for every layer."""
    if isinstance(stack, dict):
        per = {k: _layers(v) for k, v in stack.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return unbind_marked(stack)


def block_defs(kind, cfg, layers):
    if kind == "mamba2":
        return mamba2_defs(cfg, layers)
    if kind == "mlstm":
        return mlstm_defs(cfg, layers)
    if kind == "slstm":
        return slstm_defs(cfg, layers)
    if kind == "dec":
        return {
            "ln1": norm_defs(cfg.d_model, cfg.norm, layers),
            "ln_x": norm_defs(cfg.d_model, cfg.norm, layers),
            "ln2": norm_defs(cfg.d_model, cfg.norm, layers),
            "attn": attn_defs(cfg, layers),
            "xattn": attn_defs(cfg, layers),
            "mlp": mlp_defs(cfg.d_model, cfg.d_ff, layers),
        }
    if kind not in ("dense", "moe", "shared_attn", "enc"):
        raise ValueError(kind)
    d = {
        "ln1": norm_defs(cfg.d_model, cfg.norm, layers),
        "ln2": norm_defs(cfg.d_model, cfg.norm, layers),
        "attn": attn_defs(cfg, layers),
    }
    if kind == "moe":
        d["moe"] = moe_defs(cfg, layers)
    else:
        d["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff, layers)
    return d


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
class LM:
    def __init__(self, cfg):
        self.cfg = cfg

    # -- parameters -----------------------------------------------------------
    def param_defs(self):
        cfg = self.cfg
        d: Dict[str, Any] = {
            "embed": {"emb": ParamDef((cfg.vocab, cfg.d_model),
                                      ("tp", "fsdp"), init="embed",
                                      scale=0.02)},
            "final_norm": norm_defs(cfg.d_model, cfg.norm),
        }
        if not cfg.tie_embeddings:
            d["embed"]["unemb"] = ParamDef((cfg.d_model, cfg.vocab),
                                           ("fsdp", "tp"))
        stacks = {}
        for kind, total in cfg.stack_sizes().items():
            if kind == "shared_attn":        # one block, called per segment
                d["shared"] = block_defs(kind, cfg, None)
            else:
                stacks[kind] = block_defs(kind, cfg, total)
        d["stacks"] = stacks
        if cfg.family == "encdec":
            d["enc_norm"] = norm_defs(cfg.d_model, cfg.norm)
        return d

    def init(self, gen: torch.Generator):
        """Parameters drawn from ``gen``, on the generator's device."""
        return init_params(self.param_defs(), gen)

    # -- segment runner ---------------------------------------------------------
    def _run_segments(self, params, x, *, mode, caches=None, positions=None,
                      pos_offset=0, mrope_positions=None, enc_out=None,
                      segments=None, plan=None, sp=False):
        """Run ``segments`` (the config's list unless given); returns (x,
        caches, aux).  ``train`` runs every block under activation
        checkpointing and sums the MoE aux losses over the layers (``{}``
        without MoE layers); prefill builds the caches (each leaf with a
        leading dimension per kind: the layers of a stack, the calls of the
        shared block; a ``dec`` layer's cache nested as ``self`` and
        ``cross``; the ``enc`` blocks keep none); decode writes into the
        given caches in place and returns them."""
        cfg = self.cfg
        offsets: Dict[str, int] = {}
        layers: Dict[str, list] = {}
        pieces: Dict[str, list] = {}
        aux: Dict[str, Any] = {}
        for kind, count in cfg.segments if segments is None else segments:
            start = offsets.get(kind, 0)
            offsets[kind] = start + count
            if kind != "shared_attn" and kind not in layers:
                layers[kind] = _layers(params["stacks"][kind])
            for li in range(start, start + count):
                pl = params["shared"] if kind == "shared_attn" \
                    else layers[kind][li]
                if mode == "train":
                    x, a = checkpoint(_train_block, kind, x, pl, cfg,
                                      positions, mrope_positions, enc_out,
                                      plan, sp, spmd.frames(),
                                      use_reentrant=False,
                                      preserve_rng_state=False)
                    for k, v in a.items():
                        aux[k] = aux[k] + v if k in aux else v
                    continue
                cl = "init" if mode == "prefill" else \
                    tree_map(lambda c: c[li], caches[kind])
                x, nc, _ = apply_block(kind, x, pl, cfg, cache=cl,
                                       positions=positions,
                                       pos_offset=pos_offset,
                                       mrope_positions=mrope_positions,
                                       enc_out=enc_out, plan=plan, sp=sp)
                if mode == "prefill" and nc is not None:
                    pieces.setdefault(kind, []).append(nc)
        if mode == "prefill":
            caches = {kind: tree_map(lambda *ls: torch.stack(ls), *cs)
                      for kind, cs in pieces.items()}
        return x, caches, aux

    def _embed_in(self, params, batch, tokens, plan=None, sp=False):
        """The block input: ``batch["embeds"]`` in bf16 for the ``vlm``
        family when it is there (the reference's stub front end; over a
        manual model axis the rank's sequence block under ``sp``), else
        the embedding of ``tokens`` (vocab-parallel over a plan's model
        axis)."""
        if self._embeds(batch):
            x = batch["embeds"].to(torch.bfloat16)
            tp = model_plan(plan)
            return x if tp is None else tp.seq_block(x, sp)
        if _tp_axis(plan) is not None:
            return vocab_parallel_embed(tokens, gathered(
                plan, params["embed"]["emb"], ("tp", "fsdp")), plan)
        return embed(tokens, params["embed"], plan)

    def _mrope(self, batch):
        return batch.get("mrope_positions") if self.cfg.mrope else None

    def _embeds(self, batch) -> bool:
        return self.cfg.family == "vlm" and "embeds" in batch

    def _seq_len(self, batch) -> int:
        """The global length of the token stream: the ``embeds``' for a
        ``vlm`` batch that has them, else the tokens'."""
        return (batch["embeds"] if self._embeds(batch)
                else batch["tokens"]).shape[1]

    def _forward(self, params, batch, mode, plan=None):
        """The backbone over a prompt or a training batch (``mode`` prefill
        or train); returns the final-normed activations (B, S, d), the
        caches (prefill) and the aux losses (train).  For ``encdec`` the
        frames (B, S_enc, d) run through the ``enc`` segment and
        ``enc_norm`` first, and the tokens through the ``dec`` segment on
        that output.  Over a plan's model axis the activations are this
        rank's block, sequence-sharded when the plan's ``sp`` axis fits
        the sequence (the frames and the tokens each by their own length);
        the encoder's output is gathered over the sequence once, for every
        decoder layer's cross k/v."""
        cfg = self.cfg
        tp = model_plan(plan)
        enc_out, segments = None, None
        if cfg.family == "encdec":
            frames = batch["frames"].to(torch.bfloat16)
            B, S = frames.shape[:2]
            sp_enc = tp is not None and tp.seq_split(S)
            if sp_enc:
                frames = tp.seq_block(frames, sp_enc)
            pos = torch.arange(S, device=frames.device)[None].expand(B, S)
            enc_x, _, _ = self._run_segments(
                params, frames, mode=mode, positions=pos,
                segments=[("enc", cfg.enc_layers)], plan=plan, sp=sp_enc)
            enc_out = apply_norm(enc_x, params["enc_norm"], cfg.norm)
            if sp_enc:
                enc_out = tp.seq_gather(enc_out, sp_enc)
            segments = [("dec", cfg.dec_layers)]
        S = self._seq_len(batch)
        sp = tp is not None and tp.seq_split(S)
        x = self._embed_in(params, batch, batch.get("tokens"), plan, sp)
        B = x.shape[0]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x, caches, aux = self._run_segments(
            params, x, mode=mode, positions=positions,
            mrope_positions=self._mrope(batch), enc_out=enc_out,
            segments=segments, plan=plan, sp=sp)
        return apply_norm(x, params["final_norm"], cfg.norm), caches, aux

    # -- serving -----------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, batch, plan=None,
                cache_len: Optional[int] = None):
        """Process the prompt (``tokens``; for ``vlm`` also ``embeds`` and
        ``mrope_positions``; for ``encdec`` ``frames`` and the decoder's
        ``tokens``); returns (last-position logits (B,1,V), caches padded
        to ``cache_len``; an ``encdec`` cache's ``cross`` holds the
        encoder's S_enc positions)."""
        cfg = self.cfg
        if cache_len is not None:
            cfg.cache_len = (min(cache_len, cfg.window)
                             if cfg.attn_kind == "swa" else cache_len)
        x, caches, _ = self._forward(params, batch, "prefill", plan)
        x_last = x[:, -1:]
        tp = model_plan(plan)
        if tp is not None and tp.seq_split(self._seq_len(batch)):
            # the last position is on the last rank of the model axis
            x_last = spmd.all_gather(x_last, tp.model_axis(),
                                     axis_dim=1)[:, -1:]
        return unembed(x_last, params["embed"], plan), caches

    @torch.no_grad()
    def decode_step(self, params, caches, batch, plan=None):
        """One token for every sequence.  batch: {'token': (B,1), 'pos': ()
        or (B,)}, for ``vlm`` optionally ``embeds`` (B,1,d) and
        ``mrope_positions`` (3,B,1).  Returns (logits (B,1,V), caches), the
        caches written in place.  Over a plan's model axis the caches and
        the logits are this rank's blocks (the logits' vocab block)."""
        cfg = self.cfg
        tok = batch["token"]
        B = tok.shape[0]
        pos = batch["pos"]
        if not isinstance(pos, torch.Tensor):
            pos = torch.tensor(pos, dtype=torch.int32, device=tok.device)
        if pos.dim() == 1:                      # per-sequence positions
            positions = pos[:, None].to(torch.int32)
        else:
            positions = pos.reshape(1, 1).expand(B, 1).to(torch.int32)
        x = self._embed_in(params, batch, tok, plan)
        segments = [("dec", cfg.dec_layers)] if cfg.family == "encdec" \
            else None
        x, caches, _ = self._run_segments(
            params, x, mode="decode", caches=caches, positions=positions,
            pos_offset=self._cache_write_pos(pos),
            mrope_positions=self._mrope(batch), segments=segments,
            plan=plan)
        x = apply_norm(x, params["final_norm"], cfg.norm)
        return unembed(x, params["embed"], plan), caches

    # -- training ----------------------------------------------------------------
    def loss(self, params, batch, plan=None):
        """Mean next-token CE of ``batch["tokens"]`` (B, S), plus 0.01 x the
        load-balance and 0.001 x the router z losses summed over the MoE
        layers; returns (loss, metrics) with ``ce`` and the aux losses.
        Inside a ``shard_map`` over batch axes (the data-parallel train
        step) the CE and the aux losses are means over the global batch.
        The ``vlm`` family reads ``embeds`` and ``mrope_positions`` as
        :meth:`prefill` does; ``encdec`` reads ``frames`` (no aux
        losses)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x, _, aux = self._forward(params, batch, "train", plan)
        labels = torch.roll(tokens, -1, dims=1)
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
        mask[:, -1] = 0.0
        loss = vocab_parallel_ce(x, unembedding(params["embed"], plan),
                                 labels, mask, plan, cfg.loss_chunks)
        metrics = {"ce": loss}
        if aux:
            loss = loss + 0.01 * aux.get("moe_lb", 0.0) \
                + 0.001 * aux.get("moe_z", 0.0)
            metrics.update(aux)
        return loss, metrics

    def _cache_write_pos(self, pos):
        cfg = self.cfg
        if cfg.attn_kind == "swa" and cfg.cache_len == cfg.window:
            return torch.remainder(pos, cfg.window)
        return pos

    def cache_defs(self, B: int, S_max: int):
        """Tree of (shape, dtype) for the decode caches: a ``dec`` stack's
        ``self`` at the cache length and ``cross`` at ``cfg.enc_len``; the
        ``enc`` blocks keep none."""
        cfg = self.cfg
        S_eff = min(S_max, cfg.window) if cfg.attn_kind == "swa" else S_max
        cfg.cache_len = S_eff
        out = {}
        for kind, total in cfg.stack_sizes().items():
            if kind == "enc":
                continue
            states = {"mamba2": mamba2_state_defs, "mlstm": mlstm_state_defs,
                      "slstm": slstm_state_defs}.get(kind)
            if states is not None:
                out[kind] = states(cfg, B, total)
                continue

            def kv(S):
                shape = (total, B, S, cfg.n_kv_heads, cfg.head_dim)
                return {"k": (shape, torch.bfloat16),
                        "v": (shape, torch.bfloat16)}
            out[kind] = ({"self": kv(S_eff), "cross": kv(cfg.enc_len)}
                         if kind == "dec" else kv(S_eff))
        return out

    def cache_shardings(self, B: int, S_max: int, plan):
        """A :class:`~repro_torch.core.plan.TorchSharding` per leaf of
        :meth:`cache_defs`: the reference's logical axes (``_cache_axes``
        behind a layer dim for KV caches, ``CROSS_CACHE_AXES`` for a
        ``dec`` layer's ``cross``, the state defs' axes for the Mamba2,
        mLSTM and sLSTM states) fitted to each leaf's shape on ``plan``'s
        mesh; ``local_shape`` gives a rank's block."""
        kv_axes = ("layers",) + _cache_axes(self.cfg)
        state_axes = {"mamba2": MAMBA2_STATE_AXES, "mlstm": MLSTM_STATE_AXES,
                      "slstm": SLSTM_STATE_AXES}

        def place(leaves, axes):
            return {n: TorchSharding(plan.mesh, plan.spec_for_shape(
                shape, axes[n] if isinstance(axes, dict) else axes))
                for n, (shape, _) in leaves.items()}
        out = {}
        for kind, leaves in self.cache_defs(B, S_max).items():
            if kind == "dec":
                out[kind] = {"self": place(leaves["self"], kv_axes),
                             "cross": place(leaves["cross"], ("layers",)
                                            + CROSS_CACHE_AXES)}
            else:
                out[kind] = place(leaves, state_axes.get(kind, kv_axes))
        return out
