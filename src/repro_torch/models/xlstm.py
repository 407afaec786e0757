"""xLSTM blocks on one device: mLSTM (matrix memory) and sLSTM (scalar
memory).

Port of ``src/repro/models/xlstm.py`` (``mlstm_dims``, ``mlstm_defs``,
``mlstm_block``, ``mlstm_state_defs``, ``slstm_defs``, ``slstm_block``,
``slstm_state_defs``).

- mLSTM: C_t = f_t C_{t-1} + i_t v_t k_t^T, h = o (q.C / max(|q.n|, 1)),
  the normaliser n_t the same recurrence with v = 1.  Prefill runs both
  recurrences on the hand-written ``ssd_scan`` kernel
  (``kernels/ssd_scan.py``), where the reference runs ``chunked_gla``
  twice: the numerator with v = v * i (P = d_inner / H, 384 at full width)
  and the normaliser with v = i (P = 1), both returning their final fp32
  state for decode.  Decode runs ``gla_step`` twice, as the reference does,
  and writes ``C``, ``n`` and ``conv`` into the given cache slices in place.
- sLSTM: per-unit scalar recurrences c_t = f_t c_{t-1} + i_t z_t and
  n_t = f_t n_{t-1} + i_t, h = o c / max(n, 1e-6), with the reference's
  hidden-to-hidden matrix dropped (gates read the input only).  Prefill is a
  log-depth scan over the sequence with the reference's combine, the tree of
  ``jax.lax.associative_scan`` (:func:`associative_scan`); both recurrences
  share their decay products, so they are scanned together.  Decode writes
  ``c`` and ``n`` into the cache in place.

The gates round as the reference's do in bf16: both silu gates of the
mLSTM through ``silu_stepwise`` (``jax.nn.silu``'s every-step rounding),
``k / sqrt(P)`` as a division of bf16 by the bf16-rounded constant, the
output product rounded to bf16 (``preferred_element_type``).  The
reference's sharding constraints are no-ops on one device and are dropped.

Over a plan's model axis (inside the steps' manual region) both blocks run
on the rank's blocks, as GSPMD lays out the reference's: the residual's
sequence block is gathered at the entry; in the mLSTM ``wup``, ``wgate``
and the per-channel conv give the rank's channels, and ``c`` and ``up``
are gathered back over the channels (the model axis) before ``wq``, ``wk``,
``wv``, ``wi`` and ``wf``, whose column blocks are the rank's heads — so
each q, k, v and gate element is the whole contraction, rounded once as
on one device, where summing partial products would round each rank's
part — then ``ssd_scan`` runs on the local heads, ``h * gate`` on the
local channels, and ``wo`` is row-parallel (``compose``).  The sLSTM's
four gates are column-parallel, its channel-wise scans local, ``wo``
row-parallel.  The decode states take the reference's axes
(:data:`MLSTM_STATE_AXES`, :data:`SLSTM_STATE_AXES`): C and n over the
heads, conv, c and n over the channels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core import spmd
from ..core.plan import model_plan
from ..kernels.ssd_scan import ssd_scan
from .layers import gathered, mm, rms_norm
from .params import ParamDef
from .ssm import _causal_conv, gla_step, silu_stepwise


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.n_heads
    P = d_inner // H
    return d_inner, H, P


def mlstm_defs(cfg, layers: Optional[int] = None):
    d_inner, H, P = mlstm_dims(cfg)
    K = cfg.ssm_conv
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    return {
        "norm": {"w": ParamDef(lead + (cfg.d_model,), la + (None,),
                               init="zeros")},
        "wup": ParamDef(lead + (cfg.d_model, d_inner), la + ("fsdp", "tp")),
        "wgate": ParamDef(lead + (cfg.d_model, d_inner), la + ("fsdp", "tp")),
        "conv": ParamDef(lead + (K, d_inner), la + (None, "tp")),
        "wq": ParamDef(lead + (d_inner, d_inner), la + ("fsdp", "tp")),
        "wk": ParamDef(lead + (d_inner, d_inner), la + ("fsdp", "tp")),
        "wv": ParamDef(lead + (d_inner, d_inner), la + ("fsdp", "tp")),
        "wi": ParamDef(lead + (d_inner, H), la + ("fsdp", "tp")),
        "wf": ParamDef(lead + (d_inner, H), la + ("fsdp", "tp")),
        "wo": ParamDef(lead + (d_inner, cfg.d_model), la + ("tp", "fsdp")),
    }


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, ...) -> (B, H, S, ...), contiguous: the kernel's layout."""
    return t.transpose(1, 2).contiguous()


def mlstm_block(x, p, cfg, *, state=None, chunk: int = 256, plan=None,
                sp=False):
    """state: None (no state kept) | 'init' (prefill: return the final
    state) | dict {C, n, conv} (decode step: written in place and
    returned).  Returns (x + out, state).  With a plan whose model axis is
    manual, ``x`` is this rank's block of the residual (sequence-sharded
    when ``sp``), ``p`` and the state this rank's blocks."""
    tp = model_plan(plan)
    B, P = x.shape[0], mlstm_dims(cfg)[2]
    decode = isinstance(state, dict)

    xn = rms_norm(x if tp is None else tp.seq_gather(x, sp), p["norm"]["w"])
    S = xn.shape[1]
    defs = mlstm_defs(cfg)
    w = {n: gathered(plan, p[n], defs[n].axes)
         for n in ("wup", "wgate", "wq", "wk", "wv", "wi", "wf")}
    up = mm(xn, w["wup"])
    gate = silu_stepwise(mm(xn, w["wgate"]))

    conv_state = state["conv"] if decode else None
    c, new_conv = _causal_conv(up, p["conv"], conv_state)
    c = silu_stepwise(c)
    if tp is not None:
        c, up = _all_channels(tp, cfg, c, up)

    q = mm(c, w["wq"])
    # a bf16 tensor over a Python float: JAX rounds the constant to bf16
    # and divides (a fill on the device, no host-to-device copy)
    k = mm(c, w["wk"]) \
        / torch.full((), P ** 0.5, dtype=c.dtype, device=c.device)
    v = mm(up, w["wv"])
    if tp is not None and q.shape[-1] // P != w["wi"].shape[-1]:
        # the columns split but not the heads (H % tp != 0): every head
        m = tp.model_axis()
        q, k, v = (spmd.all_gather(t, m, axis_dim=2) for t in (q, k, v))
    Hl = q.shape[-1] // P                     # this rank's heads
    q, k, v = (t.reshape(B, S, Hl, P) for t in (q, k, v))
    i_gate = mm(c, w["wi"]).float()
    f_gate = mm(c, w["wf"]).float()
    log_a = F.logsigmoid(f_gate)                              # (B,S,H)
    i_scl = torch.exp(torch.clamp(i_gate, -20.0, 2.0))[..., None]
    vi = v.float() * i_scl                                    # (B,S,H,P)

    if decode:
        new_C, num = gla_step(state["C"], q, k, vi, log_a)
        new_n, den = gla_step(state["n"], q, k, i_scl, log_a)
        state["C"].copy_(new_C)
        state["n"].copy_(new_n)
        new_state = state
    else:
        qh, kh, lah = _heads_first(q), _heads_first(k), _heads_first(log_a)
        num, C_fin = ssd_scan(qh, kh, _heads_first(vi), lah, chunk,
                              out_dtype=torch.float32, return_state=True)
        den, n_fin = ssd_scan(qh, kh, _heads_first(i_scl), lah, chunk,
                              out_dtype=torch.float32, return_state=True)
        num, den = num.transpose(1, 2), den.transpose(1, 2)   # (B,S,H,·)
        new_state = None
        if state == "init":
            new_state = {"C": C_fin, "n": n_fin, "conv": new_conv}

    h = num / torch.clamp(den.abs(), min=1.0)
    h = h.reshape(B, S, Hl * P).to(x.dtype)
    if h.shape[-1] != gate.shape[-1]:         # every head: the rank's channels
        h = tp.block(h, 2)
    out = mm(h * gate, gathered(plan, p["wo"], defs["wo"].axes)).to(
        torch.bfloat16)
    if tp is not None:
        out = tp.compose(out, sp, defs["wo"])
    return x + out, new_state


def _all_channels(tp, cfg, c, up):
    """``c`` and ``up`` over every channel of d_inner: gathered over the
    model axis where the conv's def splits the channels."""
    conv = mlstm_defs(cfg)["conv"]
    if not tp.model_split(conv.shape, conv.axes):
        return c, up
    m = tp.model_axis()
    return (spmd.all_gather(c, m, axis_dim=2),
            spmd.all_gather(up, m, axis_dim=2))


# the decode state's logical axes behind its layer dim (the reference's
# ``mlstm_state_defs``): C and n over the heads, conv over the channels
MLSTM_STATE_AXES = {"C": ("layers", "batch", "tp", None, None),
                    "n": ("layers", "batch", "tp", None, None),
                    "conv": ("layers", "batch", None, "tp")}


def mlstm_state_defs(cfg, B: int, layers: int):
    """(shape, dtype) of the decode state, with a leading layer dimension."""
    d_inner, H, P = mlstm_dims(cfg)
    return {
        "C": ((layers, B, H, P, P), torch.float32),
        "n": ((layers, B, H, P, 1), torch.float32),
        "conv": ((layers, B, cfg.ssm_conv - 1, d_inner), torch.bfloat16),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_defs(cfg, layers: Optional[int] = None):
    d = cfg.d_model
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    return {
        "norm": {"w": ParamDef(lead + (d,), la + (None,), init="zeros")},
        "wz": ParamDef(lead + (d, d), la + ("fsdp", "tp")),
        "wi": ParamDef(lead + (d, d), la + ("fsdp", "tp")),
        "wf": ParamDef(lead + (d, d), la + ("fsdp", "tp")),
        "wo_gate": ParamDef(lead + (d, d), la + ("fsdp", "tp")),
        "wo": ParamDef(lead + (d, d), la + ("tp", "fsdp")),
    }


def _decay_combine(a, b):
    """Compose two steps of h -> f h + u (a first): the reference's combine
    on (f, c) and on (f, n), the decay shared."""
    f1, *u1 = a
    f2, *u2 = b
    return (f1 * f2,) + tuple(f2 * x1 + x2 for x1, x2 in zip(u1, u2))


def associative_scan(fn, elems: tuple, dim: int = 1) -> tuple:
    """Inclusive scan of ``elems`` (tensors of one length along ``dim``)
    under the associative ``fn``, on the tree ``jax.lax.associative_scan``
    builds: combine neighbouring pairs, scan the pairs, then fill in the
    even positions.  ~2 log2(S) rounds of whole-tensor operations."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    odd = associative_scan(fn, fn(tuple(sl(e, 0, -1, 2) for e in elems),
                                  tuple(sl(e, 1, None, 2) for e in elems)),
                           dim)
    if n % 2 == 0:
        even = fn(tuple(sl(o, 0, -1) for o in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim)
                 for e, r in zip(elems, even))
    out = []
    for ev, od in zip(even, odd):           # interleave: ev0 od0 ev1 od1 ...
        if od.shape[dim] < ev.shape[dim]:
            od = torch.cat([od, torch.zeros_like(sl(ev, 0, 1))], dim)
        both = torch.stack([ev, od], dim + 1)
        shape = list(ev.shape)
        shape[dim] *= 2
        out.append(sl(both.reshape(shape), 0, n))
    return tuple(out)


def slstm_block(x, p, cfg, *, state=None, plan=None, sp=False):
    """state: None | 'init' (prefill: return the last c and n) | dict {c, n}
    (decode step: written in place and returned).  Returns (x + out,
    state).  With a plan whose model axis is manual, ``x`` is this rank's
    block of the residual (sequence-sharded when ``sp``), the gates and
    the state this rank's channels."""
    tp = model_plan(plan)
    decode = isinstance(state, dict)
    xn = rms_norm(x if tp is None else tp.seq_gather(x, sp), p["norm"]["w"])
    defs = slstm_defs(cfg)
    w = {n: gathered(plan, p[n], defs[n].axes)
         for n in ("wz", "wi", "wf", "wo_gate", "wo")}
    z = torch.tanh(mm(xn, w["wz"]).float())
    i = torch.exp(torch.clamp(mm(xn, w["wi"]).float(), -20.0, 2.0))
    f = torch.sigmoid(mm(xn, w["wf"]).float())
    o = torch.sigmoid(mm(xn, w["wo_gate"]).float())

    if decode:
        c = f[:, 0] * state["c"] + i[:, 0] * z[:, 0]
        n = f[:, 0] * state["n"] + i[:, 0]
        h = (o[:, 0] * c / torch.clamp(n, min=1e-6))[:, None]
        state["c"].copy_(c)
        state["n"].copy_(n)
        new_state = state
    else:
        _, c, n = associative_scan(_decay_combine, (f, i * z, i), dim=1)
        h = o * c / torch.clamp(n, min=1e-6)
        new_state = {"c": c[:, -1], "n": n[:, -1]} if state == "init" \
            else None

    out = mm(h.to(x.dtype), w["wo"]).to(torch.bfloat16)
    if tp is not None:
        out = tp.compose(out, sp, defs["wo"])
    return x + out, new_state


# the decode state's logical axes behind its layer dim: c and n over the
# channels
SLSTM_STATE_AXES = {"c": ("layers", "batch", "tp"),
                    "n": ("layers", "batch", "tp")}


def slstm_state_defs(cfg, B: int, layers: int):
    d = cfg.d_model
    return {
        "c": ((layers, B, d), torch.float32),
        "n": ((layers, B, d), torch.float32),
    }
