"""State-space / linear-recurrence blocks on one device: Mamba2 (SSD).

Port of ``src/repro/models/ssm.py`` (``gla_step``, ``mamba2_dims``,
``mamba2_defs``, ``_causal_conv``, ``mamba2_block``,
``mamba2_state_defs``).  Prefill runs the recurrence on the hand-written
``ssd_scan`` kernel (``kernels/ssd_scan.py``) in its (B, H, S, N) layout,
where the reference runs ``chunked_gla`` (an associative scan over the
chunk transforms); both compute the same chunkwise recurrence, and the
tests hold ``ssd_scan`` (y and the final state) to the reference's
``chunked_gla``.  B and C go to the kernel once per group instead of
repeated to every head, and the kernel takes any prompt length (the
reference needs a multiple of the chunk).  Decode stays plain, as in the reference, and writes
the new ``ssm`` and ``conv`` state into the given cache slices in place
instead of returning updated copies.  The block's two silu gates round as
the reference's ``jax.nn.silu`` does in bf16 (:func:`silu_stepwise`): the
block's B and C projections are large under the reference's init, and a
one-ulp difference in a gate moves the whole model's logits by several
percent.  The reference's sharding constraints are no-ops on one device and
are dropped.  Over a plan's model axis (inside the steps' manual region)
the block runs on this rank's blocks as the reference's GSPMD program
does: the sequence-parallel gather of the normed input, ``wz``/``wx``/
``wdt`` and the conv over d_inner, ``A_log``/``D``/``dt_bias`` on the
local heads, ``wB``/``wC`` replicated (each rank passes the scan the
groups its heads read), ``ssd_scan`` on the local H/tp heads and ``wo``
row-parallel; the decode state holds the local
heads (``ssm``) and the local d_inner block (``conv``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan
from ..core.plan import model_plan
from .layers import einsum, gathered, mm, rms_norm, silu_stepwise
from .params import ParamDef


def gla_step(state, q, k, v, log_a):
    """Single decode step: state (B,H,N,P); q/k (B,1,H,N); v (B,1,H,P).
    Returns the new state and y (B,1,H,P), both fp32."""
    a = torch.exp(log_a.float())[:, 0, :, None, None]        # (B,H,1,1)
    kv = torch.einsum("bhn,bhp->bhnp", k[:, 0].float(), v[:, 0].float())
    state = state * a + kv
    y = torch.einsum("bhn,bhnp->bhp", q[:, 0].float(), state)
    return state, y[:, None]


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------
def mamba2_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    return d_inner, n_heads


def mamba2_defs(cfg, layers: Optional[int] = None):
    d_inner, H = mamba2_dims(cfg)
    N = cfg.ssm_state
    G = cfg.ssm_groups
    K = cfg.ssm_conv
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    return {
        "norm": {"w": ParamDef(lead + (cfg.d_model,), la + (None,),
                               init="zeros")},
        "wz": ParamDef(lead + (cfg.d_model, d_inner), la + ("fsdp", "tp")),
        "wx": ParamDef(lead + (cfg.d_model, d_inner), la + ("fsdp", "tp")),
        "wB": ParamDef(lead + (cfg.d_model, G, N), la + ("fsdp", None, None)),
        "wC": ParamDef(lead + (cfg.d_model, G, N), la + ("fsdp", None, None)),
        "wdt": ParamDef(lead + (cfg.d_model, H), la + ("fsdp", "tp")),
        "dt_bias": ParamDef(lead + (H,), la + ("tp",), init="zeros"),
        "A_log": ParamDef(lead + (H,), la + ("tp",), init="zeros"),
        "D": ParamDef(lead + (H,), la + ("tp",), init="zeros"),
        "conv": ParamDef(lead + (K, d_inner), la + (None, "tp")),
        "wo": ParamDef(lead + (d_inner, cfg.d_model), la + ("tp", "fsdp")),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv along seq: x (B,S,C), w (K,C), products in
    fp32, the result in x's type.  Prefill returns the last K-1 inputs as
    the decode state (B,K-1,C); with ``state`` this is the decode step
    (S == 1), which writes the shifted window into ``state`` in place."""
    K = w.shape[0]
    if state is not None:
        buf = torch.cat([state, x], dim=1)                    # (B,K,C)
        y = torch.einsum("bkc,kc->bc", buf.float(), w.float())[:, None]
        state.copy_(buf[:, 1:])
        # einsum may return a strided result; the gates' kernel takes a
        # contiguous one
        return y.to(x.dtype).contiguous(), state
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))                           # (B,S+K-1,C)
    y = sum(xp[:, i:i + S].float() * w[i].float() for i in range(K))
    return y.to(x.dtype), xp[:, S:] if K > 1 else None


def _groups_of_heads(Bm, Cm, h0: int, n: int, rep: int):
    """The B/C groups (B, S, G, N) that the heads ``h0 .. h0 + n`` read
    (head h reads group h // ``rep``), as the scan takes them: the groups'
    slice when each serves the same number of consecutive heads of the
    range, else one group per head.  A model axis splits the heads and
    keeps ``wB``/``wC`` whole, as the reference's layout does."""
    ids = [(h0 + j) // rep for j in range(n)]
    first, g = ids[0], ids[-1] - ids[0] + 1
    if n % g == 0 and ids == [first + j // (n // g) for j in range(n)]:
        return Bm.narrow(2, first, g), Cm.narrow(2, first, g)
    idx = torch.tensor(ids, device=Bm.device)
    return Bm.index_select(2, idx), Cm.index_select(2, idx)


def mamba2_block(x, p, cfg, *, state=None, chunk: int = 256, plan=None,
                 sp: bool = False):
    """state: None (no state kept) | 'init' (prefill: return the final
    state) | dict {ssm, conv} (decode step: written in place and
    returned).  Returns (x + out, state).  With a plan whose model axis is
    manual, ``x`` is this rank's block of the residual (sequence-sharded
    when ``sp``), and ``p`` and the state this rank's blocks."""
    tp = model_plan(plan)
    xn = rms_norm(x, p["norm"]["w"])
    if tp is not None:
        xn = tp.seq_gather(xn, sp)           # SP gather (bf16)
    B, S, _ = xn.shape
    d_inner, H = mamba2_dims(cfg)
    G, P = cfg.ssm_groups, cfg.ssm_headdim
    h0 = 0                                    # this rank's first head
    if tp is not None:                        # this rank's heads
        d_inner, H = p["wx"].shape[-1], p["A_log"].shape[-1]
        if d_inner != H * P:
            raise NotImplementedError(
                f"a Mamba2 block whose d_inner and {mamba2_dims(cfg)[1]} "
                "heads split apart over the model axis")
        if H < mamba2_dims(cfg)[1]:
            h0 = tp.mesh.coord(tp.model_axis()) * H
    decode = isinstance(state, dict)

    defs = mamba2_defs(cfg)
    w = {n: gathered(plan, p[n], defs[n].axes)
         for n in ("wz", "wx", "wB", "wC", "wdt")}
    z = mm(xn, w["wz"])
    xi = mm(xn, w["wx"])
    Bm = einsum("bsd,dgn->bsgn", xn, w["wB"])               # (B,S,G,N) bf16
    Cm = einsum("bsd,dgn->bsgn", xn, w["wC"])
    if G > 1 and H < mamba2_dims(cfg)[1]:     # the groups the heads read
        Bm, Cm = _groups_of_heads(Bm, Cm, h0, H, mamba2_dims(cfg)[1] // G)
    dt = mm(xn, w["wdt"]) + p["dt_bias"]
    dt = F.softplus(dt.float())                              # (B,S,H)

    conv_state = state["conv"] if decode else None
    xi, new_conv = _causal_conv(xi, p["conv"], conv_state)
    xi = silu_stepwise(xi)

    A = -torch.exp(p["A_log"].float())                       # (H,) negative
    log_a = dt * A[None, None, :]                            # (B,S,H)
    xh = xi.reshape(B, S, H, P)
    dtx = xh.float() * dt[..., None]                         # (B,S,H,P) fp32

    if decode:
        rep = H // Bm.shape[2]
        k = Bm.repeat_interleave(rep, dim=2)                 # (B,1,H,N)
        q = Cm.repeat_interleave(rep, dim=2)
        new_ssm, y = gla_step(state["ssm"], q, k, dtx, log_a)
        state["ssm"].copy_(new_ssm)
        new_state = state
    else:
        # the kernel's layout: (B,S,·,·) -> (B,·,S,·), made explicit
        y, s_final = ssd_scan(
            Cm.transpose(1, 2).contiguous(), Bm.transpose(1, 2).contiguous(),
            dtx.transpose(1, 2).contiguous(),
            log_a.transpose(1, 2).contiguous(), chunk,
            out_dtype=torch.float32, return_state=True)
        y = y.transpose(1, 2)                                # (B,S,H,P)
        new_state = None
        if state == "init":
            new_state = {"ssm": s_final,
                         "conv": new_conv if new_conv is not None else
                         torch.zeros((B, cfg.ssm_conv - 1, d_inner),
                                     dtype=x.dtype, device=x.device)}

    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = y * silu_stepwise(z)
    out = mm(y, gathered(plan, p["wo"], defs["wo"].axes)).to(torch.bfloat16)
    if tp is not None:
        out = tp.compose(out, sp, defs["wo"])
    return x + out, new_state


# the decode state's logical axes (the reference's ``mamba2_state_defs``)
MAMBA2_STATE_AXES = {"ssm": ("layers", "batch", "tp", None, None),
                     "conv": ("layers", "batch", None, "tp")}


def mamba2_state_defs(cfg, B: int, layers: int):
    """(shape, dtype) of the decode state, with a leading layer dimension."""
    d_inner, H = mamba2_dims(cfg)
    return {
        "ssm": ((layers, B, H, cfg.ssm_state, cfg.ssm_headdim),
                torch.float32),
        "conv": ((layers, B, cfg.ssm_conv - 1, d_inner), torch.bfloat16),
    }
