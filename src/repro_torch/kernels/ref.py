"""Plain PyTorch oracles, one for each kernel of the reference
(``src/repro/kernels/ref.py``): naive on purpose — the score matrix is
materialized, recurrences run step by step.  The tests hold the port's
kernels and the JAX oracles against these on shared numpy inputs."""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B,H,Sq,D); k,v: (B,Hkv,Sk,D); GQA by head repetition."""
    B, H, Sq, D = q.shape
    Hkv = k.shape[1]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    Sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / torch.sqrt(torch.tensor(float(D)))
    qpos = torch.arange(Sq)[:, None] + (Sk - Sq)  # q aligned to the end of k
    kpos = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask.to(s.device)[None, None], s,
                    torch.tensor(NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype)


def ssd_scan_ref(q, k, v, log_a):
    """Sequential gated linear recurrence: h_t = a_t h_{t-1} + k_t v_t^T ;
    y_t = q_t . h_t.  q,k: (B,H,S,N); v: (B,H,S,P); log_a: (B,H,S)."""
    B, H, S, N = q.shape
    P = v.shape[-1]
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=q.device)
    ys = []
    for t in range(S):
        h = torch.exp(log_a[:, :, t].float())[..., None, None] * h \
            + k[:, :, t].float()[..., :, None] * v[:, :, t].float()[..., None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", q[:, :, t].float(), h))
    return torch.stack(ys, dim=2).to(q.dtype)          # (B,H,S,P)


def a2a_fused_ref(logits, xs, expert_fns, capacity: int):
    """Oracle for the fused all-to-all hop: top-1 route per token, first-come
    capacity position, routed expert applied directly, dropped tokens
    zero-filled.  logits: (T, E); xs: (T, *item).  Returns ``(out, keep)``."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    idx = torch.argmax(probs, dim=-1)
    onehot = torch.nn.functional.one_hot(idx, E).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1   # FCFS rank
    keep = pos < capacity
    outs = torch.stack([torch.func.vmap(fn)(xs) for fn in expert_fns])
    out = outs[0]
    for j in range(1, E):
        sel = (idx == j).reshape((T,) + (1,) * (out.dim() - 1))
        out = torch.where(sel, outs[j], out)
    mask = keep.reshape((T,) + (1,) * (out.dim() - 1))
    return torch.where(mask, out, torch.zeros_like(out)), keep


def router_topk_ref(logits, top_k: int, capacity: int):
    """Top-k routing with capacity-bounded positions (first-come order).
    logits: (T, E) fp32.  Returns (weights (T,K), experts (T,K),
    positions (T,K), keep (T,K))."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat_e, E).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = pos < capacity
    return (w, idx.to(torch.int32), pos.reshape(T, top_k).to(torch.int32),
            keep.reshape(T, top_k))
