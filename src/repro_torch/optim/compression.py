"""Gradient compression: int8 symmetric quantization with a per-tensor
scale, and error feedback (the quantization error is carried and re-added
next step).

Port of ``src/repro/optim/compression.py``.  The reference compresses
before the cross-pod all-reduce; the port runs on one device and has no pod
axis yet, so nothing on its train step calls these.
"""

from __future__ import annotations

import torch

from ..core.tree import tree_map, tree_unflatten


def int8_compress(x: torch.Tensor):
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_grads(grads, errors):
    """Error-feedback compression: returns (dequantized grads in their own
    types, new error tree).  The quantization error (g+e) - deq(q) is fed
    back next step."""
    def one(g, e):
        gf = g.float() + e
        deq = int8_decompress(*int8_compress(gf))
        return deq.to(g.dtype), gf - deq

    out = []
    tree_map(lambda g, e: out.append(one(g, e)), grads, errors)
    return tree_unflatten(grads, [o[0] for o in out]), \
        tree_unflatten(grads, [o[1] for o in out])
