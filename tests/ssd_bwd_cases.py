"""Inputs that ``ssd_scan_bwd`` must refuse, shared by
``tests/test_torch_ssd.py`` (CPU tensors) and ``tests/test_torch_cuda.py``
(CUDA tensors; imports no JAX)."""

import torch

# (what is wrong, q, k, v, log_a shapes) around B1 G2 H4 S8 N16 P4: inputs
# the backward refuses before any kernel could index past them
BWD_BAD_SHAPES = [
    ("k", (1, 2, 8, 16), (1, 2, 8, 12), (1, 4, 8, 4), (1, 4, 8)),
    ("v_batch", (1, 2, 8, 16), (1, 2, 8, 16), (2, 4, 8, 4), (2, 4, 8)),
    ("v_steps", (1, 2, 8, 16), (1, 2, 8, 16), (1, 4, 9, 4), (1, 4, 9)),
    ("groups", (1, 2, 8, 16), (1, 2, 8, 16), (1, 3, 8, 4), (1, 3, 8)),
    ("log_a", (1, 2, 8, 16), (1, 2, 8, 16), (1, 4, 8, 4), (1, 4, 9)),
]
BWD_BAD_IDS = [b[0] for b in BWD_BAD_SHAPES]


def bwd_bad_inputs(shapes, device="cpu"):
    """Zero q, k, v, log_a at ``shapes`` and dy of v's shape."""
    q, k, v, la = (torch.zeros(s, device=device) for s in shapes)
    return q, k, v, la, torch.zeros_like(v)
