"""Parameters carried across from the reference package.

:func:`from_numpy` turns a pytree of numpy arrays — e.g. the JAX package's
parameters after ``jax.tree.map(np.asarray, params)`` — into the port's
tensors with the same nesting, so both packages compute with the same
weights.  bf16 arrays (numpy's ``bfloat16`` extension dtype, as JAX hands
them out) cross through float32, which holds every bf16 value exactly.
:func:`state_from_numpy` does the same for a whole train state, so both
packages can train from one state.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .tree import tree_map


def _leaf(a: Any, device: torch.device,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C"))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_numpy(tree: Any, device: Any,
               dtype: Optional[torch.dtype] = None) -> Any:
    """Pytree of numpy arrays -> the same pytree of tensors on ``device``,
    each leaf keeping its dtype (``dtype=`` casts the floating leaves)."""
    device = torch.device(device)
    return tree_map(lambda a: _leaf(a, device, dtype), tree)


def state_from_numpy(state: Any, device: Any,
                     dtype: Optional[torch.dtype] = None) -> Any:
    """A reference train state as numpy (``{"params", "opt", "step"}``, e.g.
    ``jax.tree.map(np.asarray, state)``) -> the port's: the parameters as
    :func:`from_numpy` gives them (``dtype=`` casts them), the optimizer's
    moments and counters and the step in their own types."""
    return {k: from_numpy(v, device, dtype if k == "params" else None)
            for k, v in state.items()}
