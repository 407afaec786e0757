"""Pytrees of tensors and arrays: the port's stand-in for ``jax.tree``.

A tree is a dict, list or tuple of trees, or a leaf.  The device boundary
uses these helpers to move per-item pytrees (dict batches, tuples) between
numpy on the host and tensors on the device, canonicalizing dtypes the way
JAX does with 64-bit mode off, so a numpy-default stream computes in the
same types in both packages.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

# JAX with x64 disabled narrows every 64-bit type on the way in
_CANON = {np.dtype(np.float64): np.dtype(np.float32),
          np.dtype(np.int64): np.dtype(np.int32),
          np.dtype(np.uint64): np.dtype(np.uint32),
          np.dtype(np.complex128): np.dtype(np.complex64)}


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``tree`` and same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def jax_leaves(tree: Any) -> List[Any]:
    """The leaves in ``jax.tree.leaves`` order: dict keys sorted, lists and
    tuples in order (:func:`tree_leaves` follows insertion order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in jax_leaves(v)]
    return [tree]


def jax_unflatten(like: Any, leaves: List[Any]) -> Any:
    """``leaves``, in :func:`jax_leaves` order, in the structure of
    ``like`` (dicts keep ``like``'s key order)."""
    it = iter(leaves)

    def build(t: Any) -> Any:
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            out = [build(v) for v in t]
            return out if isinstance(t, list) else tuple(out)
        return next(it)
    return build(like)


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """``leaves``, in :func:`tree_leaves` order, in the structure of
    ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def canonical_dtype(dtype: np.dtype) -> np.dtype:
    """The dtype ``jnp.asarray`` gives a numpy array of ``dtype``."""
    return _CANON.get(np.dtype(dtype), np.dtype(dtype))


def stack_items(items: List[Any]) -> Any:
    """Stack per-item pytrees of arrays into one numpy batch per leaf, in
    the canonical dtypes."""
    def stack(*leaves: Any) -> np.ndarray:
        arrs = [np.asarray(x) for x in leaves]
        return np.stack(arrs).astype(canonical_dtype(arrs[0].dtype),
                                     copy=False)
    return tree_map(stack, items[0], *items[1:])


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor as numpy.  numpy has no bfloat16, so a bf16
    tensor comes back widened to float32 (exact)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
