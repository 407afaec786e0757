"""Parameter definition trees.

Port of ``src/repro/models/params.py``.  A model builds a nested dict of
:class:`ParamDef` leaves; :func:`init_params` draws real tensors from it with
a ``torch.Generator`` (on the generator's device, so a CUDA generator fills
the card directly).  Each def names its dims' logical axes, as in the
reference: :func:`pspecs`, :func:`shardings` and :func:`shape_structs`
read them through a :class:`~repro_torch.core.plan.ShardingPlan`; over a
mesh with ranks :func:`init_blocks` draws each rank's blocks (the same
numbers as the whole draw's slices, without the whole) and
:func:`block_shapes` gives their shapes.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Iterator, Optional, Tuple

import torch

from ..core.tree import tree_leaves, tree_map

_DRAW = 1 << 28                  # elements drawn at once: 1 GiB of fp32


@dataclasses.dataclass
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float = 1.0            # fan-in style scale applied by _init_leaf

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _init_leaf(d: ParamDef, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    # fan-in scaled truncated normal, cut at two standard deviations
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale / math.sqrt(max(fan_in, 1))
    if d.init == "embed":
        std = d.scale
    # drawn in fp32 pieces of at most _DRAW elements, so a leaf of tens of
    # GB (Kimi-K2's expert stacks) needs no fp32 twin of itself
    out = torch.empty(d.shape, dtype=d.dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), _DRAW):
        x = torch.empty(min(_DRAW, flat.numel() - i), dtype=torch.float32,
                        device=device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        flat[i:i + x.numel()] = x * std
    return out


def _block_runs(shape, slices):
    """The block ``slices`` of a row-major tensor of ``shape`` as runs of
    whole-tensor flat indices: [(start, length)] in the block's own flat
    order."""
    split = [d for d, (sl, n) in enumerate(zip(slices, shape))
             if (sl.start, sl.stop) != (0, n)]
    if not split:
        return [(0, math.prod(shape))]
    k = split[-1]
    inner = math.prod(shape[k + 1:])
    length = (slices[k].stop - slices[k].start) * inner
    runs = []
    for outer in itertools.product(*[range(sl.start, sl.stop)
                                     for sl in slices[:k]]):
        row = 0
        for i, n in zip(outer, shape[:k]):
            row = row * n + i
        runs.append(((row * shape[k] + slices[k].start) * inner, length))
    return runs


def _init_block(d: ParamDef, gen: torch.Generator, device: torch.device,
                slices) -> torch.Tensor:
    """This block of the leaf :func:`_init_leaf` draws, drawn the same way
    (the same pieces from ``gen``, so the same numbers) but keeping only
    the block: the whole is never held."""
    shape = tuple(sl.stop - sl.start for sl in slices)
    if shape == tuple(d.shape):
        return _init_leaf(d, gen, device)
    if d.init in ("zeros", "ones"):          # a fill draws nothing
        return (torch.zeros if d.init == "zeros" else torch.ones)(
            shape, dtype=d.dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale if d.init == "embed" else d.scale / math.sqrt(
        max(fan_in, 1))
    out = torch.empty(shape, dtype=d.dtype, device=device)
    flat = out.view(-1)
    runs = _block_runs(tuple(d.shape), slices)
    total, r, pos = math.prod(d.shape), 0, 0    # next run, its output
    for i in range(0, total, _DRAW):
        x = torch.empty(min(_DRAW, total - i), dtype=torch.float32,
                        device=device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        end = i + x.numel()
        while r < len(runs) and runs[r][0] < end:
            start, n = runs[r]
            lo, hi = max(start, i), min(start + n, end)
            if hi > lo:
                o = pos + (lo - start)
                flat[o:o + hi - lo] = x[lo - i:hi - i] * std
            if start + n > end:
                break                   # the run goes on in the next piece
            pos += n
            r += 1
    return out


def init_blocks(defs: Any, gen: torch.Generator, plan,
                coords: Optional[dict] = None) -> Any:
    """This rank's blocks of :func:`init_params`' draw on ``plan``'s mesh
    (each leaf's ``shardings`` block; ``coords`` names a position of an
    abstract mesh), equal to slicing the whole draw, bit for bit, with at
    most one drawn piece held beside the blocks."""
    device = gen.device
    sh = shardings(defs, plan)
    return tree_map(lambda d, s: _init_block(
        d, gen, device, s.local_slices(d.shape, coords)), defs, sh)


def block_shapes(defs: Any, plan, coords: Optional[dict] = None) -> Any:
    """Each leaf's block shape on ``plan``'s mesh (the reference's
    ``NamedSharding.shard_shape``)."""
    return tree_map(lambda d, s: s.local_shape(d.shape, coords), defs,
                    shardings(defs, plan))


def init_params(defs: Any, gen: torch.Generator) -> Any:
    """Real parameters for a def tree, drawn leaf by leaf from ``gen`` on
    the generator's device.  The numbers differ from the reference's
    ``jax.random`` draw; tests carry the reference's parameters across with
    ``core.params.from_numpy`` instead."""
    device = gen.device
    return tree_map(lambda d: _init_leaf(d, gen, device), defs)


def shape_structs(defs: Any, plan=None) -> Any:
    """Stand-ins for the parameters that allocate nothing: meta tensors of
    each def's shape and type, each with its ``sharding`` (a
    :class:`~repro_torch.core.plan.TorchSharding`, DTensor placements on
    the plan's mesh) when a plan is given — the dry run's
    ``ShapeDtypeStruct``s."""
    def leaf(d: ParamDef) -> torch.Tensor:
        t = torch.empty(d.shape, dtype=d.dtype, device="meta")
        t.sharding = None if plan is None else \
            plan.sharding_for(d.axes, d.shape)
        return t
    return tree_map(leaf, defs)


def shardings(defs: Any, plan) -> Any:
    return tree_map(lambda d: plan.sharding_for(d.axes, d.shape), defs)


def pspecs(defs: Any, plan) -> Any:
    return tree_map(lambda d: plan.param_spec(d.axes, d.shape), defs)


def walk_defs(defs: Any, path: Tuple[str, ...] = ()
              ) -> Iterator[Tuple[Tuple[str, ...], ParamDef]]:
    """(key path, def) for every leaf of a nested dict of defs."""
    if isinstance(defs, dict):
        for k, v in defs.items():
            yield from walk_defs(v, path + (k,))
    else:
        yield path, defs


def count_params(defs: Any) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs))


def bytes_params(defs: Any) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize
               for d in tree_leaves(defs))
