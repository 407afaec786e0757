"""Device-side skeleton lowering: the FastFlow patterns as batched PyTorch
programs on one CUDA device.

==================  ==========================================================
FastFlow skeleton    device lowering here
==================  ==========================================================
farm (DP)           ``farm_map`` — on one device, one batched call
feedback            ``feedback_scan`` — wrap_around as K batched turns;
                    ``feedback_while`` — the data-dependent variant with a
                    per-lane active mask (per-item early exit)
all_to_all          ``a2a_dispatch`` — left map, route, the fused a2a hop
                    (``kernels/a2a_fused.py``: CUDA route + combine kernels)
==================  ==========================================================

Port of ``src/repro/core/device.py``.  Where the reference writes a per-item
function and lets ``jax.vmap`` batch it, the lowerings here take functions
that are already batched (``torch.func.vmap`` of the per-item function), so
a loop whose length depends on the data runs as a plain Python loop over the
whole batch.  ``tensor_map``, ``pipeline_shard`` and ``flash_decode_combine``
(the multi-device lowerings) come with the multi-device slice.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from .tree import tree_leaves, tree_map


def _mesh_size(mesh: Any, axis: str) -> int:
    return int(dict(mesh.shape).get(axis, 1)) if mesh is not None else 1


# ---------------------------------------------------------------------------
# farm over the data axis (the plain DP farm)
# ---------------------------------------------------------------------------
def farm_map(fn: Callable, mesh: Any = None, axis: str = "data") -> Callable:
    """Run the batched ``fn`` as the farm's workers over ``axis``: on one
    device the round-robin schedule is the batch itself, so the farm is one
    batched call."""
    if _mesh_size(mesh, axis) > 1:
        raise NotImplementedError("farm_map over several devices is not "
                                  "ported yet")
    return fn


# ---------------------------------------------------------------------------
# feedback channel (wrap_around)
# ---------------------------------------------------------------------------
def feedback_scan(step_fn: Callable, init_state: Any, n_steps: int,
                  collect: bool = True):
    """Route the stream back to the input ``n_steps`` times:
    ``state -> step_fn -> state``, with ``step_fn(state) -> (state, emit)``.
    Returns ``(state, emits stacked along a new leading axis)`` — or
    ``(state, None)`` without ``collect`` — as ``lax.scan`` does."""
    state, emits = init_state, []
    for _ in range(n_steps):
        state, emit = step_fn(state)
        if collect:
            emits.append(emit)
    if not collect or not emits:
        return state, None
    return state, tree_map(lambda *es: torch.stack(
        [torch.as_tensor(e) for e in es]), *emits)


def _where_lanes(active: torch.Tensor, new: torch.Tensor,
                 old: torch.Tensor) -> torch.Tensor:
    mask = active.reshape(active.shape + (1,) * (new.dim() - active.dim()))
    return torch.where(mask, new, old)


def feedback_while(step_fn: Callable, init_state: Any, cond_fn: Callable,
                   max_steps: Optional[int] = None):
    """Data-dependent feedback channel over a batch of lanes: ``do {state =
    step(state)} while (cond(state))`` per lane, the batched counterpart of
    the reference's vmapped ``lax.while_loop``.

    ``step_fn(state) -> (state, emit)`` and ``cond_fn(state) -> bool per
    lane`` are batched over the leading axis.  Every lane runs the step at
    least once; the loop turns while any lane is active, and a finished
    lane's state is frozen by the ``active`` mask, so extra turns cannot
    change it.  ``max_steps`` caps the turns.  Returns ``(final_state,
    n_steps per lane)``."""
    leaf = tree_leaves(init_state)[0]
    lanes = leaf.shape[:1]
    active = torch.ones(lanes, dtype=torch.bool, device=leaf.device)
    k = torch.zeros(lanes, dtype=torch.int32, device=leaf.device)
    state = init_state
    while True:
        new_state, _ = step_fn(state)
        state = tree_map(lambda old, new: _where_lanes(active, new, old),
                         state, new_state)
        k = k + active.to(torch.int32)
        go = torch.as_tensor(cond_fn(state), device=leaf.device).to(torch.bool)
        if max_steps is not None:
            go = go & (k < max_steps)
        active = active & go
        if not bool(active.any()):
            return state, k


# ---------------------------------------------------------------------------
# all-to-all (ff_a2a) as dispatch/combine through the fused hop
# ---------------------------------------------------------------------------
def a2a_dispatch(left_fns: Sequence[Callable], right_fns: Sequence[Callable],
                 router: Optional[Callable] = None, mesh: Any = None,
                 axis: str = "data",
                 capacity_factor: Optional[float] = None) -> Callable:
    """Device lowering of ``ff_a2a``: left workers map the batch, then the
    whole dispatch/combine hop — route, capacity position, expert compute,
    combine — runs through :func:`~repro_torch.kernels.a2a_fused.a2a_fused`
    (the route and combine are CUDA kernels on the card), sized by
    :func:`expert_capacity`.

    Semantics mirror the host :class:`~repro_torch.core.graph.A2ASkeleton`:
    item ``t`` enters left worker ``t % nL`` (the feeder's round-robin);
    without a ``router`` the default schedule matches the host's
    per-producer staggered round-robin ``(i + k) % nR``.  A ``router(item,
    n_right) -> int`` must be a torch function ``torch.func.vmap`` can
    batch.  ``capacity_factor=None`` sizes every lane to the whole batch
    (lossless); with a factor, items beyond capacity produce zeros.

    Returns ``batched(xs, t_idx)`` mapping a stacked batch ``(T, ...)`` plus
    absolute stream indices ``(T,)`` to stacked outputs ``(T, ...)``; right
    workers must agree on output shape/dtype."""
    from ..kernels.a2a_fused import a2a_fused

    if _mesh_size(mesh, axis) > 1:
        raise NotImplementedError("a2a_dispatch over several devices is not "
                                  "ported yet")
    nL, nR = len(left_fns), len(right_fns)
    one_left = all(f is left_fns[0] for f in left_fns)

    def left_apply(xs: torch.Tensor, t_idx: torch.Tensor) -> torch.Tensor:
        if one_left:
            return torch.func.vmap(left_fns[0])(xs)
        # each residue class t % nL is one left worker's share of the batch
        # (the reference's lax.switch per item), scattered back in order
        lane = t_idx % nL
        parts = [(lane == i).nonzero().squeeze(1) for i in range(nL)]
        outs = [torch.func.vmap(left_fns[i])(xs[p]) if p.numel() else None
                for i, p in enumerate(parts)]
        ref = next(o for o in outs if o is not None)
        ys = torch.empty((xs.shape[0],) + ref.shape[1:], dtype=ref.dtype,
                         device=ref.device)
        for p, o in zip(parts, outs):
            if o is not None:
                ys[p] = o
        return ys

    def batched(xs: torch.Tensor, t_idx: torch.Tensor) -> torch.Tensor:
        T = xs.shape[0]
        ys = left_apply(xs, t_idx)
        if router is not None:
            e = torch.func.vmap(lambda y: torch.as_tensor(router(y, nR)))(ys)
            e = e.to(torch.int32) % nR
        else:  # host default: producer i's k-th output goes to (i + k) % nR
            e = (((t_idx % nL) + (t_idx // nL)) % nR).to(torch.int32)
        cap = T if capacity_factor is None else \
            expert_capacity(T, nR, 1, capacity_factor)
        logits = torch.nn.functional.one_hot(e.long(), nR).to(torch.float32)
        out, _keep = a2a_fused(logits, ys, right_fns, cap)
        return out

    return batched


# ---------------------------------------------------------------------------
# MoE farm helpers (emitter = learned load balancer)
# ---------------------------------------------------------------------------
def expert_capacity(tokens_per_shard: int, n_experts: int, top_k: int,
                    capacity_factor: float, multiple_of: int = 8) -> int:
    """Slots per expert per token-shard — the bounded SPSC lane depth of the
    MoE farm.  Tasks beyond capacity are dropped (FastFlow would block; a
    synchronous SPMD program must bound the lane)."""
    cap = int(tokens_per_shard * top_k * capacity_factor / n_experts)
    cap = max(multiple_of, (cap + multiple_of - 1) // multiple_of * multiple_of)
    return min(cap, tokens_per_shard)
