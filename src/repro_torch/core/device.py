"""Device-side skeleton lowering: the FastFlow patterns as batched PyTorch
programs on CUDA devices, SPMD over the ranks of a mesh.

==================  ==========================================================
FastFlow skeleton    device lowering here
==================  ==========================================================
farm (DP)           ``farm_map`` — batch scatter (emitter) + pmean collector
map  (Sec. 12.1)    ``tensor_map`` — shard_map Split/Compose over an axis
farm (EP/MoE)       dispatch/combine in models/moe.py; helpers
                    ``expert_capacity`` here
pipeline            ``pipeline_shard`` — stages on a mesh axis, microbatches
                    streamed over ``ppermute`` edges (SPSC channels), GPipe
                    schedule with fill/drain bubbles
farm+collector      ``flash_decode_combine`` — partial-softmax workers +
                    logsumexp-combining collector for sharded-KV decode
feedback            ``feedback_scan`` — wrap_around as K batched turns;
                    ``feedback_while`` — the data-dependent variant with a
                    per-lane active mask (per-item early exit)
all_to_all          ``a2a_dispatch`` — left map, route, the fused a2a hop
                    (``kernels/a2a_fused.py``: CUDA route + combine kernels),
                    per data shard over a mesh
==================  ==========================================================

Port of ``src/repro/core/device.py``.  Where the reference writes a per-item
function and lets ``jax.vmap`` batch it, the lowerings here take functions
that are already batched (``torch.func.vmap`` of the per-item function), so
a loop whose length depends on the data runs as a plain Python loop over the
whole batch.  Over a mesh with ranks behind it the lowerings run through
``core/spmd.py``'s ``shard_map``: every rank holds the global inputs and
computes its block; on one device they are one batched call.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from . import spmd
from .plan import P
from .tree import tree_leaves, tree_map


def _mesh_size(mesh: Any, axis: str) -> int:
    return int(dict(mesh.shape).get(axis, 1)) if mesh is not None else 1


def _spmd(mesh: Any) -> bool:
    """The mesh has ranks behind it: the lowering runs as ``shard_map``."""
    return mesh is not None and getattr(mesh, "live", False)


# ---------------------------------------------------------------------------
# farm over the data axis (the plain DP farm)
# ---------------------------------------------------------------------------
def farm_map(fn: Callable, mesh: Any = None, axis: str = "data",
             in_specs=None, out_specs=None,
             reduce_outputs: bool = False) -> Callable:
    """Run the batched ``fn`` as farm workers over ``axis``; round-robin
    scheduling is the even batch sharding.  If ``reduce_outputs``, the
    collector pmeans the results (gradient consolidation 'in memory', paper
    Sec. 8.2).  On one device the farm is one batched call."""
    if not _spmd(mesh):
        if _mesh_size(mesh, axis) > 1:
            raise RuntimeError(f"farm_map over {axis!r} of an abstract mesh")
        return fn
    in_specs = in_specs if in_specs is not None else P(axis)
    out_specs = out_specs if out_specs is not None else (
        P() if reduce_outputs else P(axis))

    def worker(*args):
        out = fn(*args)
        if reduce_outputs:
            out = tree_map(lambda t: spmd.pmean(t, axis), out)
        return out

    return spmd.shard_map(worker, mesh, in_specs, out_specs)


# ---------------------------------------------------------------------------
# map skeleton (Split -> workers -> Compose) over the model axis
# ---------------------------------------------------------------------------
def tensor_map(fn: Callable, mesh: Any, axis: str = "model",
               split_spec=None, compose: str = "gather",
               out_axis: int = -1) -> Callable:
    """Paper Sec. 12.1 map on a farm template: Split partitions the input
    over ``axis``; workers compute partitions; Compose rebuilds the result
    — ``gather`` (concatenate partitions, e.g. row-parallel) or ``reduce``
    (psum partial results, e.g. col-parallel matmul contributions)."""
    split_spec = split_spec if split_spec is not None else P(None, axis)

    def worker(*args):
        out = fn(*args)
        if compose == "reduce":
            out = tree_map(lambda t: spmd.psum(t, axis), out)
        return out

    if compose == "reduce":
        out_specs = P()
    else:  # gather: partitions concatenated along out_axis by the Compose
        ndim = (-out_axis) if out_axis < 0 else out_axis + 1
        spec = [None] * ndim
        spec[out_axis] = axis
        out_specs = P(*spec)
    return spmd.shard_map(worker, mesh, split_spec, out_specs)


# ---------------------------------------------------------------------------
# pipeline skeleton over a mesh axis (pipeline parallelism)
# ---------------------------------------------------------------------------
def pipeline_shard(stage_fn: Callable, mesh: Any, axis: str,
                   n_microbatches: int) -> Callable:
    """GPipe-style pipeline: each rank along ``axis`` owns one stage's
    parameters; microbatches stream through ``ppermute`` edges — the
    device SPSC channels.  Total steps = M + S - 1 (fill/drain bubble,
    cf. paper Sec. 13: service time = max stage time).

    ``stage_fn(stage_params, x) -> x`` must keep the activation shape.

    Returns ``run(stacked_stage_params, x_microbatches)`` where
    ``stacked_stage_params`` has a leading stage dim sharded over ``axis``
    and ``x_microbatches`` is ``(M, mb, ...)`` replicated along ``axis``.
    A stage computes only in the steps that hold one of its microbatches
    (the reference computes in the bubbles too and discards the result);
    every step's edge is sent all the same."""
    S = _mesh_size(mesh, axis)
    M = n_microbatches

    def body(params, x_mb):
        params = tree_map(lambda t: t[0], params)
        idx = spmd.axis_index(axis)
        state = torch.zeros_like(x_mb[0])          # in-flight microbatch
        outs = []                                  # drained results
        fwd_perm = [(i, (i + 1) % S) for i in range(S)]
        for t in range(M + S - 1):
            if idx == 0 and t < M:                 # stage 0 ingests t
                state = x_mb[t]
            if 0 <= t - idx < M:                   # a microbatch is here
                state = stage_fn(params, state)
            if idx == S - 1 and t - (S - 1) >= 0:  # last stage drains
                outs.append(state)
            # SPSC edge: push my state to the next stage
            state = spmd.ppermute(state, axis, fwd_perm)
        out = torch.stack(outs) if outs else torch.zeros_like(x_mb)
        # Compose: broadcast the last stage's buffer (collector gather)
        if S > 1:
            out = spmd.psum(out, axis)
        return out

    def run(stage_params, x_mb):
        specs = tree_map(lambda _: P(axis), stage_params)
        return spmd.shard_map(body, mesh, (specs, P()), P())(stage_params,
                                                               x_mb)

    return run


# ---------------------------------------------------------------------------
# farm-with-collector for sharded-KV decode (flash decoding)
# ---------------------------------------------------------------------------
def flash_decode_combine(partial_out: torch.Tensor, partial_lse: torch.Tensor,
                         axis: str) -> torch.Tensor:
    """Collector for context-parallel decode attention: workers hold KV
    shards and produce (softmax-partial output, logsumexp); the collector
    renormalizes — a farm whose collector implements a numerically exact
    gather policy.  Runs inside ``shard_map`` over ``axis``.

    partial_out: (..., d) local unnormalized-softmax output
    partial_lse: (...,)   local logsumexp of scores
    """
    m = spmd.pmax(partial_lse, axis)
    w = torch.exp(partial_lse - m)
    num = spmd.psum(partial_out * w[..., None], axis)
    den = spmd.psum(w, axis)
    return num / den[..., None]


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


def _any_rank(flag: torch.Tensor) -> torch.Tensor:
    """``flag`` or'ed over the ranks of the manual axes (the flag itself
    outside a manual region)."""
    axes = tuple(sorted(spmd.manual_axes()))
    mesh = spmd.current_mesh()
    if not axes or mesh is None or not mesh.live:
        return flag
    return spmd.pmax(flag.to(torch.int32), axes) > 0


def feedback_while(step_fn: Callable, init_state: Any, cond_fn: Callable,
                   max_steps: Optional[int] = None):
    """Data-dependent feedback channel over a batch of lanes: ``do {state =
    step(state)} while (cond(state))`` per lane, the batched counterpart of
    the reference's vmapped ``lax.while_loop``.  Inside a manual region
    over ranks (a ``farm_map`` over the mesh, each rank on its block of
    lanes) the ranks agree each turn whether any lane of any of them is
    still active, so every rank turns the loop as often.

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
        if not bool(_any_rank(active.any())):
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
    (lossless); with a factor, items beyond capacity produce zeros.  With
    a ``mesh`` that has ranks behind ``axis``, the left map runs sharded
    over ``axis`` — and in the lossless case the route and combine
    kernels run sharded too, every rank on its own tokens (per-shard lane
    cursors reproduce the global first-come outcome exactly because
    nothing can overflow).  A bounded ``capacity_factor`` keeps the
    dispatch batch-global: first-come lane occupancy across shards needs
    the one set of cursors.

    Returns ``batched(xs, t_idx)`` mapping a stacked batch ``(T, ...)`` plus
    absolute stream indices ``(T,)`` to stacked outputs ``(T, ...)``; right
    workers must agree on output shape/dtype."""
    from ..kernels.a2a_fused import a2a_fused

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
        axis_size = _mesh_size(mesh, axis)
        sharded = _spmd(mesh) and axis_size > 1 and T % axis_size == 0
        if sharded:
            ys = farm_map(left_apply, mesh, axis=axis,
                          in_specs=(P(axis), P(axis)),
                          out_specs=P(axis))(xs, t_idx)
        else:
            ys = left_apply(xs, t_idx)
        if router is not None:
            e = torch.func.vmap(lambda y: torch.as_tensor(router(y, nR)))(ys)
            e = e.to(torch.int32) % nR
        else:  # host default: producer i's k-th output goes to (i + k) % nR
            e = (((t_idx % nL) + (t_idx // nL)) % nR).to(torch.int32)
        cap = T if capacity_factor is None else \
            expert_capacity(T, nR, 1, capacity_factor)
        # compared with the lanes, not F.one_hot, which reads the routes'
        # range on the host (a wait inside the device segment)
        logits = (e.long()[:, None] == torch.arange(nR, device=e.device)
                  ).to(torch.float32)
        if sharded and capacity_factor is None:
            # sharded expert compute: every rank runs the hop on its own
            # tokens (capacity is lossless, so per-shard cursors cannot
            # diverge from the batch-global first-come outcome)
            return farm_map(
                lambda lg, y: a2a_fused(lg, y, right_fns, cap)[0], mesh,
                axis=axis, in_specs=(P(axis), P(axis)),
                out_specs=P(axis))(logits, ys)
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
