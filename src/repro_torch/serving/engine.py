"""Serving tier — continuous batching, SLO-aware overload policies, and
per-request early exit, expressed as ONE FFGraph feedback program.

Port of ``src/repro/serving/engine.py`` onto the port's host runtime
(``core/graph.py``) and its model (``models/lm.py``), on one CUDA device
(or the CPU, when the plan names it).  Each ``jax.jit``-ed step of the
reference is an eager call here; the batched cache insert is an in-place
write into the slot (whatever the block kind keeps: KV caches, a Mamba2
layer's fp32 ``ssm`` and bf16 ``conv`` state, an mLSTM layer's fp32 ``C``
and ``n`` and bf16 ``conv``, an sLSTM layer's fp32 ``c`` and ``n``);
device-to-host reads go through pinned buffers.  On the card every prefill
runs the ``flash_attention`` kernel in every attention block and the
``ssd_scan`` kernel in every Mamba2 layer and twice in every mLSTM layer,
and every prefill and decode step the ``router_topk`` kernel in every MoE
layer.

The engine is a streaming network compiled through the staged compiler
(``compile(config=CompileConfig(...))``):

    pipeline( PrefillNode, CacheManager, DecodeNode, CollectNode
            ).wrap_around()

  PrefillNode   the farm stage AHEAD of admission: requests' KV caches are
                prefilled on a small worker pool concurrently with the
                decode tick (the eager prefill drops the GIL inside torch's
                ops), while the circulating control tokens bypass the farm
                on a fast path — a mid-stream prefill never stalls the
                batch;
  CacheManager  KV-cache management as a first-class graph stage: owns the
                slot free-list, the batched cache insert, the ready queue
                (per-tick slot REFILL — continuous batching), shed/evict
                accounting, and the cache-occupancy + SLO stats exposed
                through the :class:`~repro_torch.core.graph.StageHandle`
                surface (``slo_controllable``);
  DecodeNode    the batched decode worker — every active slot advances one
                token per tick, plus the per-slot confidence (max softmax
                probability) the early-exit policy consumes;
  CollectNode   the per-request collector: appends tokens, applies the
                FastBERT-style per-turn exit policy (confidence above the
                request's threshold), enforces deadlines (a request past
                its ``deadline_s`` finishes truncated), and delivers
                finished requests out of the loop (``Deliver``);
  feedback      the tick re-entering the loop head (``wrap_around``).

Client API (the supported surface)
----------------------------------
``engine.submit(Request) -> RequestHandle`` admits a request without
blocking: under overload it is *shed* — the handle resolves immediately to
a typed :class:`Overloaded` — or *degraded* (``max_new_tokens`` capped,
early exit tightened) instead of queueing unboundedly.
``handle.result(timeout)`` blocks for that request;
``engine.results()`` iterates every outcome in finish order;
``engine.close()`` drains and shuts down, and the engine is a context
manager (``with InferenceEngine(...) as eng:`` starts it, exit closes it).

Over a plan whose mesh has ranks (``InferenceEngine(cfg, plan, params)``
with a ``make_mesh((data, model), ("data", "model"))`` plan, one engine
per rank, each given this rank's blocks of the parameters and the same
requests in the same order) the engines run in lock step: every
scheduling decision comes from what every rank has seen.  At the top of
each tick the CacheManager agrees with the other ranks, in one
collective, on how many requests all have received, whether all are
draining, and which deadlines have passed on any rank's clock; it then
admits in request order, prefilling each admitted request there (its
collectives in the same order on every rank) instead of on the prefill
pool.  The loop keeps ticking while idle, so the ranks meet at every
agreement whatever their timing.  The greedy token and the confidence
read the whole vocabulary (the logits gathered over the model axis), so
every rank appends the same tokens.  Shedding and degrading under SLO
pressure, and the Supervisor, decide from each rank's own backlog at its
own time and are not available there (every request is admitted;
``adaptive=True`` raises).

The paper's accelerator mode (Sec. 9) remains verbatim as the compat
adapter: ``run_then_freeze()`` / ``offload(request)`` (blocking
back-pressure at ``max_pending``) / ``load_result()`` /
``offload(FF_EOS)`` + ``wait()``.

Overload policy
---------------
:class:`~repro_torch.core.runtime.SLOPolicy` maps the waiting-backlog /
``max_pending`` ratio to a pressure level: 0 unconstrained, 1 degrade, 2
shed.  The engine enforces the policy inline on every ``submit`` (so it
works without a supervisor), and ``adaptive=True`` additionally attaches a
:class:`~repro_torch.core.runtime.Supervisor` that samples the
CacheManager's ``slo`` stats block and pushes pressure levels through the
stage handle — the effective level is the max of the two.  ``offload``
keeps the paper's blocking semantics; host memory is bounded by
``max_pending`` either way.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
import time
from typing import Any, Deque, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from ..core.compiler import CompileConfig
from ..core.graph import Deliver, StageHandle, pipeline
from ..core.node import EOS, GO_ON, FFNode, _Sentinel
from ..core import spmd
from ..core.plan import TorchPlan, single_device_plan
from ..core.runtime import SLOPolicy, Supervisor
from ..core.tree import tree_leaves
from ..models.lm import LM
from ..runtime.steps import (_sharded, gather_logits, make_decode_step,
                             make_prefill_step)


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
    id: int = -1
    # filled by the engine:
    tokens: Optional[List[int]] = None
    done: bool = False
    submit_t: float = 0.0
    finish_t: float = 0.0
    # SLO / early-exit surface:
    deadline_s: Optional[float] = None  # wall budget from submit; truncates
    exit_threshold: Optional[float] = None  # confidence for early exit
    degraded: bool = False              # overload policy capped this request
    finish_reason: str = ""             # max_tokens | eos | early_exit |
    #                                     deadline


@dataclasses.dataclass
class Overloaded:
    """Typed shed result: the engine refused (or abandoned) ``request``
    under overload instead of queueing it unboundedly."""

    request: Request
    reason: str
    backlog: int = 0


class RequestHandle:
    """Future for one submitted request: resolves to the finished
    :class:`Request` or a typed :class:`Overloaded`."""

    def __init__(self, request: Request):
        self.request = request
        self._event = threading.Event()
        self._outcome: Union[Request, Overloaded, None] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None
               ) -> Union[Request, Overloaded]:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.id} not finished in {timeout}s")
        return self._outcome

    def _resolve(self, outcome: Union[Request, Overloaded]) -> None:
        self._outcome = outcome
        self._event.set()


class _Accounting:
    """Shared request ledger: the one place submit/shed/admit/finish counts
    live, so admission back-pressure, the EOS decision, and the SLO stats
    all agree under concurrency."""

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.admitted = 0       # inserted into a batch slot
        self.finished = 0
        self.shed = 0

    def bump(self, field: str) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)

    def waiting(self) -> int:
        """Requests accepted but not yet decoding (input queue + prefill +
        ready queue) — what admission back-pressure bounds."""
        with self._lock:
            return self.submitted - self.shed - self.admitted

    def in_flight(self) -> int:
        """Requests with an outcome still owed (anywhere in the engine)."""
        with self._lock:
            return self.submitted - self.shed - self.finished


class _SLOState:
    """Pressure shared between the inline policy, the stage handle, and
    the collector: ``level`` 0/1/2 per :class:`SLOPolicy`."""

    def __init__(self, policy: SLOPolicy):
        self.policy = policy
        self.ext_level = 0      # pushed down through the stage handle


_TICK = _Sentinel("TICK")     # the circulating batch step
_DRAIN = _Sentinel("DRAIN")   # FF_EOS translated so admission can drain first
_END = _Sentinel("END")       # client-side end-of-results marker


@dataclasses.dataclass
class _Ready:
    """A prefilled request, queued for slot refill at the CacheManager."""

    req: Request
    tok: Any = None             # (1, 1) int32 first generated token (host)
    cache1: Any = None          # B=1 KV caches on the device
    prompt_len: int = 0
    error: Optional[BaseException] = None


class _BatchState:
    """The batched decode state: KV caches for B slots + bookkeeping.
    Owned by whichever node currently holds the tick."""

    def __init__(self, cfg, B: int, cache_len: int, device: torch.device,
                 plan=None):
        model = LM(cfg)
        defs = model.cache_defs(B, cache_len)
        # over a mesh with ranks, this rank's blocks (and, where the batch
        # splits over the data axes, its block of the slots)
        sh = model.cache_shardings(B, cache_len, plan) \
            if plan is not None else None
        self.slots = (0, B)
        if sh is not None:
            i, n = next(iter(next(iter(sh.values())).values())).block(1)
            self.slots = (i * (B // n), B // n)

        def zeros(kind, n, shape, dtype):
            if sh is not None:
                shape = sh[kind][n].local_shape(shape)
            return torch.zeros(shape, dtype=dtype, device=device)
        self.caches = {kind: {n: zeros(kind, n, shape, dtype)
                              for n, (shape, dtype) in kv.items()}
                       for kind, kv in defs.items()}
        self.cur_tok = torch.zeros((B, 1), dtype=torch.int32, device=device)
        self.pos = torch.zeros((B,), dtype=torch.int32, device=device)
        self.active_mask = np.zeros((B,), bool)
        self.last_toks: Optional[np.ndarray] = None
        self.last_conf: Optional[np.ndarray] = None
        # the in-flight decode step: (next_tokens, confidence) host copies
        # queued by DecodeNode behind the step but not yet waited on, and
        # the event that marks them landed — CollectNode resolves them at
        # the top of its turn, so the d2h copy (and the compute remainder
        # behind it) overlaps the hop between the nodes and the next tick's
        # slot-refill dispatch never waits on a host sync inside the decode
        # node
        self.pending: Optional[tuple] = None
        # lock step: the slots whose deadline passed on some rank's clock
        # (agreed at the CacheManager, read by the CollectNode)
        self.expired: set = set()


def _insert(st: _BatchState, cache1, slot: int, tok: torch.Tensor,
            prompt_len: int) -> None:
    """Write a prefilled (B=1) request into slot ``slot`` of the batched
    state, in place: its caches (where this rank holds the slot), its
    first token (on the host) and its position.  The scalars go in as
    fills, not as blocking host-to-device copies, so the insert queues
    behind the in-flight step without waiting for it."""
    first, count = st.slots
    if first <= slot < first + count:
        for kind, kv in cache1.items():
            for name, new in kv.items():
                st.caches[kind][name][:, slot - first] = new[:, 0]
    st.cur_tok[slot].fill_(int(tok[0, 0]))
    st.pos[slot].fill_(prompt_len)


def confidence(logits: torch.Tensor) -> torch.Tensor:
    """The early-exit confidence of each row of ``logits`` ``(B, 1, V)``:
    its largest softmax probability, rounded as the reference's jitted
    ``jnp.max(jax.nn.softmax(logits[:, -1, :]))`` rounds it on the CPU: in
    the logits' type (bf16) ``x - max`` and ``exp`` of it, the sum taken
    over the fp32 exponentials (XLA's fusion never rounds them to bf16)
    and rounded once, the division in bf16.  Returned as float32 (exact),
    so the host copy is a numpy array; a device op only, so the decode
    step queues it without a host wait."""
    x = logits[:, -1, :]
    d = x - x.amax(-1, keepdim=True)
    e = torch.exp(d.float())
    s = e.sum(-1, keepdim=True).to(x.dtype)
    return (e.to(x.dtype) / s).amax(-1).float()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``; to the card through a pinned buffer, queued
    without waiting for the work ahead of it on the stream."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _copy_out(*ts: torch.Tensor) -> tuple:
    """Host copies of ``ts`` queued behind the work that makes them, plus
    the CUDA event that marks them landed (None on the CPU, where the
    copies are done on return)."""
    if ts[0].device.type != "cuda":
        return tuple(t.clone() for t in ts) + (None,)
    hosts = []
    for t in ts:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        hosts.append(h)
    landed = torch.cuda.Event()
    landed.record(torch.cuda.current_stream(ts[0].device))
    return tuple(hosts) + (landed,)


class PrefillNode(FFNode):
    """The prefill farm AHEAD of admission (continuous batching's first
    half): requests fan out to a small worker pool that builds their KV
    caches concurrently with the decode tick, while control tokens
    (``_TICK``/``_DRAIN``) bypass the pool entirely — a long prompt being
    prefilled never stalls the running batch.

    All emissions (bypass AND worker completions) go through one lock, so
    the downstream SPSC lane still sees serialized pushes — the same
    discipline ``HostRunner`` uses on its multi-producer input queue."""

    def __init__(self, prefill, params, device: torch.device,
                 n_workers: int = 2):
        super().__init__()
        self._label = "prefill-farm"
        self._prefill = prefill
        self._params = params
        self._device = device
        self.n_workers = max(1, n_workers)
        self._jobs: "queue.Queue[Any]" = queue.Queue()
        self._emit_lock = threading.Lock()
        self._workers: List[threading.Thread] = []
        self.prefills = 0

    def _emit(self, item: Any) -> None:
        with self._emit_lock:
            self.ff_send_out(item)

    def _worker(self) -> None:
        while True:
            req = self._jobs.get()
            if req is EOS:
                return
            try:
                prompt = torch.as_tensor(np.asarray(req.prompt),
                                         dtype=torch.int32,
                                         device=self._device)[None, :]
                tok, cache1 = self._prefill(self._params, prompt)
                tok = tok.cpu()         # waits for the prefill to finish
                out = _Ready(req, tok, cache1, int(prompt.shape[1]))
                with self._stats_lock:
                    self.prefills += 1
            except BaseException as e:  # noqa: BLE001 - surfaced as a shed
                out = _Ready(req, error=e)
            self._emit(out)

    def svc_init(self) -> int:
        if self._prefill is None:
            return 0
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"ff-prefill-{i}")
            for i in range(self.n_workers)]
        for t in self._workers:
            t.start()
        return 0

    def svc(self, item):
        if item is _TICK or item is _DRAIN or isinstance(item, _Sentinel):
            self._emit(item)            # fast path: never behind a prefill
        elif self._prefill is None:     # lock step: the CacheManager
            self._emit(_Ready(item))    # prefills at admission
        else:
            self._jobs.put(item)        # a Request: fan out to the pool
        return GO_ON

    def svc_end(self) -> None:
        for _ in self._workers:
            self._jobs.put(EOS)
        for t in self._workers:
            t.join(timeout=5.0)

    def node_stats(self) -> dict:
        s = super().node_stats()
        with self._stats_lock:
            s.update({"node": self._label, "prefills": self.prefills,
                      "queued": self._jobs.qsize(),
                      "workers": self.n_workers})
        return s


class _CacheManagerHandle(StageHandle):
    """The CacheManager's stage handle: read-only like the base handle,
    plus the SLO control surface an overload policy drives."""

    slo_controllable = True

    def __init__(self, cm: "CacheManager"):
        super().__init__("cache-manager", cm)
        self._cm = cm

    def stats(self) -> dict:
        return self._cm.node_stats()

    def set_pressure(self, level: int, policy: Optional[SLOPolicy] = None
                     ) -> None:
        if policy is not None:
            self._cm.slo.policy = policy
        self._cm.slo.ext_level = int(level)


class CacheManager(FFNode):
    """KV-cache management as a first-class graph stage: owns the slot
    free-list, the batched cache insert (eviction is the release back to
    the free list), the ready queue feeding per-tick slot REFILL, and the
    occupancy/SLO stats behind :meth:`make_handle`.  Terminates the whole
    loop (returns EOS) once draining and every accepted request has an
    outcome."""

    def __init__(self, state: _BatchState, B: int, insert,
                 acct: _Accounting, slo: _SLOState, max_pending: int,
                 lockstep: Optional["_LockStep"] = None):
        super().__init__()
        self.lockstep = lockstep
        self.received = 0            # lock step: requests received, taken
        self.taken = 0
        self._label = "cache-manager"
        self.state = state
        self.B = B
        self._insert = insert
        self.acct = acct
        self.slo = slo
        self.max_pending = max_pending
        self.free: List[int] = list(range(B))
        self.active: Dict[int, Request] = {}
        self.ready: Deque[_Ready] = collections.deque()
        self.inserts = 0
        self.evicts = 0
        self.draining = False
        self.holding = True          # the tick starts here
        self.drained = threading.Event()

    # -- slot lifecycle ----------------------------------------------------
    def release(self, slot: int) -> None:
        """Evict a finished request's cache slot (called by the collector,
        which holds the tick — never concurrent with a refill)."""
        self.active.pop(slot, None)
        self.free.append(slot)
        self.evicts += 1

    def _shed(self, req: Request, reason: str) -> None:
        self.acct.bump("shed")
        self.ff_send_out(Deliver(Overloaded(req, reason,
                                            self.acct.waiting())))

    def _refill(self) -> None:
        st = self.state
        now = time.perf_counter()
        while self.ready and self.free:
            r = self.ready.popleft()
            req = r.req
            if r.error is not None:
                self._shed(req, f"prefill failed: {r.error!r}")
                continue
            if (req.deadline_s is not None
                    and now - req.submit_t > req.deadline_s):
                self._shed(req, f"deadline {req.deadline_s}s expired "
                                "before admission")
                continue
            slot = self.free.pop()
            self.active[slot] = req
            self._insert(st, r.cache1, slot, r.tok, r.prompt_len)
            req.tokens.append(int(r.tok[0, 0]))
            st.active_mask[slot] = True
            self.inserts += 1
            self.acct.bump("admitted")

    def _maybe_go(self):
        if not self.holding:
            return GO_ON                  # tick is downstream; queue up
        if self.lockstep is not None:
            return self._lockstep_go()
        self._refill()
        if self.state.active_mask.any():
            self.holding = False
            return _TICK
        if self.draining and not self.ready and self.acct.in_flight() == 0:
            self.drained.set()
            return EOS                    # unwinds decode + collect too
        return GO_ON                      # idle: hold the tick, wait

    def _lockstep_go(self):
        """One tick of the lock-step loop: agree with the other ranks, then
        take the agreed decisions (see the module's docstring)."""
        st, B = self.state, self.B
        now = time.perf_counter()
        late = lambda req: (req.deadline_s is not None
                            and now - req.submit_t > req.deadline_s)
        slots = [int(s in self.active and late(self.active[s]))
                 for s in range(B)]
        waiting = [int(late(r.req)) for r in list(self.ready)[:B]]
        waiting += [0] * (B - len(waiting))
        got = self.lockstep.agree([self.received, int(self.draining)]
                                  + [-x for x in slots + waiting])
        n, draining = got[0], got[1] == 1
        st.expired = {s for s in range(B) if got[2 + s] < 0}
        for j in range(B):
            if not (self.ready and self.free and self.taken < n):
                break
            r = self.ready.popleft()
            self.taken += 1
            if got[2 + B + j] < 0:
                self._shed(r.req, f"deadline {r.req.deadline_s}s expired "
                                  "before admission")
                continue
            tok, cache1 = self.lockstep.prefill(r.req)
            slot = self.free.pop()
            self.active[slot] = r.req
            self._insert(st, cache1, slot, tok, len(r.req.prompt))
            r.req.tokens.append(int(tok[0, 0]))
            st.active_mask[slot] = True
            self.inserts += 1
            self.acct.bump("admitted")
        if (draining and not st.active_mask.any()
                and self.taken == self.received == n):
            self.drained.set()
            return EOS
        if not st.active_mask.any():
            time.sleep(self.lockstep.idle_s)   # idle: tick on, slowly
        self.holding = False
        return _TICK

    def svc(self, item):
        if item is _DRAIN:
            self.draining = True
        elif item is _TICK:
            self.holding = True           # back from the feedback edge
        elif isinstance(item, _Ready):
            self.ready.append(item)
            self.received += 1
        return self._maybe_go()

    # -- observability -----------------------------------------------------
    def node_stats(self) -> dict:
        s = super().node_stats()
        with self._stats_lock:
            occupied = len(self.active)
            s.update({
                "node": self._label,
                "cache": {"slots": self.B, "occupied": occupied,
                          "inserts": self.inserts, "evicts": self.evicts,
                          "ready": len(self.ready)},
                "slo": {"backlog": self.acct.waiting(),
                        "capacity": self.max_pending,
                        "in_flight": self.acct.in_flight(),
                        "shed": self.acct.shed,
                        "pressure": self.slo.ext_level},
            })
        return s

    def make_handle(self) -> StageHandle:
        return _CacheManagerHandle(self)


class DecodeNode(FFNode):
    """The batched decode worker: one step advances every active slot and
    reports each slot's next-token confidence (max softmax probability) for
    the early-exit policy.  Non-tick items (``Deliver`` escapes from
    upstream) pass straight through."""

    def __init__(self, state: _BatchState, params, decode):
        super().__init__()
        self._label = "decode"
        self.state = state
        self.params = params
        self._decode = decode
        self.steps = 0

    def svc(self, item):
        if item is not _TICK:
            return item                   # pass-through (Deliver, drain...)
        st = self.state
        if not st.active_mask.any():      # a lock-step tick while idle
            return _TICK
        nt, conf, st.caches = self._decode(
            self.params, st.caches, {"token": st.cur_tok, "pos": st.pos})
        st.cur_tok = nt
        st.pos = st.pos + _to_device(st.active_mask.astype(np.int32),
                                     st.pos.device)
        self.steps += 1
        # the overlapped boundary, serving edition: do NOT sync here — queue
        # the device->host copies behind the step and hand them down the
        # loop.  CollectNode waits for them, so the copy-out (and compute
        # remainder) rides under the decode->collect hop, and the next
        # tick's CacheManager refill dispatches behind the in-flight step
        # without a host sync in between
        st.pending = _copy_out(nt[:, 0], conf)
        return _TICK


class CollectNode(FFNode):
    """Per-request collector: appends each active slot's token, applies the
    per-turn exit policy — target length, EOS token, FastBERT-style
    confidence exit, deadline truncation — releases finished slots back to
    the CacheManager, and delivers the requests out of the loop."""

    def __init__(self, state: _BatchState, cm: CacheManager,
                 acct: _Accounting, slo: _SLOState,
                 eos_token: Optional[int],
                 exit_threshold: Optional[float]):
        super().__init__()
        self._label = "collect"
        self.state = state
        self.cm = cm
        self.acct = acct
        self.slo = slo
        self.eos_token = eos_token
        self.exit_threshold = exit_threshold
        self.early_exits = 0

    def _exit_threshold_for(self, req: Request) -> Optional[float]:
        thr = (req.exit_threshold if req.exit_threshold is not None
               else self.exit_threshold)
        if thr is None:
            return None
        # under pressure (or for a degraded request) exit more aggressively:
        # accept a lower confidence to free the slot sooner
        if self.slo.ext_level >= 1 or req.degraded:
            thr = thr * self.slo.policy.exit_margin
        return thr

    def svc(self, item):
        if item is not _TICK:
            return item                   # pass-through
        st = self.state
        if not st.active_mask.any():      # a lock-step tick while idle
            return _TICK
        if st.pending is not None:        # resolve the in-flight decode step
            toks, conf, landed = st.pending
            st.pending = None
            if landed is not None:
                landed.synchronize()
            st.last_toks = toks.numpy()
            st.last_conf = conf.numpy()
        now = time.perf_counter()
        for slot in list(self.cm.active):
            req = self.cm.active[slot]
            if not st.active_mask[slot]:
                continue
            t = int(st.last_toks[slot])
            req.tokens.append(t)
            conf = float(st.last_conf[slot]) if st.last_conf is not None \
                else 0.0
            thr = self._exit_threshold_for(req)
            reason = ""
            if len(req.tokens) >= req.max_new_tokens:
                reason = "max_tokens"
            elif self.eos_token is not None and t == self.eos_token:
                reason = "eos"
            elif thr is not None and conf >= thr:
                reason = "early_exit"
                self.early_exits += 1
            elif (slot in st.expired if self.cm.lockstep is not None
                  else (req.deadline_s is not None
                        and now - req.submit_t > req.deadline_s)):
                reason = "deadline"       # out of budget: truncate
            if reason:
                req.done = True
                req.finish_reason = reason
                req.finish_t = now
                st.active_mask[slot] = False
                self.cm.release(slot)
                self.acct.bump("finished")
                self.ff_send_out(Deliver(req))
        return _TICK                      # wrap_around -> loop head


class _LockStep:
    """The lock-step engine's link to the other ranks: ``agree`` takes the
    elementwise minimum of an int vector over every rank of the plan's
    mesh (one collective), ``prefill`` runs one request's prefill (the
    greedy first token over the whole vocabulary, this rank's cache
    blocks)."""

    idle_s = 5e-4                # an idle tick's pause

    def __init__(self, plan, params, prefill):
        self.plan, self.params, self._prefill = plan, params, prefill

    def agree(self, vec: list) -> list:
        t = torch.tensor(vec, dtype=torch.int64, device=self.plan.device)
        mesh = self.plan.mesh
        return spmd.all_min(t, mesh, mesh.axis_names).tolist()

    def prefill(self, req: "Request"):
        prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int32,
                                 device=self.plan.device)[None, :]
        tok, cache1 = self._prefill(self.params, prompt)
        return tok.cpu(), cache1


class InferenceEngine:
    """Continuous-batching serving engine: an FFGraph feedback program with
    a typed client API (``submit``/``results``/``close``) in front and the
    paper's accelerator surface kept as the compat adapter."""

    def __init__(self, cfg, plan: Optional[TorchPlan], params, *,
                 max_batch: int = 4, cache_len: int = 256,
                 eos_token: Optional[int] = None, adaptive: bool = False,
                 max_pending: int = 256, prefill_workers: int = 2,
                 exit_threshold: Optional[float] = None,
                 slo: Optional[SLOPolicy] = None, device: Any = None):
        # plan=None means single_device_plan(device): cuda:0 unless the
        # caller names another device, and an error without CUDA
        plan = plan if plan is not None else single_device_plan(device)
        where = {t.device for t in tree_leaves(params)}
        if where != {plan.device}:
            raise ValueError(f"params on {sorted(map(str, where))}, the plan "
                             f"on {plan.device}")
        self.cfg = cfg
        self.plan = plan
        self.params = params
        self.B = max_batch
        self.cache_len = cache_len
        self.eos_token = eos_token
        self.model = LM(cfg)
        # admission back-pressure: offload() blocks / submit() sheds once
        # this many requests wait for a slot — host memory stays bounded
        # under any offered load
        self.max_pending = max_pending

        prefill_step = make_prefill_step(cfg, plan, cache_len)
        spmd_plan = _sharded(plan) and plan.mesh.size > 1
        if spmd_plan and adaptive:
            raise ValueError("the Supervisor decides from each rank's own "
                             "backlog: adaptive=True needs a one-device plan")

        def _prefill(p, tokens):
            logits, cache1 = prefill_step(p, {"tokens": tokens})
            logits = gather_logits(logits, plan, cfg, tokens.shape[0])
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            return tok, cache1

        decode_step = make_decode_step(cfg, plan, cache_len)

        def _decode(p, caches, batch):
            nt, logits, caches = decode_step(p, caches, batch)
            return nt, confidence(gather_logits(logits, plan, cfg, self.B)), \
                caches

        self._acct = _Accounting()
        self._slo = _SLOState(slo or SLOPolicy())
        self.state = _BatchState(cfg, self.B, cache_len, plan.device,
                                 plan if spmd_plan else None)
        self._lockstep = _LockStep(plan, params, _prefill) if spmd_plan \
            else None
        self._prefill_node = PrefillNode(
            None if spmd_plan else _prefill, params, plan.device,
            n_workers=prefill_workers)
        self._cm = CacheManager(self.state, self.B, _insert, self._acct,
                                self._slo, max_pending, self._lockstep)
        self._decode_node = DecodeNode(self.state, params, _decode)
        self._collect = CollectNode(self.state, self._cm, self._acct,
                                    self._slo, eos_token, exit_threshold)

        self.graph = pipeline(self._prefill_node, self._cm,
                              self._decode_node,
                              self._collect).wrap_around()
        # the nodes are stateful (slot free-list, batched caches), so
        # place() pins the feedback loop to host threads — the prefill and
        # decode steps inside the nodes are the device side
        self._runner = self.graph.compile(config=CompileConfig(
            capacity=self.max_pending, results_capacity=1024,
            adaptive=adaptive))
        self.placements = getattr(self._runner, "placements", [])
        self.supervisor = None
        if adaptive:
            self.supervisor = Supervisor(self._runner,
                                         slo=self._slo.policy)

        self._ids = itertools.count(0)
        self._handles: Dict[int, RequestHandle] = {}
        self._handles_lock = threading.Lock()
        self._results_q: "queue.Queue[Any]" = queue.Queue()
        self._dispatcher: Optional[threading.Thread] = None
        self._dispatcher_stop = threading.Event()
        self._started = False
        self._closing = False

    # -- introspection -----------------------------------------------------
    @property
    def steps(self) -> int:
        return self._decode_node.steps

    @property
    def early_exits(self) -> int:
        return self._collect.early_exits

    @property
    def shed_count(self) -> int:
        return self._acct.shed

    @property
    def error(self) -> Optional[BaseException]:
        return self._runner.error()

    def stats(self) -> dict:
        """Runner stats (per-node service EMA, cache occupancy, SLO block)
        plus the request ledger."""
        s = self._runner.stats()
        s["requests"] = {"submitted": self._acct.submitted,
                         "admitted": self._acct.admitted,
                         "finished": self._acct.finished,
                         "shed": self._acct.shed}
        if self.supervisor is not None:
            s["supervisor"] = self.supervisor.stats()
        return s

    def replacement_events(self):
        """Supervisor events (pressure changes, migrations) for reports."""
        if self.supervisor is not None:
            return list(self.supervisor.events)
        return self._runner.replacement_events()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "InferenceEngine":
        """Start the streaming network, the result dispatcher, and (in
        adaptive mode) the supervisor.  Idempotent."""
        if self._started:
            return self
        self._started = True
        self._runner.run_then_freeze()
        self._dispatcher = threading.Thread(target=self._dispatch,
                                            daemon=True,
                                            name="ff-serve-dispatch")
        self._dispatcher.start()
        if self.supervisor is not None:
            self.supervisor.start()
        return self

    def __enter__(self) -> "InferenceEngine":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def _dispatch(self) -> None:
        """Single consumer of the runner's result stream: resolves request
        handles and feeds the client-facing results queue (which the compat
        ``load_result`` also reads)."""
        while True:
            try:
                ok, item = self._runner.load_result(0.2)
            except TimeoutError:
                if self._dispatcher_stop.is_set():
                    self._results_q.put(_END)
                    return
                continue
            if not ok:                    # network EOS: loop fully drained
                self._results_q.put(_END)
                return
            rid = (item.request.id if isinstance(item, Overloaded)
                   else item.id)
            with self._handles_lock:
                h = self._handles.pop(rid, None)
            if h is not None:
                h._resolve(item)
            self._results_q.put(item)

    # -- typed client API --------------------------------------------------
    def submit(self, req: Request) -> RequestHandle:
        """Admit a request without blocking.  Under overload the request is
        shed (handle resolves to :class:`Overloaded` immediately) or
        degraded (``max_new_tokens`` capped, earlier exit) per the engine's
        :class:`~repro.core.runtime.SLOPolicy`; the hard ``max_pending``
        cap always sheds."""
        if not self._started:
            self.start()
        if self._closing:
            raise RuntimeError("submit() on a closing engine")
        if req.id < 0:
            req.id = next(self._ids)
        req.tokens = []
        req.submit_t = time.perf_counter()
        handle = RequestHandle(req)
        self._acct.bump("submitted")
        waiting = self._acct.waiting()
        policy = self._slo.policy
        level = max(self._slo.ext_level,
                    policy.level(waiting, self.max_pending))
        if self._lockstep is not None:    # every rank admits every request
            level, waiting = 0, 0
        if level >= 2 or waiting > self.max_pending:
            self._acct.bump("shed")
            ov = Overloaded(req, f"overloaded: backlog {waiting}/"
                                 f"{self.max_pending}", waiting)
            handle._resolve(ov)
            self._results_q.put(ov)
            return handle
        if level == 1:
            req.max_new_tokens = min(req.max_new_tokens,
                                     policy.degrade_tokens)
            req.degraded = True
        with self._handles_lock:
            self._handles[req.id] = handle
        self._runner.offload(req)
        return handle

    def results(self) -> Iterator[Union[Request, Overloaded]]:
        """Iterate every outcome (finished ``Request`` or ``Overloaded``)
        in completion order, until the engine is drained."""
        while True:
            item = self._results_q.get()
            if item is _END:
                self._results_q.put(_END)   # repeated iteration stays ended
                return
            yield item

    def close(self, timeout: Optional[float] = 60.0) -> int:
        """Stop accepting, drain in-flight requests, shut the network,
        supervisor, and dispatcher down.  Idempotent."""
        if not self._started:
            return 0
        if not self._closing:
            self._closing = True
            self._runner.offload(_DRAIN)
        return self.wait(timeout)

    # -- paper accelerator API (compat adapter) ----------------------------
    def run_then_freeze(self) -> int:
        self.start()
        return 0

    def offload(self, req) -> None:
        """Submit a request with the paper's blocking semantics (single
        producer): blocks while ``max_pending`` requests are waiting for a
        slot instead of shedding.  ``offload(FF_EOS)`` starts the drain."""
        if not self._started:
            self.start()
        if req is EOS:
            self._closing = True
            self._runner.offload(_DRAIN)
            return
        delay = 1e-5
        while (self.error is None
               and self._acct.waiting() >= self.max_pending):
            time.sleep(delay)
            delay = min(delay * 2, 1e-2)  # park, don't spin, while throttled
        if req.id < 0:
            req.id = next(self._ids)
        req.tokens = []
        req.submit_t = time.perf_counter()
        self._acct.bump("submitted")
        self._runner.offload(req)

    def load_result(self, timeout: Optional[float] = None):
        try:
            item = self._results_q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("load_result timed out") from None
        if item is _END:
            self._results_q.put(_END)
            return False, None
        return True, item

    def load_result_nb(self):
        try:
            item = self._results_q.get_nowait()
        except queue.Empty:
            return False, None
        if item is _END:
            self._results_q.put(_END)
            return False, None
        return True, item

    def wait(self, timeout: Optional[float] = None) -> int:
        """Join the drained network.  The terminating EOS originates
        mid-pipeline (the CacheManager), so once the loop reports drained
        this also unwinds the prefill stage ahead of it."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.error is not None or self._cm.drained.wait(0.05):
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
        terminating = self._cm.drained.is_set() or self.error is not None
        if terminating:
            self._runner.offload(EOS)     # unwind the prefill stage
        remaining = None if deadline is None \
            else max(0.0, deadline - time.monotonic())
        rc = self._runner.wait(remaining)
        if terminating:
            if self.supervisor is not None:
                self.supervisor.stop()    # idempotent — no _thread peeking
            self._dispatcher_stop.set()
            if self._dispatcher is not None:
                self._dispatcher.join(timeout=2.0)
        return rc
