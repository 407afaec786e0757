"""L1/L2 — true shared-memory channels for the process-backed host tier.

``core/queues.py`` carries the thread-backed host tier; its rings are Python
lists, so they cannot cross a process boundary and its CPU-bound producers
serialize on the GIL.  This module is the same FastFlow layer-1 structure on
``multiprocessing.shared_memory``: a fixed-slot single-producer /
single-consumer ring whose indices live *in* the shared segment, with the
same wait-free single-writer discipline — the producer only writes ``tail``,
the consumer only writes ``head``, each as one aligned 8-byte store (a single
memcpy in CPython, atomic on every platform we target), so neither side ever
takes a lock on the fast path.

The transport has **three lane tiers**, selected per lane at build time
(:class:`TransportConfig` / ``compile(transport=...)``):

1. **bounded SPSC** (:class:`ShmSPSCQueue`) — the classic fixed-slot ring;
   a full ring is back-pressure, pushed batches amortize the index traffic
   (one tail publish per batch, not per item);
2. **uSPSC unbounded** (:class:`ShmUSPSCQueue`) — the 2009 FastFlow TR's
   unbounded queue: a linked chain of fixed-slot ring segments, grown on
   overflow (a ``SEG`` control slot names the next segment) and retired on
   drain, so back-pressure policy becomes a compile-time choice
   (``bounded=`` on lanes) instead of a wedge risk;
3. **slab arena** (:class:`ShmArena`) — a FIFO byte ring riding next to a
   lane, so ndarrays larger than a slot ship as arena offsets in the slot
   header instead of falling back to pickle.

Payload encoding per slot:

- **ndarray fast path** (tag ``ARR``): dtype/shape header plus the raw data
  bytes copied straight into the slot — no pickling of the buffer;
- **arena ndarray** (tag ``ARN``): the same dtype/shape header plus a
  ``(offset, nbytes)`` pair naming a block in the lane's :class:`ShmArena`
  — the slot stays fixed-size while the payload does not;
- **pickle fallback** (tag ``PKL``): arbitrary pytrees / Python objects as
  pickled bytes;
- **vectored batch** (tag ``BATCH``): one pickled list of ``(seq, item)``
  pairs — the coalesced form ``push_many`` emits for runs of small
  non-array items, one ``pickle.dumps`` and one slot for the whole run;
- **control tags**: ``EOS`` (end-of-stream; decoded back to the module-wide
  :data:`~repro_torch.core.node.EOS` sentinel so identity checks keep working
  across the boundary), ``ERR`` (a pickled error record from a worker) and
  ``SEG`` (a uSPSC growth marker carrying the next segment's name).

Each slot header also carries a **u64 sequence number** alongside the
length/tag word.  Per-lane FIFO order is enough for a farm (one hop, parent
assigns seqs and matches results by arrival order), but the ``all_to_all``
grid routes items data-dependently across two hops, so the seq must ride the
wire with the payload — in the fixed header, not the payload, so bare
ndarrays keep the raw-slab fast path.

Layer 2 composes the same SPMC / MPSC lane bundles as ``core/queues.py`` out
of these rings — the emitter/collector wiring of a process farm — plus
:class:`ShmMPMCGrid`, the process-tier instance of
``queues.MPMCQueue``: an nL x nR grid of SPSC lanes where producer ``i``
owns row ``i`` and consumer ``j`` owns column ``j``, so every lane keeps the
single-writer index discipline.  It is the interconnect of the process-backed
``all_to_all`` (``core/process.ProcessA2ANode``).

This module is the PyTorch port's own copy of the reference package's
``core/shm.py``, unchanged: it needs only numpy, and it keeps the slot
layout (``_SLOT_FMT``, ``_SLOT_HDR``, the ``TAG_*`` codes), so a ring of
either package reads the other's.  Nothing here imports torch: the lanes
carry numpy arrays and pickles, and forked workers never touch the card.
"""

from __future__ import annotations

import pickle
import struct
import time
from collections import deque
from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from .node import EOS
from .queues import QueueClosed

# ring header: producer / consumer indices on separate cache lines, plus the
# closed flag (written by the producer, read by both sides)
_OFF_TAIL = 0
_OFF_HEAD = 64
_OFF_CLOSED = 128
_HEADER = 192

_SLOT_HDR = 16           # u32 payload length | u8 tag | 3B pad | u64 seq
_SLOT_FMT = "<IB3xQ"

TAG_PKL = 0
TAG_ARR = 1
TAG_EOS = 2
TAG_ERR = 3
TAG_BATCH = 4       # pickled list of (seq, item) pairs — one slot per run
TAG_SEG = 5         # uSPSC growth marker: pickled next-segment descriptor
TAG_ARN = 6         # ndarray meta + (offset, nbytes) into the lane's arena

# most items a single BATCH slot may coalesce; bounds both the pickle size
# probe (halving search below) and the consumer-side staging burst
_BATCH_MAX = 64


@dataclass(frozen=True)
class TransportConfig:
    """Per-compile tuning knobs for the shm transport.

    Defaults are the values that were hard-coded before this existed:

    - ``ring_slots`` (64): slots per farm lane (emitter->worker and
      worker->collector rings); the compiler clamps its ``capacity`` hint
      into ``[2, ring_slots]``;
    - ``grid_slots`` (32): slots per :class:`ShmMPMCGrid` lane — the
      ``all_to_all`` interconnect allocates nL x nR of them, so its clamp
      is tighter;
    - ``slot_bytes`` (64 KiB): fixed payload bytes per slot;
    - ``arena_bytes`` (4 MiB): per-lane slab arena for ndarrays larger than
      a slot; ``0`` disables the arena (oversize arrays then fall back to
      pickle as before);
    - ``bounded`` (True): ``False`` swaps farm input lanes to the uSPSC
      unbounded tier — the emitter never blocks, segments grow on overflow;
    - ``batch`` (16): producer-side max items buffered per vectored flush;
    - ``flush_s`` (2 ms): adaptive-flush timeout — a partial batch older
      than this is pushed anyway so latency-sensitive streams don't stall.
    """

    ring_slots: int = 64
    grid_slots: int = 32
    slot_bytes: int = 1 << 16
    arena_bytes: int = 1 << 22
    bounded: bool = True
    batch: int = 16
    flush_s: float = 2e-3

    def __post_init__(self):
        if self.ring_slots < 2 or self.grid_slots < 2:
            raise ValueError("transport ring/grid slots must be >= 2")
        if self.slot_bytes < _SLOT_HDR:
            raise ValueError("transport slot_bytes too small")
        if self.batch < 1:
            raise ValueError("transport batch must be >= 1")
        if self.arena_bytes != 0 and self.arena_bytes < 4096:
            raise ValueError("transport arena_bytes must be 0 (disabled) "
                             "or >= 4096")


def as_transport(obj: Any) -> "TransportConfig":
    """Coerce ``compile(transport=...)`` input: None (defaults), a
    :class:`TransportConfig`, or a dict of field overrides."""
    if obj is None:
        return TransportConfig()
    if isinstance(obj, TransportConfig):
        return obj
    if isinstance(obj, dict):
        return TransportConfig(**obj)
    raise TypeError(f"transport must be TransportConfig/dict/None, "
                    f"not {type(obj).__name__}")


class _SegMark:
    """Decoded ``SEG`` slot: descriptor of the next uSPSC segment."""

    __slots__ = ("state",)

    def __init__(self, state: dict):
        self.state = state


class ShmError:
    """A worker-side failure shipped through the ring (tag ``ERR``)."""

    __slots__ = ("worker", "exc", "tb")

    def __init__(self, worker: int, exc: str, tb: str):
        self.worker = worker
        self.exc = exc
        self.tb = tb

    def __repr__(self) -> str:
        return f"ShmError(worker={self.worker}, exc={self.exc!r})"


class WorkerStats:
    """A worker-side CPU-time record shipped over a result lane (seq-less
    control payload, not a stream item): ``items`` processed so far and an
    EMA of per-item *CPU* seconds (``time.thread_time``).  Farms fold these
    into ``node_stats()["svc_cpu_ema_s"]`` so the runtime Supervisor's
    process→thread policy compares true service times instead of inferring
    them from hop domination."""

    __slots__ = ("worker", "items", "cpu_ema_s")

    def __init__(self, worker: int, items: int, cpu_ema_s: float):
        self.worker = worker
        self.items = items
        self.cpu_ema_s = cpu_ema_s

    def __repr__(self) -> str:
        return (f"WorkerStats(worker={self.worker}, items={self.items}, "
                f"cpu_ema_s={self.cpu_ema_s:.3g})")


def _unregister_tracker(name: str) -> None:
    # attaching registers the segment with this process's resource_tracker,
    # which would unlink it when the attacher exits; only the creator owns
    # the segment's lifetime
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister("/" + name, "shared_memory")
    except Exception:   # noqa: BLE001 - best effort, platform-dependent
        pass


# arena header: producer / consumer byte cursors on separate cache lines;
# both are *absolute* (monotonically increasing, never wrapped) so the
# free-space check is plain subtraction and wrap-skips stay consistent
_ARN_OFF_TAIL = 0
_ARN_OFF_HEAD = 64
_ARN_HEADER = 128


class ShmArena:
    """Variable-size slab arena: a FIFO byte ring in one shm segment.

    Rides next to an SPSC lane and inherits its discipline: the lane's
    producer owns the alloc cursor (``tail``), the lane's consumer owns the
    free cursor (``head``), each a single aligned 8-byte store.  Because the
    lane is consumed FIFO and blocks are allocated FIFO, blocks are freed in
    allocation order — so the arena never needs a free list, just two
    cursors.  A block that would straddle the end of the ring is placed at
    the start instead; the skipped gap is accounted for by carrying the
    *absolute* start offset in the slot header, so the consumer's free
    cursor jumps the same gap.

    Producer protocol: ``alloc`` -> ``write`` -> ``commit``; consumer:
    ``take`` (copy out + free in one step).  ``alloc`` returning ``None``
    is back-pressure (the lane's ``try_push`` returns False and the
    blocking wrapper retries after the consumer frees).
    """

    def __init__(self, size: int = 1 << 22, name: Optional[str] = None,
                 _create: bool = True):
        if size < 4096:
            raise ValueError("arena size must be >= 4096 bytes")
        self._size = size
        self._creator = _create
        if _create:
            self._shm = shared_memory.SharedMemory(create=True,
                                                   size=_ARN_HEADER + size)
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            _unregister_tracker(self._shm.name)
        self._buf = self._shm.buf

    def __getstate__(self):
        return {"size": self._size, "name": self._shm.name}

    def __setstate__(self, state):
        self.__init__(state["size"], name=state["name"], _create=False)

    @property
    def name(self) -> str:
        return self._shm.name

    @property
    def data_size(self) -> int:
        return self._size

    def _load(self, off: int) -> int:
        return int.from_bytes(self._buf[off:off + 8], "little")

    def _store(self, off: int, v: int) -> None:
        self._buf[off:off + 8] = v.to_bytes(8, "little")

    def used(self) -> int:
        return self._load(_ARN_OFF_TAIL) - self._load(_ARN_OFF_HEAD)

    # -- producer side -------------------------------------------------------
    def alloc(self, nbytes: int) -> Optional[int]:
        """Reserve ``nbytes`` contiguous; returns the absolute start offset
        or ``None`` when the ring is too full (back-pressure, not an
        error)."""
        if nbytes > self._size:
            raise ValueError(
                f"array of {nbytes}B exceeds the {self._size}B shm arena; "
                "raise arena_bytes= on the transport")
        tail = self._load(_ARN_OFF_TAIL)
        head = self._load(_ARN_OFF_HEAD)
        pos = tail % self._size
        start = tail if pos + nbytes <= self._size \
            else tail + (self._size - pos)      # skip the end-of-ring gap
        if start + nbytes - head > self._size:
            return None
        return start

    def write(self, start: int, data: memoryview) -> None:
        off = _ARN_HEADER + (start % self._size)
        self._buf[off:off + len(data)] = data

    def commit(self, start: int, nbytes: int) -> None:
        self._store(_ARN_OFF_TAIL, start + nbytes)

    # -- consumer side -------------------------------------------------------
    def take(self, start: int, nbytes: int) -> bytes:
        """Copy a block out and free it (advance the head cursor past it,
        including any wrap gap the producer skipped)."""
        off = _ARN_HEADER + (start % self._size)
        data = bytes(self._buf[off:off + nbytes])
        self._store(_ARN_OFF_HEAD, start + nbytes)
        return data

    # -- segment lifetime ----------------------------------------------------
    def detach(self) -> None:
        try:
            self._buf = None
            self._shm.close()
        except Exception:   # noqa: BLE001 - already detached
            pass

    def destroy(self) -> None:
        self.detach()
        if self._creator:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


class ShmSPSCQueue:
    """Bounded SPSC ring over one shared-memory segment.

    Same surface as :class:`~repro_torch.core.queues.SPSCQueue` (``try_push`` /
    ``try_pop`` / blocking wrappers / ``close``), crossing a process
    boundary.  The object is picklable: unpickling (or ``attach``) maps the
    same segment by name, so a ``fork``- or ``spawn``-started worker sees the
    identical ring.  Only the creating process may ``unlink``.
    """

    def __init__(self, capacity: int = 64, slot_bytes: int = 1 << 16,
                 name: Optional[str] = None, _create: bool = True,
                 arena_bytes: int = 0, arena_name: Optional[str] = None):
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        self._cap = capacity
        self._slot = slot_bytes
        self._stride = _SLOT_HDR + slot_bytes
        self._creator = _create
        self.max_depth = 0          # producer-side observation, process-local
        self.arena_pushes = 0       # oversize ndarrays shipped via the arena
        self.pickle_fallbacks = 0   # ndarrays that had to ride TAG_PKL
        # consumer-side overflow of expanded BATCH slots (process-local)
        self._staged: deque = deque()
        size = _HEADER + capacity * self._stride
        if _create:
            self._shm = shared_memory.SharedMemory(create=True, size=size)
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            _unregister_tracker(self._shm.name)
        self._buf = self._shm.buf
        try:
            if arena_name is not None:
                self._arena: Optional[ShmArena] = ShmArena(
                    arena_bytes, name=arena_name, _create=False)
            elif _create and arena_bytes > 0:
                self._arena = ShmArena(arena_bytes)
            else:
                self._arena = None
        except Exception:
            # a rejected arena must not leak the ring segment just created
            self._buf = None
            self._shm.close()
            if _create:
                self._shm.unlink()
            raise

    # -- pickling: reattach by name -----------------------------------------
    def __getstate__(self):
        state = {"capacity": self._cap, "slot_bytes": self._slot,
                 "name": self._shm.name}
        if self._arena is not None:
            state["arena_bytes"] = self._arena.data_size
            state["arena_name"] = self._arena.name
        return state

    def __setstate__(self, state):
        self.__init__(state["capacity"], state["slot_bytes"],
                      name=state["name"], _create=False,
                      arena_bytes=state.get("arena_bytes", 0),
                      arena_name=state.get("arena_name"))

    @property
    def name(self) -> str:
        return self._shm.name

    @property
    def capacity(self) -> int:
        return self._cap - 1

    # -- shared-index helpers ------------------------------------------------
    def _load(self, off: int) -> int:
        return int.from_bytes(self._buf[off:off + 8], "little")

    def _store(self, off: int, v: int) -> None:
        self._buf[off:off + 8] = v.to_bytes(8, "little")

    def __len__(self) -> int:
        if self._buf is None:           # detached/destroyed: nothing queued
            return 0
        return len(self._staged) \
            + (self._load(_OFF_TAIL) - self._load(_OFF_HEAD)) % self._cap

    def empty(self) -> bool:
        if self._buf is None:
            return True
        return not self._staged \
            and self._load(_OFF_TAIL) == self._load(_OFF_HEAD)

    @property
    def closed(self) -> bool:
        if self._buf is None:           # a detached lane refuses new items
            return True
        return self._buf[_OFF_CLOSED] != 0

    def close(self) -> None:
        self._buf[_OFF_CLOSED] = 1

    def drained(self) -> bool:
        """Closed with nothing left to pop."""
        return self.closed and self.empty()

    # -- encode / decode -----------------------------------------------------
    def _encode(self, base: int, tag: int, obj: Any, seq: int = 0) -> None:
        if tag == TAG_ARR:
            dt = obj.dtype.str.encode("ascii")
            meta = struct.pack("<BB", obj.ndim, len(dt)) + dt \
                + struct.pack(f"<{obj.ndim}q", *obj.shape)
            payload_len = len(meta) + obj.nbytes
            if payload_len > self._slot:
                raise ValueError(
                    f"array of {obj.nbytes}B exceeds the {self._slot}B shm "
                    "slot; raise slot_bytes= on the ring")
            off = base + _SLOT_HDR
            self._buf[off:off + len(meta)] = meta
            off += len(meta)
            self._buf[off:off + obj.nbytes] = memoryview(obj).cast("B")
        elif tag in (TAG_PKL, TAG_ERR, TAG_SEG):
            payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
            payload_len = len(payload)
            if payload_len > self._slot:
                raise ValueError(
                    f"pickled item of {payload_len}B exceeds the "
                    f"{self._slot}B shm slot; raise slot_bytes= on the ring")
            off = base + _SLOT_HDR
            self._buf[off:off + payload_len] = payload
        else:                       # TAG_EOS
            payload_len = 0
        struct.pack_into(_SLOT_FMT, self._buf, base, payload_len, tag, seq)

    def _encode_raw(self, base: int, tag: int, payload: bytes,
                    seq: int = 0) -> None:
        """Write an already-serialized payload (BATCH / SEG slots)."""
        if len(payload) > self._slot:
            raise ValueError(
                f"payload of {len(payload)}B exceeds the {self._slot}B shm "
                "slot; raise slot_bytes= on the ring")
        self._buf[base + _SLOT_HDR:base + _SLOT_HDR + len(payload)] = payload
        struct.pack_into(_SLOT_FMT, self._buf, base, len(payload), tag, seq)

    @staticmethod
    def _arr_meta(a: np.ndarray) -> bytes:
        dt = a.dtype.str.encode("ascii")
        return struct.pack("<BB", a.ndim, len(dt)) + dt \
            + struct.pack(f"<{a.ndim}q", *a.shape)

    def _encode_arena(self, base: int, a: np.ndarray, seq: int) -> bool:
        """Ship ``a`` through the slab arena: the slot carries only meta +
        ``(offset, nbytes)``.  False when the arena is too full (the ring
        slot stays unclaimed — caller must not advance the tail)."""
        start = self._arena.alloc(a.nbytes)
        if start is None:
            return False
        self._arena.write(start, memoryview(a).cast("B"))
        self._arena.commit(start, a.nbytes)
        payload = self._arr_meta(a) + struct.pack("<QQ", start, a.nbytes)
        self._encode_raw(base, TAG_ARN, payload, seq)
        self.arena_pushes += 1
        return True

    def _decode(self, base: int) -> Tuple[int, Any, int]:
        """Decode one slot -> ``(tag, obj, seq)``.  BATCH decodes to the
        list of ``(seq, item)`` pairs; SEG to a :class:`_SegMark`; ARN
        copies the block out of the arena and frees it."""
        payload_len, tag, seq = struct.unpack_from(_SLOT_FMT, self._buf, base)
        off = base + _SLOT_HDR
        if tag == TAG_EOS:
            return tag, EOS, seq
        if tag in (TAG_ARR, TAG_ARN):
            ndim, dlen = struct.unpack_from("<BB", self._buf, off)
            off += 2
            dtype = np.dtype(bytes(self._buf[off:off + dlen]).decode("ascii"))
            off += dlen
            shape = struct.unpack_from(f"<{ndim}q", self._buf, off)
            off += 8 * ndim
            if tag == TAG_ARN:
                start, nbytes = struct.unpack_from("<QQ", self._buf, off)
                data = self._arena.take(start, nbytes)
                return tag, np.frombuffer(data, dtype=dtype).reshape(shape), \
                    seq
            nbytes = int(dtype.itemsize * int(np.prod(shape, dtype=np.int64))) \
                if ndim else dtype.itemsize
            # bytes() copies out of the slot before the producer reuses it
            return tag, np.frombuffer(bytes(self._buf[off:off + nbytes]),
                                      dtype=dtype).reshape(shape), seq
        obj = pickle.loads(bytes(self._buf[off:off + payload_len]))
        if tag == TAG_SEG:
            return tag, _SegMark(obj), seq
        return tag, obj, seq

    # -- non-blocking primitives (the lock-free layer) -----------------------
    def _try_push_tag(self, tag: int, obj: Any, seq: int = 0) -> bool:
        tail = self._load(_OFF_TAIL)
        head = self._load(_OFF_HEAD)
        nxt = (tail + 1) % self._cap
        if nxt == head:             # full
            return False
        self._encode(_HEADER + tail * self._stride, tag, obj, seq)
        self._store(_OFF_TAIL, nxt)     # single atomic publish
        depth = (nxt - head) % self._cap
        if depth > self.max_depth:
            self.max_depth = depth
        return True

    @staticmethod
    def _is_plain_array(item: Any) -> bool:
        # the raw-slab path only fits plain dtypes: structured dtypes
        # collapse to void under dtype.str (field names lost) and object
        # dtypes have no flat buffer — both must ride the pickle path
        return isinstance(item, np.ndarray) and item.dtype.names is None \
            and item.dtype.kind != "O"

    def _try_push_arena(self, a: np.ndarray, seq: int) -> bool:
        tail = self._load(_OFF_TAIL)
        head = self._load(_OFF_HEAD)
        nxt = (tail + 1) % self._cap
        if nxt == head:             # full
            return False
        if not self._encode_arena(_HEADER + tail * self._stride, a, seq):
            return False            # arena full — back-pressure, retry later
        self._store(_OFF_TAIL, nxt)
        depth = (nxt - head) % self._cap
        if depth > self.max_depth:
            self.max_depth = depth
        return True

    def try_push(self, item: Any, seq: int = 0) -> bool:
        if self._is_plain_array(item):
            a = np.ascontiguousarray(item)
            if len(self._arr_meta(a)) + a.nbytes <= self._slot:
                return self._try_push_tag(TAG_ARR, a, seq)
            if self._arena is not None:
                return self._try_push_arena(a, seq)
            self.pickle_fallbacks += 1
            return self._try_push_tag(TAG_PKL, item, seq)
        return self._try_push_tag(TAG_PKL, item, seq)

    def try_pop_seq(self) -> Tuple[bool, Any, int]:
        if self._staged:
            item, seq = self._staged.popleft()
            return True, item, seq
        head = self._load(_OFF_HEAD)
        if head == self._load(_OFF_TAIL):   # empty
            return False, None, 0
        tag, item, seq = self._decode(_HEADER + head * self._stride)
        self._store(_OFF_HEAD, (head + 1) % self._cap)
        if tag == TAG_BATCH:
            # expand the run: hand out the first pair now, stage the rest
            (seq, item), rest = item[0], item[1:]
            self._staged.extend((it, s) for s, it in rest)
        return True, item, seq

    def try_pop(self) -> Tuple[bool, Any]:
        ok, item, _seq = self.try_pop_seq()
        return ok, item

    # -- vectored (batched) primitives ---------------------------------------
    def try_push_many(self, items: Sequence[Any],
                      seqs: Optional[Sequence[int]] = None,
                      reserve: int = 0) -> int:
        """Vectored push: encode as many leading ``items`` as fit, then
        publish the tail ONCE — one atomic-index write and (on the blocking
        wrapper) one spin per batch instead of per item.  Runs of small
        non-array items coalesce into single ``BATCH`` slots (one
        ``pickle.dumps`` per run); plain ndarrays keep their raw-slab /
        arena slots inside the same publish.  ``reserve`` keeps that many
        ring slots unclaimed (the uSPSC tier reserves one for its growth
        marker).  Returns the number of leading items pushed."""
        n = len(items)
        if n == 0:
            return 0
        if seqs is None:
            seqs = (0,) * n
        tail = self._load(_OFF_TAIL)
        head = self._load(_OFF_HEAD)
        free = (head - tail - 1) % self._cap - reserve
        if free <= 0:
            return 0
        pos = tail
        pushed = 0
        pending: List[Tuple[int, Any]] = []   # (seq, item) run to coalesce

        def emit(tag, obj, seq):
            nonlocal pos, free
            self._encode(_HEADER + pos * self._stride, tag, obj, seq)
            pos = (pos + 1) % self._cap
            free -= 1

        def flush_pending() -> bool:
            """Emit the buffered run as BATCH slots (halving a chunk whose
            pickle overflows the slot); False when the ring filled first."""
            nonlocal pos, free, pushed
            while pending:
                if free <= 0:
                    return False
                chunk = pending[:_BATCH_MAX]
                payload = pickle.dumps(chunk,
                                       protocol=pickle.HIGHEST_PROTOCOL)
                while len(payload) > self._slot and len(chunk) > 1:
                    chunk = chunk[:max(1, len(chunk) // 2)]
                    payload = pickle.dumps(chunk,
                                           protocol=pickle.HIGHEST_PROTOCOL)
                if len(chunk) == 1:
                    # a lone item gains nothing from the batch frame; this
                    # also surfaces the oversize-pickle ValueError unchanged
                    emit(TAG_PKL, chunk[0][1], chunk[0][0])
                else:
                    self._encode_raw(_HEADER + pos * self._stride, TAG_BATCH,
                                     payload, chunk[0][0])
                    pos = (pos + 1) % self._cap
                    free -= 1
                del pending[:len(chunk)]
                pushed += len(chunk)
            return True

        try:
            for seq, obj in zip(seqs, items):
                if self._is_plain_array(obj):
                    if not flush_pending() or free <= 0:
                        break
                    a = np.ascontiguousarray(obj)
                    if len(self._arr_meta(a)) + a.nbytes <= self._slot:
                        emit(TAG_ARR, a, seq)
                    elif self._arena is not None:
                        if not self._encode_arena(
                                _HEADER + pos * self._stride, a, seq):
                            break       # arena full — stop, caller retries
                        pos = (pos + 1) % self._cap
                        free -= 1
                    else:
                        self.pickle_fallbacks += 1
                        emit(TAG_PKL, obj, seq)
                    pushed += 1
                else:
                    pending.append((seq, obj))
                    if len(pending) >= _BATCH_MAX and not flush_pending():
                        break
            else:
                flush_pending()
        finally:
            if pos != tail:             # single atomic publish for the batch
                self._store(_OFF_TAIL, pos)
                depth = (pos - head) % self._cap
                if depth > self.max_depth:
                    self.max_depth = depth
        return pushed

    def try_pop_many(self, max_items: int = 256) -> List[Tuple[Any, int]]:
        """Vectored pop: drain staged items plus every currently-published
        slot (up to ``max_items``), then publish the head ONCE.  Returns
        ``(item, seq)`` pairs in FIFO order; a BATCH slot expands in place
        (its items count toward, and may overshoot, ``max_items`` — a slot
        is atomic).  Control items (EOS / ShmError) appear in-stream."""
        out: List[Tuple[Any, int]] = []
        while self._staged and len(out) < max_items:
            out.append(self._staged.popleft())
        head = self._load(_OFF_HEAD)
        tail = self._load(_OFF_TAIL)
        pos = head
        while pos != tail and len(out) < max_items:
            tag, item, seq = self._decode(_HEADER + pos * self._stride)
            pos = (pos + 1) % self._cap
            if tag == TAG_BATCH:
                out.extend((it, s) for s, it in item)
            else:
                out.append((item, seq))
        if pos != head:                 # single atomic publish for the batch
            self._store(_OFF_HEAD, pos)
        return out

    def push_many(self, items: Sequence[Any],
                  seqs: Optional[Sequence[int]] = None,
                  timeout: Optional[float] = None) -> None:
        """Blocking vectored push — one spin loop per *batch*.  Preserves
        input order exactly across partial flushes (a full ring or full
        arena pushes a prefix and retries the rest)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        done = 0
        n = len(items)
        while done < n:
            if self.closed:
                raise QueueClosed("push_many to closed shm queue")
            k = self.try_push_many(
                items[done:] if done else items,
                (seqs[done:] if done else seqs) if seqs is not None else None)
            done += k
            if done >= n:
                return
            if k:
                delay = 1e-6            # progress: reset the backoff
                continue
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm SPSC push_many timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def pop_many(self, max_items: int = 256,
                 timeout: Optional[float] = None) -> List[Tuple[Any, int]]:
        """Blocking vectored pop: at least one ``(item, seq)`` pair, up to
        whatever is already published (one head write for the lot)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            got = self.try_pop_many(max_items)
            if got:
                return got
            if self.closed:
                raise QueueClosed("pop from closed empty shm queue")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm SPSC pop_many timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    # -- blocking wrappers ---------------------------------------------------
    def push(self, item: Any, timeout: Optional[float] = None,
             seq: int = 0) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            # same discipline as the thread tier: a closed queue refuses new
            # items even when slots remain
            if self.closed:
                raise QueueClosed("push to closed shm queue")
            if self.try_push(item, seq):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm SPSC push timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def pop_seq(self, timeout: Optional[float] = None) -> Tuple[Any, int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            ok, item, seq = self.try_pop_seq()
            if ok:
                return item, seq
            if self.closed:
                raise QueueClosed("pop from closed empty shm queue")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm SPSC pop timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def pop(self, timeout: Optional[float] = None) -> Any:
        return self.pop_seq(timeout)[0]

    def push_eos(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            # a closed lane's consumer is gone (or the network is unwinding)
            # and will never see the mark; raising lets a worker's EOS
            # fan-out unwind instead of wedging on a dead peer's full lane
            if self.closed:
                raise QueueClosed("push_eos to closed shm queue")
            if self._try_push_tag(TAG_EOS, None):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm SPSC push_eos timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def push_err(self, err: ShmError, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            if self.closed:
                raise QueueClosed("push_err to closed shm queue")
            if self._try_push_tag(TAG_ERR, err):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm SPSC push_err timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    # -- segment lifetime ----------------------------------------------------
    def detach(self) -> None:
        try:
            self._buf = None
            self._shm.close()
        except Exception:   # noqa: BLE001 - already detached
            pass
        if self._arena is not None:
            self._arena.detach()

    def destroy(self) -> None:
        """Release the segment (creator only; attachers just detach)."""
        self.detach()
        if self._creator:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
        if self._arena is not None and self._creator:
            self._arena.destroy()

    def _unlink_any(self) -> None:
        """Best-effort unlink regardless of creator — the uSPSC tier hands
        segment ownership to whichever side retires the segment.  A creator
        handle goes through ``SharedMemory.unlink`` (which also clears its
        resource-tracker entry); an attached handle unlinks raw, because its
        tracker entry was already balanced at attach time and a second
        unregister would just splat a KeyError in the tracker process."""
        name = getattr(self._shm, "_name", "/" + self._shm.name)
        self.detach()
        try:
            from multiprocessing.shared_memory import _posixshmem
            _posixshmem.shm_unlink(name)
        except Exception:   # noqa: BLE001 - gone already / non-posix
            pass


class BatchedLaneWriter:
    """Producer-side adaptive batcher over one lane.

    Buffers ``put()`` items and flushes them with one vectored
    ``push_many`` when the batch fills, when ``maybe_flush`` finds the
    oldest buffered item past ``flush_s`` (the adaptive-flush timeout), or
    when EOS/ERR must go out — a control mark never overtakes buffered
    items, so stream order survives partial flushes."""

    __slots__ = ("_lane", "_batch", "_flush_s", "_items", "_seqs", "_t0")

    def __init__(self, lane: Any, batch: int = 16, flush_s: float = 2e-3):
        self._lane = lane
        self._batch = max(1, batch)
        self._flush_s = flush_s
        self._items: List[Any] = []
        self._seqs: List[int] = []
        self._t0 = 0.0

    def __len__(self) -> int:
        return len(self._items)

    def put(self, item: Any, seq: int = 0,
            timeout: Optional[float] = None) -> None:
        if not self._items:
            self._t0 = time.monotonic()
        self._items.append(item)
        self._seqs.append(seq)
        if len(self._items) >= self._batch:
            self.flush(timeout)

    def due(self) -> bool:
        return bool(self._items) \
            and time.monotonic() - self._t0 >= self._flush_s

    def maybe_flush(self, timeout: Optional[float] = None) -> None:
        if self.due():
            self.flush(timeout)

    def flush(self, timeout: Optional[float] = None) -> None:
        if not self._items:
            return
        items, seqs = self._items, self._seqs
        self._items, self._seqs = [], []
        self._lane.push_many(items, seqs, timeout=timeout)

    def push_eos(self, timeout: Optional[float] = None) -> None:
        self.flush(timeout)
        self._lane.push_eos(timeout)

    def push_err(self, err: "ShmError",
                 timeout: Optional[float] = None) -> None:
        self.flush(timeout)
        self._lane.push_err(err, timeout)


class ShmUSPSCQueue:
    """Unbounded SPSC: a linked chain of fixed-slot ring segments (the 2009
    FastFlow TR's uSPSC design, lifted onto shm segments).

    The producer writes into its current tail segment; when the ring fills
    it creates a fresh segment, drops a ``SEG`` marker (the new segment's
    name) into the permanently-reserved last slot, and carries on in the
    new ring — the push side never blocks on a slow consumer.  The consumer
    drains its current head segment; the marker is by construction the
    final slot of a segment, so on decoding one it retires the drained
    segment (close + unlink) and re-attaches the next by name.  Every
    segment individually keeps the wait-free single-writer discipline, and
    one shared :class:`ShmArena` spans the whole chain (allocation order ==
    consumption order across segments, so FIFO freeing still holds).

    Same push/pop surface as :class:`ShmSPSCQueue`; ``bounded=False`` lanes
    in a farm are exactly this class.  ``close()`` marks the *producer's*
    current segment, so the drain-then-raise contract is *per chain*: the
    consumer raises ``QueueClosed`` only after following every marker to
    the closed final segment and emptying it.
    """

    def __init__(self, capacity: int = 64, slot_bytes: int = 1 << 16,
                 arena_bytes: int = 0, _seg: Optional[ShmSPSCQueue] = None,
                 _arena: Optional[ShmArena] = None):
        if capacity < 4:
            raise ValueError("uSPSC segment capacity must be >= 4")
        self._cap = capacity
        self._slot = slot_bytes
        if _seg is not None:            # attaching side (unpickle)
            self._arena = _arena
            seg = _seg
        else:
            self._arena = ShmArena(arena_bytes) if arena_bytes > 0 else None
            seg = ShmSPSCQueue(capacity, slot_bytes)
            seg._arena = self._arena
            # uSPSC segments live outside the resource tracker: retirement
            # crosses process boundaries (the consumer unlinks what the
            # producer created), which the tracker's per-name set cannot
            # express without double-unregister noise
            _unregister_tracker(seg.name)
        self._w = seg                   # producer's current tail segment
        self._r = seg                   # consumer's current head segment
        self._retired: deque = deque()  # grown-past segments awaiting drain
        self.segments_grown = 0         # producer-side, process-local

    # -- pickling: both sides start at the producer's current segment -------
    def __getstate__(self):
        return {"capacity": self._cap, "slot_bytes": self._slot,
                "seg": self._w.__getstate__(),
                "arena": None if self._arena is None
                else self._arena.__getstate__()}

    def __setstate__(self, state):
        arena = None
        if state["arena"] is not None:
            arena = ShmArena.__new__(ShmArena)
            arena.__setstate__(state["arena"])
        seg = ShmSPSCQueue.__new__(ShmSPSCQueue)
        seg.__setstate__(state["seg"])
        seg._arena = arena
        self.__init__(state["capacity"], state["slot_bytes"],
                      _seg=seg, _arena=arena)

    @property
    def capacity(self) -> int:
        """Per-segment capacity — the chain itself is unbounded."""
        return self._cap - 1

    @property
    def unbounded(self) -> bool:
        return True

    @property
    def max_depth(self) -> int:
        return self._w.max_depth

    @property
    def arena_pushes(self) -> int:
        return self._w.arena_pushes

    @property
    def pickle_fallbacks(self) -> int:
        return self._w.pickle_fallbacks

    def __len__(self) -> int:
        # local view only: the segments this handle currently maps
        n = len(self._r)
        if self._w is not self._r:
            n += len(self._w)
        return n

    def empty(self) -> bool:
        return self._r.empty() and self._w.empty()

    @property
    def closed(self) -> bool:
        # producer view; consumers detect shutdown via drained() (the flag
        # lives on the chain's final segment, reached by draining)
        return self._w.closed

    def close(self) -> None:
        self._w.close()
        if self._r is not self._w:
            self._r.close()

    def drained(self) -> bool:
        return self._r.closed and self._r.empty()

    # -- producer side -------------------------------------------------------
    def _free_w(self) -> int:
        w = self._w
        return (w._load(_OFF_HEAD) - w._load(_OFF_TAIL) - 1) % w._cap

    def _grow(self) -> None:
        """Chain a fresh segment: marker into the reserved last slot of the
        full ring, then switch writes over."""
        new = ShmSPSCQueue(self._cap, self._slot)
        new._arena = self._arena
        _unregister_tracker(new.name)   # tracker-free, like every segment
        ok = self._w._try_push_tag(TAG_SEG, new.__getstate__())
        assert ok, "uSPSC reserved growth slot was taken"
        old = self._w
        self._w = new
        self.segments_grown += 1
        # this handle may also BE the consumer (in-process use), so the old
        # mapping cannot be dropped eagerly — park it and close mappings of
        # segments the consumer has provably drained
        if old is not self._r:
            self._retired.append(old)
        while self._retired:
            seg = self._retired[0]
            if seg._buf is not None and not seg.empty():
                break                   # consumer still inside it
            if seg._buf is not None:
                seg._arena = None       # the chain arena outlives segments
                seg.detach()
            self._retired.popleft()

    def try_push(self, item: Any, seq: int = 0) -> bool:
        if self._free_w() <= 1:        # only the reserved marker slot left
            self._grow()
        return self._w.try_push(item, seq)

    def try_push_many(self, items: Sequence[Any],
                      seqs: Optional[Sequence[int]] = None) -> int:
        total = 0
        n = len(items)
        while total < n:
            k = self._w.try_push_many(
                items[total:] if total else items,
                (seqs[total:] if total else seqs) if seqs is not None
                else None,
                reserve=1)
            total += k
            if total >= n:
                break
            if self._free_w() <= 1:
                self._grow()            # ring-bound stall: chain and go on
                continue
            break                       # arena-bound stall: let caller retry
        return total

    def push(self, item: Any, timeout: Optional[float] = None,
             seq: int = 0) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            if self.closed:
                raise QueueClosed("push to closed shm queue")
            if self.try_push(item, seq):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm uSPSC push timed out")
            time.sleep(delay)           # arena back-pressure only
            delay = min(delay * 2, 1e-3)

    def push_many(self, items: Sequence[Any],
                  seqs: Optional[Sequence[int]] = None,
                  timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        done = 0
        n = len(items)
        while done < n:
            if self.closed:
                raise QueueClosed("push_many to closed shm queue")
            k = self.try_push_many(
                items[done:] if done else items,
                (seqs[done:] if done else seqs) if seqs is not None else None)
            done += k
            if done >= n:
                return
            if k:
                delay = 1e-6
                continue
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm uSPSC push_many timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def push_eos(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            if self.closed:
                raise QueueClosed("push_eos to closed shm queue")
            if self._free_w() <= 1:
                self._grow()
            if self._w._try_push_tag(TAG_EOS, None):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm uSPSC push_eos timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def push_err(self, err: ShmError,
                 timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            if self.closed:
                raise QueueClosed("push_err to closed shm queue")
            if self._free_w() <= 1:
                self._grow()
            if self._w._try_push_tag(TAG_ERR, err):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm uSPSC push_err timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    # -- consumer side -------------------------------------------------------
    def _switch(self, mark: _SegMark) -> None:
        """Follow a growth marker: retire the drained segment, attach the
        next.  Retiring unlinks — this side inherited ownership when the
        producer grew past it."""
        state = dict(mark.state)
        new = ShmSPSCQueue(state["capacity"], state["slot_bytes"],
                           name=state["name"], _create=False)
        new._arena = self._arena
        old = self._r
        self._r = new
        if self._w is old:              # attached handle: track the head
            self._w = new
        old._arena = None               # the chain arena outlives segments
        old._unlink_any()

    def try_pop_seq(self) -> Tuple[bool, Any, int]:
        while True:
            ok, item, seq = self._r.try_pop_seq()
            if ok and isinstance(item, _SegMark):
                self._switch(item)
                continue
            return ok, item, seq

    def try_pop(self) -> Tuple[bool, Any]:
        ok, item, _seq = self.try_pop_seq()
        return ok, item

    def try_pop_many(self, max_items: int = 256) -> List[Tuple[Any, int]]:
        out: List[Tuple[Any, int]] = []
        while len(out) < max_items:
            got = self._r.try_pop_many(max_items - len(out))
            if not got:
                break
            # a marker is always the last slot of its segment
            if isinstance(got[-1][0], _SegMark):
                out.extend(got[:-1])
                self._switch(got[-1][0])
                continue
            out.extend(got)
        return out

    def pop_seq(self, timeout: Optional[float] = None) -> Tuple[Any, int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            ok, item, seq = self.try_pop_seq()
            if ok:
                return item, seq
            if self.drained():
                raise QueueClosed("pop from closed empty shm queue")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm uSPSC pop timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def pop(self, timeout: Optional[float] = None) -> Any:
        return self.pop_seq(timeout)[0]

    def pop_many(self, max_items: int = 256,
                 timeout: Optional[float] = None) -> List[Tuple[Any, int]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            got = self.try_pop_many(max_items)
            if got:
                return got
            if self.drained():
                raise QueueClosed("pop from closed empty shm queue")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm uSPSC pop_many timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    # -- segment lifetime ----------------------------------------------------
    def detach(self) -> None:
        for seg in (self._r, self._w):
            seg._arena = None           # the chain arena outlives segments
        self._r.detach()
        if self._w is not self._r:
            self._w.detach()
        if self._arena is not None:
            self._arena.detach()

    def destroy(self) -> None:
        """Unlink whatever segments this handle still maps (intermediate
        segments were already retired by the consumer as it drained)."""
        for seg in (self._r, self._w):
            seg._arena = None
        self._r._unlink_any()
        if self._w is not self._r:
            self._w._unlink_any()
        for seg in self._retired:       # mapped but not yet swept
            seg._arena = None
            seg._unlink_any()
        self._retired.clear()
        if self._arena is not None:
            if self._arena._creator:
                self._arena.destroy()
            else:
                self._arena.detach()


class ShmSPMCQueue:
    """Single producer, multiple consumer *processes*: one shm SPSC lane per
    consumer, round-robin by default (mirrors
    :class:`~repro_torch.core.queues.SPMCQueue`)."""

    def __init__(self, n_consumers: int, capacity: int = 64,
                 slot_bytes: int = 1 << 16, arena_bytes: int = 0,
                 bounded: bool = True):
        if bounded:
            self.lanes = [ShmSPSCQueue(capacity, slot_bytes,
                                       arena_bytes=arena_bytes)
                          for _ in range(n_consumers)]
        else:
            self.lanes = [ShmUSPSCQueue(max(capacity, 4), slot_bytes,
                                        arena_bytes=arena_bytes)
                          for _ in range(n_consumers)]
        self._rr = 0

    @classmethod
    def from_lanes(cls, lanes: List[Any]) -> "ShmSPMCQueue":
        """Wrap pre-built lanes (the farm builds them one worker at a time
        so each lane's pages can first-touch on its worker's NUMA node)."""
        self = cls.__new__(cls)
        self.lanes = list(lanes)
        self._rr = 0
        return self

    def push_to(self, idx: int, item: Any,
                timeout: Optional[float] = None) -> None:
        self.lanes[idx].push(item, timeout)

    def push_rr(self, item: Any, timeout: Optional[float] = None) -> int:
        idx = self._rr
        self.lanes[idx].push(item, timeout)
        self._rr = (self._rr + 1) % len(self.lanes)
        return idx

    def broadcast_eos(self) -> None:
        for lane in self.lanes:
            lane.push_eos()

    def close_all(self) -> None:
        for lane in self.lanes:
            lane.close()

    def destroy(self) -> None:
        for lane in self.lanes:
            lane.destroy()


class ShmMPSCQueue:
    """Multiple producer processes, single consumer: one shm SPSC lane per
    producer, drained fairly (mirrors
    :class:`~repro_torch.core.queues.MPSCQueue`)."""

    def __init__(self, n_producers: int, capacity: int = 64,
                 slot_bytes: int = 1 << 16, arena_bytes: int = 0):
        self.lanes = [ShmSPSCQueue(capacity, slot_bytes,
                                   arena_bytes=arena_bytes)
                      for _ in range(n_producers)]
        self._next = 0

    @classmethod
    def from_lanes(cls, lanes: List[Any]) -> "ShmMPSCQueue":
        """Wrap pre-built lanes (see :meth:`ShmSPMCQueue.from_lanes`)."""
        self = cls.__new__(cls)
        self.lanes = list(lanes)
        self._next = 0
        return self

    def lane(self, idx: int) -> ShmSPSCQueue:
        return self.lanes[idx]

    def try_pop_any_seq(self) -> Tuple[bool, Any, int, int]:
        n = len(self.lanes)
        for off in range(n):
            i = (self._next + off) % n
            ok, item, seq = self.lanes[i].try_pop_seq()
            if ok:
                self._next = (i + 1) % n
                return True, item, i, seq
        return False, None, -1, 0

    def try_pop_any_many(self,
                         max_items: int = 256) -> List[Tuple[Any, int, int]]:
        """Vectored fair drain: ``(item, lane, seq)`` triples, one head
        publish per non-empty lane visited.  Per-lane FIFO order holds (a
        lane's run stays contiguous); fairness rotates the start lane."""
        n = len(self.lanes)
        out: List[Tuple[Any, int, int]] = []
        for off in range(n):
            i = (self._next + off) % n
            got = self.lanes[i].try_pop_many(max_items - len(out))
            if got:
                out.extend((item, i, seq) for item, seq in got)
                if len(out) >= max_items:
                    self._next = (i + 1) % n
                    break
        if out and len(out) < max_items:
            self._next = (self._next + 1) % n
        return out

    def try_pop_any(self) -> Tuple[bool, Any, int]:
        ok, item, i, _seq = self.try_pop_any_seq()
        return ok, item, i

    def pop_any(self, timeout: Optional[float] = None) -> Tuple[Any, int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            ok, item, i = self.try_pop_any()
            if ok:
                return item, i
            if all(lane.drained() for lane in self.lanes):
                raise QueueClosed("pop from closed and drained shm MPSC")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm MPSC pop timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def close_all(self) -> None:
        for lane in self.lanes:
            lane.close()

    def destroy(self) -> None:
        for lane in self.lanes:
            lane.destroy()


class ShmMPMCGrid:
    """Multiple producer / multiple consumer *processes*: an nL x nR grid of
    shm SPSC lanes (producer ``i`` -> consumer ``j``), the process-tier
    instance of :class:`~repro_torch.core.queues.MPMCQueue`.

    Producer ``i`` writes only row ``i`` and consumer ``j`` reads only column
    ``j``, so every lane keeps the wait-free single-writer index discipline —
    the MPMC behaviour is composition, not locking.  This is the stage
    interconnect of the process-backed ``all_to_all``: left worker processes
    attach their row (``row(i)``), right worker processes their column
    (``col(j)``); both are plain lists of picklable lanes, so a child maps
    only the segments it touches."""

    def __init__(self, n_producers: int, n_consumers: int, capacity: int = 64,
                 slot_bytes: int = 1 << 16, arena_bytes: int = 0):
        self.grid = [[ShmSPSCQueue(capacity, slot_bytes,
                                   arena_bytes=arena_bytes)
                      for _ in range(n_consumers)]
                     for _ in range(n_producers)]
        self._next = [0] * n_consumers

    @property
    def n_producers(self) -> int:
        return len(self.grid)

    @property
    def n_consumers(self) -> int:
        return len(self.grid[0]) if self.grid else 0

    def row(self, i: int) -> List[ShmSPSCQueue]:
        """Producer ``i``'s output lanes, one per consumer."""
        return self.grid[i]

    def col(self, j: int) -> List[ShmSPSCQueue]:
        """Consumer ``j``'s input lanes, one per producer."""
        return [r[j] for r in self.grid]

    def push(self, producer: int, consumer: int, item: Any,
             timeout: Optional[float] = None, seq: int = 0) -> None:
        self.grid[producer][consumer].push(item, timeout, seq=seq)

    def try_pop(self, consumer: int) -> Tuple[bool, Any, int, int]:
        """Fair non-blocking pop from ``consumer``'s column:
        ``(ok, item, producer, seq)``."""
        n = len(self.grid)
        for off in range(n):
            i = (self._next[consumer] + off) % n
            ok, item, seq = self.grid[i][consumer].try_pop_seq()
            if ok:
                self._next[consumer] = (i + 1) % n
                return True, item, i, seq
        return False, None, -1, 0

    def pop(self, consumer: int,
            timeout: Optional[float] = None) -> Tuple[Any, int, int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            ok, item, i, seq = self.try_pop(consumer)
            if ok:
                return item, i, seq
            if all(row[consumer].drained() for row in self.grid):
                raise QueueClosed("pop from closed and drained shm MPMC column")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm MPMC pop timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def max_depth(self) -> int:
        """Process-local high-water mark over every lane this side pushed."""
        return max((l.max_depth for row in self.grid for l in row), default=0)

    def close_all(self) -> None:
        for row in self.grid:
            for lane in row:
                lane.close()

    def destroy(self) -> None:
        for row in self.grid:
            for lane in row:
                lane.destroy()
