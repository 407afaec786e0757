"""L1/L2 — network lanes for the distributed tier: the shm slot protocol
over TCP, remote farms, and the loopback cluster harness.

``core/shm.py`` carries the process-backed host tier over fixed-slot
shared-memory rings; this module is the same FastFlow layer-1 structure
across the *node* boundary.  A :class:`NetLane` speaks the **same slot
protocol** as the shm rings — each frame is the shm slot header
(``<IB3xQ``: u32 payload length | u8 tag | 3B pad | u64 seq) followed by the
payload, so the raw-ndarray fast path (dtype/shape meta + buffer bytes), the
pickled-bytes fallback, and the EOS/ERR control marks ride TCP byte-for-byte
the way they ride a shared-memory slot.  Three net-only control tags ride
the same header: ``CREDIT`` (the bounded in-flight window for back-pressure
— the stream analogue of a full ring), ``HB`` (heartbeats, so a silent peer
is *detected* instead of wedging a blocking pop), and ``FN`` (the pickled
``svc`` callable a remote farm ships to its worker once at startup).

The pieces, mirroring the process tier one level up:

- :class:`NetLane` — one full-duplex framed TCP link with the lane surface
  the farm machinery and
  :class:`~repro_torch.core.skeletons.AutoscaleLB` already consume
  (``push``/``try_push``/``pop_seq``/``push_eos``/``push_err``/
  ``close``/``__len__``).  Client half via :meth:`NetLane.connect` (retry +
  exponential backoff), server half by wrapping an accepted socket.  A dead
  peer (EOF/RST mid-stream, or heartbeat silence past ``hb_timeout``)
  surfaces as :class:`~repro_torch.core.process.WorkerCrashed` on the next
  push/pop instead of blocking forever.

- :func:`worker_main` — the worker-pool entry point
  (``python -m repro_torch.launch.worker --listen host:port``): accept a
  connection, receive the pickled ``svc`` callable (tag ``FN``), then serve
  the farm worker loop — pop an item, push ``fn(item)`` with the item's seq
  echoed, ship worker-side CPU-time records
  (:class:`~repro_torch.core.shm.WorkerStats`) every few dozen items and at
  EOS.

- :class:`RemoteFarmNode` — the
  :class:`~repro_torch.core.process.ProcessFarmNode` of the distributed
  tier: one host boundary node whose workers live on remote hosts.  ``svc``
  routes items onto per-worker net lanes (failing over past dead peers); a
  collector thread drains results, restores exact input order from the
  echoed sequence numbers, folds worker CPU stats, and surfaces crashes.
  ``set_active``/``active_workers`` move the routing boundary, so
  :class:`~repro_torch.core.skeletons.AutoscaleLB` and the
  :class:`~repro_torch.core.runtime.Supervisor` drive **cluster
  autoscaling** — growing or shrinking the active remote worker set from
  observed lane depth, exactly the policy that scales thread and process
  farms.

- :func:`spawn_loopback_pool` — the test/bench harness: fork local
  ``worker_main`` pools on 127.0.0.1 ephemeral ports, so a "cluster" run
  needs nothing but this machine.

This module is the PyTorch port's copy of the reference package's
``core/net.py``.  It imports numpy, the standard library and the port's own
``node``, ``queues``, ``shm`` and ``process`` modules, never torch: a worker
pool runs numpy callables only and never touches the card, so
:func:`spawn_loopback_pool` may fork its pools from a parent that has
initialised CUDA (through ``core/process.py``'s ``_mp_context`` and
``_quiet_fork``, as the process tier does).  The frame codec is the
reference's byte for byte, so either package's :func:`decode_payload` reads
the other's frames.  One change to the code: a credit grant or heartbeat
that fails to send (the peer closed after its EOS) does not mark the lane
dead, so results still in flight are read before the reader judges the end
of the stream; the heartbeat thread keeps its silence watch, which stands
down once the peer's EOS has arrived (``NetLane._grant``,
``NetLane._hb_loop``).  And a worker ends its connection by half-closing
it and draining the parent's credits and heartbeats until the parent
closes (``NetLane.finish``): closing with them unread reset the
connection, and the reset dropped the worker's last frames, its EOS among
them, before they were sent.  A lane still carries one package only: the control
records that ride it pickled (:class:`~repro_torch.core.shm.WorkerStats`,
:class:`~repro_torch.core.shm.ShmError`, the ``FN`` handshake's callable)
name their package, and a port collector would not recognise the
reference's ``WorkerStats`` and would pass it on as a result.  Do not serve
a port farm from a reference pool, or the other way round.
"""

from __future__ import annotations

import collections
import pickle
import socket
import struct
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .node import EOS, FFNode, GO_ON
from .queues import QueueClosed
from .shm import (_SLOT_FMT, _SLOT_HDR, TAG_ARR, TAG_EOS, TAG_ERR, TAG_PKL,
                  ShmError, WorkerStats)

# net-only control tags, riding the same slot header as the shm tags
TAG_CREDIT = 4          # seq field carries the grant count; empty payload
TAG_HB = 5              # heartbeat; empty payload
TAG_FN = 6              # pickled svc callable (farm handshake)

# refuse absurd frames before allocating for them: a corrupt/hostile length
# word must fail the decode, not the allocator
MAX_FRAME_BYTES = 1 << 26       # 64 MiB

_HB_FRAME = struct.pack(_SLOT_FMT, 0, TAG_HB, 0)
_EOS_FRAME = struct.pack(_SLOT_FMT, 0, TAG_EOS, 0)

_STATS_EVERY = 32       # ship a WorkerStats record every this many items


class FrameError(RuntimeError):
    """A malformed frame on a net lane: truncated mid-frame, oversized
    length word, or corrupt ndarray meta."""


def parse_addr(addr: Any) -> Tuple[str, int]:
    """``"host:port"`` / ``(host, port)`` -> ``(host, port)``."""
    if isinstance(addr, str):
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad worker address {addr!r} "
                             "(expected host:port)")
        return host, int(port)
    host, port = addr
    return str(host), int(port)


# ---------------------------------------------------------------------------
# Frame codec: the shm slot encoding, length-prefixed onto a byte stream
# ---------------------------------------------------------------------------
def encode_frame(tag: int, obj: Any = None, seq: int = 0,
                 max_frame: int = MAX_FRAME_BYTES) -> bytes:
    """One wire frame: the shm slot header + payload, as bytes.

    Payload encodings match :meth:`~repro_torch.core.shm.ShmSPSCQueue._encode`
    exactly: ``ARR`` is ``<BB`` (ndim, dtype-string length) + dtype string +
    ``<{ndim}q`` shape + the raw contiguous buffer; ``PKL``/``ERR``/``FN``
    are pickled bytes; control tags carry no payload."""
    if tag == TAG_ARR:
        dt = obj.dtype.str.encode("ascii")
        meta = struct.pack("<BB", obj.ndim, len(dt)) + dt \
            + struct.pack(f"<{obj.ndim}q", *obj.shape)
        payload = meta + memoryview(obj).cast("B").tobytes()
    elif tag in (TAG_PKL, TAG_ERR, TAG_FN):
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    else:                           # EOS / HB / CREDIT
        payload = b""
    if len(payload) > max_frame:
        raise FrameError(f"frame payload of {len(payload)}B exceeds the "
                         f"{max_frame}B lane limit")
    return struct.pack(_SLOT_FMT, len(payload), tag, seq) + payload


def encode_item(item: Any, seq: int = 0,
                max_frame: int = MAX_FRAME_BYTES) -> bytes:
    """Encode one stream item, choosing the tag the way the shm ring's
    ``try_push`` does: plain-dtype ndarrays ride the raw-slab ``ARR`` fast
    path (made contiguous first), everything else — structured/object
    dtypes, pytrees, scalars — the ``PKL`` fallback."""
    if isinstance(item, np.ndarray) and item.dtype.names is None \
            and item.dtype.kind != "O":
        # order="C", not ascontiguousarray: the latter promotes 0-d to 1-d,
        # and the wire must round-trip shapes exactly
        return encode_frame(TAG_ARR, np.asarray(item, order="C"), seq,
                            max_frame)
    return encode_frame(TAG_PKL, item, seq, max_frame)


def decode_payload(tag: int, payload: bytes) -> Any:
    """Payload bytes -> object (the shm ``_decode``, off a byte string).
    ``EOS`` decodes back to the module-wide sentinel so identity checks keep
    working across the wire."""
    if tag in (TAG_EOS, TAG_HB, TAG_CREDIT):
        return EOS if tag == TAG_EOS else None
    if tag == TAG_ARR:
        try:
            ndim, dlen = struct.unpack_from("<BB", payload, 0)
            off = 2
            dtype = np.dtype(payload[off:off + dlen].decode("ascii"))
            off += dlen
            shape = struct.unpack_from(f"<{ndim}q", payload, off)
            off += 8 * ndim
            nbytes = int(dtype.itemsize
                         * int(np.prod(shape, dtype=np.int64))) \
                if ndim else dtype.itemsize
            if off + nbytes != len(payload):
                raise FrameError(
                    f"corrupt ndarray frame: meta claims {nbytes}B of data, "
                    f"payload carries {len(payload) - off}B")
            return np.frombuffer(payload[off:off + nbytes],
                                 dtype=dtype).reshape(shape)
        except (struct.error, ValueError, UnicodeDecodeError) as e:
            raise FrameError(f"corrupt ndarray frame meta: {e}") from e
    return pickle.loads(payload)


def _recv_exact(sock: socket.socket, n: int,
                allow_eof: bool = False) -> Optional[bytes]:
    """Read exactly ``n`` bytes, riding out partial reads.  EOF at offset 0
    returns None when ``allow_eof`` (a clean close between frames); EOF
    mid-read always raises :class:`FrameError` (a truncated frame)."""
    chunks: List[bytes] = []
    got = 0
    while got < n:
        try:
            b = sock.recv(n - got)
        except OSError as e:
            raise FrameError(f"lane read failed: {e}") from e
        if not b:
            if got == 0 and allow_eof:
                return None
            raise FrameError(f"truncated frame: connection closed after "
                             f"{got} of {n} bytes")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def read_frame(sock: socket.socket,
               max_frame: int = MAX_FRAME_BYTES
               ) -> Optional[Tuple[int, bytes, int]]:
    """Read one frame: ``(tag, payload bytes, seq)``, or None on a clean
    EOF at a frame boundary.  Raises :class:`FrameError` on a truncated
    frame or an oversized length word (rejected before any allocation)."""
    hdr = _recv_exact(sock, _SLOT_HDR, allow_eof=True)
    if hdr is None:
        return None
    length, tag, seq = struct.unpack(_SLOT_FMT, hdr)
    if length > max_frame:
        raise FrameError(f"oversized frame: length word {length}B exceeds "
                         f"the {max_frame}B lane limit")
    payload = _recv_exact(sock, length) if length else b""
    return tag, payload, seq


def _worker_crashed(msg: str):
    from .process import WorkerCrashed
    return WorkerCrashed(msg)


# ---------------------------------------------------------------------------
# NetLane: one framed TCP link with the shm-lane surface
# ---------------------------------------------------------------------------
class _Handshake:
    """A received ``FN`` frame: the svc callable a remote farm shipped."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable):
        self.fn = fn


class NetLane:
    """A full-duplex framed TCP lane speaking the shm slot protocol.

    Same surface as :class:`~repro_torch.core.shm.ShmSPSCQueue` (``push`` /
    ``try_push`` / ``pop_seq`` / ``push_eos`` / ``push_err`` / ``close`` /
    ``__len__``), crossing a host boundary.  Two extra disciplines the
    shared-memory ring gets for free from its fixed slots and liveness
    polling:

    - **credit window**: a data push consumes one credit from a bounded
      window (``credit=``); the receiver returns one credit per item its
      application actually pops.  In-flight items are therefore bounded —
      the stream back-pressures exactly like a full ring — and the lane's
      ``len()`` (outstanding + locally queued) is the depth signal
      ``AutoscaleLB`` scales on.  Control frames (EOS/ERR/HB/CREDIT/FN)
      never consume credit, so termination and errors cannot wedge behind
      back-pressure.
    - **heartbeat**: each side sends ``HB`` every ``hb_interval`` and marks
      the peer dead after ``hb_timeout`` without *any* traffic (EOF/RST
      marks it immediately).  A dead peer surfaces as
      :class:`~repro_torch.core.process.WorkerCrashed` on the next push, or
      on a pop that would otherwise wait forever — never a silent wedge.
    """

    def __init__(self, sock: socket.socket, *, credit: int = 32,
                 hb_interval: float = 0.5,
                 hb_timeout: Optional[float] = None,
                 max_frame: int = MAX_FRAME_BYTES, label: str = "netlane"):
        if credit < 1:
            raise ValueError("credit window must be >= 1")
        self._sock = sock
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:             # not TCP (e.g. a unix socketpair in tests)
            pass
        self._window = credit
        self._credits = credit
        self._credit_cv = threading.Condition()
        self._hb_interval = hb_interval
        self._hb_timeout = hb_timeout if hb_timeout is not None \
            else 6.0 * hb_interval
        self._max_frame = max_frame
        self._label = label
        self._send_lock = threading.Lock()
        self._rq: collections.deque = collections.deque()
        self._dead: Optional[str] = None
        self._closed = False
        self._saw_eos = False
        self._shutdown = False
        self._last_recv = time.monotonic()
        self.max_depth = 0
        self._stop = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"{label}-reader")
        self._hb = threading.Thread(target=self._hb_loop, daemon=True,
                                    name=f"{label}-hb")
        self._reader.start()
        self._hb.start()

    # -- construction --------------------------------------------------------
    @classmethod
    def connect(cls, host: str, port: int, *, timeout: float = 15.0,
                backoff: float = 0.05, max_backoff: float = 1.0,
                **kw) -> "NetLane":
        """Client half: dial ``host:port``, retrying with exponential
        backoff until ``timeout`` (workers and parents race to start — a
        refused connect means the listener is not up *yet*)."""
        deadline = time.monotonic() + timeout
        delay = backoff
        while True:
            try:
                sock = socket.create_connection((host, port), timeout=5.0)
                sock.settimeout(None)
                return cls(sock, label=f"netlane[{host}:{port}]", **kw)
            except OSError as e:
                if time.monotonic() + delay > deadline:
                    raise _worker_crashed(
                        f"cannot connect to worker {host}:{port} within "
                        f"{timeout:.0f}s: {e}") from e
                time.sleep(delay)
                delay = min(delay * 2.0, max_backoff)

    # -- peer liveness -------------------------------------------------------
    @property
    def peer_dead(self) -> Optional[str]:
        """The reason the peer is considered gone, or None while healthy."""
        return self._dead

    @property
    def saw_eos(self) -> bool:
        return self._saw_eos

    def _mark_dead(self, reason: str) -> None:
        if self._dead is None and not self._shutdown:
            self._dead = f"{self._label}: {reason}"
        with self._credit_cv:       # wake pushers blocked on the window
            self._credit_cv.notify_all()

    # -- background threads --------------------------------------------------
    def _read_loop(self) -> None:
        try:
            while True:
                fr = read_frame(self._sock, self._max_frame)
                if fr is None:
                    if not self._saw_eos:
                        self._mark_dead("peer closed the connection "
                                        "mid-stream")
                    return
                tag, payload, seq = fr
                self._last_recv = time.monotonic()
                if tag == TAG_HB:
                    continue
                if tag == TAG_CREDIT:
                    with self._credit_cv:
                        self._credits += int(seq) or 1
                        self._credit_cv.notify_all()
                    continue
                if tag == TAG_EOS:
                    self._saw_eos = True
                    self._rq.append((EOS, seq))
                    continue
                if tag == TAG_FN:
                    self._rq.append((_Handshake(pickle.loads(payload)), seq))
                    continue
                self._rq.append((decode_payload(tag, payload), seq))
        except FrameError as e:
            self._mark_dead(str(e))
        except Exception as e:      # noqa: BLE001 - reader must never wedge
            self._mark_dead(f"lane reader failed: {e!r}")

    def _hb_loop(self) -> None:
        sending = True
        while not self._stop.wait(self._hb_interval):
            if self._dead is not None or self._shutdown:
                return
            if sending:
                try:
                    with self._send_lock:
                        self._sock.sendall(_HB_FRAME)
                except OSError:
                    # the peer closed its end (after its EOS, or dying):
                    # stop sending; the reader judges the close once it has
                    # drained what is in flight, as for a failed credit
                    # grant, and the silence watch below stays on
                    sending = False
            # silence after the peer's EOS is the end of its stream
            if not self._saw_eos and \
                    time.monotonic() - self._last_recv > self._hb_timeout:
                self._mark_dead(
                    f"heartbeat timeout ({self._hb_timeout:.1f}s without "
                    "traffic from the peer)")
                return

    # -- send primitives -----------------------------------------------------
    def _send_raw(self, buf: bytes) -> None:
        try:
            with self._send_lock:
                self._sock.sendall(buf)
        except OSError as e:
            self._mark_dead(f"send failed: {e}")
            raise _worker_crashed(self._dead) from e

    def try_push(self, item: Any, seq: int = 0) -> bool:
        """Non-blocking data push: False when the credit window is
        exhausted (back-pressure), :class:`WorkerCrashed` when the peer is
        dead — a full window on a dead peer never drains."""
        if self._dead is not None:
            raise _worker_crashed(self._dead)
        with self._credit_cv:
            if self._credits <= 0:
                return False
            self._credits -= 1
            depth = self._window - self._credits
            if depth > self.max_depth:
                self.max_depth = depth
        try:
            self._send_raw(encode_item(item, seq, self._max_frame))
        except BaseException:
            with self._credit_cv:   # un-spend the credit of a failed send
                self._credits += 1
            raise
        return True

    def push(self, item: Any, timeout: Optional[float] = None,
             seq: int = 0) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            if self._closed:
                raise QueueClosed("push to closed net lane")
            if self.try_push(item, seq):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{self._label}: push timed out waiting "
                                   "for credit")
            with self._credit_cv:
                if self._credits <= 0 and self._dead is None:
                    self._credit_cv.wait(delay)
            delay = min(delay * 2, 1e-3)

    def push_eos(self, timeout: Optional[float] = None) -> None:
        if self._closed:
            raise QueueClosed("push_eos to closed net lane")
        self._send_raw(_EOS_FRAME)

    def push_err(self, err: ShmError, timeout: Optional[float] = None) -> None:
        if self._closed:
            raise QueueClosed("push_err to closed net lane")
        self._send_raw(encode_frame(TAG_ERR, err, 0, self._max_frame))

    def push_fn(self, fn: Callable) -> None:
        """Ship the farm worker's ``svc`` callable (the ``FN`` handshake)."""
        self._send_raw(encode_frame(TAG_FN, fn, 0, self._max_frame))

    # -- receive primitives --------------------------------------------------
    def _grant(self) -> None:
        # one credit back per item the application consumed; best-effort —
        # a dead peer has no use for credits.  A failed grant does not mark
        # the peer dead: a worker closes its socket right after its EOS, and
        # a grant for an item popped before the reader has drained the
        # frames still in flight would otherwise surface as a crash.  The
        # reader is the judge: EOF without EOS, or heartbeat silence.
        try:
            with self._send_lock:
                self._sock.sendall(struct.pack(_SLOT_FMT, 0, TAG_CREDIT, 1))
        except OSError:             # peer gone
            pass

    def try_pop_seq(self) -> Tuple[bool, Any, int]:
        if not self._rq:
            return False, None, 0
        item, seq = self._rq.popleft()
        if item is not EOS and not isinstance(item, (ShmError, _Handshake)):
            self._grant()
        return True, item, seq

    def pop_seq(self, timeout: Optional[float] = None) -> Tuple[Any, int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 1e-6
        while True:
            ok, item, seq = self.try_pop_seq()
            if ok:
                return item, seq
            if self._dead is not None:
                raise _worker_crashed(self._dead)
            if self._closed:
                raise QueueClosed("pop from closed empty net lane")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{self._label}: pop timed out")
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def pop(self, timeout: Optional[float] = None) -> Any:
        return self.pop_seq(timeout)[0]

    # -- lane surface shared with the shm/thread tiers -----------------------
    def __len__(self) -> int:
        """Depth signal: data in flight toward the peer (sent, not yet
        consumed there) plus data locally received and not yet popped."""
        outstanding = max(0, self._window - self._credits)
        return outstanding + len(self._rq)

    def empty(self) -> bool:
        return len(self) == 0

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Local close: further pushes raise ``QueueClosed`` (the unwind
        discipline of the shm rings).  The socket stays up so in-flight
        results still drain; :meth:`shutdown` tears it down."""
        self._closed = True

    def drained(self) -> bool:
        return self._closed and self.empty()

    def finish(self, timeout: Optional[float] = None) -> None:
        """End this side after its last frame: half-close the socket (the
        peer reads every frame sent, then EOF), let the reader drain what
        the peer still sends (credits, heartbeats) until the peer closes
        its side or ``timeout`` (default the heartbeat timeout) passes,
        then tear the link down.  Closing with unread input at once would
        reset the connection, and the reset drops the frames still queued
        to send: the peer would lose this side's last results and its
        EOS."""
        self._stop.set()            # no heartbeat after the half-close
        try:
            with self._send_lock:
                self._sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        if self._reader is not threading.current_thread():
            self._reader.join(self._hb_timeout if timeout is None
                              else timeout)
        self.shutdown()

    def shutdown(self) -> None:
        """Tear the link down: close the socket and stop the lane threads."""
        self._shutdown = True
        self._closed = True
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        for t in (self._reader, self._hb):
            if t is not threading.current_thread():
                t.join(timeout=2.0)


# ---------------------------------------------------------------------------
# Worker side: the pool entry point (python -m repro_torch.launch.worker)
# ---------------------------------------------------------------------------
def _serve_conn(sock: socket.socket, idx: int, *, credit: int,
                hb_interval: float, hb_timeout: Optional[float],
                max_frame: int) -> None:
    """Serve one farm-parent connection: receive the ``FN`` handshake, then
    loop pop item -> push ``fn(item)`` with the item's seq echoed.  Ships a
    :class:`~repro_torch.core.shm.WorkerStats` CPU-time record every
    ``_STATS_EVERY`` items and at EOS; an exception in ``fn`` ships an
    error record; the parent dying just ends the loop."""
    lane = NetLane(sock, credit=credit, hb_interval=hb_interval,
                   hb_timeout=hb_timeout, max_frame=max_frame,
                   label=f"worker{idx}")
    fn: Optional[Callable] = None
    cpu_ema = 0.0
    done = 0
    try:
        while True:
            try:
                item, seq = lane.pop_seq()
            except Exception:       # noqa: BLE001 - parent gone/closed lane
                return
            if item is EOS:
                return
            if isinstance(item, _Handshake):
                fn = item.fn
                continue
            if fn is None:
                lane.push_err(ShmError(
                    idx, "ProtocolError('item before FN handshake')", ""))
                return
            try:
                c0 = time.thread_time()
                out = fn(item)
                c = time.thread_time() - c0
            except BaseException as e:  # noqa: BLE001 - shipped to the parent
                try:
                    lane.push_err(ShmError(idx, repr(e),
                                           traceback.format_exc()))
                except BaseException:   # noqa: BLE001 - parent may be gone
                    pass
                return
            done += 1
            cpu_ema = c if cpu_ema == 0.0 else 0.9 * cpu_ema + 0.1 * c
            try:
                lane.push(out, seq=seq)
                if done % _STATS_EVERY == 0:
                    lane.push(WorkerStats(idx, done, cpu_ema), seq=0)
            except BaseException:       # noqa: BLE001 - parent gone
                return
    finally:
        try:
            if done:
                lane.push(WorkerStats(idx, done, cpu_ema), seq=0)
            lane.push_eos()
        except BaseException:           # noqa: BLE001 - parent may be gone
            pass
        lane.finish()


def worker_main(host: str = "127.0.0.1", port: int = 0, *, slots: int = 4,
                credit: int = 32, hb_interval: float = 0.5,
                hb_timeout: Optional[float] = None,
                max_frame: int = MAX_FRAME_BYTES,
                max_conns: Optional[int] = None,
                announce: Optional[Callable[[str, int], None]] = None,
                quiet: bool = False) -> None:
    """Serve a farm worker pool on ``host:port`` until killed.

    Each accepted connection is one farm lane, served on its own thread (up
    to ``slots`` concurrently); the first data frame must be the ``FN``
    handshake carrying the pickled ``svc`` callable.  ``port=0`` binds an
    ephemeral port — ``announce(host, actual_port)`` reports it (the
    loopback pool harness listens on a queue; the CLI prints it)."""
    ls = socket.create_server((host, port), backlog=max(slots, 4))
    actual = ls.getsockname()[1]
    if announce is not None:
        announce(host, actual)
    if not quiet:
        print(f"repro_torch worker: listening on {host}:{actual} "
              f"(slots={slots})", flush=True)
    gate = threading.BoundedSemaphore(max(1, slots))
    served = 0
    try:
        while max_conns is None or served < max_conns:
            conn, _peer = ls.accept()
            gate.acquire()
            idx = served
            served += 1

            def _run(c=conn, i=idx):
                try:
                    _serve_conn(c, i, credit=credit,
                                hb_interval=hb_interval,
                                hb_timeout=hb_timeout, max_frame=max_frame)
                finally:
                    gate.release()

            threading.Thread(target=_run, daemon=True,
                             name=f"ff-net-worker-{idx}").start()
    finally:
        ls.close()


def _pool_entry(q, host: str, kw: dict) -> None:
    import os

    def announce(h: str, p: int) -> None:
        q.put((h, p, os.getpid()))

    worker_main(host, 0, announce=announce, quiet=True, **kw)


def spawn_loopback_pool(n: int, *, host: str = "127.0.0.1",
                        start_timeout: float = 15.0,
                        **kw) -> Tuple[List[Tuple[str, int]], List[Any]]:
    """The loopback-cluster harness: fork ``n`` local :func:`worker_main`
    pools on ephemeral 127.0.0.1 ports.  Returns ``(addrs, procs)`` with
    ``addrs[i]`` served by ``procs[i]`` (so a test can kill a *specific*
    worker); the caller owns the processes and must ``terminate()`` them."""
    from .process import _mp_context, _quiet_fork
    ctx = _mp_context()
    q = ctx.Queue()
    procs = [ctx.Process(target=_pool_entry, args=(q, host, kw),
                         daemon=True, name=f"ff-net-pool-{i}")
             for i in range(n)]
    with _quiet_fork():
        for p in procs:
            p.start()
    by_pid: Dict[int, Tuple[str, int]] = {}
    deadline = time.monotonic() + start_timeout
    while len(by_pid) < n:
        try:
            h, prt, pid = q.get(timeout=max(0.1, deadline - time.monotonic()))
        except Exception as e:      # noqa: BLE001 - queue.Empty
            for p in procs:
                p.terminate()
            raise _worker_crashed(
                f"loopback pool: only {len(by_pid)} of {n} workers came up "
                f"within {start_timeout:.0f}s") from e
        by_pid[pid] = (h, prt)
    addrs = [by_pid[p.pid] for p in procs]
    return addrs, procs


# ---------------------------------------------------------------------------
# Parent side: the remote farm boundary node
# ---------------------------------------------------------------------------
class _LaneBundle:
    """The ``lanes``-list surface :class:`AutoscaleLB` attaches to."""

    def __init__(self, lanes: List[NetLane]):
        self.lanes = lanes


class RemoteFarmNode(FFNode):
    """A farm stage whose workers live on remote hosts, embedded as one
    host node — the :class:`~repro_torch.core.process.ProcessFarmNode` of the
    distributed tier.

    ``fns`` is one picklable per-item callable per worker; ``addrs`` the
    matching ``(host, port)`` worker-pool addresses (connected with retry +
    backoff at build time; each lane then ships its callable once, tag
    ``FN``).  ``pre``/``post`` run in the parent around the network hop.
    Results carry the item's sequence number back, so output order is
    exactly *input* order through a reorder buffer — past any credit-window
    depth — matching the process and device lowerings.

    Crash surfacing: a worker exception ships an error record; a killed
    worker is an EOF/RST (or heartbeat silence) on its lane — either way the
    farm sets :class:`~repro_torch.core.process.WorkerCrashed`, refuses new
    input, and unwinds instead of wedging.  ``set_active``/
    ``active_workers`` move the round-robin routing boundary across the
    connected pool, so
    ``autoscale=True`` (an :class:`AutoscaleLB` over the net lanes) and the
    runtime :class:`~repro_torch.core.runtime.Supervisor` (through the node's
    resizable stage handle) both drive cluster autoscaling from observed
    lane depth — growing never dials a new connection, it starts routing to
    an idle one."""

    def __init__(self, fns: Sequence[Callable],
                 addrs: Sequence[Any], pre: Optional[Callable] = None,
                 post: Optional[Callable] = None, credit: int = 32,
                 label: str = "remote_farm", autoscale: bool = False,
                 min_workers: int = 1, connect_timeout: float = 15.0,
                 hb_interval: float = 0.5, hb_timeout: Optional[float] = None,
                 max_frame: int = MAX_FRAME_BYTES):
        super().__init__()
        if not fns:
            raise ValueError("remote farm with no workers")
        if len(addrs) < len(fns):
            raise ValueError(f"remote farm needs one worker address per "
                             f"callable ({len(fns)} fns, {len(addrs)} addrs)")
        self._fns = list(fns)
        self._pre = pre
        self._post = post
        self._label = label
        self._n = len(self._fns)
        self._addrs = [parse_addr(a) for a in addrs[:self._n]]
        self._lanes: List[NetLane] = []
        try:
            for host, port in self._addrs:
                self._lanes.append(NetLane.connect(
                    host, port, timeout=connect_timeout, credit=credit,
                    hb_interval=hb_interval, hb_timeout=hb_timeout,
                    max_frame=max_frame))
            for lane, fn in zip(self._lanes, self._fns):
                lane.push_fn(fn)
        except BaseException:
            for lane in self._lanes:
                lane.shutdown()
            raise
        self._lb = None
        if autoscale:
            from .skeletons import AutoscaleLB
            self._lb = AutoscaleLB(min_workers=min_workers,
                                   max_workers=self._n)
            self._lb._attach(_LaneBundle(self._lanes))
        self._seq = 0
        self._delivered = 0
        self._routed = [0] * self._n
        self._active = self._n
        self._hop_ema = 0.0         # parent-side per-item lane push cost
        self._gap_ema = 0.0
        self._last_delivery: Optional[float] = None
        self._worker_cpu: Dict[int, Tuple[int, float]] = {}
        self._eos_seen = [False] * self._n
        self._collector: Optional[threading.Thread] = None
        self._destroyed = False

    @property
    def width(self) -> int:
        return self._n

    @property
    def active_workers(self) -> int:
        return self._lb.cur if self._lb is not None else self._active

    def set_active(self, k: int) -> None:
        """Move the routing boundary: new items go to workers [0, k).  The
        full pool connected at build time; an inactive remote worker just
        idles on its lane, so growing the active set never dials — it
        resumes routing.  This is the cluster-autoscaling mechanism the
        AutoscaleLB and the runtime Supervisor drive."""
        k = max(1, min(int(k), self._n))
        if self._lb is not None:
            self._lb.cur = min(max(k, self._lb.min_workers),
                               self._lb.max_workers or self._n)
        self._active = k

    def make_handle(self, desc: Optional[str] = None) -> "RemoteStageHandle":
        return RemoteStageHandle(desc or self._label, self)

    # -- parent-side emitter -------------------------------------------------
    def _push_alive(self, idx: int, item: Any, seq: int) -> bool:
        """Blocking push to worker ``idx`` that fails over instead of
        wedging when the peer has died (or the collector flagged the farm
        as failed)."""
        from .process import WorkerCrashed
        lane = self._lanes[idx]
        delay = 1e-6
        self._push_waited = False
        while True:
            if self.error is not None:
                return False
            try:
                if lane.try_push(item, seq):
                    return True
            except WorkerCrashed:   # dead peer: fail over to the next worker
                return False
            # anything else (unpicklable item, oversized frame) is the
            # item's fault, not the worker's — surface it like the shm
            # tier does instead of misreporting a cluster death
            self._push_waited = True
            time.sleep(delay)
            delay = min(delay * 2, 1e-3)

    def svc(self, item: Any) -> Any:
        if self.error is not None:      # collector flagged a failed farm
            raise self.error
        if self._pre is not None:
            item = self._pre(item)
        with self._stats_lock:
            seq = self._seq
            self._seq += 1
        start = self._lb.selectworker(item) if self._lb is not None \
            else seq % max(1, min(self._active, self._n))
        t0 = time.perf_counter()
        for off in range(self._n):
            idx = (start + off) % self._n
            if self._push_alive(idx, item, seq):
                hop = time.perf_counter() - t0
                with self._stats_lock:
                    self._routed[idx] += 1
                    if not self._push_waited:
                        self._hop_ema = hop if self._hop_ema == 0.0 \
                            else 0.9 * self._hop_ema + 0.1 * hop
                return GO_ON
        if self.error is None:
            self.error = _worker_crashed(
                f"{self._label}: all {self._n} remote workers are gone")
        raise self.error

    # -- parent-side collector ----------------------------------------------
    def _collect(self) -> None:
        hold: Dict[int, Any] = {}       # out-of-order results by sequence
        nxt = 0
        scan = 0
        delay = 1e-6
        last_liveness = time.monotonic()
        while not all(self._eos_seen):
            got = None
            for off in range(self._n):
                i = (scan + off) % self._n
                if self._eos_seen[i]:
                    continue
                ok, item, seq = self._lanes[i].try_pop_seq()
                if ok:
                    scan = (i + 1) % self._n
                    got = (item, seq, i)
                    break
            if got is None:
                now = time.monotonic()
                if now - last_liveness > 0.05:
                    last_liveness = now
                    if self._check_crashed():
                        self._fail()
                        return
                time.sleep(delay)
                delay = min(delay * 2, 1e-3)
                continue
            delay = 1e-6
            item, seq, lane = got
            if item is EOS:
                self._eos_seen[lane] = True
                continue
            if isinstance(item, ShmError):
                self.error = _worker_crashed(
                    f"{self._label}: worker {lane} ({self._addrs[lane][0]}:"
                    f"{self._addrs[lane][1]}) raised {item.exc}\n{item.tb}")
                self._fail()
                return
            if isinstance(item, WorkerStats):
                with self._stats_lock:
                    self._worker_cpu[lane] = (item.items, item.cpu_ema_s)
                continue
            hold[seq] = item
            while nxt in hold:
                out = hold.pop(nxt)
                nxt += 1
                if self._post is not None:
                    out = self._post(out)
                now = time.perf_counter()
                with self._stats_lock:
                    if self._last_delivery is not None:
                        gap = now - self._last_delivery
                        self._gap_ema = gap if self._gap_ema == 0.0 \
                            else 0.8 * self._gap_ema + 0.2 * gap
                    self._last_delivery = now
                    self._delivered += 1
                self.ff_send_out(out)
        # completeness invariant (mirrors ProcessA2ANode): a clean end of
        # stream must have delivered every accepted item — a gap means a
        # worker vanished with items in flight and its death evaded the
        # liveness scan; surface it, never return a truncated stream
        if self.error is None and self._delivered < self._seq:
            self.error = _worker_crashed(
                f"{self._label}: stream truncated — only {self._delivered} "
                f"of {self._seq} items delivered")

    def _check_crashed(self) -> bool:
        for i, lane in enumerate(self._lanes):
            if not self._eos_seen[i] and lane.peer_dead is not None \
                    and not lane._rq:
                self.error = _worker_crashed(
                    f"{self._label}: worker {i} "
                    f"({self._addrs[i][0]}:{self._addrs[i][1]}) died before "
                    f"end of stream — {lane.peer_dead}")
                return True
        return False

    def _fail(self) -> None:
        """Unwind a failed farm without wedging: refuse new input (``svc``
        raises once ``self.error`` is set), tell surviving workers to stop
        (EOS is credit-free, so it cannot block behind back-pressure), and
        drain their EOS acknowledgements briefly so sockets close clean."""
        for i, lane in enumerate(self._lanes):
            if lane.peer_dead is None and not self._eos_seen[i]:
                try:
                    lane.push_eos()
                except BaseException:   # noqa: BLE001 - racing a dying peer
                    pass
        deadline = time.monotonic() + 5.0
        while not all(self._eos_seen) and time.monotonic() < deadline:
            moved = False
            for i, lane in enumerate(self._lanes):
                if self._eos_seen[i]:
                    continue
                if lane.peer_dead is not None and not lane._rq:
                    self._eos_seen[i] = True
                    continue
                ok, item, _seq = lane.try_pop_seq()
                if ok:
                    moved = True
                    if item is EOS:
                        self._eos_seen[i] = True
            if not moved:
                time.sleep(1e-4)

    # -- lifecycle -----------------------------------------------------------
    def svc_init(self) -> int:
        self._collector = threading.Thread(target=self._collect, daemon=True,
                                           name=f"{self._label}-collector")
        self._collector.start()
        return 0

    def svc_end(self) -> None:
        if self._destroyed:
            return
        try:
            for i, lane in enumerate(self._lanes):
                if lane.peer_dead is None:
                    try:
                        lane.push_eos()
                    except BaseException:   # noqa: BLE001 - racing a crash
                        pass
            if self._collector is not None:
                self._collector.join(timeout=30.0)
        finally:
            self._destroy()

    def _destroy(self) -> None:
        if not self._destroyed:
            self._destroyed = True
            for lane in self._lanes:
                lane.shutdown()

    def __del__(self):
        # a compiled-but-never-run or abandoned node must still release its
        # sockets and lane threads (same contract as ProcessFarmNode)
        try:
            if not self._destroyed:
                self._destroy()
        except Exception:   # noqa: BLE001 - interpreter teardown
            pass

    # -- stats ---------------------------------------------------------------
    def node_stats(self) -> dict:
        from .perf_model import fn_key
        depths = [0] * self._n if self._destroyed \
            else [len(l) for l in self._lanes]
        with self._stats_lock:
            cpu_recs = list(self._worker_cpu.values())
            total = sum(i for i, _ in cpu_recs)
            svc_cpu = (sum(i * c for i, c in cpu_recs) / total
                       if total else 0.0)
            s = {
                "node": self._label,
                "backend": "remote",
                "tier": "host_remote",
                "workers": self._n,
                "active": self.active_workers,
                "items": self._seq,
                "delivered": self._delivered,
                "routed_per_worker": list(self._routed),
                "svc_time_ema_s": self.svc_time_ema,
                "svc_cpu_ema_s": svc_cpu,
                "hop_ema_s": self._hop_ema,
                "delivery_gap_ema_s": self._gap_ema,
                "lane_depths": depths,
                "max_lane_depth": max(
                    (l.max_depth for l in self._lanes), default=0),
                "fn_key": fn_key(self._fns[0]),
            }
        if self._lb is not None:
            s["autoscale"] = {"active": self._lb.cur,
                              "grown": self._lb.grown,
                              "shrunk": self._lb.shrunk}
        return s


class RemoteStageHandle:
    """Resizable stage handle over a :class:`RemoteFarmNode`: the runtime
    Supervisor's width policy moves the active remote worker set (cluster
    autoscaling); tier migration does not apply across the wire."""

    reconfigurable = True

    def __init__(self, desc: str, node: RemoteFarmNode):
        self.desc = desc
        self.node = node

    @property
    def tier(self) -> str:
        return "host_remote"

    @property
    def max_width(self) -> int:
        return self.node.width

    def stats(self) -> dict:
        return self.node.node_stats()

    def can_migrate(self, target: str) -> bool:
        return False

    def resize(self, width: int) -> bool:
        self.node.set_active(width)
        return True

    def migrate(self, target: str) -> bool:
        from .graph import GraphError
        raise GraphError(f"stage {self.desc!r} runs on remote hosts; "
                         "tier migration does not apply")
