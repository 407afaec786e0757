"""L3 building block — the ``ff_node`` sequential-concurrent-activity
abstraction (FastFlow Secs. 4-6).

A node wraps business-logic into ``svc`` (called once per input stream item),
with ``svc_init``/``svc_end`` lifecycle hooks.  Returning:

- an object  -> delivered onto the node's output stream;
- ``GO_ON``  -> no output, keep the node alive;
- ``EOS``    -> terminate this node; end-of-stream propagates downstream
                (FastFlow returns NULL; we use an explicit sentinel).

``ff_send_out`` delivers extra items mid-``svc`` (Sec. 5).  Each node runs on
its own thread; streams are the SPSC queues of core/queues.py.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable, Optional

from .queues import SPSCQueue


class _Sentinel:
    def __init__(self, name: str):
        self._name = name

    def __repr__(self):
        return self._name


GO_ON = _Sentinel("GO_ON")
EOS = _Sentinel("EOS")            # FastFlow: returning NULL / FF_EOS mark
_NO_INPUT = _Sentinel("NO_INPUT")  # activation token for source nodes

# service-time EMA warm-up: the EMA seeds from the *median* of this many
# initial samples instead of the first one alone — a slow first call (jit
# trace, cold cache, page faults) would otherwise poison the estimate for
# ~20 items, and the adaptive supervisor acts on these estimates
_SVC_WARMUP_N = 5
_SVC_EMA_ALPHA = 0.2


def spawn_drainer(pop: Callable[[], Any], n_eos: int = 1) -> None:
    """A node that exits before consuming its input's end-of-stream — by
    error or by voluntarily returning EOS/None — must never wedge upstream
    producers on its full queue.  Hand the stream to a detached daemon
    drainer (discarding items until ``n_eos`` EOS marks arrive) so the
    node's own thread stays joinable even when the terminating EOS never
    arrives.  ``pop`` abstracts the channel: an SPSC pop, an MPSC pop_any,
    or an MPMC column pop."""
    def drain() -> None:
        try:
            n = n_eos
            while n > 0:
                if pop() is EOS:
                    n -= 1
        except BaseException:   # noqa: BLE001 - queue closed etc.
            pass
    threading.Thread(target=drain, daemon=True, name="ff-drain").start()


def _drain_until_eos(in_q: "SPSCQueue") -> None:
    spawn_drainer(in_q.pop)


class FFNode:
    """Subclass and override ``svc`` (mandatory), ``svc_init``/``svc_end``
    (optional), exactly as in the paper."""

    def __init__(self):
        self._out: Optional[Callable[[Any], None]] = None
        self._id: int = -1
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.svc_calls: int = 0   # for stats (ffStats analogue)
        self.svc_time_ema: float = 0.0   # EMA of svc() service time, seconds
        # counters above are mutated by the node's worker thread and read by
        # stats()/the adaptive supervisor mid-stream: updates and snapshots
        # both go through this lock so readers see a consistent pair
        self._stats_lock = threading.Lock()
        self._svc_warmup: list = []
        # When this node has an input stream but must generate initial tasks
        # itself (divide&conquer emitters on a feedback loop), set
        # ``prime = True``: svc(None) is called once before consuming input.
        self.prime: bool = False

    # -- user API ------------------------------------------------------------
    def svc(self, task: Any) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    def svc_init(self) -> int:
        return 0

    def svc_end(self) -> None:
        pass

    def get_my_id(self) -> int:
        """Paper Sec. 14 run-time routine."""
        return self._id

    def ff_send_out(self, task: Any) -> None:
        if self._out is None:
            raise RuntimeError("ff_send_out outside a running streaming network")
        self._out(task)

    # -- runtime -------------------------------------------------------------
    def _bind(self, out_fn: Callable[[Any], None], node_id: int) -> None:
        self._out = out_fn
        self._id = node_id

    def _run_loop(self, in_q: Optional[SPSCQueue]) -> None:
        """Thread body: pull from input stream (if any), call svc, route
        output.  End-of-stream handling follows the paper: EOS on the input
        stream terminates the node (svc not called) and propagates."""
        input_eos = in_q is None      # source nodes have no stream to drain
        try:
            if self.svc_init() < 0:
                raise RuntimeError(f"svc_init failed in {type(self).__name__}")
            primed = (in_q is None) or not self.prime
            while True:
                if in_q is None:
                    task = _NO_INPUT
                elif not primed:
                    task, primed = _NO_INPUT, True
                else:
                    task = in_q.pop()
                    if task is EOS:
                        input_eos = True
                        break
                with self._stats_lock:
                    self.svc_calls += 1
                t0 = time.perf_counter()
                result = self.svc(None if task is _NO_INPUT else task)
                self._record_svc_time(time.perf_counter() - t0)
                if result is None:   # paper: returning NULL terminates the node
                    result = EOS
                if result is EOS:
                    break
                if result is not GO_ON:
                    self._out(result)
        except BaseException as e:  # noqa: BLE001 - surfaced to the runner
            self.error = e
            traceback.print_exc()
        finally:
            try:
                self.svc_end()
            finally:
                if self._out is not None:
                    self._out(EOS)
                if not input_eos:
                    _drain_until_eos(in_q)

    def _start(self, in_q: Optional[SPSCQueue]) -> None:
        self.thread = threading.Thread(
            target=self._run_loop, args=(in_q,), daemon=True,
            name=f"ffnode-{type(self).__name__}-{self._id}")
        self.thread.start()

    def _join(self, timeout: Optional[float] = None) -> None:
        if self.thread is not None:
            self.thread.join(timeout)

    def _alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def _record_svc_time(self, dt: float) -> None:
        """Fold one measured ``svc`` duration into ``svc_time_ema``.  The
        first ``_SVC_WARMUP_N`` samples seed the EMA with their running
        median, so one slow warm-up call cannot poison the estimate."""
        with self._stats_lock:
            if len(self._svc_warmup) < _SVC_WARMUP_N:
                self._svc_warmup.append(dt)
                self.svc_time_ema = \
                    sorted(self._svc_warmup)[len(self._svc_warmup) // 2]
            else:
                self.svc_time_ema = ((1.0 - _SVC_EMA_ALPHA) * self.svc_time_ema
                                     + _SVC_EMA_ALPHA * dt)

    def node_stats(self) -> dict:
        """Per-node runtime stats for ``runner.stats()``: items processed and
        the service-time EMA (seconds).  Snapshot under the stats lock so a
        mid-stream reader never sees a torn calls/EMA pair."""
        with self._stats_lock:
            return {"node": type(self).__name__, "items": self.svc_calls,
                    "svc_time_ema_s": self.svc_time_ema}


class FnNode(FFNode):
    """Convenience: lift a plain callable into an ff_node."""

    def __init__(self, fn: Callable[[Any], Any]):
        super().__init__()
        self._fn = fn

    def svc(self, task: Any) -> Any:
        return self._fn(task)

    def node_stats(self) -> dict:
        s = super().node_stats()
        s["node"] = getattr(self._fn, "__name__", "FnNode")
        return s
