"""Runtime policies of the port.

Only :class:`SLOPolicy` so far, copied from ``src/repro/core/runtime.py``:
the serving engine enforces it inline on every ``submit``.  The adaptive
runtime (``Supervisor``, ``AdaptiveFarmNode``) comes with its own slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SLOPolicy:
    """Overload policy for SLO-controllable stages (the serving engine's
    admission stage): how hard to push back as backlog approaches capacity,
    instead of queueing unboundedly.

    Pressure is the backlog/capacity ratio of the stage's ``stats()["slo"]``
    block.  Below ``degrade_at`` the stage runs unconstrained (level 0); in
    [``degrade_at``, ``shed_at``) it *degrades* (level 1: new requests'
    ``max_new_tokens`` capped at ``degrade_tokens``, early-exit thresholds
    tightened by ``exit_margin``); at ``shed_at`` and above it *sheds*
    (level 2: new submissions rejected with a typed ``Overloaded`` result).
    The controlled stage always enforces its own hard cap inline — the
    supervisor policy moves the soft thresholds below it."""

    degrade_at: float = 0.5
    shed_at: float = 0.9
    degrade_tokens: int = 8
    exit_margin: float = 0.5

    def level(self, backlog: int, capacity: int) -> int:
        ratio = backlog / max(1, capacity)
        if ratio >= self.shed_at:
            return 2
        if ratio >= self.degrade_at:
            return 1
        return 0
