"""Metrics sink + straggler detection (the collector of the supervising
farm).  Plain-python, dependency-free; a fleet deployment would point
``emit`` at its telemetry bus.

A copy of ``src/repro/runtime/monitor.py``."""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import numpy as np


class Monitor:
    def __init__(self, log_fn=print, log_every: int = 10):
        self.history: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []
        self.log_fn = log_fn
        self.log_every = log_every

    def log_step(self, step: int, metrics: Dict[str, Any], dt: float) -> None:
        rec = {"step": step, "dt": dt}
        for k, v in metrics.items():
            try:
                rec[k] = float(np.asarray(v))
            except Exception:   # noqa: BLE001
                pass
        self.history.append(rec)
        if self.log_fn and step % self.log_every == 0:
            loss = rec.get("loss", float("nan"))
            self.log_fn(f"step {step:6d} loss {loss:.4f} "
                        f"({dt*1e3:.0f} ms/step)")

    def event(self, kind: str, **kw) -> None:
        rec = {"kind": kind, "time": time.time(), **kw}
        self.events.append(rec)
        if self.log_fn:
            self.log_fn(f"[{kind}] {kw}")


class StragglerWatchdog:
    """EMA mean/var of step time; observe() -> True when a step exceeds
    mean + k*std (the signal that would trigger re-slicing on a fleet)."""

    def __init__(self, k: float = 4.0, alpha: float = 0.1,
                 warmup: int = 5, min_threshold_s: float = 1e-4):
        self.k = k
        self.alpha = alpha
        self.warmup = warmup
        self.min_threshold_s = min_threshold_s
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.count = 0

    def observe(self, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            # prime the EMA
            self.mean = dt if self.n == 1 else \
                (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = max(self.var, (dt - self.mean) ** 2)
            return False
        is_straggler = dt > max(self.mean + self.k * math.sqrt(self.var),
                                self.mean * 1.5, self.min_threshold_s)
        if is_straggler:
            self.count += 1
        else:
            self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = (1 - self.alpha) * self.var \
                + self.alpha * (dt - self.mean) ** 2
        return is_straggler
