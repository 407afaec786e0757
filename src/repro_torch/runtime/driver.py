"""Fault-tolerant training driver.

Port of ``src/repro/runtime/driver.py`` (``DriverConfig``, ``TrainDriver``)
on one device:

  * checkpoint/restart: periodic async checkpoints (+ the data source's
    state in ``extras``); on any step exception the driver restores the
    last checkpoint and resumes with bounded retries and backoff;
  * straggler watchdog: per-step wall-time EMA + k*sigma threshold; slow
    steps are logged and counted.

This is the paper's farm with a *supervising emitter*: the stream items are
steps, the worker is the card, the collector is the metrics sink, and the
feedback loop re-offloads failed work.

Where the reference waits with ``jax.block_until_ready(metrics["loss"])``,
the port reads all of a step's metrics to the host in one transfer, which
waits for the step; reading the state's step counter is one more host read
per (re)start.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..checkpoint import CheckpointManager
from .monitor import Monitor, StragglerWatchdog


@dataclasses.dataclass
class DriverConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    max_retries: int = 3
    retry_backoff_s: float = 0.5
    log_every: int = 10
    watchdog_k: float = 4.0


def host_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """A step's metrics as Python floats, the tensors read in one transfer
    (which waits for the step that computes them)."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    vals = torch.stack([metrics[k].detach().float().reshape(())
                        for k in keys]).tolist() if keys else []
    out = {k: float(v) for k, v in metrics.items() if k not in keys}
    out.update(zip(keys, vals))
    return out


class TrainDriver:
    def __init__(self, train_step: Callable, state, pipeline,
                 config: DriverConfig, monitor: Optional[Monitor] = None,
                 fault_hook: Optional[Callable[[int], None]] = None):
        self.step_fn = train_step
        self.state = state
        self.pipeline = pipeline
        self.cfg = config
        self.ckpt = CheckpointManager(config.ckpt_dir, keep=config.keep)
        self.monitor = monitor or Monitor(log_every=config.log_every)
        self.watchdog = StragglerWatchdog(k=config.watchdog_k)
        self.fault_hook = fault_hook        # test hook: raise at step N
        self.restarts = 0

    # -- main loop -------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        step = int(self.state["step"])
        retries = 0
        while step < self.cfg.total_steps:
            batch = self.pipeline.get()
            if batch is None:
                break
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                metrics = host_metrics(metrics)
                dt = time.perf_counter() - t0
                retries = 0
            except Exception as e:  # noqa: BLE001 - supervised retry
                retries += 1
                self.monitor.event("step_failure", step=step,
                                   error=f"{type(e).__name__}: {e}",
                                   retry=retries)
                if retries > self.cfg.max_retries:
                    raise
                time.sleep(self.cfg.retry_backoff_s * retries)
                self._restore()
                step = int(self.state["step"])
                continue

            if self.watchdog.observe(dt):
                self.monitor.event("straggler", step=step, step_time_s=dt,
                                   mean_s=self.watchdog.mean)
            self.monitor.log_step(step, metrics, dt)
            step += 1
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save_async(step, self.state,
                                     extras={"data": self.pipeline.state()})
        # final synchronous checkpoint
        self.ckpt.wait()
        self.ckpt.save(step, self.state,
                       extras={"data": self.pipeline.state()})
        return {"final_step": step, "restarts": self.restarts,
                "stragglers": self.watchdog.count,
                "history": self.monitor.history}

    def _restore(self) -> None:
        self.ckpt.wait()
        latest = self.ckpt.latest()
        if latest is None:
            return                      # nothing saved yet: retry in place
        self.state, extras = self.ckpt.restore(self.state)
        if extras.get("data"):
            self.pipeline.source.restore(extras["data"])
        self.restarts += 1
        self.monitor.event("restart", from_step=latest)
