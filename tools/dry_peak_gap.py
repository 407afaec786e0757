#!/usr/bin/env python3
"""Where a cell's traced peak and the card's measured peak part, op by op,
on one NVIDIA GPU.

    python3 tools/dry_peak_gap.py ["zamba2-1.2b train"]

Runs one of ``chip_smoke.py``'s phase 13 cells (``chip_smoke.dry_cells``;
default Zamba2-1.2B's train step) once on the card under a dispatch mode
that, for every aten op, reads the caching allocator's bytes before and
after the op and its peak inside the op, beside the bytes of the live
storages the op's outputs hold (the dry run's count, taken on real
tensors and without its decomposition).  The allocator's bytes that no
live storage accounts for are an op's workspace or a storage made outside
the dispatcher: the tool prints the allocator's and the storages' peaks,
the ops around the allocator's peak, and the ops that leave or briefly
take the most such bytes.
"""

from __future__ import annotations

import collections
import importlib
import json
import pathlib
import sys
import threading
import time
import weakref

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import chip_smoke as cs  # noqa: E402

_DEVICE = torch.ops.prim.device.default


def _tensors(tree, out):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _tensors(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _tensors(t, out)
    return out


class AllocatorRows(TorchDispatchMode):
    """Per op: (op, allocated before, peak inside, allocated after, live
    storage bytes before, after), all above ``base``."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.rows = []
        self.base = 0
        self._st = {}
        self._lock = threading.Lock()

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            if key in self._st:
                return
            self._st[key] = st.nbytes()
            self.live += self._st[key]
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        with self._lock:
            self.live -= self._st.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _DEVICE:
            return func(*args)
        torch.cuda.reset_peak_memory_stats()
        a0, l0 = torch.cuda.memory_allocated(), self.live
        out = func(*args, **(kwargs or {}))
        peak, a1 = torch.cuda.max_memory_allocated(), \
            torch.cuda.memory_allocated()
        for t in _tensors(out, []):
            self.track(t)
        self.rows.append((str(func), a0 - self.base, peak - self.base,
                          a1 - self.base, l0, self.live))
        return out


def main() -> int:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this tool needs a GPU")
    want = sys.argv[1] if len(sys.argv) > 1 else "zamba2-1.2b train"
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    importlib.import_module("torch._dynamo")   # the first checkpoint's
    card = cs.phase_card()
    from repro_torch.core.plan import single_device_plan
    plan = single_device_plan()
    tag, cfg, mode, B, S = next(c for c in cs.dry_cells() if c[0] == want)
    # the step run once bare first (the first run's one-off allocations:
    # cuBLAS workspaces, the autograd thread's), then under the recorder
    step, args = cs.dry_real_args(cfg, mode, B, S, plan)
    out = step(*args)
    del out
    cs.sync(dev)
    rec = AllocatorRows()
    for t in _tensors(args, []):
        rec.track(t)
    rec.base = torch.cuda.memory_allocated() - rec.live
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with rec:
        out = step(*args)
    cs.sync(dev)
    secs = time.perf_counter() - t0
    whole_peak = torch.cuda.max_memory_allocated() - rec.base
    del out
    rows = rec.rows
    i_pk = max(range(len(rows)), key=lambda i: rows[i][2])
    live_peak = max(max(r[4], r[5]) for r in rows)
    gb = 1e9
    cs.say(f"[gap] {tag} on {card['card']}: {len(rows)} ops in {secs:.1f} s;"
           f" allocator peak {rows[i_pk][2] / gb:.3f} GB (whole step "
           f"{whole_peak / gb:.3f} GB) at op {i_pk} {rows[i_pk][0]}; live "
           f"storages there {rows[i_pk][4] / gb:.3f} GB before, "
           f"{rows[i_pk][5] / gb:.3f} GB after; their own peak "
           f"{live_peak / gb:.3f} GB")
    for i in range(max(0, i_pk - 6), min(len(rows), i_pk + 4)):
        r = rows[i]
        cs.say(f"[gap]   op {i} {r[0]}: allocated {r[1] / gb:.3f} -> "
               f"{r[3] / gb:.3f} GB (peak inside {r[2] / gb:.3f}), live "
               f"{r[4] / gb:.3f} -> {r[5] / gb:.3f} GB")
    left = collections.Counter()
    inside = collections.Counter()
    for r in rows:
        left[r[0]] += (r[3] - r[5]) - (r[1] - r[4])
        inside[r[0]] = max(inside[r[0]], r[2] - max(r[1], r[3]))
    cs.say("[gap] bytes left beyond the live storages, by op (sum): "
           + json.dumps({k: v for k, v in left.most_common(12)}))
    cs.say("[gap] bytes taken inside an op beyond its before and after, by "
           "op (most): " + json.dumps({k: v for k, v in
                                       inside.most_common(12)}))
    i_un = max(range(len(rows)), key=lambda i: rows[i][3] - rows[i][5])
    cs.say(f"[gap] the most allocated beyond the live storages after an op: "
           f"{(rows[i_un][3] - rows[i_un][5]) / gb:.3f} GB, after op {i_un} "
           f"{rows[i_un][0]}")
    cs.say(f"[gap] allocated beyond the live storages at the peak: "
           f"{(rows[i_pk][1] - rows[i_pk][4]) / gb:.3f} GB before the op, "
           f"{(rows[i_pk][2] - max(rows[i_pk][1], rows[i_pk][3])) / gb:.3f}"
           f" GB inside it")
    return 0


if __name__ == "__main__":
    sys.exit(main())
