"""Tuned host-runtime preset for the launchers (``--tuned``).

Port of ``src/repro/launch/tuned.py``.  Two environment-level wins for
host-tier streaming workers, applied by re-exec so they land *before* the
interpreter loads numpy and torch:

* **tcmalloc** — ``LD_PRELOAD`` a thread-caching malloc when one is
  installed.  The process-tier farm workers allocate per item (pickle
  buffers, ndarray copies out of the shm rings); glibc malloc's central
  arena lock serializes exactly the hot path the transport just
  parallelized.  Detection only — no tcmalloc on the box means no preload,
  never a failure.
* **one intra-op thread** — ``OMP_NUM_THREADS=1`` and ``MKL_NUM_THREADS=1``
  where the reference sets ``XLA_FLAGS`` for XLA:CPU's Eigen pool.  Farm
  workers already occupy every core; a torch (OpenMP) or MKL pool in every
  process oversubscribes the machine and destroys the placement math.  The
  variables are read once, when those libraries load, hence the re-exec.
  The card's work is not touched: CUDA kernels run on the device whatever
  the host's thread count.

``apply_tuned()`` is idempotent across the re-exec (an env guard breaks
the loop) and a no-op when the environment is already tuned.
"""

from __future__ import annotations

import glob
import os
import sys
from typing import Dict, List, Optional

# set in the re-exec'd child so the second pass through apply_tuned()
# knows the environment is already in place
_GUARD = "REPRO_TORCH_TUNED"

# one intra-op thread per worker process: the farm supplies the parallelism
_THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")

# silence tcmalloc's large-alloc reports for big ndarray slabs
_TCMALLOC_THRESHOLD = "60000000000"

_TCMALLOC_CANDIDATES = [
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
]


def find_tcmalloc() -> Optional[str]:
    """Path of an installed tcmalloc shared object, or None."""
    for path in _TCMALLOC_CANDIDATES:
        if os.path.exists(path):
            return path
    for pat in ("/usr/lib/*/libtcmalloc*.so*", "/usr/lib/libtcmalloc*.so*"):
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    return None


def tuned_env(base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment deltas the tuned preset wants on top of ``base``
    (default: ``os.environ``).  Pure — computes, never mutates."""
    env = dict(os.environ if base is None else base)
    delta: Dict[str, str] = {}
    tc = find_tcmalloc()
    if tc is not None and tc not in env.get("LD_PRELOAD", ""):
        preload = env.get("LD_PRELOAD", "")
        delta["LD_PRELOAD"] = f"{preload}:{tc}".lstrip(":")
        delta.setdefault("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD",
                         _TCMALLOC_THRESHOLD)
    for var in _THREAD_VARS:
        if env.get(var) != "1":
            delta[var] = "1"
    return delta


def apply_tuned(argv: Optional[List[str]] = None) -> bool:
    """Apply the tuned preset, re-exec'ing the current program once so
    ``LD_PRELOAD`` and the thread counts precede every library load.
    Returns False when the environment is already tuned (including the
    post-re-exec pass) — the caller just continues; does not return
    otherwise."""
    if os.environ.get(_GUARD) == "1":
        return False
    delta = tuned_env()
    if not delta:
        return False
    os.environ.update(delta)
    os.environ[_GUARD] = "1"
    args = sys.argv if argv is None else argv
    mod = _main_module()
    cmd = ([sys.executable, "-m", mod] + args[1:] if mod
           else [sys.executable] + args)
    sys.stdout.flush()
    sys.stderr.flush()
    os.execv(sys.executable, cmd)


def _main_module() -> Optional[str]:
    """``python -m repro_torch.launch.X`` spelling of the running launcher,
    so the re-exec preserves the module entry point (sys.argv[0] is the
    script path, which ``-m`` launches don't want back)."""
    main = sys.modules.get("__main__")
    spec = getattr(main, "__spec__", None)
    name = getattr(spec, "name", None)
    return name if name else None
