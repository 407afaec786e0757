"""Where each kernel call runs, and the build of the CUDA sources.

The reference resolves a Pallas ``interpret`` flag from the JAX backend.  The
port decides by the tensor instead: a kernel wrapper given a CPU tensor runs
its plain PyTorch version, given a CUDA tensor it launches the hand-written
kernel or raises — there is no ``try`` that falls back.

The kernels live in ``csrc/*.cu`` as plain C entry points.  At first use each
source is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the root of the checkout (named by a hash of the
source and the ``csrc/*.cuh`` headers it includes, so an edited source or
header never meets a stale library) and loaded with
``ctypes``.  Nothing is built or imported when this module is imported.

The dry run (``launch/dryrun.py``) runs the steps on fake tensors
(``torch._subclasses.FakeTensor``: a shape, a type and a device, no
storage).  A wrapper given a fake CUDA tensor takes one branch of its own:
it allocates the outputs and workspace a launch would (on fake tensors,
so the dry run's memory count sees them), hands the launch it stands in
for to :func:`note_launch` and returns, touching no library, no pointer,
no stream and no ``launches`` counter (those count real launches only); a
real CUDA tensor never takes it, and a failed build still raises.  Every
wrapper call, on any path, hands its :class:`Work` to :func:`note`.  A torch built without CUDA has no CUDA
device for autograd to take a fake CUDA tensor's gradient on, so there the
dry run traces on fake CPU tensors inside :func:`fake_cuda`, and those take
the same branch.  Each kernel module's ``work(...)`` gives the operations
and bytes behind the kernel's bound in ``PERF.md`` (H100 SXM data sheet).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Callable, Dict, Iterable, NamedTuple, Optional

import torch

from ..core.perf_model import H100_SXM

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas's report (registers, spills per kernel) of each verbose build
PTXAS_REPORT: Dict[str, str] = {}


_FAKE_CUDA = threading.local()
_NOTES: list = []


def is_fake(t: torch.Tensor) -> bool:
    """``t`` is a fake tensor (no storage: the dry run's)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


@contextlib.contextmanager
def fake_cuda():
    """Inside (in this thread), a fake CPU tensor takes the kernels' CUDA
    path as a fake CUDA tensor does: the dry run's trace of the card's
    path where torch has no CUDA."""
    before = getattr(_FAKE_CUDA, "on", False)
    _FAKE_CUDA.on = True
    try:
        yield
    finally:
        _FAKE_CUDA.on = before


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises.  Inside
    :func:`fake_cuda` a fake CPU tensor counts as CUDA."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return getattr(_FAKE_CUDA, "on", False) and is_fake(t)
    raise RuntimeError(f"no kernel for tensors on {t.device}")


class Work(NamedTuple):
    """One kernel call's work: its operations, the bytes it must move
    (each input read once, each output written once) and the time its
    operations take at their types' peak rates on an H100 SXM."""
    flops: float
    bytes: float
    ops_s: float

    @property
    def bytes_s(self) -> float:
        return self.bytes / H100_SXM.hbm_bw

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the larger of the two."""
        return max(self.bytes_s, self.ops_s)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_s >= self.ops_s else "operations"


@contextlib.contextmanager
def noting(on_call: Callable, on_launch: Callable):
    """Inside, every kernel wrapper call, on any path, calls
    ``on_call(name, work)`` with its :class:`Work`, and every launch a
    wrapper's fake branch stands in for calls ``on_launch(name)``."""
    sinks = (on_call, on_launch)
    _NOTES.append(sinks)
    try:
        yield
    finally:
        _NOTES.remove(sinks)


def noted() -> bool:
    """Whether a :func:`noting` sink listens (a wrapper computes its work
    only then)."""
    return bool(_NOTES)


def note(name: str, work: Work) -> None:
    for on_call, _ in _NOTES:
        on_call(name, work)


def note_launch(name: str) -> None:
    """A fake tensor's launch of kernel ``name``: nothing ran."""
    for _, on_launch in _NOTES:
        on_launch(name)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the card (set CUDA_HOME)")
    return found


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and every header under ``csrc`` it includes,
    directly or through another header (``#include "x.cuh"``), in the
    order they are first met."""
    found, todo = [], [f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f in found:
            continue
        found.append(f)
        todo += re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                           (CSRC / f).read_text(), re.M)
    return [CSRC / f for f in found]


def library_path(name: str) -> pathlib.Path:
    """The library's path, named by a hash of the source, the headers it
    includes and the flags, so an edited source or header never meets a
    stale library."""
    h = hashlib.sha1(" ".join(ARCH_FLAGS).encode())
    for f in sources(name):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str, verbose: bool = False) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` into its shared library unless it exists.
    The library is written under a temporary name and renamed into place, so
    concurrent builds never load a half-written file.  ``verbose`` keeps
    ptxas's report in ``PTXAS_REPORT[name]``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, str(CSRC / f"{name}.cu")]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
        if verbose:
            PTXAS_REPORT[name] = res.stderr
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(names: Optional[Iterable[str]] = None,
              verbose: bool = False) -> Dict[str, float]:
    """Build every source (default: all of ``csrc/``), one ``nvcc`` per
    source, all started together.  Returns the seconds each build took."""
    names = sorted(names if names is not None
                   else (p.stem for p in CSRC.glob("*.cu")))

    def timed(name: str) -> float:
        t0 = time.perf_counter()
        build(name, verbose=verbose)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as pool:
        futures = {n: pool.submit(timed, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


def current_stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
