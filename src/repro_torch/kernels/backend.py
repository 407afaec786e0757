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
"""

from __future__ import annotations

import concurrent.futures
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
from typing import Dict, Iterable, Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas's report (registers, spills per kernel) of each verbose build
PTXAS_REPORT: Dict[str, str] = {}


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel for tensors on {t.device}")


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
