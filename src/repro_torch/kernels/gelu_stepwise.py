"""The dense MLP's gelu as the reference rounds it: one kernel pass.

``jax.nn.gelu`` (its default tanh form, ``src/repro/models/layers.py:71``)
rounds each of its steps to the input's type:
g * (0.5 * (1 + tanh(c * (g + 0.044715 * g**3)))) with c = sqrt(2/pi).
``F.gelu`` rounds once, and over Whisper's 48 layers that moves the logits
past the port's tolerance, so the port computes every step.  Its plain
version (:func:`gelu_stepwise_plain`) is nine eager ops, nine passes over
memory; the CUDA kernel (``csrc/gelu_stepwise.cu``) makes one, rounding each
step in registers.  There is no Pallas kernel behind it in the reference:
XLA fuses the steps there.

:func:`gelu_stepwise` runs the plain version for CPU tensors and launches
the kernel for CUDA tensors; ``gelu_stepwise.launches`` counts the
launches (a fake CUDA tensor launches nothing and hands the launch to
``backend.note_launch``; :func:`work` is the bound's operations and
bytes).  The backward recomputes the plain
version and takes its gradient, which rounds each step as ``jax.grad``
does; the profiler sees it as the range ``gelu_stepwise.recompute_backward``.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import backend
from ..core.perf_model import H100_SXM

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    lib = backend.load("gelu_stepwise")
    if not getattr(lib, "_ff_typed", False):
        p = ctypes.c_void_p
        lib.gelu_stepwise_launch.argtypes = [p, p, ctypes.c_longlong,
                                             ctypes.c_int, ctypes.c_float,
                                             ctypes.c_float, p]
        lib.gelu_stepwise_launch.restype = ctypes.c_int
        lib._ff_typed = True
    return lib


def _consts(dtype: torch.dtype) -> tuple:
    """0.044715 and sqrt(2/pi) rounded to ``dtype`` (torch would take a
    Python float into the product in fp32)."""
    def const(v: float) -> float:
        return float(torch.tensor(v, dtype=torch.float64).to(dtype))
    return const(0.044715), const(math.sqrt(2 / math.pi))


def gelu_stepwise_plain(g: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` step by step, each step rounded to g's type."""
    k, c = _consts(g.dtype)
    inner = c * (g + k * (g * g * g))
    return g * (0.5 * (1.0 + torch.tanh(inner)))


def _launch(g: torch.Tensor) -> torch.Tensor:
    if g.dtype not in _DTYPES:
        raise TypeError(f"gelu_stepwise kernel takes float32 or bfloat16, "
                        f"got {g.dtype}")
    if not g.is_contiguous():
        raise ValueError("gelu_stepwise kernel takes a contiguous tensor")
    y = torch.empty_like(g)
    if g.numel() == 0:
        return y
    k, c = _consts(g.dtype)
    if backend.is_fake(g):
        backend.note_launch("gelu_stepwise")
        return y
    err = _lib().gelu_stepwise_launch(
        g.data_ptr(), y.data_ptr(), g.numel(), _DTYPES[g.dtype], k, c,
        backend.current_stream(g.device))
    with _count_lock:
        gelu_stepwise.launches += 1
    backend.check(err, "gelu_stepwise")
    return y


class _GeluStepwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g):
        ctx.save_for_backward(g)
        if backend.use_kernel(g):
            return _launch(g)
        return gelu_stepwise_plain(g)

    @staticmethod
    def backward(ctx, dy):
        (g,) = ctx.saved_tensors
        with torch.enable_grad(), torch.profiler.record_function(
                "gelu_stepwise.recompute_backward"):
            leaf = g.detach().requires_grad_(True)
            (dg,) = torch.autograd.grad(gelu_stepwise_plain(leaf), leaf, dy)
        return dg


def gelu_stepwise(g: torch.Tensor) -> torch.Tensor:
    """gelu (tanh form) of ``g`` in g's type, each step rounded as
    ``jax.nn.gelu``'s are, with the gradient ``jax.grad`` gives it."""
    if backend.noted():
        backend.note("gelu_stepwise", work(g.numel(), g.dtype))
    return _GeluStepwise.apply(g)


def work(n: int, dtype: torch.dtype) -> backend.Work:
    """Each of ``n`` elements read and written once; ~10 fp32 operations
    an element (nine steps and the tanh), far under the bytes."""
    return backend.Work(10 * n, 2 * n * dtype.itemsize,
                        10 * n / H100_SXM.peak_flops_f32)


gelu_stepwise.launches = 0
