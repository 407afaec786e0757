"""silu as the reference rounds it, and its gradient: one kernel pass each
way.

``jax.nn.silu`` is x * logistic(x), and XLA computes the logistic as
1 / (1 + exp(-x)), rounding each step to x's type (in bf16); its VJP is
dx = dy * s + (x * dy) * (s * (1 - s)), the logistic's JVP rule, each step
rounded the same way.  ``F.silu`` rounds once, which moves the reduced
Zamba2's logits 4-8% of their scale from the reference's, so the port
computes every step: the Mixtral and Kimi experts, Mamba2's ``xi`` and
``z`` gates, the mLSTM's gates and the dense silu MLP all call
:func:`silu_stepwise`.  Its plain versions (:func:`silu_stepwise_plain`,
:func:`silu_stepwise_vjp_plain`) are five and about ten eager ops; the
CUDA kernels (``csrc/silu_stepwise.cu``) make one pass each, rounding each
step in registers.  There is no Pallas kernel behind them in the
reference: XLA fuses the steps there.

:func:`silu_stepwise` runs the plain version for CPU tensors and launches
the kernel for CUDA tensors, and its backward calls
:func:`silu_stepwise_bwd`, which does the same for the gradient (the
profiler sees it as the range ``silu_stepwise.backward``); only x is
saved, s is recomputed.  ``silu_stepwise.launches`` and
``silu_stepwise_bwd.launches`` count the launches.  A fake CUDA tensor
launches nothing and hands the launch to ``backend.note_launch``;
:func:`work` is the bound's operations and bytes.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import backend
from ..core.perf_model import H100_SXM

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    lib = backend.load("silu_stepwise")
    if not getattr(lib, "_ff_typed", False):
        p, n, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.silu_stepwise_launch.argtypes = [p, p, n, i, p]
        lib.silu_stepwise_launch.restype = i
        lib.silu_stepwise_bwd_launch.argtypes = [p, p, p, n, i, p]
        lib.silu_stepwise_bwd_launch.restype = i
        lib._ff_typed = True
    return lib


def _logistic(x: torch.Tensor) -> torch.Tensor:
    return torch.reciprocal(torch.exp(-x) + 1)


def silu_stepwise_plain(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` step by step: x * (1 / (exp(-x) + 1)), each step
    rounded to x's type."""
    return x * _logistic(x)


def silu_stepwise_vjp_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """XLA's VJP of ``jax.nn.silu`` at ``x`` for ``dy``, each step rounded
    to x's type: dy * s + (x * dy) * (s * (1 - s))."""
    s = _logistic(x)
    return dy * s + (x * dy) * (s * (1 - s))


def _checked(*ts: torch.Tensor) -> None:
    if ts[0].dtype not in _DTYPES:
        raise TypeError(f"silu_stepwise kernel takes float32 or bfloat16, "
                        f"got {ts[0].dtype}")
    for t in ts:
        if t.dtype != ts[0].dtype or t.shape != ts[0].shape:
            raise ValueError("silu_stepwise kernel takes x and dy of one "
                             "type and shape")
        if not t.is_contiguous():
            raise ValueError("silu_stepwise kernel takes a contiguous tensor")


def _launch(x: torch.Tensor) -> torch.Tensor:
    _checked(x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    if backend.is_fake(x):
        backend.note_launch("silu_stepwise")
        return y
    err = _lib().silu_stepwise_launch(
        x.data_ptr(), y.data_ptr(), x.numel(), _DTYPES[x.dtype],
        backend.current_stream(x.device))
    with _count_lock:
        silu_stepwise.launches += 1
    backend.check(err, "silu_stepwise")
    return y


def _launch_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    _checked(x, dy)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    if backend.is_fake(x):
        backend.note_launch("silu_stepwise_bwd")
        return dx
    err = _lib().silu_stepwise_bwd_launch(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), x.numel(),
        _DTYPES[x.dtype], backend.current_stream(x.device))
    with _count_lock:
        silu_stepwise_bwd.launches += 1
    backend.check(err, "silu_stepwise_bwd")
    return dx


class _SiluStepwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if backend.use_kernel(x):
            return _launch(x)
        return silu_stepwise_plain(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        with torch.profiler.record_function("silu_stepwise.backward"):
            return silu_stepwise_bwd(x, dy.contiguous())


def silu_stepwise(x: torch.Tensor) -> torch.Tensor:
    """silu as ``jax.nn.silu`` computes it: x * (1 / (1 + exp(-x))), every
    step rounded to x's type (``F.silu`` rounds once), with the gradient
    ``jax.grad`` gives it, rounded the same way."""
    if backend.noted():
        backend.note("silu_stepwise", work(x.numel(), x.dtype))
    return _SiluStepwise.apply(x)


def silu_stepwise_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`silu_stepwise` at ``x`` for ``dy``:
    :func:`silu_stepwise_vjp_plain` for CPU tensors, its kernel for CUDA
    tensors."""
    if backend.noted():
        backend.note("silu_stepwise_bwd", work(x.numel(), x.dtype, True))
    if backend.use_kernel(x):
        return _launch_bwd(x, dy)
    return silu_stepwise_vjp_plain(x, dy)


def work(n: int, dtype: torch.dtype, backward: bool = False) -> backend.Work:
    """Each of ``n`` elements read and written once (the backward reads x
    and dy); ~5 fp32 operations an element forward (the exponential, the
    sum, the reciprocal and the product), ~10 backward, far under the
    bytes."""
    ops = (10 if backward else 5) * n
    return backend.Work(ops, (3 if backward else 2) * n * dtype.itemsize,
                        ops / H100_SXM.peak_flops_f32)


silu_stepwise.launches = 0
silu_stepwise_bwd.launches = 0
