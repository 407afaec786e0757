"""The dense MLP's gelu as the reference rounds it, and its gradient: one
kernel pass each way.

``jax.nn.gelu`` (its default tanh form, ``src/repro/models/layers.py:71``)
rounds each of its steps to the input's type:
g * (0.5 * (1 + tanh(c * (g + 0.044715 * g**3)))) with c = sqrt(2/pi).
``F.gelu`` rounds once, and over Whisper's 48 layers that moves the logits
past the port's tolerance, so the port computes every step.  Its plain
version (:func:`gelu_stepwise_plain`) is nine eager ops, nine passes over
memory; the CUDA kernel (``csrc/gelu_stepwise.cu``) makes one, rounding each
step in registers.  The gradient is XLA's VJP of ``jax.nn.gelu``, step by
step and rounded the same way (:func:`gelu_stepwise_vjp_plain`; its kernel
``gelu_stepwise_bwd_launch`` reads g and dy once and writes dx once).
There is no Pallas kernel behind either in the reference: XLA fuses the
steps there.

:func:`gelu_stepwise` runs the plain version for CPU tensors and launches
the kernel for CUDA tensors, and its backward calls
:func:`gelu_stepwise_bwd`, which does the same for the gradient (the
profiler sees it as the range ``gelu_stepwise.backward``);
``gelu_stepwise.launches`` and ``gelu_stepwise_bwd.launches`` count the
launches.  A fake CUDA tensor launches nothing and hands the launch to
``backend.note_launch``; :func:`work` is the bound's operations and bytes.
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
        p, n, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float)
        lib.gelu_stepwise_launch.argtypes = [p, p, n, i, f, f, p]
        lib.gelu_stepwise_launch.restype = i
        lib.gelu_stepwise_bwd_launch.argtypes = [p, p, p, n, i, f, f, p]
        lib.gelu_stepwise_bwd_launch.restype = i
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


def gelu_stepwise_vjp_plain(g: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """XLA's VJP of ``jax.nn.gelu`` at ``g`` for the cotangent ``dy``, op
    by op in the order of its jaxpr (``jax.make_jaxpr`` of
    ``jax.vjp(jax.nn.gelu, a)[1]``), each step rounded to g's type: g**2
    and g**3 as ``integer_pow`` lowers them, the tanh's derivative as
    ``p + p * t`` with p = (0.5 * (g * dy)) * (1 - t), and the three
    ``add_any`` sums."""
    k, c = _consts(g.dtype)
    g2 = g * g
    t = torch.tanh(c * (g + k * (g2 * g)))
    through_half = dy * (0.5 * (1.0 + t))
    p = (0.5 * (g * dy)) * (1.0 - t)
    s = c * (p + p * t)
    return (through_half + s) + (k * s) * (3.0 * g2)


def _checked(*ts: torch.Tensor) -> None:
    if ts[0].dtype not in _DTYPES:
        raise TypeError(f"gelu_stepwise kernel takes float32 or bfloat16, "
                        f"got {ts[0].dtype}")
    for t in ts:
        if t.dtype != ts[0].dtype or t.shape != ts[0].shape:
            raise ValueError("gelu_stepwise kernel takes g and dy of one "
                             "type and shape")
        if not t.is_contiguous():
            raise ValueError("gelu_stepwise kernel takes a contiguous tensor")


def _launch(g: torch.Tensor) -> torch.Tensor:
    _checked(g)
    y = torch.empty_like(g)
    if g.numel() == 0:
        return y
    if backend.is_fake(g):
        backend.note_launch("gelu_stepwise")
        return y
    k, c = _consts(g.dtype)
    err = _lib().gelu_stepwise_launch(
        g.data_ptr(), y.data_ptr(), g.numel(), _DTYPES[g.dtype], k, c,
        backend.current_stream(g.device))
    with _count_lock:
        gelu_stepwise.launches += 1
    backend.check(err, "gelu_stepwise")
    return y


def _launch_bwd(g: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    _checked(g, dy)
    dx = torch.empty_like(g)
    if g.numel() == 0:
        return dx
    if backend.is_fake(g):
        backend.note_launch("gelu_stepwise_bwd")
        return dx
    k, c = _consts(g.dtype)
    err = _lib().gelu_stepwise_bwd_launch(
        g.data_ptr(), dy.data_ptr(), dx.data_ptr(), g.numel(),
        _DTYPES[g.dtype], k, c, backend.current_stream(g.device))
    with _count_lock:
        gelu_stepwise_bwd.launches += 1
    backend.check(err, "gelu_stepwise_bwd")
    return dx


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
        with torch.profiler.record_function("gelu_stepwise.backward"):
            return gelu_stepwise_bwd(g, dy.contiguous())


def gelu_stepwise(g: torch.Tensor) -> torch.Tensor:
    """gelu (tanh form) of ``g`` in g's type, each step rounded as
    ``jax.nn.gelu``'s are, with the gradient ``jax.grad`` gives it."""
    if backend.noted():
        backend.note("gelu_stepwise", work(g.numel(), g.dtype))
    return _GeluStepwise.apply(g)


def gelu_stepwise_bwd(g: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The gradient of :func:`gelu_stepwise` at ``g`` for ``dy``:
    :func:`gelu_stepwise_vjp_plain` for CPU tensors, its kernel for CUDA
    tensors."""
    if backend.noted():
        backend.note("gelu_stepwise_bwd", work(g.numel(), g.dtype, True))
    if backend.use_kernel(g):
        return _launch_bwd(g, dy)
    return gelu_stepwise_vjp_plain(g, dy)


def work(n: int, dtype: torch.dtype, backward: bool = False) -> backend.Work:
    """Each of ``n`` elements read and written once (the backward reads g
    and dy); ~10 fp32 operations an element forward (nine steps and the
    tanh), ~22 backward, far under the bytes."""
    ops = (22 if backward else 10) * n
    return backend.Work(ops, (3 if backward else 2) * n * dtype.itemsize,
                        ops / H100_SXM.peak_flops_f32)


gelu_stepwise.launches = 0
gelu_stepwise_bwd.launches = 0
