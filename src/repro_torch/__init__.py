"""PyTorch/CUDA port of the FastFlow reproduction in ``repro``.

The port imports ``torch`` and ``numpy`` and nothing of JAX or of the
reference package; where it needs a module of the reference it keeps its own
copy.  Its entry points run on the first CUDA device unless the caller asks
for the CPU (``single_device_plan(device="cpu")``).
"""
