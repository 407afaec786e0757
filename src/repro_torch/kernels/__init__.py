"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``kernels/ref.py`` holds the oracles the tests compare against)."""


def wrappers() -> dict:
    """Every kernel wrapper by kernel name, each with its ``launches``
    count of real launches (a kernel with a backward kernel has a second
    wrapper for it, ``<name>_bwd``)."""
    from .a2a_fused import a2a_combine, a2a_route
    from .flash_attention import flash_attention
    from .gelu_stepwise import gelu_stepwise, gelu_stepwise_bwd
    from .router_topk import router_topk
    from .silu_stepwise import silu_stepwise, silu_stepwise_bwd
    from .ssd_scan import ssd_scan, ssd_scan_bwd
    return {"flash_attention": flash_attention, "router_topk": router_topk,
            "ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_bwd,
            "gelu_stepwise": gelu_stepwise,
            "gelu_stepwise_bwd": gelu_stepwise_bwd,
            "silu_stepwise": silu_stepwise,
            "silu_stepwise_bwd": silu_stepwise_bwd,
            "a2a_route": a2a_route, "a2a_combine": a2a_combine}
