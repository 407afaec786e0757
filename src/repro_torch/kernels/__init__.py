"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``kernels/ref.py`` holds the oracles the tests compare against)."""


def wrappers() -> dict:
    """Every kernel wrapper by kernel name, each with its ``launches``
    count of real launches."""
    from .a2a_fused import a2a_combine, a2a_route
    from .flash_attention import flash_attention
    from .gelu_stepwise import gelu_stepwise
    from .router_topk import router_topk
    from .ssd_scan import ssd_scan
    return {"flash_attention": flash_attention, "router_topk": router_topk,
            "ssd_scan": ssd_scan, "gelu_stepwise": gelu_stepwise,
            "a2a_route": a2a_route, "a2a_combine": a2a_combine}
