"""The rank side of ``tests/test_torch_graph_spmd.py``: the graphs it holds,
built in either package from one set of constants, and the cases every
rank of two gloo CPU ranks (``core.spmd.launch``) compiles over a plan
whose ``data`` axis has those ranks behind it.  Imports only torch, numpy
and the port at module level, so a rank starts without JAX; the JAX side
(``tests/graph_spmd_reference.py``) imports it for the graphs.

Every stage is one rounding (an add or a multiply by a Python float), so
the a2a hop's routing and drops are exact in both packages.  Each graph
runs over ``N_ITEMS`` items, so the last microbatch is partial and padded
to a multiple of the two ranks.
"""

from __future__ import annotations

import numpy as np

N_ITEMS, WIDTH = 37, 8
C = (1.5, -0.5, 2.0, 0.75)            # the experts: y * C[e] (odd e) ...
D = (0.25, -1.0, 0.5, 3.0)            # ... or y + D[e] (even e)
CASES = ("a2a", "a2a_cap", "hybrid", "feedback_steps", "feedback_cond")
HYBRID_PLACE = {0: "host", 1: "device", 2: "device", 3: "host"}


def _experts():
    return [(lambda y, e=e: y * C[e]) if e % 2 else
            (lambda y, e=e: y + D[e]) for e in range(len(C))]


def build(name: str, fw: str):
    """``(graph, compile kwargs)`` of case ``name`` in package ``fw``
    (``"torch"``: the port, ``"jax"``: the reference)."""
    if fw == "jax":
        import jax.numpy as xp
        import repro.core as pkg

        def to_int(t):
            return t.astype(xp.int32)
    else:
        import torch as xp
        import repro_torch.core as pkg

        def to_int(t):
            return t.to(xp.int32)
    left = [lambda x: x + 1.0] * 2
    if name == "a2a":                  # the default (position) routing
        g = pkg.pipeline(lambda x: x * 1.5, pkg.all_to_all(left, _experts()),
                         lambda x: x - 0.125)
        return g, {"mode": "device"}
    if name == "a2a_cap":
        # most items to expert 0, so a chunk of 16 overflows its 8 slots;
        # the last chunk of 5 (6 padded) fits
        def skewed(y, n):
            return to_int(xp.abs(y[0]) > 2.5) % n
        g = pkg.pipeline(lambda x: x * 1.5,
                         pkg.all_to_all(left, _experts(), router=skewed),
                         lambda x: x - 0.125)
        return g, {"mode": "device", "a2a_capacity_factor": 1.25,
                   "microbatch": 16}
    if name == "hybrid":
        # a host farm in front of the device segment (all_to_all and the
        # stage after it), a host stage behind; the router reads the
        # item's value, so its expert does not depend on arrival order
        def router(y, n):
            return to_int(xp.abs(y[0]) * 7.0) % n
        g = pkg.pipeline(pkg.farm(lambda x: np.asarray(x) * np.float32(2.0),
                                  n=2),
                         pkg.all_to_all(left, _experts(), router=router),
                         lambda x: x - 0.125,
                         lambda x: np.asarray(x) - np.float32(3.0))
        return g, {"placements": dict(HYBRID_PLACE), "microbatch": 4,
                   "inflight": 2}
    if name == "feedback_steps":
        g = pkg.farm(lambda x: xp.tanh(x * 0.9) + 0.1, n=2).wrap_around()
        return g, {"mode": "device", "feedback_steps": 3}
    g = pkg.farm(lambda x: x * 1.5 + 0.5, n=2).wrap_around()
    return g, {"mode": "device", "feedback_steps": 8,
               "feedback_cond": lambda x: xp.sum(x) < 20.0}


def serial_hybrid(stream) -> np.ndarray:
    """The hybrid graph's item function in numpy, item by item in input
    order: f, the left worker, the routed expert, the stages after."""
    out = []
    for x in stream:
        y = np.asarray(x, np.float32) * np.float32(2.0) + np.float32(1.0)
        e = int(np.abs(y[0]) * np.float32(7.0)) % len(C)
        y = y * np.float32(C[e]) if e % 2 else y + np.float32(D[e])
        out.append(y - np.float32(0.125) - np.float32(3.0))
    return np.stack(out)


def _two_ranked_segments(pkg):
    """A graph with two device segments that would span the ranks, apart
    by a host stage."""
    hop = lambda: pkg.all_to_all([lambda x: x + 1.0] * 2, _experts())
    return pkg.pipeline(hop(), lambda x: np.asarray(x) + np.float32(1.0),
                        hop())


def rank_main(inp_path: str) -> dict:
    """Every case on this rank over the two ranks, and on this rank alone
    (``single_device_plan``); returns ``{name: array}``."""
    import torch
    torch.set_num_threads(1)
    import repro_torch.core as T
    from repro_torch.core import spmd
    from repro_torch.core.graph import GraphError
    from repro_torch.core.plan import ShardingPlan, single_device_plan
    from repro_torch.launch.mesh import make_mesh
    stream = list(np.load(inp_path)["stream"])
    plan = ShardingPlan(make_mesh((2,), ("data",), "cpu"))
    one = single_device_plan("cpu")
    out = {"rank": np.asarray(spmd.rank())}
    for name in CASES:
        g, kw = build(name, "torch")
        runner = g.compile(config=T.CompileConfig(plan=plan, **kw))
        out[f"{name}/ranks"] = np.stack(runner.run(stream))
        if name == "hybrid":
            hs = runner.stage_handles()
            dev = [h for h in hs if getattr(h, "boundary_tunable", False)]
            s = dev[0].stats()
            out["hybrid/flushes"] = np.asarray(s["flushes"])
            out["hybrid/retired"] = np.asarray(s["boundary"]["retired"])
            out["hybrid/stages"] = np.asarray([h.desc for h in hs])
        g, kw = build(name, "torch")
        out[f"{name}/one"] = np.stack(g.compile(
            config=T.CompileConfig(plan=one, **kw)).run(stream))
    try:
        _two_ranked_segments(T).compile(config=T.CompileConfig(
            plan=plan, placements={0: "device", 1: "host", 2: "device"}))
        out["two_segments_raised"] = np.asarray(0)
    except GraphError:
        out["two_segments_raised"] = np.asarray(1)
    return out


if __name__ == "__main__":
    raise SystemExit("imported by tests/test_torch_graph_spmd.py")
