"""The port's compiled graph path against the reference, on the CPU.

The same graphs are built in both packages — stage functions written once
per framework from shared constants — and one numpy stream runs through
``compile(mode="device")`` in each: the reference on JAX's CPU backend, the
port on ``single_device_plan(device="cpu")``.  Integer outputs must match
exactly.  Float outputs may differ by a few f32 ulps: XLA contracts
multiply-adds into FMAs and has its own ``tanh``/``exp``, PyTorch's CPU
kernels round each op (tolerance rtol 1e-5, atol 1e-6).  Port-only
comparisons — fused vs ``fuse=False``, windowed vs ``overlap=False`` — run
the same torch ops on the same inputs and must be byte-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.plan import single_device_plan as jax_plan
from repro_torch.core.fuse import segment_cache_clear, segment_cache_info
from repro_torch.core.plan import single_device_plan

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
XP = {"jax": jnp, "torch": torch}
PKG = {"jax": J, "torch": T}


def _plan(fw):
    return jax_plan() if fw == "jax" else single_device_plan(device="cpu")


def _compile(fw, graph, **cfg):
    pkg = PKG[fw]
    return graph.compile(config=pkg.CompileConfig(plan=_plan(fw), **cfg))


def _stream(n=13, width=6, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(width).astype(dtype) for _ in range(n)]


def _assert_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        else:
            assert np.array_equal(g, w)


def _bytes(out):
    return [np.asarray(y).tobytes() for y in out]


def _both(build, stream, **cfg):
    """Run the graph ``build(fw)`` makes through both packages."""
    return {fw: _compile(fw, build(fw), **cfg).run(stream)
            for fw in ("jax", "torch")}


# -- graphs, one builder per shape, each taking the framework's name ---------
def _stages(fw):
    xp = XP[fw]
    return [lambda x: x * 1.5 + 0.25, lambda x: xp.tanh(x),
            lambda x: x - 0.125, lambda x: x * x + x]


def _pipeline(fw):
    return PKG[fw].pipeline(*_stages(fw))


def _farm(fw):
    xp = XP[fw]
    return PKG[fw].pipeline(lambda x: x * 2.0,
                            PKG[fw].farm(lambda x: xp.sin(x) + x, n=4))


def _ffmap(fw):
    xp = XP[fw]
    cat = jnp.concatenate if fw == "jax" else torch.cat
    return PKG[fw].pipeline(PKG[fw].ffmap(
        lambda x: (x[:3], x[3:]),
        [lambda p: p * 2.0, lambda p: xp.tanh(p)],
        lambda parts: cat(parts)))


def _left(fw):
    return [lambda x: x + 1.0, lambda x: x * 2.0]


def _right(fw):
    xp = XP[fw]
    return [lambda x, s=float(j + 1): xp.tanh(x) * s for j in range(3)]


def _router(fw):
    if fw == "jax":
        return lambda y, n: (jnp.sum(y) > 0).astype(jnp.int32) * (n - 1)
    return lambda y, n: (torch.sum(y) > 0).to(torch.int32) * (n - 1)


def _a2a_default(fw):
    return PKG[fw].pipeline(lambda x: x * 0.5,
                            PKG[fw].all_to_all(_left(fw), _right(fw)))


def _a2a_router(fw):
    return PKG[fw].pipeline(PKG[fw].all_to_all(_left(fw), _right(fw),
                                               router=_router(fw)))


# ---------------------------------------------------------------------------
# port vs reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("build", [_pipeline, _farm, _ffmap, _a2a_default,
                                   _a2a_router],
                         ids=["pipeline", "farm", "ffmap", "a2a_default",
                              "a2a_router"])
def test_device_graph_matches_reference(build):
    out = _both(build, _stream(), mode="device")
    _assert_match(out["torch"], out["jax"])


def test_a2a_capacity_factor_matches_reference():
    # the router sends every item to expert 0 or 2, far past capacity 8
    stream = _stream(n=40, seed=1)
    out = _both(_a2a_router, stream, mode="device", a2a_capacity_factor=0.5)
    _assert_match(out["torch"], out["jax"])
    dropped = sum(not np.any(y) for y in out["torch"])
    assert dropped > 0


def test_a2a_offsets_follow_the_stream_across_microbatches():
    # default routing depends on the absolute stream index of each item
    out = _both(_a2a_default, _stream(n=19), mode="device", microbatch=4)
    _assert_match(out["torch"], out["jax"])


def test_feedback_steps_matches_reference():
    def build(fw):
        return PKG[fw].pipeline(lambda x: x * 0.9 + 0.1,
                                lambda x: XP[fw].tanh(x)).wrap_around()
    out = _both(build, _stream(), mode="device", feedback_steps=3)
    _assert_match(out["torch"], out["jax"])


def test_feedback_cond_matches_reference():
    # lanes leave the loop after different turn counts; the cap bounds it
    def build(fw):
        return PKG[fw].pipeline(lambda x: x * 1.5 + 0.5).wrap_around()

    def cond(fw):
        xp = XP[fw]
        return lambda x: xp.sum(x) < 20.0
    stream = _stream(n=9, width=3, seed=2)
    out = {fw: _compile(fw, build(fw), mode="device", feedback_steps=6,
                        feedback_cond=cond(fw)).run(stream)
           for fw in ("jax", "torch")}
    _assert_match(out["torch"], out["jax"])


def test_feedback_while_freezes_finished_lanes():
    # a lane whose cond is false after one turn keeps exactly that state
    def build(fw):
        return PKG[fw].pipeline(lambda x: x + 1.0).wrap_around()
    stream = [np.float32(100.0), np.float32(0.0)]
    got = _compile("torch", build("torch"), mode="device", feedback_steps=50,
                   feedback_cond=lambda x: x < 5.0).run(stream)
    assert np.asarray(got[0]).tobytes() == np.float32(101.0).tobytes()
    assert float(got[1]) == 5.0


def test_hybrid_host_device_host_matches_reference():
    def build(fw):
        return PKG[fw].pipeline(lambda x: np.asarray(x) * 2.0,
                                lambda x: XP[fw].tanh(x) + 1.0,
                                lambda x: np.asarray(x) - 3.0)
    place = {0: "host", 1: "device", 2: "host"}
    out = {fw: _compile(fw, build(fw), placements=place,
                        microbatch=4).run(_stream(n=11))
           for fw in ("jax", "torch")}
    _assert_match(out["torch"], out["jax"])


def test_hybrid_feedback_loop_matches_reference():
    # a device stage inside a host feedback loop: the boundary goes
    # synchronous with microbatches of one, items leave when cond is false
    def build(fw):
        return PKG[fw].pipeline(lambda x: np.asarray(x) + np.float32(1.0),
                                lambda x: x * 2.0).wrap_around()
    stream = [np.float32(i) for i in range(6)]
    out = {fw: _compile(fw, build(fw), placements={0: "host", 1: "device"},
                        feedback_cond=lambda x: float(x) < 50.0).run(stream)
           for fw in ("jax", "torch")}
    got, want = (sorted(float(y) for y in out[fw]) for fw in ("torch", "jax"))
    assert got == want == [54.0, 62.0, 62.0, 78.0, 94.0, 94.0]


def test_hybrid_dict_items_match_reference():
    def build(fw):
        xp = XP[fw]
        return PKG[fw].pipeline(
            lambda d: d,
            lambda d: {"s": xp.sum(d["a"]) * d["b"], "a": d["a"] + 1.0},
            lambda d: d)
    rng = np.random.default_rng(4)
    stream = [{"a": rng.standard_normal(3).astype(np.float32),
               "b": np.float32(i)} for i in range(7)]
    place = {0: "host", 1: "device", 2: "host"}
    out = {fw: _compile(fw, build(fw), placements=place,
                        microbatch=3).run(stream)
           for fw in ("jax", "torch")}
    for g, w in zip(out["torch"], out["jax"]):
        assert sorted(g) == sorted(w)
        _assert_match([g["s"], g["a"]], [w["s"], w["a"]])


@pytest.mark.parametrize("dtype,want", [(np.float64, np.float32),
                                        (np.int64, np.int32)])
def test_64_bit_inputs_come_back_32_bit(dtype, want):
    def build(fw):
        return PKG[fw].pipeline(lambda x: x * 3 + 1)
    stream = [np.arange(4, dtype=dtype) + i for i in range(5)]
    out = _both(build, stream, mode="device")
    assert out["torch"][0].dtype == out["jax"][0].dtype == want
    _assert_match(out["torch"], out["jax"])


def test_empty_stream():
    r = _compile("torch", _pipeline("torch"), mode="device")
    assert r.run([]) == []


# ---------------------------------------------------------------------------
# port-only invariants
# ---------------------------------------------------------------------------
def _port_a2a_graph():
    return T.pipeline(*_stages("torch"),
                      T.all_to_all(_left("torch"), _right("torch")),
                      T.farm(lambda x: x - 0.5, n=2))


def test_fused_and_unfused_are_byte_identical():
    stream = _stream(n=17)
    g = _port_a2a_graph()
    fused = _compile("torch", g, mode="device")
    unfused = _compile("torch", g, mode="device", fuse=False)
    assert _bytes(fused.run(stream)) == _bytes(unfused.run(stream))
    assert len(fused.stats()["stages"]) == 1
    assert len(unfused.stats()["stages"]) == 6


@pytest.mark.parametrize("inflight", [2, 3])
def test_windowed_and_sync_are_byte_identical(inflight):
    stream = _stream(n=23)
    g = _port_a2a_graph()
    sync = _compile("torch", g, mode="device", microbatch=4, overlap=False)
    win = _compile("torch", g, mode="device", microbatch=4, inflight=inflight)
    one = _compile("torch", g, mode="device", microbatch=4, inflight=1)
    a = win.run(stream)
    assert _bytes(a) == _bytes(sync.run(stream)) == _bytes(one.run(stream))
    assert win.stats()["boundary"]["mode"] == "overlapped"
    assert sync.stats()["boundary"]["mode"] == "sync"


def test_hybrid_windowed_and_sync_are_byte_identical():
    def build():
        return T.pipeline(lambda x: np.asarray(x) + 1.0, *_stages("torch"),
                          T.all_to_all(_left("torch"), _right("torch")),
                          lambda x: np.asarray(x) * 2.0)
    place = {0: "host", 1: "device", 2: "device", 3: "device", 4: "device",
             5: "device", 6: "host"}
    stream = _stream(n=29)
    outs = []
    for overlap in (True, False):
        r = _compile("torch", build(), placements=place, microbatch=4,
                     inflight=3, overlap=overlap)
        assert type(r).__name__ == "HybridRunner"
        outs.append(r.run(stream))
        dev = [s for s in r.stats()["graph"]["stages"]
               if s.get("backend") == "device"]
        assert len(dev) == 1      # five device stages, one boundary
        assert dev[0]["boundary"]["mode"] == ("overlapped" if overlap
                                              else "sync")
    assert _bytes(outs[0]) == _bytes(outs[1])


def test_recompile_reuses_the_segment():
    segment_cache_clear()
    g = _pipeline("torch")
    xs = _stream(n=3)
    a = _compile("torch", g, mode="device").run(xs)
    assert segment_cache_info()["misses"] >= 1
    before = segment_cache_info()["hits"]
    b = _compile("torch", g, mode="device").run(xs)
    assert segment_cache_info()["hits"] > before
    assert _bytes(a) == _bytes(b)


def test_hybrid_shutdown_drains_in_flight_work():
    r = _compile("torch", T.pipeline(lambda x: np.asarray(x),
                                     lambda x: x * 2.0),
                 placements={0: "host", 1: "device"}, microbatch=2,
                 inflight=4)
    r.run_then_freeze()
    for x in _stream(n=9):
        r.offload(x)
    r.shutdown(timeout=10.0)
    assert r.error() is None
    assert not r._skel._alive()


def test_auto_placement_puts_flop_heavy_stages_on_the_device():
    def heavy(x):
        return x * 2.0
    heavy.ff_flops = 1e12
    heavy.ff_cost = 1.0

    def light(x):
        return x + 1.0
    r = T.pipeline(light, heavy).compile(
        config=T.CompileConfig(plan=single_device_plan(device="cpu"),
                               costs={light: 1e-7}))
    targets = [p.target for _, p in r.placements]
    assert targets == ["host", "device"]
    assert type(r).__name__ == "HybridRunner"
    assert [float(y) for y in r.run([np.float32(1.0)])] == [4.0]
