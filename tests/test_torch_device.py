"""The port's device lowerings, parameters and cost model against the
reference, on the CPU.

``core/device.py``: ``expert_capacity`` must equal the reference exactly;
``feedback_scan``/``feedback_while`` and ``a2a_dispatch`` must agree with
the reference lowerings (jitted, vmapped) on shared numpy inputs — floats to
a few f32 ulps (rtol 1e-5, atol 1e-6: XLA's FMA contraction and ``tanh``),
turn counts and routing exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device as jdev
from repro_torch.core import device as tdev
from repro_torch.core import perf_model as pm
from repro_torch.core.params import from_numpy
from repro_torch.core.tree import canonical_dtype, stack_items

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("tokens,experts,k,cf", [
    (4096, 8, 1, 1.25), (512, 8, 1, 1.25), (100, 3, 2, 1.0), (7, 4, 1, 0.5),
    (64, 64, 1, 2.0), (1, 8, 1, 1.0)])
def test_expert_capacity_matches_reference(tokens, experts, k, cf):
    assert tdev.expert_capacity(tokens, experts, k, cf) == \
        jdev.expert_capacity(tokens, experts, k, cf)


def test_feedback_scan_matches_reference():
    x0 = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)

    def jstep(s):
        return s * 0.8 + jnp.tanh(s), jnp.sum(s)
    want_s, want_e = jax.jit(jax.vmap(
        lambda x: jdev.feedback_scan(jstep, x, 4)))(jnp.asarray(x0))

    def tstep(s):
        return s * 0.8 + torch.tanh(s), torch.sum(s, dim=-1)
    got_s, got_e = tdev.feedback_scan(tstep, torch.from_numpy(x0), 4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=RTOL, atol=ATOL)
    # lax.scan stacks emits per lane; the batched loop stacks turns first
    np.testing.assert_allclose(got_e.numpy().T, np.asarray(want_e),
                               rtol=RTOL, atol=ATOL)
    assert tdev.feedback_scan(tstep, torch.from_numpy(x0), 4,
                              collect=False)[1] is None


def test_feedback_while_matches_reference():
    x0 = np.array([[0.5, 0.1], [3.0, 4.0], [-2.0, 0.0], [10.0, 10.0]],
                  np.float32)

    def jcond(s):
        return jnp.sum(s) < 6.0
    want_s, want_k = jax.jit(jax.vmap(lambda x: jdev.feedback_while(
        lambda s: (s * 1.25 + 0.5, 0.0), x, jcond, max_steps=7)))(
        jnp.asarray(x0))
    got_s, got_k = tdev.feedback_while(
        lambda s: (s * 1.25 + 0.5, None), torch.from_numpy(x0),
        lambda s: s.sum(-1) < 6.0, max_steps=7)
    assert got_k.tolist() == np.asarray(want_k).tolist()
    assert got_k.tolist()[3] == 1 and max(got_k.tolist()) == 7
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("router", [False, True])
@pytest.mark.parametrize("cf", [None, 0.75])
def test_a2a_dispatch_matches_reference(router, cf):
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((21, 4)).astype(np.float32)
    offset = 6
    nR = 3
    jleft = [lambda x: x + 1.0, lambda x: x * 2.0, lambda x: -x]
    tleft = [lambda x: x + 1.0, lambda x: x * 2.0, lambda x: -x]
    jright = [lambda x, s=float(j + 1): jnp.tanh(x) * s for j in range(nR)]
    tright = [lambda x, s=float(j + 1): torch.tanh(x) * s for j in range(nR)]
    jr = (lambda y, n: jnp.argmax(y) % n) if router else None
    tr = (lambda y, n: torch.argmax(y) % n) if router else None
    t_idx = np.arange(offset, offset + len(xs), dtype=np.int32)
    want = jax.jit(jdev.a2a_dispatch(jleft, jright, router=jr,
                                     capacity_factor=cf))(
        jnp.asarray(xs), jnp.asarray(t_idx))
    got = tdev.a2a_dispatch(tleft, tright, router=tr, capacity_factor=cf)(
        torch.from_numpy(xs), torch.from_numpy(t_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    zero_rows = ~np.any(np.asarray(want), axis=1)
    assert np.array_equal(~np.any(got.numpy(), axis=1), zero_rows)
    if cf is None:
        assert not zero_rows.any()
    elif router:   # argmax % 3 favours expert 0 past its 8 slots
        assert zero_rows.any()


def test_farm_map_on_one_device_is_the_batched_call():
    f = tdev.farm_map(lambda xs: xs * 2, None)
    assert torch.equal(f(torch.ones(3)), torch.full((3,), 2.0))
    # two positions with no ranks behind them (an abstract mesh) cannot
    # run; over live ranks the farm is SPMD (tests/test_torch_spmd.py)
    mesh = type("M", (), {"shape": {"data": 2}})()
    with pytest.raises(RuntimeError, match="abstract mesh"):
        tdev.farm_map(lambda xs: xs, mesh)


# ---------------------------------------------------------------------------
# parameters and the host<->device boundary
# ---------------------------------------------------------------------------
def test_from_numpy_keeps_nesting_and_dtype():
    params = {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 7,
              "layers": [{"b": jnp.ones(2, jnp.float32)},
                         {"b": jnp.zeros(2, jnp.int32)}],
              "pair": (jnp.float32(2.5), jnp.arange(3))}
    host = jax.tree.map(np.asarray, params)
    got = from_numpy(host, "cpu")
    assert got["w"].dtype == torch.bfloat16
    assert got["w"].float().numpy().tobytes() == \
        np.asarray(params["w"], np.float32).tobytes()
    assert got["layers"][0]["b"].dtype == torch.float32
    assert got["layers"][1]["b"].dtype == torch.int32
    assert isinstance(got["pair"], tuple) and got["pair"][0].shape == ()
    cast = from_numpy(host, "cpu", dtype=torch.bfloat16)
    assert cast["layers"][0]["b"].dtype == torch.bfloat16
    assert cast["layers"][1]["b"].dtype == torch.int32


@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.uint64,
                                   np.complex128, np.float16, np.bool_,
                                   np.uint8])
def test_boundary_dtypes_match_jnp_asarray(dtype):
    a = np.ones(3, dtype)
    want = np.asarray(jnp.asarray(a)).dtype
    assert canonical_dtype(a.dtype) == want
    assert stack_items([a, a]).dtype == want
    assert stack_items([{"x": a}, {"x": a}])["x"].dtype == want


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------
def test_h100_roofline():
    terms = pm.roofline(989e12, 3.35e12, 0.0, 1)
    assert terms.compute_s == pytest.approx(1.0)
    assert terms.memory_s == pytest.approx(1.0)
    assert pm.roofline(1e9, 1e12, 0.0, 1).dominant == "memory"


def test_calibration_uses_its_own_cache_file(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_FF_CACHE", str(tmp_path))
    # the reference's file must never be read
    (tmp_path / "calibration.json").write_text(json.dumps(
        {"version": 1, "autotune": {"device_overlap:window":
                                    {"inflight": 9}}}))
    pm.reset_calibration()
    pm.reset_autotuned()
    try:
        assert pm.lookup_autotuned("device_overlap:window") is None
        assert pm.get_calibration(measure=False).source == "default"
        c = pm.calibrate(cache=True)
        assert c.source == "measured" and c.queue_hop_s > 0
        path = tmp_path / "torch_calibration.json"
        d = json.loads(path.read_text())
        d["autotune"] = {"device_overlap:window": {"inflight": 3}}
        path.write_text(json.dumps(d))
        pm.reset_calibration()
        pm.reset_autotuned()
        assert pm.get_calibration(measure=False).source == "cached"
        assert pm.lookup_autotuned("device_overlap:window") == {"inflight": 3}
    finally:
        pm.reset_calibration()
        pm.reset_autotuned()


def test_farm_width_algebra():
    assert pm.choose_farm_width(1e-3, 64, overhead=1e-4) == 10
    assert pm.choose_farm_width(1e-3, 4, overhead=1e-4) == 4
    assert pm.pipeline_service_time([1.0, 3.0, 2.0]) == 3.0
    assert pm.a2a_service_time(4.0, 9.0, 2, 3) == 3.0
