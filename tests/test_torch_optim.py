"""The port's optimizers, schedules and gradient compression against the
reference's, on the CPU.

Inputs come from numpy seeds.  The reference's updates run op by op
(un-jitted), so each of its steps rounds as the port's does.  Tolerances,
each a few ulps above what these inputs measure:

* AdamW: parameters and moments within 1 ulp of their type (``pow`` comes
  from another math library);
* the global norm within 4 fp32 ulps (measured 3: the sums of squares run
  in another order) and the clipped grads within 2 ulps of their type;
* Adafactor: its moments within 4 fp32 ulps (measured 4: the row and column
  means sum in another order); bf16 parameters exactly; fp32 parameters
  within 64 fp32 ulps of the update's size (measured 17: the moments' ulps
  pass through ``rsqrt`` and the update's RMS), where an ulp of a parameter
  that moved by lr x step is the wrong yardstick;
* the schedules within 2 fp32 ulps (measured 2: ``cos`` from another math
  library); the int8 compression exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as J
from repro_torch import optim as T
from repro_torch.core.params import from_numpy

torch.set_num_threads(1)


def _tree(seed, dtype=np.float32, scale=1.0):
    """A parameter-like tree: matrices (decayed, factored by Adafactor at
    min_dim_factored=8), a stacked 3-D leaf and vectors."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 24), "stack": {"a": (2, 12, 9), "b": (5,)},
              "bias": (24,)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(dtype)
    return draw(shapes)


def _jtree(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype or a.dtype), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _within_ulps(got, want, dtype, ulps=1, of=None):
    """|got - want| <= ulps x the spacing of ``dtype`` at the values (at
    ``of``'s magnitude, if given)."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    eps = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7}[dtype]
    mag = np.maximum(np.abs(got), np.abs(want)) if of is None else \
        np.full(got.shape, float(np.abs(of).max()))
    spacing = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-38)))) * eps
    bad = np.abs(got - want) > ulps * spacing
    assert not bad.any(), (f"{bad.sum()}/{bad.size} beyond {ulps} ulp "
                           f"(max {(np.abs(got - want) / spacing).max()}): "
                           f"{got[bad][:4]} vs {want[bad][:4]}")


def _pairs(a, b):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k])
    else:
        yield a, b


P0 = _tree(0)


def _run_both(make_j, make_t, dtype, steps=3, lr=3e-2):
    """``steps`` updates of both optimizers from one state, on the same
    fp32 grads; returns both (params, state)."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    p0 = P0
    jp, tp = _jtree(p0, jdt), from_numpy(p0, "cpu", dtype)
    jo, to = make_j(), make_t()
    js, ts = jo.init(jp), to.init(tp)
    for i in range(steps):
        g = _tree(10 + i, scale=0.1 * (i + 1))
        jp, js = jo.update(_jtree(g), js, jp, lr)
        tp, ts = to.update(from_numpy(g, "cpu"), ts, tp, lr)
    return (jp, js), (tp, ts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_matches_the_reference(dtype, wd):
    (jp, js), (tp, ts) = _run_both(lambda: J.AdamW(weight_decay=wd),
                                   lambda: T.AdamW(weight_decay=wd), dtype)
    for a, b in _pairs(tp, jp):
        assert a.dtype == dtype
        _within_ulps(a, b, dtype)
    for name in ("m", "v"):
        for a, b in _pairs(ts[name], js[name]):
            assert a.dtype == torch.float32
            _within_ulps(a, b, torch.float32)
    assert int(ts["count"]) == int(js["count"]) == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adafactor_matches_the_reference(dtype, wd):
    (jp, js), (tp, ts) = _run_both(
        lambda: J.Adafactor(min_dim_factored=8, weight_decay=wd),
        lambda: T.Adafactor(min_dim_factored=8, weight_decay=wd), dtype)
    assert set(ts["s"]["w"]) == {"vr", "vc"} and set(ts["s"]["bias"]) == {"v"}
    for (a, b), (p0, _) in zip(_pairs(tp, jp), _pairs(P0, P0)):
        if dtype == torch.bfloat16:
            _within_ulps(a, b, dtype, ulps=0)
        else:
            _within_ulps(a, b, dtype, ulps=64, of=_np(b) - p0)
    for a, b in _pairs(ts["s"], js["s"]):
        _within_ulps(a, b, torch.float32, ulps=4)
    assert int(ts["count"]) == int(js["count"]) == 3


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    g = _tree(3)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        jc, jn = J.clip_by_global_norm(_jtree(g, jdt), max_norm)
        tc, tn = T.clip_by_global_norm(from_numpy(g, "cpu", dtype), max_norm)
        _within_ulps(tn, jn, torch.float32, ulps=4)
        for a, b in _pairs(tc, jc):
            assert a.dtype == dtype
            _within_ulps(a, b, dtype, ulps=2)


@pytest.mark.parametrize("name,args", [
    ("linear_warmup", (3e-3, 20)), ("linear_warmup", (1e-2, 0)),
    ("cosine_warmup", (3e-3, 20, 50)), ("cosine_warmup", (3e-3, 5, 6)),
    ("cosine_warmup", (1e-3, 0, 1))])
def test_schedules_match_the_reference(name, args):
    jf, tf = getattr(J, name)(*args), getattr(T, name)(*args)
    for step in range(51):
        want = jf(jnp.int32(step))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = tf(s)
            assert got.dtype == torch.float32
            _within_ulps(got, want, torch.float32, ulps=2)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_int8_compression_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(300) * rng.uniform(0.1, 10)).astype(np.float32)
    jq, js = J.int8_compress(jnp.asarray(x))
    tq, ts = T.int8_compress(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(T.int8_decompress(tq, ts).numpy(),
                                  np.asarray(J.int8_decompress(jq, js)))


def test_error_feedback_equals_the_reference():
    grads = [_tree(20 + i, scale=0.3) for i in range(4)]
    jerr = jax.tree.map(jnp.zeros_like, _jtree(grads[0]))
    terr = from_numpy(jax.tree.map(np.asarray, jerr), "cpu")
    for g in grads:
        jsent, jerr = J.ef_compress_grads(_jtree(g), jerr)
        tsent, terr = T.ef_compress_grads(from_numpy(g, "cpu"), terr)
        for a, b in list(_pairs(tsent, jsent)) + list(_pairs(terr, jerr)):
            np.testing.assert_array_equal(_np(a), _np(b))


# -- the reference's own properties, on the port -------------------------------
def test_adamw_first_step_matches_closed_form():
    opt = T.AdamW(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    params = {"w": torch.tensor([1.0, -2.0])}
    grads = {"w": torch.tensor([0.5, -1.0])}
    expected = params["w"] - 0.1 * grads["w"] / (grads["w"].abs() + 1e-8)
    new_p, state = opt.update(grads, opt.init(params), params, lr=0.1)
    np.testing.assert_allclose(new_p["w"].numpy(), expected.numpy(),
                               rtol=1e-4)
    assert new_p["w"] is params["w"]           # updated in place
    assert int(state["count"]) == 1


@pytest.mark.parametrize("make_opt", [lambda: T.AdamW(weight_decay=0.0),
                                      lambda: T.Adafactor(min_dim_factored=2)])
def test_optimizers_converge_on_quadratic(make_opt):
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(32)
                         .astype(np.float32) * 2.0)
    params = {"w": torch.zeros(32), "m": torch.zeros(4, 32)}

    def loss(p):
        return torch.sum((p["w"] - a) ** 2) + torch.sum(p["m"] ** 2)

    opt = make_opt()
    state = opt.init(params)
    l0 = float(loss(params))
    for _ in range(200):
        g = {"w": 2 * (params["w"] - a), "m": 2 * params["m"]}
        params, state = opt.update(g, state, params, lr=0.05)
    assert float(loss(params)) < 0.05 * l0


def test_clip_by_global_norm_scales_to_the_bound():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((9,), 4.0)}
    clipped, gn = T.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(np.sqrt(180), rel=1e-5)
    after = np.sqrt(sum(float((x * x).sum()) for x in clipped.values()))
    assert after == pytest.approx(1.0, rel=1e-4)


def test_adafactor_state_is_factored():
    opt = T.Adafactor(min_dim_factored=8)
    st = opt.init({"big": torch.zeros(16, 32), "small": torch.zeros(4)})
    assert tuple(st["s"]["big"]["vr"].shape) == (16,)
    assert tuple(st["s"]["big"]["vc"].shape) == (32,)
    assert set(st["s"]["small"]) == {"v"}


def test_make_optimizer_names():
    assert set(T.make_optimizer("adamw").init({"w": torch.zeros(2)})) == \
        {"m", "v", "count"}
    assert set(T.make_optimizer("adafactor").init({"w": torch.zeros(2)})) \
        == {"s", "count"}
    with pytest.raises(ValueError):
        T.make_optimizer("sgd")
