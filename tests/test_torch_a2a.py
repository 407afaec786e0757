"""The port's all-to-all hop (``repro_torch.kernels.a2a_fused``) against the
reference Pallas kernel and its oracle.

Inputs are made with numpy from a seed and handed to both packages.  The
reference runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode and the jitted ``ref.a2a_fused_ref``.  The port runs its
plain versions (CPU tensors).  Routing (``idx``/``pos``/``keep``) and
int32 outputs must match exactly.  Float outputs may differ by one rounding
of ``x*s - s``: XLA contracts the jitted multiply-add into an FMA, PyTorch's
CPU kernels round the product first — 1 ulp at the operands' magnitude, in
f32, and 1 bf16 ulp compared in f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.a2a_fused import a2a_fused as jax_a2a_fused
from repro.kernels.ref import a2a_fused_ref as jax_a2a_fused_ref
from repro.kernels.ops import router_topk as jax_router_topk_pallas
from repro.kernels.ref import router_topk_ref as jax_router_topk_ref
from repro_torch.kernels import ref as tref
from repro_torch.kernels.a2a_fused import (a2a_combine, a2a_combine_plain,
                                           a2a_fused, a2a_route,
                                           a2a_route_plain)
from repro_torch.kernels.router_topk import (ONE_BLOCK_MAX_T,
                                             THREAD_PATH_MAX_E,
                                             TOKENS_PER_BLOCK, launch_plan,
                                             tile_positions)

torch.set_num_threads(1)

EPS = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}


def _inputs(T, E, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    if dtype == "int32":
        xs = rng.integers(-50, 50, (T, D)).astype(np.int32)
    else:
        xs = rng.standard_normal((T, D)).astype(np.float32)
    return logits, xs


def _experts(E, dtype):
    # plain operators: the same expert functions serve both packages
    if dtype == "int32":
        return tuple((lambda x, s=j + 2: x * s + s) for j in range(E))
    return tuple((lambda x, s=float(j + 1): x * s - s) for j in range(E))


def _jax_xs(xs, dtype):
    return jnp.asarray(xs).astype(dtype)


def _torch_xs(xs, dtype):
    t = torch.from_numpy(xs)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, dtype=np.float32)


def _assert_outputs(out_t, out_j, xs, E, dtype):
    if dtype == "int32":
        assert out_t.dtype == torch.int32
        assert np.array_equal(out_t.numpy(), np.asarray(out_j))
        return
    assert str(out_t.dtype).endswith(dtype)
    # one rounding at the magnitude of the operands x*s and s (s <= E)
    x = _f32(np.asarray(_jax_xs(xs, dtype)))
    scale = (np.abs(x) * E + E).reshape(out_t.shape)
    diff = np.abs(_f32(out_t) - _f32(np.asarray(out_j)))
    assert np.all(diff <= EPS[dtype] * scale), float(diff.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("cap_kind", ["lossless", "overflow", "tight"])
def test_a2a_fused_matches_reference(dtype, cap_kind):
    T, E, D = 32, 3, 5
    logits, xs = _inputs(T, E, D, dtype)
    cap = {"lossless": T, "overflow": max(1, T // E - 3), "tight": 1}[cap_kind]
    jfns = _experts(E, dtype)
    out_j, keep_j = jax_a2a_fused(jnp.asarray(logits), _jax_xs(xs, dtype),
                                  jfns, cap, block_t=8, interpret=True)
    ro, rk = jax.jit(functools.partial(jax_a2a_fused_ref, expert_fns=jfns,
                                       capacity=cap))(
        jnp.asarray(logits), _jax_xs(xs, dtype))
    out_t, keep_t = a2a_fused(torch.from_numpy(logits), _torch_xs(xs, dtype),
                              _experts(E, dtype), cap)
    assert np.array_equal(keep_t.numpy(), np.asarray(keep_j))
    assert np.array_equal(keep_t.numpy(), np.asarray(rk))
    _assert_outputs(out_t, out_j, xs, E, dtype)
    _assert_outputs(out_t, ro, xs, E, dtype)
    if cap_kind == "lossless":
        assert bool(keep_t.all())
    else:
        assert not bool(keep_t.all())
        assert bool((out_t[~keep_t] == 0).all())


@pytest.mark.parametrize("T", [1, 7, 37])
def test_a2a_fused_ragged_tokens(T):
    E, D = 4, 3
    logits, xs = _inputs(T, E, D, "float32", seed=T)
    cap = max(1, T // E)
    jfns = _experts(E, "float32")
    out_j, keep_j = jax_a2a_fused(jnp.asarray(logits), jnp.asarray(xs), jfns,
                                  cap, interpret=True)
    out_t, keep_t = a2a_fused(torch.from_numpy(logits), torch.from_numpy(xs),
                              _experts(E, "float32"), cap)
    assert np.array_equal(keep_t.numpy(), np.asarray(keep_j))
    _assert_outputs(out_t, out_j, xs, E, "float32")


@pytest.mark.parametrize("E", [2, 8, 64])
@pytest.mark.parametrize("cap_kind", ["lossless", "overflow"])
def test_route_matches_reference(E, cap_kind):
    T = 300
    logits, _ = _inputs(T, E, 1, "float32", seed=E)
    cap = T if cap_kind == "lossless" else max(1, T // E - 2)
    _w, idx_j, pos_j, keep_j = jax_router_topk_ref(jnp.asarray(logits), 1, cap)
    idx, pos, keep = a2a_route(torch.from_numpy(logits), cap)
    assert idx.dtype == pos.dtype == torch.int32 and keep.dtype == torch.bool
    assert np.array_equal(idx.numpy(), np.asarray(idx_j)[:, 0])
    assert np.array_equal(pos.numpy(), np.asarray(pos_j)[:, 0])
    assert np.array_equal(keep.numpy(), np.asarray(keep_j)[:, 0])


# the route kernel's grid and positions: the top-1 case of the router's
# multi-block scan, at the edges of its tiles and of its one-block case
# (test_torch_router.edge_ts), with all tokens on one expert and capacities
# 0, 1 and T
ROUTE_EDGES = [(T, E) for E in (1, 8, 384)
               for T in sorted({tt + d for tt in (TOKENS_PER_BLOCK[
                   "warp" if E > THREAD_PATH_MAX_E else "thread"],)
                   for d in (-1, 0, 1, 2 * tt + 5)}
                   | ({ONE_BLOCK_MAX_T, ONE_BLOCK_MAX_T + 1}
                      if E <= THREAD_PATH_MAX_E else set()))]


@pytest.mark.parametrize("one_expert", [False, True])
@pytest.mark.parametrize("T,E", ROUTE_EDGES)
def test_route_tile_positions_at_tile_edges(T, E, one_expert):
    """``tile_positions`` on the route's plan (K = 1) gives the plain
    version's positions, and the Pallas kernel's keep flags in interpret
    mode (the whole hop for E <= 8, with identity-scaled experts; the
    router kernel at K = 1 for E = 384, whose hop would trace 384
    experts)."""
    logits, xs = _inputs(T, E, 2, "float32", seed=T + E)
    if one_expert:
        logits[:, 0] += 30.0
    plan = launch_plan(T, E, 1)
    one_block = T <= (ONE_BLOCK_MAX_T if E <= THREAD_PATH_MAX_E
                      else TOKENS_PER_BLOCK["warp"])
    assert (plan.blocks == 1) == one_block
    idx, pos, _keep = a2a_route_plain(torch.from_numpy(logits), T)
    assert torch.equal(tile_positions(idx[:, None], E, plan)[:, 0], pos)
    for cap in (0, 1, T):
        assert torch.equal(a2a_route(torch.from_numpy(logits), cap)[2],
                           pos < cap)
    if one_expert:
        assert bool((idx == 0).all()) and pos.tolist() == list(range(T))
    if E <= 8:
        _out, keep_j = jax_a2a_fused(jnp.asarray(logits), jnp.asarray(xs),
                                     _experts(E, "float32"), 1, block_t=T,
                                     interpret=True)
        assert np.array_equal((pos < 1).numpy(), np.asarray(keep_j))
    else:
        _w, jidx, jpos, _k = (np.array(t) for t in jax_router_topk_pallas(
            jnp.asarray(logits), 1, 1, T))
        assert np.array_equal(jidx[:, 0], idx.numpy())
        assert np.array_equal(
            tile_positions(torch.from_numpy(jidx), E, plan).numpy(), jpos)


def test_route_ties_take_first_index():
    # equal probabilities: the first expert wins, in both packages
    logits = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 2.0], [5.0, 1.0, 5.0]],
                      np.float32)
    idx, pos, _keep = a2a_route_plain(torch.from_numpy(logits), 8)
    _w, idx_j, _p, _k = jax_router_topk_ref(jnp.asarray(logits), 1, 8)
    assert idx.tolist() == [0, 1, 0] == np.asarray(idx_j)[:, 0].tolist()
    assert pos.tolist() == [0, 0, 1]


def test_combine_is_pure_selection():
    # -0.0, NaN payloads and infinities pass through bit for bit
    ys = torch.tensor([[[-0.0, float("nan")], [1.0, 2.0], [3.0, 4.0]],
                       [[5.0, 6.0], [float("inf"), -0.0], [7.0, 8.0]]])
    idx = torch.tensor([0, 1, 0], dtype=torch.int32)
    keep = torch.tensor([True, True, False])
    out = a2a_combine(ys, idx, keep)
    want = torch.stack([ys[0, 0], ys[1, 1], torch.zeros(2)])
    assert out.view(torch.int32).tolist() == want.view(torch.int32).tolist()
    assert torch.equal(out.view(torch.int32),
                       a2a_combine_plain(ys, idx, keep).view(torch.int32))


def test_cpu_tensors_take_the_plain_versions():
    a2a_route.launches = a2a_combine.launches = 0
    logits, xs = _inputs(16, 2, 4, "float32")
    a2a_fused(torch.from_numpy(logits), torch.from_numpy(xs),
              _experts(2, "float32"), 16)
    assert a2a_route.launches == 0 and a2a_combine.launches == 0


def test_a2a_fused_rejects_mismatched_experts():
    logits = torch.from_numpy(_inputs(8, 2, 4, "float32")[0])
    xs = torch.from_numpy(_inputs(8, 2, 4, "float32")[1])
    with pytest.raises(ValueError, match="agree on output"):
        a2a_fused(logits, xs, (lambda x: x, lambda x: torch.sum(x)), 8)
    with pytest.raises(ValueError, match="experts"):
        a2a_fused(logits, xs, (lambda x: x,), 8)


def test_scalar_output_experts():
    T, E = 16, 2
    logits, xs = _inputs(T, E, 4, "float32", seed=3)
    out_j, _ = jax_a2a_fused(jnp.asarray(logits), jnp.asarray(xs),
                             (jnp.sum, jnp.prod), T, interpret=True)
    out_t, _ = a2a_fused(torch.from_numpy(logits), torch.from_numpy(xs),
                         (torch.sum, torch.prod), T)
    assert out_t.shape == (T,)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_torch_oracle_matches_jax_oracle(dtype):
    T, E, D = 24, 3, 4
    logits, xs = _inputs(T, E, D, dtype, seed=7)
    cap = 5
    jfns = _experts(E, dtype)
    ro, rk = jax.jit(functools.partial(jax_a2a_fused_ref, expert_fns=jfns,
                                       capacity=cap))(
        jnp.asarray(logits), _jax_xs(xs, dtype))
    to, tk = tref.a2a_fused_ref(torch.from_numpy(logits), _torch_xs(xs, dtype),
                                _experts(E, dtype), cap)
    assert np.array_equal(tk.numpy(), np.asarray(rk))
    _assert_outputs(to, ro, xs, E, dtype)


# ---------------------------------------------------------------------------
# the other oracles of kernels/ref.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,hkv", [(True, 0, 2), (True, 3, 1),
                                               (False, 0, 4)])
def test_attention_oracle_matches_jax(causal, window, hkv):
    from repro.kernels.ref import attention_ref
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 4, 5, 8)).astype(np.float32)
    k = rng.standard_normal((2, hkv, 7, 8)).astype(np.float32)
    v = rng.standard_normal((2, hkv, 7, 8)).astype(np.float32)
    want = attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window)
    got = tref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ssd_scan_oracle_matches_jax():
    from repro.kernels.ref import ssd_scan_ref
    rng = np.random.default_rng(12)
    q, k = (rng.standard_normal((1, 2, 9, 4)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((1, 2, 9, 3)).astype(np.float32)
    log_a = -np.abs(rng.standard_normal((1, 2, 9))).astype(np.float32)
    want = ssd_scan_ref(*(jnp.asarray(a) for a in (q, k, v, log_a)))
    got = tref.ssd_scan_ref(*(torch.from_numpy(a) for a in (q, k, v, log_a)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_topk_oracle_matches_jax(top_k):
    rng = np.random.default_rng(13)
    logits = rng.standard_normal((40, 6)).astype(np.float32)
    want = jax_router_topk_ref(jnp.asarray(logits), top_k, 9)
    got = tref.router_topk_ref(torch.from_numpy(logits), top_k, 9)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-7)
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
