"""The port's model against the reference's, on the CPU, at reduced size.

The reference's parameters (``jax.random`` from a key) are carried across
with ``core.params.from_numpy``; token and activation inputs come from
numpy seeds.  On CPU tensors the port's kernels run their plain versions.
Everything is bf16, so outputs are held to the model-path tolerance of
``tests/test_kernels.py:134-136``: 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core.plan import single_device_plan
from repro.models import attention as JA
from repro.models import moe as JM
from repro.models import ssm as JS
from repro.models.lm import LM as JLM
from repro.models.params import init_params as jinit
from repro.runtime.steps import make_decode_step, make_prefill_step
from repro_torch.configs import get as tget
from repro_torch.core.params import from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.models.lm import LM as TLM
from repro_torch.models.params import count_params, init_params

torch.set_num_threads(1)

TOL = 3e-2
ARCHS = ["mixtral-8x7b", "ff-tiny"]
HYBRID = "zamba2-1.2b"
# the decoder-only configs of the xLSTM/dense/Kimi slice, reduced
DECODERS = ["gemma-7b", "llama3.2-3b", "yi-34b", "mistral-large-123b",
            "kimi-k2-1t-a32b"]
# Kimi-K2's router at a width the reduced config cuts away (E4 top-2):
# 32 experts, top-8, one shared expert, set on both packages' configs
KIMI_WIDE = {"n_experts": 32, "top_k": 8, "n_shared_experts": 1}
LM_CASES = [(a, {}) for a in ARCHS + DECODERS] + \
    [("kimi-k2-1t-a32b", KIMI_WIDE)]


@pytest.fixture(scope="module")
def jplan():
    return single_device_plan()


def _cfgs(arch, **kw):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    for c in (jc, tc):
        for k, v in kw.items():
            setattr(c, k, v)
    return jc, tc


def _carry(tree):
    return from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _x(seed, *shape, scale=0.3):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    a = a * scale
    return jnp.asarray(a).astype(jnp.bfloat16), \
        torch.from_numpy(a).to(torch.bfloat16)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _close_to_scale(got, want, tol=TOL):
    """Whole-model outputs: bf16 rounding differences compound over the
    layers, and the reference's jitted layer scan rounds fewer bf16
    intermediates than an op-by-op run (XLA's excess precision), so the
    absolute part of the tolerance is taken of the output's scale."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _margin(got, want) -> float:
    """max |got - want| over the output's scale (at least 1): the share of
    the 3e-2 tolerance a whole-model output uses."""
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / max(1.0, float(np.abs(want).max())))


# -- attention block -------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [20, 48])
def test_attention_prefill(arch, S, jplan):
    jc, tc = _cfgs(arch, cache_len=32)
    p = jinit(JA.attn_defs(jc, None), jax.random.PRNGKey(1))
    jx, tx = _x(S, 2, S, jc.d_model)
    window = jc.window if jc.attn_kind == "swa" else 0
    pos = np.broadcast_to(np.arange(S)[None], (2, S)).astype(np.int32)
    jo, jcache = jax.jit(lambda x, p, pos: JA.attention(
        x, p, jc, jplan, positions=pos, window=window, cache="init",
        q_block=16, kv_block=16))(jx, p, jnp.asarray(pos))
    to, tcache = TA.attention(tx, _carry(p), tc,
                              positions=torch.from_numpy(pos),
                              window=window, cache="init")
    _close(to, jo)
    for n in ("k", "v"):       # padded, or rolled into the window's ring
        assert tuple(tcache[n].shape) == jcache[n].shape
        _close(tcache[n], jcache[n])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("warm", [False, True])
def test_attention_decode_per_row_positions(arch, warm, jplan):
    """One decode token per row at per-row positions against a filled cache;
    ``warm`` puts Mixtral's positions past its window, on the ring."""
    jc, tc = _cfgs(arch)
    window = jc.window if jc.attn_kind == "swa" else 0
    Sc = window if window else 64
    p = jinit(JA.attn_defs(jc, None), jax.random.PRNGKey(2))
    B = 3
    jx, tx = _x(7, B, 1, jc.d_model)
    jk, tk = _x(8, B, Sc, jc.n_kv_heads, jc.head_dim, scale=1.0)
    jv, tv = _x(9, B, Sc, jc.n_kv_heads, jc.head_dim, scale=1.0)
    pos = np.array([5, 17, Sc - 1], np.int32)
    if warm:
        pos = pos + 3 * Sc
    cpos = pos % Sc if window else pos
    jo, jcache = jax.jit(lambda x, p, pos, cache, cpos: JA.attention(
        x, p, jc, jplan, positions=pos, window=window, cache=cache,
        cache_pos=cpos))(jx, p, jnp.asarray(pos[:, None]),
                         {"k": jk, "v": jv}, jnp.asarray(cpos))
    tcache = {"k": tk.clone(), "v": tv.clone()}
    to, tcache2 = TA.attention(
        tx, _carry(p), tc, positions=torch.from_numpy(pos[:, None]),
        window=window, cache=tcache, cache_pos=torch.from_numpy(cpos))
    assert tcache2 is tcache                     # written in place
    _close(to, jo)
    for n in ("k", "v"):
        _close(tcache[n], jcache[n])


# -- MoE block ---------------------------------------------------------------
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])   # 0.5 drops
def test_moe_block_and_aux_losses(capacity_factor, jplan):
    jc, tc = _cfgs("mixtral-8x7b", capacity_factor=capacity_factor)
    p = jinit(JM.moe_defs(jc, None), jax.random.PRNGKey(3))
    jx, tx = _x(11, 2, 16, jc.d_model, scale=1.0)
    jo, jaux = jax.jit(lambda x, p: JM.moe_block(x, p, jc, jplan))(jx, p)
    to, taux = TM.moe_block(tx, _carry(p), tc)
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == jo.shape
    _close(to, jo)
    for name in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-4)
    bare, none = TM.moe_block(tx, _carry(p), tc, losses=False)
    assert none == {} and torch.equal(bare, to)


# -- whole model -------------------------------------------------------------
def _models(arch, cache_len, **kw):
    jc, tc = _cfgs(arch, **kw)
    params = JLM(jc).init(jax.random.PRNGKey(0))
    return jc, tc, params, _carry(params), cache_len


@pytest.mark.parametrize("arch,kw", LM_CASES,
                         ids=[a + ("-E32K8" if kw else "")
                              for a, kw in LM_CASES])
@pytest.mark.parametrize("S", [20, 40])
def test_lm_prefill_then_four_decode_steps(arch, kw, S, jplan):
    """Prefill logits and caches, then 4 decode steps with per-row
    positions: for Mixtral S=40 outgrows its 32-token window, so the
    prefill rolls the cache into the ring and decode runs on it warm.
    Prints the largest logit error over the output's scale (``-s``), the
    margin left under the tolerance."""
    jc, tc, jp, tp, cache_len = _models(arch, 64, **kw)
    jprefill = jax.jit(make_prefill_step(jc, jplan, cache_len))
    jdecode = jax.jit(make_decode_step(jc, jplan, cache_len))
    tm = TLM(tc)
    B = 2
    toks = np.random.default_rng(S).integers(0, jc.vocab, (B, S),
                                             dtype=np.int32)
    jl, jcache = jprefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                            cache_len=cache_len)
    _close_to_scale(tl, jl)
    worst = _margin(tl, jl)
    for kind in jcache:
        for n in ("k", "v"):
            assert tuple(tcache[kind][n].shape) == jcache[kind][n].shape
            _close_to_scale(tcache[kind][n], jcache[kind][n])
    # feed both the same tokens, so the steps stay comparable
    nxt = np.random.default_rng(S + 1).integers(0, jc.vocab, (4, B, 1),
                                                dtype=np.int32)
    for i in range(4):
        pos = np.full((B,), S + i, np.int32)
        _, jl, jcache = jdecode(jp, jcache, {"token": jnp.asarray(nxt[i]),
                                             "pos": jnp.asarray(pos)})
        tl, tcache = tm.decode_step(tp, tcache,
                                    {"token": torch.from_numpy(nxt[i]),
                                     "pos": torch.from_numpy(pos)})
        assert tuple(tl.shape) == jl.shape
        _close_to_scale(tl, jl)
        worst = max(worst, _margin(tl, jl))
    print(f"[margin] {arch} {kw or ''} S{S}: logits within {worst:.4f} "
          f"of their scale (tolerance {TOL})")


# the families with stub front ends, whose trees LM_CASES does not cover:
# Whisper's enc/dec stacks and enc_norm (LayerNorm w and b), Qwen2-VL's
# dense stack at its 12/2 heads
FRONT_END_CASES = [("whisper-medium", {}),
                   ("qwen2-vl-2b", {"n_heads": 12, "n_kv_heads": 2,
                                    "n_kv_eff": 2})]
TREE_CASES = LM_CASES + [(HYBRID, {}), ("xlstm-125m", {})] + FRONT_END_CASES


@pytest.mark.parametrize("arch,kw", TREE_CASES,
                         ids=[a + ("-E32K8" if "top_k" in kw else "")
                              for a, kw in TREE_CASES])
def test_param_tree_matches_reference_nesting(arch, kw):
    jc, tc = _cfgs(arch, **kw)
    jp = JLM(jc).init(jax.random.PRNGKey(0))
    tp = _carry(jp)
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tdefs = TLM(tc).param_defs()

    def walk(t, d, path=""):
        if isinstance(t, dict):
            assert sorted(t) == sorted(d), path
            for k in t:
                walk(t[k], d[k], f"{path}['{k}']")
        else:
            assert tuple(t.shape) == d.shape == jflat[path].shape, path
            assert t.dtype == d.dtype, path
    walk(tp, tdefs)
    assert count_params(tdefs) == jc.n_params() == tc.n_params()
    assert tc.n_params_active() == jc.n_params_active()


def test_init_draws_from_a_torch_generator():
    _, tc = _cfgs("mixtral-8x7b")
    defs = TLM(tc).param_defs()
    a = init_params(defs, torch.Generator().manual_seed(0))
    b = init_params(defs, torch.Generator().manual_seed(0))
    w = a["stacks"]["moe"]["moe"]["wi"]
    assert torch.equal(w, b["stacks"]["moe"]["moe"]["wi"])
    assert w.dtype == torch.bfloat16 and float(w.float().std()) > 0
    # truncated at two standard deviations of the fan-in scaled normal
    assert float(w.float().abs().max()) <= 2.0 / tc.d_model ** 0.5 + 1e-3
    assert float(a["final_norm"]["w"].abs().max()) == 0.0


# -- Mamba2 block and the hybrid model (Zamba2) --------------------------------
@pytest.mark.parametrize("S", [16, 48, 9])
def test_mamba2_block_prefill_state_then_decode(S, jplan):
    """Prefill (the ssd_scan path, returning the ssm and conv state), then
    two decode steps on that state, written in place.  The reference's init
    draws wB and wC at unit scale (their fan-in axis is the one group), so
    the block's outputs reach the hundreds: held to the output's scale."""
    jc, tc = _cfgs(HYBRID)
    p = jinit(JS.mamba2_defs(jc, None), jax.random.PRNGKey(4))
    tp = _carry(p)
    jx, tx = _x(S, 2, S, jc.d_model, scale=1.0)
    jo, jst = jax.jit(lambda x, p: JS.mamba2_block(
        x, p, jc, jplan, state="init", chunk=jc.gla_chunk))(jx, p)
    to, tst = TS.mamba2_block(tx, tp, tc, state="init", chunk=tc.gla_chunk)
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == jo.shape
    _close_to_scale(to, jo)
    assert tst["ssm"].dtype == torch.float32
    assert tst["conv"].dtype == torch.bfloat16
    for n in ("ssm", "conv"):
        assert tuple(tst[n].shape) == jst[n].shape
        _close_to_scale(tst[n], jst[n])
    jstep = jax.jit(lambda x, p, st: JS.mamba2_block(x, p, jc, jplan,
                                                     state=st))
    for i in range(2):
        jx1, tx1 = _x(100 + i, 2, 1, jc.d_model, scale=1.0)
        jo, jst = jstep(jx1, p, jst)
        ssm = tst["ssm"]
        to, tst2 = TS.mamba2_block(tx1, tp, tc, state=tst)
        assert tst2 is tst and tst["ssm"] is ssm       # written in place
        _close_to_scale(to, jo)
        for n in ("ssm", "conv"):
            _close_to_scale(tst[n], jst[n])


def test_silu_stepwise_rounds_as_the_reference():
    """The Mamba2 block's gates: bit for bit ``jax.nn.silu`` in bf16 (jitted
    or not), where ``F.silu``'s one rounding differs in many elements."""
    jx, tx = _x(12, 4096, scale=3.0)
    want = np.asarray(jax.jit(jax.nn.silu)(jx), np.float32)
    assert np.array_equal(TS.silu_stepwise(tx).float().numpy(), want)
    assert np.array_equal(np.asarray(jax.nn.silu(jx), np.float32), want)
    assert not np.array_equal(
        torch.nn.functional.silu(tx).float().numpy(), want)


def test_dense_mlp_rounds_as_the_reference_op_by_op():
    """The dense GLU MLP in bf16 equals the reference's ``mlp`` run op by op
    bit for bit: its silu rounds every step as ``jax.nn.silu`` does
    (``layers.activation`` -> ``silu_stepwise``).  With ``F.silu``'s one
    rounding the same inputs give other bits.  The products are exact in
    any summation order (x in quarters, wi and wg in eighths; wo selects
    and halves one feature a column), so only the activation's rounding
    can differ."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(21)
    x = rng.integers(-8, 9, (2, 24, 64)).astype(np.float32) / 4
    wi = rng.integers(-4, 5, (64, 256)).astype(np.float32) / 8
    wg = rng.integers(-4, 5, (64, 256)).astype(np.float32) / 8
    wo = np.zeros((256, 64), np.float32)
    wo[np.arange(64) * 4, np.arange(64)] = 0.5
    arrs = {"x": x, "wi": wi, "wg": wg, "wo": wo}
    j = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in arrs.items()}
    t = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in arrs.items()}
    with jax.disable_jit():
        want = np.asarray(JL.mlp(j["x"], j, "silu"), np.float32)
    assert np.array_equal(TL.mlp(t["x"], t, "silu").float().numpy(), want)
    a = TL.mm(t["x"], t["wi"])
    g = torch.nn.functional.silu(TL.mm(t["x"], t["wg"]))
    once = TL.mm(a * g, t["wo"]).to(torch.bfloat16)
    assert not np.array_equal(once.float().numpy(), want)


def test_mamba2_state_defs_match_the_reference():
    jc, tc = _cfgs(HYBRID)
    jdefs = JS.mamba2_state_defs(jc, 3, 4)
    for n, (shape, dtype) in TS.mamba2_state_defs(tc, 3, 4).items():
        assert shape == jdefs[n][0]
        assert str(dtype).removeprefix("torch.") == jnp.dtype(jdefs[n][1]).name


@pytest.mark.parametrize("S", [7, 32, 48])
def test_hybrid_lm_prefill_then_four_decode_steps(S, jplan):
    """Zamba2: prefill logits and caches (per mamba2 layer ``ssm``/``conv``,
    per call of the shared block ``k``/``v``), then 4 decode steps with
    per-row positions.  S=48 outgrows the reduced 32-token window, so the
    shared block's cache is rolled into the ring and decode runs on it;
    prompt lengths are ones the reference's ``chunked_gla`` takes (shorter
    than or a multiple of ``gla_chunk`` 16)."""
    jc, tc, jp, tp, cache_len = _models(HYBRID, 64)
    jprefill = jax.jit(make_prefill_step(jc, jplan, cache_len))
    jdecode = jax.jit(make_decode_step(jc, jplan, cache_len))
    tm = TLM(tc)
    B = 2
    toks = np.random.default_rng(S).integers(0, jc.vocab, (B, S),
                                             dtype=np.int32)
    jl, jcache = jprefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                            cache_len=cache_len)
    _close_to_scale(tl, jl)
    assert sorted(tcache) == sorted(jcache) == ["mamba2", "shared_attn"]
    for kind in jcache:
        assert sorted(tcache[kind]) == sorted(jcache[kind])
        for n in jcache[kind]:
            assert tuple(tcache[kind][n].shape) == jcache[kind][n].shape
            _close_to_scale(tcache[kind][n], jcache[kind][n])
    defs = tm.cache_defs(B, cache_len)
    for kind, leaves in defs.items():
        for n, (shape, dtype) in leaves.items():
            assert tuple(tcache[kind][n].shape) == shape
            assert tcache[kind][n].dtype == dtype
    nxt = np.random.default_rng(S + 1).integers(0, jc.vocab, (4, B, 1),
                                                dtype=np.int32)
    for i in range(4):
        pos = np.full((B,), S + i, np.int32)
        _, jl, jcache = jdecode(jp, jcache, {"token": jnp.asarray(nxt[i]),
                                             "pos": jnp.asarray(pos)})
        tl, tcache = tm.decode_step(tp, tcache,
                                    {"token": torch.from_numpy(nxt[i]),
                                     "pos": torch.from_numpy(pos)})
        assert tuple(tl.shape) == jl.shape
        _close_to_scale(tl, jl)
    for n in ("ssm", "conv"):
        _close_to_scale(tcache["mamba2"][n], jcache["mamba2"][n])
