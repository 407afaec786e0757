"""The port's encoder-decoder family (Whisper) against the reference's, on the
CPU, at reduced size: LayerNorm, the ``enc`` block, ``cross_kv`` and
``cross_attention``, the ``dec`` block with its nested cache, the whole
model's prefill (frames and tokens) and decode, and ``LM.loss`` with its
gradient.

The reference's parameters (``jax.random`` from a key) are carried across
with ``core.params.from_numpy``; frames and tokens come from numpy seeds.
On CPU tensors the port's kernels run their plain versions.  The reference
runs jitted with XLA's excess precision off
(``xla_allow_excess_precision=False``), which rounds every bf16 step its
code asks for, as an op-by-op run does (equal here, bit for bit): reduced
Whisper's attention is sharply peaked (the reference's init scales wq, wk
and wv by the fan-in of their head axis) and its residual stream reaches
tens after one block, so a one-ulp difference moves the logits by hundredths
of their scale.  The default jit keeps some bf16 intermediates in fp32 and
is itself 0.032 of the logits' scale away from the op-by-op reference at
S 21.  Whole-model outputs are held to 3e-2 of their scale, as
``tests/test_torch_models.py`` holds the other families, and ``-s`` prints
the margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core.plan import single_device_plan
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lm as JLMmod
from repro.models.lm import LM as JLM
from repro.runtime.steps import make_decode_step, make_prefill_step
from repro_torch.configs import get as tget
from repro_torch.core.params import from_numpy
from repro_torch.core.plan import single_device_plan as tplan
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.kernels.gelu_stepwise import (gelu_stepwise,
                                               gelu_stepwise_bwd,
                                               gelu_stepwise_plain,
                                               gelu_stepwise_vjp_plain)
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLMmod
from repro_torch.models.lm import LM as TLM
from repro_torch.runtime import steps as tsteps

torch.set_num_threads(1)

ARCH = "whisper-medium"
TOL = 3e-2
NO_EXCESS = {"xla_allow_excess_precision": False}
S_ENC = 48
CACHE_LEN = 64


@pytest.fixture(scope="module")
def jplan():
    return single_device_plan()


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)


def _cfgs():
    return jget(ARCH).reduced(), tget(ARCH).reduced()


def _carry(tree):
    return from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _x(seed, *shape, scale=0.3):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    a = a * scale
    return jnp.asarray(a).astype(jnp.bfloat16), \
        torch.from_numpy(a).to(torch.bfloat16)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_to_scale(got, want, tol=TOL):
    """bf16 rounding differences compound over the blocks: the absolute
    part of the tolerance is taken of the output's scale (at least 1)."""
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _margin(got, want) -> float:
    want = _f32(want)
    return float(np.abs(_f32(got) - want).max()
                 / max(1.0, float(np.abs(want).max())))


def _layer(tree, i):
    return jax.tree.map(lambda t: t[i], tree)


# -- LayerNorm ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layer_norm_matches_the_reference(dtype):
    """eps 1e-5 (one row's variance, ~1e-6, is where eps tells), statistics
    in fp32, one rounding back to x's type.  The mean and variance are
    summed in another order, so a bf16 output on a rounding boundary may
    fall one bf16 step away (1 of 36,864 here); f32 within 1e-5."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 9, 1024)) * 20 + 3).astype(np.float32)
    x[0, 0] = 0.5 + 1e-3 * rng.standard_normal(1024)
    w = rng.standard_normal(1024).astype(np.float32)
    b = rng.standard_normal(1024).astype(np.float32)
    jx, jw, jb = (jnp.asarray(a).astype(dtype) for a in (x, w, b))
    want = _f32(_compiled(JL.layer_norm, jx, jw, jb)(jx, jw, jb))
    tx, tw, tb = (torch.from_numpy(_f32(a)).to(getattr(torch, dtype))
                  for a in (jx, jw, jb))
    got = TL.layer_norm(tx, tw, tb)
    assert got.dtype == tx.dtype
    if dtype == "bfloat16":
        np.testing.assert_allclose(_f32(got), want, rtol=2.0 ** -7, atol=0)
        assert (_f32(got) != want).sum() <= 4
    else:
        np.testing.assert_allclose(_f32(got), want, rtol=1e-5, atol=1e-5)


def test_gelu_stepwise_rounds_as_the_reference():
    """The dense MLP's gelu: bit for bit ``jax.nn.gelu`` in bf16 as its code
    rounds it (excess precision off, or op by op), where ``F.gelu``'s one
    rounding differs in many elements."""
    jx, tx = _x(12, 65536, scale=3.0)
    want = _f32(_compiled(jax.nn.gelu, jx)(jx))
    assert np.array_equal(_f32(gelu_stepwise(tx)), want)
    assert np.array_equal(_f32(jax.nn.gelu(jx)), want)
    assert not np.array_equal(
        _f32(torch.nn.functional.gelu(tx, approximate="tanh")), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_stepwise_wrapper_runs_its_plain_version_on_the_cpu(dtype):
    """On a CPU tensor the kernel's wrapper is its plain version, forward and
    gradient bit for bit, and counts no launch; the gradient is
    ``gelu_stepwise_vjp_plain``, XLA's VJP step by step, which
    ``test_gelu_stepwise_gradient_is_the_references`` holds to
    ``jax.vjp``."""
    g = (torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 37, 64), dtype=np.float32)) * 3).to(dtype)
    dy = torch.randn(g.shape, generator=torch.Generator().manual_seed(6)
                     ).to(dtype)
    before = (gelu_stepwise.launches, gelu_stepwise_bwd.launches)
    a = g.clone().requires_grad_(True)
    got = gelu_stepwise(a)
    assert got.dtype == dtype and torch.equal(got, gelu_stepwise_plain(g))
    (ga,) = torch.autograd.grad(got, a, dy)
    assert torch.equal(ga, gelu_stepwise_vjp_plain(g, dy))
    assert torch.equal(gelu_stepwise_bwd(g, dy), ga)
    assert (gelu_stepwise.launches, gelu_stepwise_bwd.launches) == before


# -- blocks ------------------------------------------------------------------
@pytest.mark.parametrize("S", [17, S_ENC])
def test_enc_block_matches_the_reference(S, jplan):
    """The encoder block: the dense block with non-causal attention (the
    kernel's ``causal=False`` path) and no cache."""
    jc, tc = _cfgs()
    p = _layer(JLM(jc).init(jax.random.PRNGKey(1))["stacks"]["enc"], 0)
    jx, tx = _x(S, 2, S, jc.d_model)
    pos = np.broadcast_to(np.arange(S)[None], (2, S)).astype(np.int32)
    f = _compiled(lambda x, p, pos: JLMmod.apply_block(
        "enc", x, p, jc, jplan, mode="prefill", cache="init",
        positions=pos)[0], jx, p, jnp.asarray(pos))
    want = f(jx, p, jnp.asarray(pos))
    got, cache, aux = TLMmod.apply_block("enc", tx, _carry(p), tc,
                                         cache="init",
                                         positions=torch.from_numpy(pos))
    assert cache is None and aux == {}
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _close_to_scale(got, want)


@pytest.mark.parametrize("Sq", [1, 20])
def test_cross_kv_and_cross_attention_match_the_reference(Sq, jplan):
    """k/v from the encoder's output, then every query (1 at decode, 20 at
    prefill) against all 48 encoder positions."""
    jc, tc = _cfgs()
    p = JLM(jc).init(jax.random.PRNGKey(2))["stacks"]["dec"]["xattn"]
    p = _layer(p, 1)
    je, te = _x(5, 2, S_ENC, jc.d_model, scale=1.0)
    jx, tx = _x(6 + Sq, 2, Sq, jc.d_model, scale=1.0)
    fkv = _compiled(lambda e, p: JA.cross_kv(e, p, jc, jplan), je, p)
    jkv = fkv(je, p)
    tkv = TA.cross_kv(te, _carry(p))
    for n in ("k", "v"):
        assert tuple(tkv[n].shape) == jkv[n].shape == (2, S_ENC,
                                                       jc.n_kv_heads,
                                                       jc.head_dim)
        _close_to_scale(tkv[n], jkv[n])
    fx = _compiled(lambda x, p, kv: JA.cross_attention(x, p, kv, jc, jplan),
                   jx, p, jkv)
    want = fx(jx, p, jkv)
    got = TA.cross_attention(tx, _carry(p), _carry(jkv))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _close_to_scale(got, want)


def test_dec_block_prefill_then_decode(jplan):
    """The decoder block: prefill builds ``{"self": {k, v}, "cross": {k,
    v}}`` (self padded to the cache length, cross at the encoder's length);
    a decode step writes its k/v into ``self`` in place and reads
    ``cross``."""
    jc, tc = _cfgs()
    for c in (jc, tc):
        c.cache_len = 32
    p = _layer(JLM(jc).init(jax.random.PRNGKey(3))["stacks"]["dec"], 0)
    tp = _carry(p)
    je, te = _x(7, 2, S_ENC, jc.d_model, scale=1.0)
    jx, tx = _x(8, 2, 20, jc.d_model)
    pos = np.broadcast_to(np.arange(20)[None], (2, 20)).astype(np.int32)
    fpre = _compiled(lambda x, p, e, pos: JLMmod.apply_block(
        "dec", x, p, jc, jplan, mode="prefill", cache="init", positions=pos,
        enc_out=e)[:2], jx, p, je, jnp.asarray(pos))
    jo, jcache = fpre(jx, p, je, jnp.asarray(pos))
    to, tcache, _ = TLMmod.apply_block("dec", tx, tp, tc, cache="init",
                                       positions=torch.from_numpy(pos),
                                       enc_out=te)
    _close_to_scale(to, jo)
    assert sorted(tcache) == ["cross", "self"]
    for part in ("self", "cross"):
        for n in ("k", "v"):
            assert tuple(tcache[part][n].shape) == jcache[part][n].shape
            _close_to_scale(tcache[part][n], jcache[part][n])
    assert tcache["self"]["k"].shape[1] == 32
    assert tcache["cross"]["k"].shape[1] == S_ENC
    jx1, tx1 = _x(9, 2, 1, jc.d_model)
    p1 = np.array([20, 23], np.int32)
    fdec = _compiled(lambda x, p, c, pos, cpos: JLMmod.apply_block(
        "dec", x, p, jc, jplan, mode="decode", cache=c, positions=pos,
        pos_offset=cpos)[:2], jx1, p, jcache, jnp.asarray(p1[:, None]),
        jnp.asarray(p1))
    jo, jcache = fdec(jx1, p, jcache, jnp.asarray(p1[:, None]),
                      jnp.asarray(p1))
    k_self = tcache["self"]["k"]
    to, tcache2, _ = TLMmod.apply_block(
        "dec", tx1, tp, tc, cache=tcache, positions=torch.from_numpy(
            p1[:, None]), pos_offset=torch.from_numpy(p1))
    assert tcache2["self"]["k"] is k_self            # written in place
    _close_to_scale(to, jo)
    for part in ("self", "cross"):
        for n in ("k", "v"):
            _close_to_scale(tcache2[part][n], jcache[part][n])


# -- whole model ---------------------------------------------------------------
def _models():
    jc, tc = _cfgs()
    params = JLM(jc).init(jax.random.PRNGKey(0))
    return jc, tc, params, _carry(params)


def _frames(seed, B, S):
    a = (np.random.default_rng(seed).standard_normal(
        (B, S, 64), dtype=np.float32) * 0.1)
    return jnp.asarray(a).astype(jnp.bfloat16), \
        torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("S", [20, 40])
def test_whisper_prefill_then_four_decode_steps(S, jplan):
    """48 frames through the encoder, S decoder tokens, through both
    packages' ``make_prefill_step`` / ``make_decode_step``: the prefill's
    logits and both caches (``self`` padded to 64, ``cross`` at 48), then 4
    decode steps with per-row positions on the nested cache.  Prints the
    largest logit error over the logits' scale (``-s``)."""
    jc, tc, jp, tp = _models()
    B = 2
    jfr, tfr = _frames(S, B, S_ENC)
    toks = np.random.default_rng(S + 1).integers(0, jc.vocab, (B, S),
                                                 dtype=np.int32)
    jb = {"frames": jfr, "tokens": jnp.asarray(toks)}
    jprefill = _compiled(make_prefill_step(jc, jplan, CACHE_LEN), jp, jb)
    jl, jcache = jprefill(jp, jb)
    tl, tcache = tsteps.make_prefill_step(tc, tplan("cpu"), CACHE_LEN)(
        tp, {"frames": tfr, "tokens": torch.from_numpy(toks)})
    tdecode = tsteps.make_decode_step(tc, tplan("cpu"), CACHE_LEN)
    assert tuple(tl.shape) == jl.shape == (B, 1, jc.vocab)
    _close_to_scale(tl, jl)
    worst = _margin(tl, jl)
    assert sorted(tcache) == sorted(jcache) == ["dec"]
    for part in ("self", "cross"):
        for n in ("k", "v"):
            assert tuple(tcache["dec"][part][n].shape) == \
                jcache["dec"][part][n].shape
            _close_to_scale(tcache["dec"][part][n], jcache["dec"][part][n])
    nxt = np.random.default_rng(S + 2).integers(0, jc.vocab, (4, B, 1),
                                                dtype=np.int32)
    jdecode = None
    for i in range(4):
        pos = np.array([S + i, S + 2 * i], np.int32)
        db = {"token": jnp.asarray(nxt[i]), "pos": jnp.asarray(pos)}
        if jdecode is None:
            jdecode = _compiled(make_decode_step(jc, jplan, CACHE_LEN), jp,
                                jcache, db)
        _, jl, jcache = jdecode(jp, jcache, db)
        _, tl, tcache = tdecode(tp, tcache,
                                {"token": torch.from_numpy(nxt[i]),
                                 "pos": torch.from_numpy(pos)})
        assert tuple(tl.shape) == jl.shape
        _close_to_scale(tl, jl)
        worst = max(worst, _margin(tl, jl))
    _close_to_scale(tcache["dec"]["self"]["k"], jcache["dec"]["self"]["k"])
    print(f"[margin] {ARCH} S_enc {S_ENC} S{S}: logits within {worst:.4f} "
          f"of their scale (tolerance {TOL})")


@pytest.mark.parametrize("compiled", ["no_excess", "default"])
def test_whisper_needs_the_stepwise_gelu(compiled, jplan, monkeypatch):
    """Why the dense MLP's gelu rounds every step: reduced Whisper (48
    frames, 20 tokens, prefill and 4 decode steps) with ``F.gelu``'s one
    rounding lies past 3e-2 of the logits' scale from the reference
    whether it is compiled with excess precision off or by the default
    jit, and with the stepwise gelu within 3e-2 of the first (which equals
    the op-by-op reference).  The default jit keeps some bf16 steps in
    fp32, a rounding neither form of the port makes; ``-s`` prints all
    four margins."""
    jc, tc, jp, tp = _models()
    B, S = 2, 20
    jfr, tfr = _frames(S, B, S_ENC)
    toks = np.random.default_rng(S + 1).integers(0, jc.vocab, (B, S),
                                                 dtype=np.int32)
    nxt = np.random.default_rng(S + 2).integers(0, jc.vocab, (4, B, 1),
                                                dtype=np.int32)
    opts = NO_EXCESS if compiled == "no_excess" else {}
    jb = {"frames": jfr, "tokens": jnp.asarray(toks)}
    jl, jcache = jax.jit(make_prefill_step(jc, jplan, CACHE_LEN)).lower(
        jp, jb).compile(compiler_options=opts)(jp, jb)
    want = [jl]
    jdecode = None
    for i in range(4):
        db = {"token": jnp.asarray(nxt[i]),
              "pos": jnp.asarray(np.array([S + i, S + 2 * i], np.int32))}
        if jdecode is None:
            jdecode = jax.jit(make_decode_step(jc, jplan, CACHE_LEN)).lower(
                jp, jcache, db).compile(compiler_options=opts)
        _, jl, jcache = jdecode(jp, jcache, db)
        want.append(jl)

    def margin():
        tl, cache = tsteps.make_prefill_step(tc, tplan("cpu"), CACHE_LEN)(
            tp, {"frames": tfr, "tokens": torch.from_numpy(toks)})
        got = [tl]
        decode = tsteps.make_decode_step(tc, tplan("cpu"), CACHE_LEN)
        for i in range(4):
            _, tl, cache = decode(tp, cache, {
                "token": torch.from_numpy(nxt[i]),
                "pos": torch.tensor([S + i, S + 2 * i], dtype=torch.int32)})
            got.append(tl)
        return max(_margin(g, w) for g, w in zip(got, want))
    stepwise = margin()
    monkeypatch.setattr(TL, "gelu_stepwise", lambda g: torch.nn.functional
                        .gelu(g, approximate="tanh"))
    one_rounding = margin()
    print(f"[margin] {ARCH} S_enc {S_ENC} S{S} against the reference "
          f"compiled {compiled}: stepwise gelu {stepwise:.4f}, F.gelu "
          f"{one_rounding:.4f} (tolerance {TOL})")
    assert one_rounding > TOL
    if compiled == "no_excess":
        assert stepwise <= TOL


def test_whisper_decode_equals_prefill():
    """The reference's ``tests/test_models.py:70-88`` check on the port: the
    decode step's logits for the token at position S equal the last logits
    of a prefill over S+1 tokens (the cached self and cross k/v against the
    parallel path)."""
    _, tc, _, tp = _models()
    _, tfr = _frames(4, 2, S_ENC)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tc.vocab, (2, 21), dtype=np.int32))
    tm = TLM(tc)
    full, _ = tm.prefill(tp, {"frames": tfr, "tokens": toks},
                         cache_len=CACHE_LEN)
    _, cache = tm.prefill(tp, {"frames": tfr, "tokens": toks[:, :20]},
                          cache_len=CACHE_LEN)
    step, _ = tm.decode_step(tp, cache, {"token": toks[:, 20:],
                                         "pos": torch.tensor(20)})
    _close_to_scale(step, full)
    assert torch.equal(step.argmax(-1), full.argmax(-1))


def test_whisper_cache_defs_match_the_reference():
    """No cache for the encoder; ``self`` at the cache length and ``cross``
    at ``enc_len`` for the decoder, as the reference's ``_cache_struct``."""
    jc, tc = _cfgs()
    jdefs = JLM(jc).cache_defs(3, 40)
    tdefs = TLM(tc).cache_defs(3, 40)
    assert sorted(tdefs) == sorted(jdefs) == ["dec"]
    for part in ("self", "cross"):
        for n in ("k", "v"):
            shape, dtype = tdefs["dec"][part][n]
            assert shape == jdefs["dec"][part][n][0]
            assert dtype == torch.bfloat16
    assert tdefs["dec"]["cross"]["k"][0][2] == tc.enc_len == 64
    assert tdefs["dec"]["self"]["k"][0][2] == 40


# -- loss ------------------------------------------------------------------------
def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


def test_encdec_loss_and_grads_match_the_reference():
    """``LM.loss`` over frames and tokens and its gradient, every leaf (the
    encoder's, ``enc_norm`` and the decoder's cross attention included),
    with bf16 parameters as trained, at ``tests/test_torch_train.py``'s
    bf16 tolerances: loss within 2e-2 relative, each leaf's cosine >= 0.99.
    (The reference's encdec loss does not trace with fp32 parameters: the
    cross attention's fp32 output turns its layer scan's bf16 carry to
    fp32.)"""
    jc, tc = _cfgs()
    params = JLM(jc).init(jax.random.PRNGKey(0))
    jfr, tfr = _frames(5, 2, S_ENC)
    toks = np.random.default_rng(6).integers(0, jc.vocab, (2, 32),
                                             dtype=np.int32)
    jb = {"frames": jfr, "tokens": jnp.asarray(toks)}
    f = _compiled(jax.value_and_grad(
        lambda p, b: JLM(jc).loss(p, b, single_device_plan()),
        has_aux=True), params, jb)
    (jloss, jmetrics), jgrads = f(params, jb)
    tp = _carry(params)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    loss, metrics = TLM(tc).loss(tree_unflatten(tp, leaves), {
        "frames": tfr, "tokens": torch.from_numpy(toks)})
    grads = tree_unflatten(tp, list(torch.autograd.grad(loss, leaves)))
    assert sorted(metrics) == sorted(jmetrics) == ["ce"]
    rel = abs(float(loss.detach()) - float(jloss)) / abs(float(jloss))
    assert rel <= 2e-2, rel
    paths = [p for p, _ in _paths(grads)]
    assert "/enc_norm/w" in paths and "/stacks/dec/xattn/wq" in paths
    worst = 1.0
    for (path, g), r in zip(_paths(grads), jax.tree.leaves(jgrads)):
        a, b = _f32(g), _f32(r)
        assert a.shape == b.shape, path
        cos = float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)
                                     + 1e-30))
        assert cos >= 0.99, (path, cos)
        worst = min(worst, cos)
    print(f"[margin] {ARCH} loss: {rel:.2e} relative (tolerance 2e-2), "
          f"gradient cosines >= {worst:.5f} (tolerance 0.99)")
