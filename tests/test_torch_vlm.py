"""The port's vision-language family (Qwen2-VL) against the reference's, on
the CPU, at reduced size: ``apply_mrope``, the attention block with
``mrope_positions`` at prefill and decode, the whole model with vision
embeddings and M-RoPE (and text only, as the serving engine runs it), at the
reduced width and widened to 12/2 heads (a GQA group of 6), and
``LM.loss`` with its gradient.

Each row holds text, a grid of vision embeddings, then text.  Its M-RoPE ids
follow Qwen2-VL's rule (arXiv:2409.12191 §2.1): a text token's three ids
are equal, the index before the grid; on the grid (t, h, w) = (first, first
+ row, first + col); after it the text ids go on from the largest id so far
plus one, the same on all three streams.  So after the grid the ids differ
from the sequence index that the cache slot and the decode mask take.

The reference's parameters are carried across with
``core.params.from_numpy``; embeddings (N(0, 0.1²), as
``tests/test_models.py:17-23`` draws them) and tokens come from numpy
seeds.  The reference runs jitted with XLA's excess precision off, as
``tests/test_torch_encdec.py`` explains; whole-model outputs are held to
3e-2 of their scale, and ``-s`` prints the margin.
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
from repro.models.lm import LM as JLM
from repro.runtime.steps import make_decode_step, make_prefill_step
from repro_torch.configs import get as tget
from repro_torch.core.params import from_numpy
from repro_torch.core.plan import single_device_plan as tplan
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.lm import LM as TLM
from repro_torch.runtime import steps as tsteps

torch.set_num_threads(1)

ARCH = "qwen2-vl-2b"
TOL = 3e-2
NO_EXCESS = {"xla_allow_excess_precision": False}
CACHE_LEN = 64
# Qwen2-VL's 12 query heads over 2 KV heads, which reduced() cuts to 4/2
WIDE = {"n_heads": 12, "n_kv_heads": 2, "n_kv_eff": 2}
# (text before, grid rows, grid columns) of a row at each prompt length
GRIDS = {20: (4, 2, 4), 40: (4, 4, 6)}


@pytest.fixture(scope="module")
def jplan():
    return single_device_plan()


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)


def _cfgs(**kw):
    jc, tc = jget(ARCH).reduced(), tget(ARCH).reduced()
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


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_to_scale(got, want, tol=TOL):
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _margin(got, want) -> float:
    want = _f32(want)
    return float(np.abs(_f32(got) - want).max()
                 / max(1.0, float(np.abs(want).max())))


def mrope_ids(B: int, S: int, before: int, rows: int, cols: int):
    """(3, B, S) int32 M-RoPE ids of rows of ``before`` text tokens, a
    rows x cols grid of vision embeddings, then text to S; and the id the
    text token at position p >= S takes, as ``p - shift``."""
    n = rows * cols
    ids = np.empty((3, S), np.int32)
    ids[:, :before] = np.arange(before)
    r, c = np.divmod(np.arange(n), cols)
    ids[0, before:before + n] = before
    ids[1, before:before + n] = before + r
    ids[2, before:before + n] = before + c
    shift = n - max(rows, cols)
    ids[:, before + n:] = np.arange(before + n, S) - shift
    return np.broadcast_to(ids[:, None], (3, B, S)).copy(), shift


# -- M-RoPE ------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [16, 128])
def test_mrope_matches_the_reference(D, dtype):
    """On an image + text layout, at the reduced head dim 16 (sections 2, 3,
    3) and Qwen2-VL's 128 (16, 24, 24), theta 1e6.  Not bit for bit: the
    two packages' RoPE already differ by an ulp in fp32 (``pow`` and
    ``cos`` of the angles), so bf16 outputs may sit one bf16 step apart and
    f32 ones within 1e-4."""
    rng = np.random.default_rng(D)
    x = rng.standard_normal((2, 40, 3, D)).astype(np.float32)
    ids, _ = mrope_ids(2, 40, *GRIDS[40])
    jx = jnp.asarray(x).astype(dtype)
    want = _f32(_compiled(lambda a, p: JL.apply_mrope(a, p, 1e6), jx,
                          jnp.asarray(ids))(jx, jnp.asarray(ids)))
    got = TL.apply_mrope(torch.from_numpy(x).to(getattr(torch, dtype)),
                         torch.from_numpy(ids), 1e6)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        np.testing.assert_allclose(_f32(got), want, rtol=2.0 ** -7,
                                   atol=2.0 ** -9)
    else:
        np.testing.assert_allclose(_f32(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [16, 128])
def test_mrope_is_rope_when_the_streams_agree(D, dtype):
    """In both packages, bit for bit: three equal streams rotate as RoPE at
    those positions."""
    rng = np.random.default_rng(D + 1)
    x = rng.standard_normal((2, 24, 3, D)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 24)).astype(np.int32)
    thw = np.broadcast_to(pos[None], (3, 2, 24)).copy()
    jx = jnp.asarray(x).astype(dtype)
    jm = jax.jit(lambda a, p: JL.apply_mrope(a, p, 1e6))(jx, jnp.asarray(thw))
    jr = jax.jit(lambda a, p: JL.apply_rope(a, p, 1e6))(jx, jnp.asarray(pos))
    assert np.array_equal(_f32(jm), _f32(jr))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert torch.equal(TL.apply_mrope(tx, torch.from_numpy(thw), 1e6),
                       TL.apply_rope(tx, torch.from_numpy(pos), 1e6))


@pytest.mark.parametrize("D,sections", [(16, (2, 3, 3)), (128, (16, 24, 24))])
def test_mrope_takes_each_section_from_its_stream(D, sections):
    """Bit for bit, section by section: frequency j of section s rotates the
    pair (2j, 2j+1) as RoPE does at stream s's positions."""
    rng = np.random.default_rng(D + 2)
    x = torch.from_numpy(rng.standard_normal((2, 40, 3, D))
                         .astype(np.float32)).to(torch.bfloat16)
    thw = torch.from_numpy(mrope_ids(2, 40, *GRIDS[40])[0])
    got = TL.apply_mrope(x, thw, 1e6)
    start = 0
    for s, n in enumerate(sections):
        want = TL.apply_rope(x, thw[s], 1e6)
        cols = slice(2 * start, 2 * (start + n))
        assert torch.equal(got[..., cols], want[..., cols]), s
        start += n
    assert start == D // 2


# -- attention block -------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, WIDE], ids=["H4-2", "H12-2"])
def test_attention_with_mrope_prefill_then_decode(kw, jplan):
    """Prefill (the kernel's path) with M-RoPE ids on an image + text layout,
    then a decode step per row whose M-RoPE id (the text after the grid) is
    ``pos - shift`` while the cache slot and mask take ``pos``."""
    jc, tc = _cfgs(cache_len=CACHE_LEN, **kw)
    p = jax.tree.map(lambda t: t[0], JLM(jc).init(
        jax.random.PRNGKey(1))["stacks"]["dense"]["attn"])
    tp = _carry(p)
    B, S = 2, 40
    jx, tx = _x(3, B, S, jc.d_model, scale=1.0)
    ids, shift = mrope_ids(B, S, *GRIDS[40])
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    fpre = _compiled(lambda x, p, pos, m: JA.attention(
        x, p, jc, jplan, positions=pos, cache="init", mrope_positions=m,
        q_block=16, kv_block=16), jx, p, jnp.asarray(pos), jnp.asarray(ids))
    jo, jcache = fpre(jx, p, jnp.asarray(pos), jnp.asarray(ids))
    to, tcache = TA.attention(tx, tp, tc, positions=torch.from_numpy(pos),
                              cache="init",
                              mrope_positions=torch.from_numpy(ids))
    _close_to_scale(to, jo)
    for n in ("k", "v"):
        assert tuple(tcache[n].shape) == jcache[n].shape
        _close_to_scale(tcache[n], jcache[n])
    p1 = np.array([S, S + 3], np.int32)
    m1 = np.broadcast_to((p1 - shift)[None, :, None], (3, B, 1)).copy()
    jx1, tx1 = _x(4, B, 1, jc.d_model, scale=1.0)
    fdec = _compiled(lambda x, p, c, pos, cpos, m: JA.attention(
        x, p, jc, jplan, positions=pos, cache=c, cache_pos=cpos,
        mrope_positions=m), jx1, p, jcache, jnp.asarray(p1[:, None]),
        jnp.asarray(p1), jnp.asarray(m1))
    jo, jcache = fdec(jx1, p, jcache, jnp.asarray(p1[:, None]),
                      jnp.asarray(p1), jnp.asarray(m1))
    to, tcache = TA.attention(tx1, tp, tc,
                              positions=torch.from_numpy(p1[:, None]),
                              cache=tcache, cache_pos=torch.from_numpy(p1),
                              mrope_positions=torch.from_numpy(m1))
    _close_to_scale(to, jo)
    for n in ("k", "v"):
        _close_to_scale(tcache[n], jcache[n])


# -- whole model ---------------------------------------------------------------
def _batches(B, S, vocab, seed, embeds):
    """The prefill batch (tokens; with ``embeds`` the N(0, 0.1²) embeddings
    of the whole row and its M-RoPE ids) in both packages, and the decode
    batches' inputs: 4 tokens, 4 embeddings and each step's id shift."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S), dtype=np.int32)
    nxt = rng.integers(0, vocab, (4, B, 1), dtype=np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    emb1 = shift = None
    if embeds:
        e = (rng.standard_normal((B, S, 64)) * 0.1).astype(np.float32)
        emb1 = (rng.standard_normal((4, B, 1, 64)) * 0.1).astype(np.float32)
        ids, shift = mrope_ids(B, S, *GRIDS[S])
        jb.update(embeds=jnp.asarray(e).astype(jnp.bfloat16),
                  mrope_positions=jnp.asarray(ids))
        tb.update(embeds=torch.from_numpy(e).to(torch.bfloat16),
                  mrope_positions=torch.from_numpy(ids))
    return jb, tb, nxt, emb1, shift


def _step_batches(nxt, emb1, shift, i, pos):
    jd = {"token": jnp.asarray(nxt[i]), "pos": jnp.asarray(pos)}
    td = {"token": torch.from_numpy(nxt[i]), "pos": torch.from_numpy(pos)}
    if emb1 is not None:
        m = np.broadcast_to((pos - shift)[None, :, None],
                            (3,) + pos.shape + (1,)).astype(np.int32)
        jd.update(embeds=jnp.asarray(emb1[i]).astype(jnp.bfloat16),
                  mrope_positions=jnp.asarray(m))
        td.update(embeds=torch.from_numpy(emb1[i]).to(torch.bfloat16),
                  mrope_positions=torch.from_numpy(m))
    return jd, td


@pytest.mark.parametrize("kw", [{}, WIDE], ids=["H4-2", "H12-2"])
@pytest.mark.parametrize("inputs", ["embeds", "text"])
@pytest.mark.parametrize("S", [20, 40])
def test_vlm_prefill_then_four_decode_steps(S, inputs, kw, jplan):
    """Prefill logits and caches, then 4 decode steps with per-row
    positions, through both packages' ``make_prefill_step`` /
    ``make_decode_step``: with vision embeddings and M-RoPE (each step with
    its own embedding and id), or text only (RoPE), as the engine serves
    it.  Prints the largest logit error over the logits' scale (``-s``)."""
    jc, tc = _cfgs(**kw)
    jp = JLM(jc).init(jax.random.PRNGKey(0))
    tp = _carry(jp)
    B = 2
    jb, tb, nxt, emb1, shift = _batches(B, S, jc.vocab, S,
                                        inputs == "embeds")
    jl, jcache = _compiled(make_prefill_step(jc, jplan, CACHE_LEN), jp,
                           jb)(jp, jb)
    tl, tcache = tsteps.make_prefill_step(tc, tplan("cpu"), CACHE_LEN)(
        tp, tb)
    tdecode = tsteps.make_decode_step(tc, tplan("cpu"), CACHE_LEN)
    assert tuple(tl.shape) == jl.shape == (B, 1, jc.vocab)
    _close_to_scale(tl, jl)
    worst = _margin(tl, jl)
    for n in ("k", "v"):
        assert tuple(tcache["dense"][n].shape) == jcache["dense"][n].shape
        _close_to_scale(tcache["dense"][n], jcache["dense"][n])
    jdecode = None
    for i in range(4):
        jd, td = _step_batches(nxt, emb1, shift, i,
                               np.array([S + i, S + 2 * i], np.int32))
        if jdecode is None:
            jdecode = _compiled(make_decode_step(jc, jplan, CACHE_LEN), jp,
                                jcache, jd)
        _, jl, jcache = jdecode(jp, jcache, jd)
        _, tl, tcache = tdecode(tp, tcache, td)
        _close_to_scale(tl, jl)
        worst = max(worst, _margin(tl, jl))
    print(f"[margin] {ARCH} H{jc.n_heads}/{jc.n_kv_heads} {inputs} S{S}: "
          f"logits within {worst:.4f} of their scale (tolerance {TOL})")


def test_vlm_decode_equals_prefill():
    """The reference's ``tests/test_models.py:70-88`` check with embeddings
    and M-RoPE: a decode step at position S (its embedding, its M-RoPE id
    after the grid) gives the last logits of a prefill over S+1."""
    _, tc = _cfgs(**WIDE)
    tp = TLM(tc).init(torch.Generator().manual_seed(0))
    S = 40
    _, tb, _, _, _ = _batches(2, S + 1, tc.vocab, 7, False)
    ids, shift = mrope_ids(2, S + 1, *GRIDS[40])
    e = (np.random.default_rng(8).standard_normal((2, S + 1, 64)) * 0.1)
    e = torch.from_numpy(e.astype(np.float32)).to(torch.bfloat16)
    ids = torch.from_numpy(ids)
    tm = TLM(tc)
    full, _ = tm.prefill(tp, {"embeds": e, "mrope_positions": ids},
                         cache_len=CACHE_LEN)
    _, cache = tm.prefill(tp, {"embeds": e[:, :S],
                               "mrope_positions": ids[:, :, :S]},
                          cache_len=CACHE_LEN)
    assert int(ids[0, 0, S]) == S - shift
    step, _ = tm.decode_step(tp, cache, {
        "token": tb["tokens"][:, S:], "pos": torch.tensor(S),
        "embeds": e[:, S:], "mrope_positions": ids[:, :, S:]})
    _close_to_scale(step, full)
    assert torch.equal(step.argmax(-1), full.argmax(-1))


# -- loss ------------------------------------------------------------------------
def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


@pytest.mark.parametrize("f32", [True, False], ids=["fp32", "bf16"])
def test_vlm_loss_and_grads_match_the_reference(f32):
    """``LM.loss`` with embeddings and M-RoPE ids and its gradient, at
    ``tests/test_torch_train.py``'s tolerances: loss within 1e-4 (fp32
    parameters) / 2e-2 (bf16) relative, each leaf's cosine >= 0.9995 /
    0.99, fp32 leaves within 3e-2 of their scale.  The token embedding is
    not read when embeddings replace it: its gradient is zero in both."""
    jc, tc = _cfgs(**WIDE)
    params = JLM(jc).init(jax.random.PRNGKey(0))
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    jb, tb, _, _, _ = _batches(2, 40, jc.vocab, 9, True)
    f = _compiled(jax.value_and_grad(
        lambda p, b: JLM(jc).loss(p, b, single_device_plan()),
        has_aux=True), params, jb)
    (jloss, _), jgrads = f(params, jb)
    tp = _carry(params)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    loss, _ = TLM(tc).loss(tree_unflatten(tp, leaves), tb)
    grads = tree_unflatten(tp, list(torch.autograd.grad(
        loss, leaves, materialize_grads=True)))
    rel = abs(float(loss.detach()) - float(jloss)) / abs(float(jloss))
    assert rel <= (1e-4 if f32 else 2e-2), rel
    assert not grads["embed"]["emb"].any()
    assert not np.asarray(jgrads["embed"]["emb"]).any()
    worst = 1.0
    for (path, g), r in zip(_paths(grads), jax.tree.leaves(jgrads)):
        a, b = _f32(g), _f32(r)
        assert a.shape == b.shape, path
        if path == "/embed/emb":
            continue
        cos = float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)
                                     + 1e-30))
        assert cos >= (0.9995 if f32 else 0.99), (path, cos)
        worst = min(worst, cos)
        if f32:
            err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
            assert err <= 3e-2, (path, err)
    print(f"[margin] {ARCH} loss ({'fp32' if f32 else 'bf16'} parameters): "
          f"{rel:.2e} relative, gradient cosines >= {worst:.5f}")


def test_vlm_train_step_takes_embeddings():
    """``make_train_step`` on a batch with embeddings and M-RoPE ids: the
    token embedding, which the loss does not read, takes a zero gradient and
    ends the step as the reference's does; the step's loss is
    ``LM.loss``'s."""
    from repro.optim.schedules import cosine_warmup as jcosine
    from repro.runtime.steps import init_state as jinit_state
    from repro.runtime.steps import make_train_step as jmake_train_step
    from repro_torch.core.params import state_from_numpy
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.runtime.steps import make_train_step
    jc, tc = _cfgs(**WIDE)
    jstate = jinit_state(jc, single_device_plan(), jax.random.PRNGKey(0))
    jb, tb, _, _, _ = _batches(2, 40, jc.vocab, 10, True)
    jstep = _compiled(jmake_train_step(jc, single_device_plan(),
                                       jcosine(3e-4, 2, 10)), jstate, jb)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    want_loss = float(TLM(tc).loss(tstate["params"], tb)[0])
    jstate, jm = jstep(jstate, jb)
    tstate, tm = make_train_step(tc, tplan("cpu"),
                                 cosine_warmup(3e-4, 2, 10))(tstate, tb)
    assert float(tm["loss"]) == want_loss
    assert abs(want_loss - float(jm["loss"])) <= 2e-2 * abs(want_loss)
    np.testing.assert_array_equal(_f32(tstate["params"]["embed"]["emb"]),
                                  _f32(jstate["params"]["embed"]["emb"]))
