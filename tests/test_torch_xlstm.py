"""The port's xLSTM blocks and model against the reference's, on the CPU.

The reference's parameters (``jax.random`` from a key) are carried across
with ``core.params.from_numpy``; activations and tokens come from numpy
seeds.  On CPU tensors the mLSTM's ``ssd_scan`` runs its plain version.
Block outputs and states are held to 3e-2 of their scale, whole-model
logits to 3e-2 of theirs (the model-path tolerance of
``tests/test_kernels.py:134-136``).  Prompt lengths are ones the
reference's ``chunked_gla`` takes (shorter than, or a multiple of, the
chunk).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core.plan import single_device_plan
from repro.models import xlstm as JX
from repro.models.lm import LM as JLM
from repro.models.params import init_params as jinit
from repro.runtime.steps import make_decode_step, make_prefill_step
from repro_torch.configs import get as tget
from repro_torch.core.params import from_numpy
from repro_torch.models import xlstm as TX
from repro_torch.models.lm import LM as TLM

torch.set_num_threads(1)

TOL = 3e-2
ARCH = "xlstm-125m"


@pytest.fixture(scope="module")
def jplan():
    return single_device_plan()


def _cfgs(full=False):
    jc, tc = jget(ARCH), tget(ARCH)
    return (jc, tc) if full else (jc.reduced(), tc.reduced())


def _carry(tree):
    return from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _x(seed, *shape, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    a = a * scale
    return jnp.asarray(a).astype(jnp.bfloat16), \
        torch.from_numpy(a).to(torch.bfloat16)


def _close_to_scale(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


# -- mLSTM -------------------------------------------------------------------
@pytest.mark.parametrize("full,S", [(False, 16), (False, 9), (False, 32),
                                    (True, 32)],
                         ids=["reduced-16", "reduced-9", "reduced-32",
                              "full-width-32"])
def test_mlstm_block_prefill_state_then_decode(full, S, jplan):
    """Prefill on ``ssd_scan`` (numerator and normaliser, each with its
    final state), then two decode steps that write ``C``, ``n`` and
    ``conv`` into the state in place.  ``full`` is xLSTM-125m's width:
    d_model 768, 4 heads, N = P = 384."""
    jc, tc = _cfgs(full)
    p = jinit(JX.mlstm_defs(jc, None), jax.random.PRNGKey(4))
    tp = _carry(p)
    jx, tx = _x(S, 2, S, jc.d_model)
    jo, jst = jax.jit(lambda x, p: JX.mlstm_block(
        x, p, jc, jplan, state="init", chunk=jc.gla_chunk))(jx, p)
    to, tst = TX.mlstm_block(tx, tp, tc, state="init", chunk=tc.gla_chunk)
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == jo.shape
    _close_to_scale(to, jo)
    assert sorted(tst) == sorted(jst) == ["C", "conv", "n"]
    for n in jst:
        assert tuple(tst[n].shape) == jst[n].shape
        assert str(tst[n].dtype).removeprefix("torch.") == jst[n].dtype.name
        _close_to_scale(tst[n], jst[n])
    jstep = jax.jit(lambda x, p, st: JX.mlstm_block(x, p, jc, jplan,
                                                    state=st))
    for i in range(2):
        jx1, tx1 = _x(100 + i, 2, 1, jc.d_model)
        jo, jst = jstep(jx1, p, jst)
        C = tst["C"]
        to, tst2 = TX.mlstm_block(tx1, tp, tc, state=tst)
        assert tst2 is tst and tst["C"] is C            # written in place
        _close_to_scale(to, jo)
        for n in jst:
            _close_to_scale(tst[n], jst[n])


def test_mlstm_key_scale_rounds_as_the_reference():
    """``k / sqrt(P)`` on a bf16 tensor: JAX divides by the constant rounded
    to bf16; bit for bit at P = 384, where dividing by the unrounded
    constant differs."""
    jx, tx = _x(13, 4096, scale=3.0)
    want = np.asarray(jax.jit(lambda x: x / (384 ** 0.5))(jx), np.float32)
    got = tx / torch.full((), 384 ** 0.5, dtype=torch.bfloat16)
    assert np.array_equal(got.float().numpy(), want)
    assert not np.array_equal((tx / 384 ** 0.5).float().numpy(), want)


# -- sLSTM -------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 7, 16, 33])
def test_slstm_block_prefill_and_decode(S, jplan):
    """Prefill by the log-depth scan (the last ``c`` and ``n`` as the
    state), then one decode step written into the state in place."""
    jc, tc = _cfgs()
    p = jinit(JX.slstm_defs(jc, None), jax.random.PRNGKey(5))
    tp = _carry(p)
    jx, tx = _x(S + 40, 2, S, jc.d_model)
    jo, jst = jax.jit(lambda x, p: JX.slstm_block(x, p, jc, jplan,
                                                  state="init"))(jx, p)
    to, tst = TX.slstm_block(tx, tp, tc, state="init")
    _close_to_scale(to, jo)
    for n in ("c", "n"):
        assert tst[n].dtype == torch.float32
        assert tuple(tst[n].shape) == jst[n].shape
        _close_to_scale(tst[n], jst[n])
    jx1, tx1 = _x(S + 41, 2, 1, jc.d_model)
    jo, jst = jax.jit(lambda x, p, st: JX.slstm_block(
        x, p, jc, jplan, state=st))(jx1, p, jst)
    c = tst["c"]
    to, tst2 = TX.slstm_block(tx1, tp, tc, state=tst)
    assert tst2 is tst and tst["c"] is c
    _close_to_scale(to, jo)
    for n in ("c", "n"):
        _close_to_scale(tst[n], jst[n])


@pytest.mark.parametrize("S", [1, 2, 5, 64, 77])
def test_associative_scan_follows_the_reference_tree(S):
    """The sLSTM's scan against ``jax.lax.associative_scan`` with the same
    combine on fp32 inputs: the same tree, so within fp32 rounding of the
    products (1e-6 relative)."""
    rng = np.random.default_rng(S)
    f = rng.uniform(0.5, 1.0, (2, S, 3)).astype(np.float32)
    u = rng.standard_normal((2, S, 3)).astype(np.float32)

    def combine(a, b):
        (f1, c1), (f2, c2) = a, b
        return f1 * f2, f2 * c1 + c2
    jf, ju = jax.lax.associative_scan(combine, (jnp.asarray(f),
                                                jnp.asarray(u)), axis=1)
    tf, tu = TX.associative_scan(TX._decay_combine, (torch.from_numpy(f),
                                                     torch.from_numpy(u)))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6,
                               atol=1e-6)


# -- the state definitions and the model ---------------------------------------
@pytest.mark.parametrize("full", [False, True])
def test_state_defs_match_the_reference(full):
    jc, tc = _cfgs(full)
    for tdefs, jdefs in ((TX.mlstm_state_defs(tc, 3, 9),
                          JX.mlstm_state_defs(jc, 3, 9)),
                         (TX.slstm_state_defs(tc, 3, 3),
                          JX.slstm_state_defs(jc, 3, 3))):
        assert sorted(tdefs) == sorted(jdefs)
        for n, (shape, dtype) in tdefs.items():
            assert shape == jdefs[n][0]
            assert str(dtype).removeprefix("torch.") == \
                jnp.dtype(jdefs[n][1]).name


@pytest.mark.parametrize("S", [9, 16, 32])
def test_xlstm_lm_prefill_then_four_decode_steps(S, jplan):
    """The reduced xLSTM (2 mLSTM + 1 sLSTM layers): prefill logits and
    caches (per mLSTM layer ``C``, ``n``, ``conv``; per sLSTM layer ``c``,
    ``n``), then 4 decode steps with per-row positions, within 3e-2 of the
    logits' scale."""
    jc, tc = _cfgs()
    jp = JLM(jc).init(jax.random.PRNGKey(0))
    tp = _carry(jp)
    cache_len = 64
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
    assert sorted(tcache) == sorted(jcache) == ["mlstm", "slstm"]
    defs = tm.cache_defs(B, cache_len)
    for kind in jcache:
        assert sorted(tcache[kind]) == sorted(jcache[kind])
        for n in jcache[kind]:
            assert tuple(tcache[kind][n].shape) == jcache[kind][n].shape \
                == defs[kind][n][0]
            assert tcache[kind][n].dtype == defs[kind][n][1]
            _close_to_scale(tcache[kind][n], jcache[kind][n])
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
    for kind in jcache:
        for n in jcache[kind]:
            _close_to_scale(tcache[kind][n], jcache[kind][n])
