"""The port's training path against the reference's, on the CPU, at reduced
size: the loss and every gradient leaf against ``jax.value_and_grad`` of
``LM.loss``, three train steps from one carried-across state, the two
repairs the training path needed (the gradients of ``silu_stepwise`` and
``gelu_stepwise``, the router's weights), and the recompute backward of
``ssd_scan``.

The reference runs jitted with XLA's excess precision off
(``xla_allow_excess_precision=False``): otherwise XLA's CPU compiler keeps
some of the bf16 intermediates the reference's code rounds (the bf16
embedding, the ``preferred_element_type=bf16`` products) in fp32, and the
port rounds them as the code says.  Tolerances, each set above what these
inputs measure:

* fp32 parameters (every leaf cast in both packages): the activations stay
  partly bf16 even so (the embedding and the block outputs are bf16 in the
  reference's code), and their cotangents round to bf16 after sums taken in
  other orders.  Loss within 1e-4 relative (measured <= 2.2e-5); every
  gradient leaf within 3e-2 of its scale (max |x|; measured <= 1.6e-2)
  with cosine >= 0.9995 (measured >= 0.99992);
* bf16 parameters, as trained: loss within 2e-2 relative (measured <=
  1.4e-4), every leaf's cosine >= 0.99 (measured >= 0.9985);
* three AdamW steps from one carried-across state: the loss of each step
  within 2e-3 (fp32) / 2e-2 (bf16) relative, the first step's gradient norm
  within 2e-2, and each parameter leaf's update over the three steps,
  d = p3 - p0, against the reference's: |d_port - d_ref| / |d_ref| (L2
  norms) within 0.15 with fp32 parameters (measured <= 0.107) and 0.45 in
  bf16 (measured <= 0.33).  AdamW's first steps move an element by about
  lr * sign(g), so an element whose gradient lies below the two packages'
  gradient difference moves the other way: that rules out a bound on the
  largest element (measured up to 1.4 |d_ref|max) and is why the L2 norm
  is compared.  The fp32 case runs at a peak rate of 1e-6, where the three
  steps stay where the two packages' gradients agree (at 3e-4 Zamba2's
  steps part: 0.32); the bf16 case at 3e-4, where d is about six bf16
  spacings of a 0.02 weight.  A no-op update (1.0), a flipped sign (2.0),
  a doubled (1.0) or halved (0.5) rate, a skipped clip (0.40) and grads of
  half the batch (1.16) each fail the fp32 bound on reduced Zamba2 (the
  largest leaf's error in brackets), and a test plants each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core.plan import single_device_plan as jplan
from repro.kernels import ref as JR
from repro.models import moe as JM
from repro.models.lm import LM as JLM
from repro.optim.schedules import cosine_warmup as jcosine
from repro.runtime.steps import init_state as jinit_state
from repro.runtime.steps import make_train_step as jmake_train_step
from repro_torch.configs import get as tget
from repro_torch.core.params import from_numpy, state_from_numpy
from repro_torch.core.plan import single_device_plan
from repro_torch.core.tree import jax_leaves, tree_leaves, tree_unflatten
from repro_torch.data import SyntheticLMSource, make_pipeline
from repro_torch.kernels import router_topk as RT
from repro_torch.kernels import silu_stepwise as SS
from repro_torch.kernels.gelu_stepwise import gelu_stepwise
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models import moe as TM
from repro_torch.models.lm import LM as TLM
from repro_torch.models.ssm import silu_stepwise
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.runtime import steps as steps_module
from repro_torch.runtime.steps import init_state, make_train_step

torch.set_num_threads(1)

ARCHS = ["ff-tiny", "mixtral-8x7b", "zamba2-1.2b", "gemma-7b"]
NO_EXCESS = {"xla_allow_excess_precision": False}
CPU = single_device_plan("cpu")
B, S = 2, 32


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)


def _tokens(seed, vocab, b=B, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _paths(tree, pre=""):
    """(path, leaf) in sorted-key order, as jax.tree.leaves orders them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


_REF = {}


def _reference(arch, f32):
    """The reference's (loss, grads) and the parameters, cached per case."""
    if (arch, f32) not in _REF:
        cfg = jget(arch).reduced()
        params = JLM(cfg).init(jax.random.PRNGKey(0))
        if f32:
            params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        batch = {"tokens": jnp.asarray(_tokens(1, cfg.vocab))}
        f = _compiled(jax.value_and_grad(
            lambda p, b: JLM(cfg).loss(p, b, jplan()), has_aux=True),
            params, batch)
        (loss, _), grads = f(params, batch)
        _REF[arch, f32] = (params, float(loss), grads)
    return _REF[arch, f32]


def _port_loss_and_grads(arch, params):
    cfg = tget(arch).reduced()
    tp = from_numpy(jax.tree.map(np.asarray, params), "cpu")
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
    loss, metrics = TLM(cfg).loss(tree_unflatten(tp, leaves), {
        "tokens": torch.from_numpy(_tokens(1, cfg.vocab))})
    grads = torch.autograd.grad(loss, leaves)
    return float(loss), tree_unflatten(tp, list(grads)), metrics


def _check_grads(grads, ref, f32):
    for (path, g), r in zip(_paths(grads), jax.tree.leaves(ref)):
        a, b = _f32(g), _f32(r)
        assert a.shape == b.shape, path
        cos = float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)
                                     + 1e-30))
        assert cos >= (0.9995 if f32 else 0.99), (path, cos)
        if f32:
            err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
            assert err <= 3e-2, (path, err)


@pytest.mark.parametrize("f32", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch, f32):
    params, jloss, jgrads = _reference(arch, f32)
    loss, grads, metrics = _port_loss_and_grads(arch, params)
    assert abs(loss - jloss) <= (1e-4 if f32 else 2e-2) * abs(jloss)
    _check_grads(grads, jgrads, f32)
    for (path, g), (_, p) in zip(_paths(grads), _paths(from_numpy(
            jax.tree.map(np.asarray, params), "cpu"))):
        assert g.dtype == p.dtype, path
    assert ("moe_lb" in metrics) == (arch == "mixtral-8x7b")


def test_the_grad_check_sees_a_router_without_gradient(monkeypatch):
    """The check above fails on a router whose weights take no gradient
    (the port before the repair: the router then learns from the aux losses
    alone)."""
    params, _, jgrads = _reference("mixtral-8x7b", True)
    monkeypatch.setattr(TM, "router_topk", lambda logits, k, c:
                        RT.router_topk_plain(logits.detach(), k, c))
    _, grads, _ = _port_loss_and_grads("mixtral-8x7b", params)
    with pytest.raises(AssertionError):
        _check_grads(grads, jgrads, True)
    a = _f32(grads["stacks"]["moe"]["moe"]["router"])
    b = _f32(jgrads["stacks"]["moe"]["moe"]["router"])
    assert (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)) < 0.5


# -- the repairs --------------------------------------------------------------
@pytest.mark.parametrize("seed,scale", [(0, 3.0), (1, 1.0), (2, 10.0)])
def test_silu_stepwise_gradient_is_the_references(seed, scale):
    """Bit for bit with ``jax.grad`` of ``jax.nn.silu`` in bf16 (and the
    forward still bit for bit); on a CPU tensor the wrapper is the plain
    versions, forward and backward, and launches nothing."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * scale).astype(np.float32)
    g = rng.standard_normal(4096).astype(np.float32)
    jx, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, g))
    jy, vjp = jax.vjp(jax.nn.silu, jx)
    before = (SS.silu_stepwise.launches, SS.silu_stepwise_bwd.launches)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    ty = silu_stepwise(tx)
    (tgx,) = torch.autograd.grad(ty, tx, tg)
    assert tgx.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(ty), _f32(jy))
    np.testing.assert_array_equal(_f32(tgx), _f32(vjp(jg)[0]))
    x0 = tx.detach()
    assert torch.equal(ty, SS.silu_stepwise_plain(x0))
    assert torch.equal(tgx, SS.silu_stepwise_vjp_plain(x0, tg))
    assert torch.equal(tgx, SS.silu_stepwise_bwd(x0, tg))
    assert (SS.silu_stepwise.launches,
            SS.silu_stepwise_bwd.launches) == before


@pytest.mark.parametrize("seed,scale", [(0, 3.0), (1, 1.0), (2, 10.0)])
def test_gelu_stepwise_gradient_is_the_references(seed, scale, monkeypatch):
    """The gradient is XLA's VJP of ``jax.nn.gelu``.  In bf16 bit for bit
    with the reference compiled without excess precision and run op by op
    (torch autograd of the nine forward steps differs in 11,152-37,995 of
    these 65,536 elements).  In f32 bit for bit with the op by op run once
    the port takes XLA's f32 tanh, and within 3e-6 of the scale with
    torch's (measured <= 2.1e-6): XLA's CPU tanh is off the true value by
    up to 2.4e-7 where torch's is within 3.2e-8, and where t is within a
    few ulps of 1 the VJP's (1 - t) carries that error times about
    0.5 g dy c (1 + 3 k g**2)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(65536) * scale).astype(np.float32)
    g = rng.standard_normal(65536).astype(np.float32)
    vjp = lambda a, b: jax.vjp(jax.nn.gelu, a)[1](b)[0]

    def port(dtype):
        tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
        (got,) = torch.autograd.grad(gelu_stepwise(tx), tx,
                                     torch.from_numpy(g).to(dtype))
        assert got.dtype == dtype
        return _f32(got)

    def by_op(a, b):
        with jax.disable_jit():
            return _f32(vjp(a, b))

    jx, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, g))
    got = port(torch.bfloat16)
    np.testing.assert_array_equal(got, _f32(_compiled(vjp, jx, jg)(jx, jg)))
    np.testing.assert_array_equal(got, by_op(jx, jg))
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    want = by_op(jx, jg)
    assert np.abs(port(torch.float32) - want).max() \
        <= 3e-6 * np.abs(want).max()

    def xla_tanh(a):
        with jax.disable_jit():
            return torch.from_numpy(np.array(jnp.tanh(jnp.asarray(
                a.detach().numpy()))))
    monkeypatch.setattr(torch, "tanh", xla_tanh)
    np.testing.assert_array_equal(port(torch.float32), want)


@pytest.mark.parametrize("T,E,K", [(64, 8, 2), (33, 4, 1), (16, 16, 4)])
def test_router_weights_take_the_references_gradient(T, E, K):
    """The gradient of ``w`` with respect to the logits is the VJP XLA gives
    ``_route``'s renormalised top-K weights (logits times the identity, so
    ``_route`` sees these logits exactly), and equals the plain
    recompute's."""
    rng = np.random.default_rng(T + E)
    logits = (rng.standard_normal((T, E)) * 2).astype(np.float32)
    gw = rng.standard_normal((T, K)).astype(np.float32)
    def ref(l, g):
        idx = JM._route(l, jnp.eye(E), K)[2]
        _, vjp = jax.vjp(lambda l: JM._route(l, jnp.eye(E), K)[1], l)
        return vjp(g)[0], idx

    want, jidx = jax.jit(ref)(jnp.asarray(logits), jnp.asarray(gw))
    tl = torch.from_numpy(logits).requires_grad_(True)
    w, idx, _, _ = RT.router_topk(tl, K, T)
    (got,) = torch.autograd.grad(w, tl, torch.from_numpy(gw))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    x = torch.from_numpy(logits).requires_grad_(True)
    (plain,) = torch.autograd.grad(RT.routing_weights(x, idx), x,
                                   torch.from_numpy(gw))
    assert torch.equal(got, plain)


# -- the recompute backward of ssd_scan ------------------------------------------
@pytest.mark.parametrize("use_state", [False, True])
def test_ssd_scan_backward_with_the_state_used_or_not(use_state):
    """The recompute backward (the port of ``ops.py``'s VJP rule) against
    ``jax.vjp`` of the reference's ``ssd_scan_ref`` for y alone, and
    against autograd straight through the plain version when the final
    state takes a gradient too."""
    rng = np.random.default_rng(3)
    Bq, H, Sq, N, P = 2, 3, 40, 8, 5
    q, k = (rng.standard_normal((Bq, H, Sq, N)).astype(np.float32) * 0.5
            for _ in range(2))
    v = rng.standard_normal((Bq, H, Sq, P)).astype(np.float32)
    la = -rng.uniform(0.01, 0.5, (Bq, H, Sq)).astype(np.float32)
    gy = rng.standard_normal((Bq, H, Sq, P)).astype(np.float32)
    gs = rng.standard_normal((Bq, H, N, P)).astype(np.float32)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, la)]
    y, state = ssd_scan(*ts, 16, return_state=True)
    outs, cots = [y], [torch.from_numpy(gy)]
    if use_state:
        outs.append(state)
        cots.append(torch.from_numpy(gs))
    got = torch.autograd.grad(outs, ts, cots)
    if use_state:
        leaves = [t.detach().requires_grad_(True) for t in ts]
        want = torch.autograd.grad(ssd_scan_plain(*leaves, 16), leaves, cots)
        want = [w.numpy() for w in want]
    else:
        _, vjp = jax.vjp(JR.ssd_scan_ref, *(jnp.asarray(a)
                                            for a in (q, k, v, la)))
        want = [np.asarray(w) for w in vjp(jnp.asarray(gy))]
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), w_, rtol=1e-4,
                                   atol=1e-4 * np.abs(w_).max())


# -- train steps ------------------------------------------------------------------
PEAK = {True: 1e-6, False: 3e-4}           # keyed by f32
UPDATE_TOL = {True: 0.15, False: 0.45}
_STEPS, _INIT = {}, {}


def _initial_state(arch, f32):
    """The reference's initial train state as numpy (the port's state copies
    it), cached per case."""
    if (arch, f32) not in _INIT:
        st = jinit_state(jget(arch).reduced(), jplan(), jax.random.PRNGKey(0))
        if f32:
            st["params"] = jax.tree.map(lambda a: a.astype(jnp.float32),
                                        st["params"])
        _INIT[arch, f32] = jax.tree.map(np.asarray, st)
    return _INIT[arch, f32]


def _reference_steps(arch, f32):
    """The reference's state after three steps and each step's metrics,
    cached per case."""
    if (arch, f32) not in _STEPS:
        jc = jget(arch).reduced()
        st, jstep, metrics = _initial_state(arch, f32), None, []
        st = jax.tree.map(jnp.asarray, st)
        for i in range(3):
            jb = {"tokens": jnp.asarray(_tokens(10 + i, jc.vocab))}
            jstep = jstep or _compiled(jmake_train_step(
                jc, jplan(), jcosine(PEAK[f32], 2, 3)), st, jb)
            st, jm = jstep(st, jb)
            metrics.append({k: float(v) for k, v in jm.items()})
        _STEPS[arch, f32] = (st, metrics)
    return _STEPS[arch, f32]


def _port_steps(arch, f32, step=None, batch_of=lambda toks: toks):
    """The port's three steps from the same state; ``step`` replaces the
    train step and ``batch_of`` the batch (the planted faults)."""
    tc = tget(arch).reduced()
    tst = state_from_numpy(_initial_state(arch, f32), "cpu")
    step = step or make_train_step(tc, CPU, cosine_warmup(PEAK[f32], 2, 3))
    metrics = []
    for i in range(3):
        toks = batch_of(_tokens(10 + i, tc.vocab))
        tst, tm = step(tst, {"tokens": torch.from_numpy(toks)})
        metrics.append({k: float(v) for k, v in tm.items()})
    return tst, metrics


def _update_errors(arch, f32, tst):
    """Per parameter leaf: |d_port - d_ref| / |d_ref| of the three steps'
    update d = p3 - p0 (L2 norms)."""
    st, _ = _reference_steps(arch, f32)
    p0 = jax.tree.leaves(_initial_state(arch, f32)["params"])
    errs = {}
    for (path, a), b, q in zip(_paths(tst["params"]),
                               jax.tree.leaves(st["params"]), p0):
        da, db = _f32(a) - _f32(q), _f32(b) - _f32(q)
        errs[path] = float(np.linalg.norm(da - db)
                           / max(np.linalg.norm(db), 1e-30))
    return errs


@pytest.mark.parametrize("f32", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_the_reference(arch, f32):
    st, jms = _reference_steps(arch, f32)
    tst, tms = _port_steps(arch, f32)
    for i, (tm, jm) in enumerate(zip(tms, jms)):
        assert tm["lr"] == jm["lr"]
        assert abs(tm["loss"] - jm["loss"]) <= \
            (2e-3 if f32 else 2e-2) * abs(jm["loss"])
        if i == 0:
            assert tm["grad_norm"] == pytest.approx(jm["grad_norm"],
                                                    rel=2e-2)
    assert int(tst["step"]) == int(st["step"]) == 3
    assert int(tst["opt"]["count"]) == 3
    for a, b in zip(jax_leaves(tst["params"]), jax.tree.leaves(st["params"])):
        assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16
                           else torch.float32)
    errs = _update_errors(arch, f32, tst)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= UPDATE_TOL[f32], (worst, errs[worst])


class _NoUpdate:
    """AdamW's state, and no update of the parameters."""

    def __init__(self):
        self.opt = make_optimizer("adamw")

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, lr):
        return params, state


def _faulty_step(fault, monkeypatch):
    tc = tget("zamba2-1.2b").reduced()
    lr = cosine_warmup(PEAK[True], 2, 3)
    scale = {"sign": -1.0, "double": 2.0, "half": 0.5}.get(fault, 1.0)
    if fault == "no_clip":
        monkeypatch.setattr(steps_module, "clip_by_global_norm",
                            lambda g, _max: (g, torch.zeros(())))
    return make_train_step(tc, CPU, lambda s: scale * lr(s),
                           optimizer=_NoUpdate() if fault == "no_update"
                           else None)


@pytest.mark.parametrize("fault", ["no_update", "sign", "double", "half",
                                   "no_clip", "half_batch"])
def test_the_train_step_check_sees_a_faulty_step(fault, monkeypatch):
    """Each planted fault of the step fails the fp32 update bound."""
    half = (lambda t: np.concatenate([t[:B // 2]] * 2)) \
        if fault == "half_batch" else (lambda t: t)
    tst, _ = _port_steps("zamba2-1.2b", True,
                         _faulty_step(fault, monkeypatch), half)
    errs = _update_errors("zamba2-1.2b", True, tst)
    assert max(errs.values()) > UPDATE_TOL[True], errs


def test_grad_accumulation_matches_full_batch():
    """n_micro=2 on batch B == n_micro=1 on the same batch, as
    ``tests/test_system.py`` holds the reference (fp32 summation order and
    bf16 parameters through AdamW: a mismatch budget, not every element)."""
    cfg = tget("ff-tiny").reduced()
    s1 = init_state(cfg, CPU, torch.Generator().manual_seed(0))
    s2 = _clone(s1)
    batch = {"tokens": torch.from_numpy(_tokens(4, cfg.vocab, b=8))}
    lr = lambda s: 1e-2
    s1, m1 = make_train_step(cfg, CPU, lr, n_micro=1)(s1, batch)
    s2, m2 = make_train_step(cfg, CPU, lr, n_micro=2)(s2, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=2e-2)
    assert set(m2) == {"loss", "grad_norm", "lr"}
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        a, b = _f32(a), _f32(b)
        close = np.isclose(a, b, rtol=3e-2, atol=3e-3)
        assert (~close).sum() <= max(2, int(close.size * 1e-3))
        np.testing.assert_allclose(a, b, rtol=0.5, atol=0.05)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def test_end_to_end_training_reduces_loss():
    cfg = tget("ff-tiny").reduced()
    state = init_state(cfg, CPU, torch.Generator().manual_seed(0))
    pipe = make_pipeline(SyntheticLMSource(cfg.vocab, 32, 4, seed=0), CPU,
                         n_batches=25)
    step = make_train_step(cfg, CPU, cosine_warmup(3e-3, 5, 25))
    losses = []
    while (b := pipe.get(timeout=30)) is not None:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert len(losses) == 25
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


@pytest.mark.parametrize("chunks", [2, 3, 8])
def test_cross_entropy_chunks_give_the_reference_loss(chunks):
    """``loss_chunks`` splits the sequence; the loss and the input's
    gradient are those of the whole product, which equals the reference's
    one-device ``vocab_parallel_ce``."""
    from repro.models.lm import vocab_parallel_ce
    from repro_torch.models.lm import cross_entropy
    rng = np.random.default_rng(chunks)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 50)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 24)).astype(np.int32)
    mask = np.ones((2, 24), np.float32)
    mask[:, -1] = 0
    want = float(vocab_parallel_ce(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(labels), jnp.asarray(mask),
                                   jplan(), chunks=chunks))
    tx = torch.from_numpy(x).requires_grad_(True)
    args = (torch.from_numpy(w), torch.from_numpy(labels),
            torch.from_numpy(mask))
    whole = cross_entropy(tx, *args)
    (g1,) = torch.autograd.grad(whole, tx)
    split = cross_entropy(tx, *args, chunks=chunks)
    (g2,) = torch.autograd.grad(split, tx)
    assert float(split) == pytest.approx(want, rel=1e-6)
    assert float(split) == pytest.approx(float(whole), rel=1e-6)
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=1e-6, atol=1e-7)
