"""The port's ``ssd_scan`` against the reference's, on the CPU.

On a CPU tensor the port's wrapper runs its plain version
(``ssd_scan_plain``, the chunkwise loop with the TPU kernel's arithmetic);
the reference's ``repro.kernels.ops.ssd_scan`` runs the Pallas kernel in
interpret mode, ``repro.models.ssm.chunked_gla`` is the path the reference's
models take, and ``repro.kernels.ref.ssd_scan_ref`` is the step-by-step
oracle.  Inputs come from numpy seeds and go to both packages.  The kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances.  Against the Pallas kernel and ``chunked_gla``, which compute
the same chunkwise arithmetic in fp32 with sums in another order: 2e-5 in
f32 (as ``tests/test_kernels.py`` holds flash attention), and for bf16
outputs one rounding of y to bf16 (2**-7 relative at most) on top.  Against
the step-by-step oracle: ``tests/test_kernels.py``'s 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import ssd_scan as jssd
from repro.models.ssm import chunked_gla as jgla
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_scan import launch_plan, p_tile, smem_bytes, \
    ssd_scan, ssd_scan_bwd, ssd_scan_bwd_plain, ssd_scan_plain, wgmma_fits, \
    wgmma_smem_bytes
from ssd_bwd_cases import BWD_BAD_IDS, BWD_BAD_SHAPES, bwd_bad_inputs

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
H100 = (132, 232448)            # SMs, opt-in shared memory of a block


def _inputs(seed, B, H, S, N, P, G=None, dtype="float32"):
    """q, k (B,G,S,N), v (B,H,S,P), log_a (B,H,S) <= 0, as numpy f32 (q, k,
    v rounded to ``dtype`` first, so both packages see the same values)."""
    rng = np.random.default_rng(seed)
    G = G or H
    q = rng.standard_normal((B, G, S, N), dtype=np.float32) * 0.3
    k = rng.standard_normal((B, G, S, N), dtype=np.float32) * 0.3
    v = rng.standard_normal((B, H, S, P), dtype=np.float32)
    la = -np.abs(rng.standard_normal((B, H, S), dtype=np.float32)) * 0.1
    q, k, v = (np.array(jnp.asarray(a).astype(JDT[dtype]), np.float32)
               for a in (q, k, v))
    return q, k, v, la


def _t(*arrays, dtype="float32"):
    return [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# the grid of tests/test_kernels.py:61-66
@pytest.mark.parametrize("B,H,S,N,P,chunk", [
    (1, 2, 128, 16, 32, 64),
    (2, 3, 256, 32, 64, 128),
    (1, 1, 64, 8, 8, 64),        # single chunk
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_pallas_kernel(B, H, S, N, P, chunk, dtype):
    q, k, v, la = _inputs(S + N + P, B, H, S, N, P, dtype=dtype)
    jq, jk, jv = (jnp.asarray(a).astype(JDT[dtype]) for a in (q, k, v))
    want = jssd(jq, jk, jv, jnp.asarray(la), chunk)
    tq, tk, tv = _t(q, k, v, dtype=dtype)
    got = ssd_scan(tq, tk, tv, torch.from_numpy(la), chunk)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (B, H, S, P)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("B,S,H,N,P,chunk", [
    (2, 64, 3, 8, 5, 16),
    (1, 256, 4, 16, 16, 64),
    (1, 12, 2, 4, 4, 16),        # S < chunk: one short chunk
])
def test_ssd_scan_matches_chunked_gla_with_state(B, S, H, N, P, chunk):
    """The reference's model path, in its (B,S,H,·) layout: y and the final
    state (the reference's ``s_final``) that prefill hands to decode."""
    q, k, v, la = _inputs(S * H, B, H, S, N, P)
    sw = [np.ascontiguousarray(np.swapaxes(a, 1, 2)) for a in (q, k, v, la)]
    jy, js = jgla(*map(jnp.asarray, sw), chunk=chunk)
    y, state = ssd_scan(*_t(q, k, v, la), chunk, return_state=True)
    assert state.dtype == torch.float32 and tuple(state.shape) == (B, H, N, P)
    _close(y.transpose(1, 2), jy, TOL["float32"])
    _close(state, js, TOL["float32"])


@pytest.mark.parametrize("S,chunk,G,P", [
    (40, 16, 3, 5),              # ragged tail: 16 + 16 + 8
    (5, 16, 3, 5),               # shorter than a chunk
    (37, 8, 1, 4),               # one group of q/k for three heads
    (33, 16, 3, 1),              # P = 1 (xLSTM's normaliser)
])
def test_ssd_scan_ragged_and_grouped_match_the_oracle(S, chunk, G, P):
    """Lengths the Pallas kernel cannot take, and q/k shared by a group of
    heads: held to the step-by-step oracle, in both packages."""
    B, H, N = 2, 3, 8
    q, k, v, la = _inputs(S + G + P, B, H, S, N, P, G=G)
    rep = H // G
    qh, kh = (np.repeat(a, rep, axis=1) for a in (q, k))
    want = np.asarray(jref.ssd_scan_ref(*map(jnp.asarray, (qh, kh, v, la))))
    y, state = ssd_scan(*_t(q, k, v, la), chunk, return_state=True)
    _close(y, want, 2e-3)
    _close(tref.ssd_scan_ref(*_t(qh, kh, v, la)), want, 2e-5)
    # the final state carries on: one more step on it equals the oracle's
    # last output over S + 1 steps
    q1, k1, v1, la1 = _inputs(S + 1, B, H, 1, N, P, G=G)
    h = torch.exp(torch.from_numpy(la1)[..., 0])[..., None, None] * state \
        + torch.from_numpy(np.repeat(k1, rep, 1)[:, :, 0, :, None]
                           * v1[:, :, 0, None, :])
    y1 = torch.einsum("bhn,bhnp->bhp",
                      torch.from_numpy(np.repeat(q1, rep, 1)[:, :, 0]), h)
    want1 = jref.ssd_scan_ref(*map(jnp.asarray, (
        np.concatenate([qh, np.repeat(q1, rep, 1)], 2),
        np.concatenate([kh, np.repeat(k1, rep, 1)], 2),
        np.concatenate([v, v1], 2), np.concatenate([la, la1], 2))))
    _close(y1, np.asarray(want1)[:, :, -1], 2e-3)


def test_ssd_scan_out_dtype_keeps_fp32():
    """The model path passes bf16 q/k with fp32 v and asks for fp32 y: no
    bf16 rounding of y that the reference does not make."""
    q, k, v, la = _inputs(5, 1, 2, 48, 8, 4, dtype="bfloat16")
    tq, tk = _t(q, k, dtype="bfloat16")
    y = ssd_scan(tq, tk, torch.from_numpy(v), torch.from_numpy(la), 16,
                 out_dtype=torch.float32)
    assert y.dtype == torch.float32
    want = jref.ssd_scan_ref(*map(jnp.asarray, (q, k, v, la)))
    _close(y, want, 2e-3)
    assert ssd_scan(tq, tk, torch.from_numpy(v), torch.from_numpy(la),
                    16).dtype == torch.bfloat16


def test_ssd_scan_gradients_match_the_reference():
    """On a CPU tensor the backward runs ``ssd_scan_bwd_plain``, the
    backward kernel's decomposition (the chunks' states by the forward
    chain, their gradients by the reverse chain, then each chunk's
    gradients); held to ``jax.grad`` of the reference's ``ops.ssd_scan``,
    whose VJP is ``jax.vjp`` of ``ref.ssd_scan_ref``, within 1e-4."""
    q, k, v, la = _inputs(9, 1, 2, 32, 8, 4)
    gy = np.random.default_rng(10).standard_normal((1, 2, 32, 4),
                                                   dtype=np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jssd(*a, 16) * gy),
                  argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, la)))
    leaves = [t.requires_grad_(True) for t in _t(q, k, v, la)]
    (ssd_scan(*leaves, 16) * torch.from_numpy(gy)).sum().backward()
    for t, g in zip(leaves, jg):
        _close(t.grad, g, 1e-4)


# (name, B, H, G, S, N, P, chunk, log_a scale, a cotangent of the state):
# a ragged tail chunk, S under a chunk, one group of q/k for three heads
# and two for four, P = 1 (xLSTM's normaliser), the final state's cotangent,
# and log_a that reaches the exponents' -60 clip inside a chunk
BWD_CASES = [
    ("ragged", 2, 3, 3, 40, 8, 5, 16, 0.1, False),
    ("short", 2, 3, 3, 5, 8, 5, 16, 0.1, False),
    ("grouped", 2, 3, 1, 37, 8, 4, 8, 0.1, False),
    ("two_groups", 1, 4, 2, 48, 8, 6, 16, 0.1, True),
    ("p1", 2, 3, 3, 33, 8, 1, 16, 0.1, False),
    ("state", 1, 2, 2, 48, 8, 5, 16, 0.1, True),
    ("clip", 1, 2, 2, 64, 8, 5, 32, 8.0, True),
]
# fp32 gradients against each oracle, relative to the gradient's scale:
# the same function summed in other orders (the step-by-step oracle over
# every step, chunked_gla and autograd over the chunks)
BWD_TOL = 1e-5


def _bwd_case(name, B, H, G, S, N, P, chunk, la_scale, with_state):
    q, k, v, la = _inputs(S * H + P, B, H, S, N, P, G=G)
    la = la * (la_scale / 0.1)
    rng = np.random.default_rng(S + N)
    gy = rng.standard_normal((B, H, S, P), dtype=np.float32)
    gs = rng.standard_normal((B, H, N, P), dtype=np.float32) * with_state
    return q, k, v, la, gy, gs


def _group_sum(g, G):
    """Per-head gradients of q or k (B,H,...) summed over each group."""
    B, H = g.shape[:2]
    return np.asarray(g).reshape(B, G, H // G, *g.shape[2:]).sum(2)


def _close_grads(got, want, where, names=("dq", "dk", "dv", "dlog_a")):
    for name, a, b in zip(names, got, want):
        b = np.asarray(b, np.float32)
        assert tuple(a.shape) == b.shape, (where, name)
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a.float().numpy() - b).max()) / scale
        assert err <= BWD_TOL, (where, name, err)


def _plain_bwd(case):
    q, k, v, la, gy, gs = _bwd_case(*case)
    return ssd_scan_bwd_plain(*_t(q, k, v, la, gy, gs), case[7])


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_bwd_plain_matches_the_reference_vjp(case):
    """``ssd_scan_bwd_plain`` against ``jax.vjp`` of the step-by-step
    oracle ``ref.ssd_scan_ref`` (the reference's backward, ``ops.py``'s
    ``_ssd_bwd_rule``), q and k repeated over each group's heads there and
    their gradients summed back; the oracle returns no state, so a case
    with the state's cotangent adds its part by one more oracle step of
    log_a 0 and zero k, v, whose y is q . h_S."""
    name, B, H, G, S, N, P, chunk, _, with_state = case
    q, k, v, la, gy, gs = _bwd_case(*case)
    rep = H // G
    qh, kh = (np.repeat(a, rep, axis=1) for a in (q, k))
    got = _plain_bwd(case)
    if with_state:
        # y_{S+1} = q' . h_S for a step of log_a 0 and k = v = 0; with q'
        # the identity over n for each p column the cotangent of those
        # outputs is gs itself: N extra steps, step n reading row n
        eye = np.broadcast_to(np.eye(N, dtype=np.float32), (B, H, N, N))
        qx = np.concatenate([qh, eye], 2)
        kx = np.concatenate([kh, np.zeros((B, H, N, N), np.float32)], 2)
        vx = np.concatenate([v, np.zeros((B, H, N, P), np.float32)], 2)
        lx = np.concatenate([la, np.zeros((B, H, N), np.float32)], 2)
        gx = np.concatenate([gy, gs], 2)
    else:
        qx, kx, vx, lx, gx = qh, kh, v, la, gy
    _, vjp = jax.vjp(jref.ssd_scan_ref, *map(jnp.asarray, (qx, kx, vx, lx)))
    jq, jk, jv, jl = (np.asarray(t) for t in vjp(jnp.asarray(gx)))
    want = (_group_sum(jq[:, :, :S], G), _group_sum(jk[:, :, :S], G),
            jv[:, :, :S], jl[:, :, :S])
    _close_grads(got, want, name)


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_bwd_plain_matches_chunked_gla_grad(case):
    """``ssd_scan_bwd_plain`` against ``jax.vjp`` of the reference's model
    path ``chunked_gla`` (its exponents clipped as the kernels clip them)
    for the cotangents of y and of its final state, in its (B,S,H,.)
    layout; a ragged S is padded there to whole chunks with steps of log_a
    0, zero q, k, v and dy, which change neither y nor the state."""
    name, B, H, G, S, N, P, chunk, _, _ = case
    q, k, v, la, gy, gs = _bwd_case(*case)
    rep = H // G
    Q = min(chunk, S)
    pad = -S % Q

    def lay(a):
        a = np.pad(a, [(0, 0), (0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 3))
        return np.ascontiguousarray(np.swapaxes(a, 1, 2))
    qh, kh = (np.repeat(a, rep, axis=1) for a in (q, k))
    args = [jnp.asarray(lay(a)) for a in (qh, kh, v, la)]
    _, vjp = jax.vjp(lambda *a: jgla(*a, chunk=chunk), *args)
    jq, jk, jv, jl = (np.swapaxes(np.asarray(t), 1, 2)[:, :, :S]
                      for t in vjp((jnp.asarray(lay(gy)), jnp.asarray(gs))))
    want = (_group_sum(jq, G), _group_sum(jk, G), jv, jl)
    _close_grads(_plain_bwd(case), want, name)


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_bwd_plain_matches_autograd_of_the_plain_forward(case):
    """``ssd_scan_bwd_plain`` against autograd through ``ssd_scan_plain``
    (the recompute the port's backward ran before it had a kernel), for
    the cotangents of y and the final state."""
    name, B, H, G, S, N, P, chunk, _, _ = case
    q, k, v, la, gy, gs = _bwd_case(*case)
    leaves = [t.requires_grad_(True) for t in _t(q, k, v, la)]
    y, state = ssd_scan_plain(*leaves, chunk)
    want = torch.autograd.grad((y, state), leaves,
                               (torch.from_numpy(gy), torch.from_numpy(gs)))
    _close_grads(_plain_bwd(case), [w.numpy() for w in want], name)


# (B, H, G, S, N, P, chunk) with bf16 q/k shared by groups of heads: one
# group of four, two of four, and Zamba2's one group of 64 heads
BF16_GROUP_CASES = [(1, 4, 1, 40, 8, 5, 16), (1, 8, 2, 70, 8, 6, 32),
                    (1, 64, 1, 48, 8, 4, 16)]


def _bf16_group_case(B, H, G, S, N, P, chunk):
    """The model path's types: q, k in bf16 (here as their f32 values), v
    and log_a in fp32, and dy of bf16 values (the reference's y, and so its
    cotangent, is bf16)."""
    q, k, v, la = _inputs(S + H, B, H, S, N, P, G=G)
    gy = np.random.default_rng(S + N).standard_normal((B, H, S, P),
                                                      dtype=np.float32)
    q, k, gy = (np.array(jnp.asarray(a).astype(jnp.bfloat16), np.float32)
                for a in (q, k, gy))
    return q, k, v, la, gy


def _bf16_plain_bwd(case):
    q, k, v, la, gy = _bf16_group_case(*case)
    tq, tk = _t(q, k, dtype="bfloat16")
    return ssd_scan_bwd_plain(tq, tk, *_t(v, la, gy), None, case[6])


def test_bwd_plain_rounds_bf16_group_sums_as_autograd_does():
    """bf16 q/k shared by a group of heads (each of
    ``BF16_GROUP_CASES``), against autograd through ``ssd_scan_plain`` at
    the same inputs (the recompute the port's backward ran before it had a
    kernel; its forward widens q and k for each head, so autograd rounds
    each head's dq and dk to bf16 and sums the group's): dq and dk bit for
    bit, in bf16; dv and dlog_a in fp32 within ``BWD_TOL`` of their scale
    (sums in other orders)."""
    for case in BF16_GROUP_CASES:
        q, k, v, la, gy = _bf16_group_case(*case)
        got = _bf16_plain_bwd(case)
        tq, tk = _t(q, k, dtype="bfloat16")
        leaves = [t.requires_grad_(True) for t in (tq, tk, *_t(v, la))]
        y, _ = ssd_scan_plain(*leaves, case[6], out_dtype=torch.float32)
        want = torch.autograd.grad(y, leaves, torch.from_numpy(gy))
        assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16,
                                          torch.float32, torch.float32]
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a, b), case
        _close_grads(got[2:], [w.numpy() for w in want[2:]], case,
                     ("dv", "dlog_a"))


@pytest.mark.parametrize("case", BF16_GROUP_CASES)
def test_bwd_plain_bf16_group_sums_match_the_reference_vjp(case):
    """bf16 q/k shared by a group of heads, against ``jax.vjp`` of
    ``ref.ssd_scan_ref`` at the same bf16 q, k repeated over the heads
    (its bf16 cotangents of q and k are each head's gradient rounded to
    bf16), the heads of each group summed in order in fp32 and rounded to
    bf16 once: dq and dk within one bf16 step (2**-8) of the largest of
    their heads' gradients, element by element (a head whose fp32 gradient
    the two round to either side of a step); dv and dlog_a within
    ``BWD_TOL`` of their scale."""
    B, H, G, S, N, P, _ = case
    q, k, v, la, gy = _bf16_group_case(*case)
    got = _bf16_plain_bwd(case)
    rep = H // G
    bf = jnp.bfloat16
    _, vjp = jax.vjp(jref.ssd_scan_ref, jnp.asarray(np.repeat(q, rep, 1), bf),
                     jnp.asarray(np.repeat(k, rep, 1), bf), jnp.asarray(v),
                     jnp.asarray(la))
    heads = [np.asarray(t.astype(jnp.float32))
             for t in vjp(jnp.asarray(gy, bf))]
    for a, h in zip(got[:2], heads[:2]):
        h = h.reshape(B, G, rep, S, N)
        want = h[:, :, 0].copy()
        for r in range(1, rep):
            want = want + h[:, :, r]
        want = np.array(jnp.asarray(want).astype(bf), np.float32)
        step = 2.0 ** -8 * np.abs(h).max(2)
        assert (np.abs(a.float().numpy() - want) <= step).all(), case
    _close_grads(got[2:], heads[2:], case, ("dv", "dlog_a"))


def test_cpu_backward_is_the_plain_backward():
    """Autograd through ``ssd_scan`` on CPU tensors gives
    ``ssd_scan_bwd_plain``'s gradients bit for bit, with the state's
    cotangent, through ``ssd_scan_bwd``."""
    case = BWD_CASES[3]
    q, k, v, la, gy, gs = _bwd_case(*case)
    leaves = [t.requires_grad_(True) for t in _t(q, k, v, la)]
    y, state = ssd_scan(*leaves, case[7], return_state=True)
    got = torch.autograd.grad((y, state), leaves,
                              (torch.from_numpy(gy), torch.from_numpy(gs)))
    want = ssd_scan_bwd(*_t(q, k, v, la, gy, gs), case[7])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ssd_scan_bwd.launches == 0


def test_cuda_backward_reaches_no_plain_version(monkeypatch):
    """On the CUDA path (fake CUDA tensors, as the dry run traces it) the
    backward is the kernel's launch alone: neither plain version, nor
    autograd of the plain forward, runs; the gradients take the inputs'
    shapes and types and the workspace is allocated where the kernel's
    would be."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import backend
    from repro_torch.kernels import ssd_scan as module

    def refuse(*_a, **_k):
        raise AssertionError("a plain version ran on the CUDA path")
    monkeypatch.setattr(module, "ssd_scan_plain", refuse)
    monkeypatch.setattr(module, "ssd_scan_bwd_plain", refuse)
    monkeypatch.setattr(backend, "load", refuse)
    launches = []
    with FakeTensorMode():
        q, k = (torch.empty(2, 1, 40, 8, dtype=torch.bfloat16)
                for _ in range(2))
        v, la = torch.empty(2, 3, 40, 5), torch.empty(2, 3, 40)
        leaves = [t.requires_grad_(True) for t in (q, k, v, la)]
        with backend.noting(lambda n, w: None, launches.append), \
                backend.fake_cuda():
            y = ssd_scan(*leaves, 16, out_dtype=torch.float32)
            grads = torch.autograd.grad(y.sum(), leaves)
    assert launches == ["ssd_scan", "ssd_scan_bwd"]
    assert [(g.shape, g.dtype) for g in grads] == [
        (t.shape, t.dtype) for t in (q, k, v, la)]


@pytest.mark.parametrize("B,H,G,S,N,P,Q", [
    (4, 64, 1, 2048, 64, 64, 256), (1, 2, 2, 2048, 384, 384, 256),
    (1, 3, 3, 100, 8, 1, 256), (2, 4, 2, 300, 72, 130, 96)])
def test_bwd_workspace_and_shared_memory_fit(B, H, G, S, N, P, Q):
    """The backward's workspace counts its parts (csrc/ssd_scan_bwd.cu's
    ``Args``: two state slots a chunk, the partial sums of dcum, the chain
    blocks' dot products and each chunk's tot, the per-head fp32 dq, and
    dk at G < H), and a block's shared memory fits an H100's at every
    chunk the model paths use and far past it."""
    from repro_torch.kernels.ssd_scan import bwd_smem_bytes, bwd_workspace
    nc, ns = -(-S // Q), -(-N // 64)
    want = B * H * (2 * nc * N * P + S * (2 + 2 * ns)
                    + nc * (-(-N * P // 1024) + 1) + S * N)
    if G != H:
        want += B * H * S * N
    assert bwd_workspace(B, H, G, S, N, P, Q) == want
    assert bwd_smem_bytes(Q) <= H100[1]
    assert bwd_smem_bytes(8192) <= H100[1] < bwd_smem_bytes(40000)


def test_ssd_scan_rejects_shapes_that_do_not_fit():
    q, k, v, la = _t(*_inputs(1, 1, 4, 8, 8, 4, G=2))
    with pytest.raises(ValueError, match="G | H"):
        ssd_scan(q, k, v[:, :3], la[:, :3])
    with pytest.raises(ValueError, match="log_a"):
        ssd_scan(q, k, v, la[..., :-1])
    with pytest.raises(ValueError, match="q, k"):
        ssd_scan(q, k[..., :-1], v, la)


@pytest.mark.parametrize("bad", BWD_BAD_SHAPES, ids=BWD_BAD_IDS)
def test_ssd_scan_bwd_rejects_shapes_that_do_not_fit(bad):
    """``ssd_scan_bwd`` (the public wrapper) refuses q, k, v, log_a that
    do not fit one another, as the forward does."""
    with pytest.raises(ValueError, match="ssd_scan"):
        ssd_scan_bwd(*bwd_bad_inputs(bad[1:]), None, 4)


@pytest.mark.parametrize("B,H,S,N,P,Q,want,pt,ks", [
    (1, 64, 2048, 64, 64, 256, 512, 64, 4),     # Zamba2 prefill: 512 blocks
    (8, 64, 2048, 64, 64, 256, 4096, 64, 4),    # many blocks already
    (1, 4, 1000, 384, 384, 256, 96, 64, 3),     # xLSTM's mLSTM: 6 P tiles
    (1, 4, 1000, 384, 1, 256, 16, 8, 4),        # its P = 1 normaliser
    (1, 2, 128, 64, 64, 64, 4, 64, 4),
    (1, 4, 2048, 384, 384, 256, 192, 64, 3),    # xLSTM served: 32 -> 192
    (1, 2, 2048, 384, 1, 256, 16, 8, 4),        # the normaliser on a rank
])
def test_p_tile_fills_the_card_within_shared_memory(B, H, S, N, P, Q, want,
                                                    pt, ks):
    """bf16 q/k: a block per (b, h, chunk, P tile), 64 columns a tile (8
    at P <= 8): xLSTM's P 384 splits into 6 tiles, Zamba2's prefill fills
    the card without a split, and every plan fits a block's shared
    memory, the k ring with as many of its 4 stages as fit (xLSTM's
    resident 384-column query block leaves room for 3)."""
    plan = launch_plan(B, H, S, N, P, Q, *H100)
    assert (plan.blocks, plan.p_tile) == (want, pt) == (
        -(-S // Q) * B * H * -(-P // p_tile(P)), p_tile(P))
    assert plan.smem == wgmma_smem_bytes(N, Q, pt, ks) <= H100[1]
    assert wgmma_smem_bytes(N, Q, pt, ks + 1) > H100[1] or ks == 4
    assert plan.k_stages == ks and plan.score_tiles == 0
    assert plan.waves == plan.blocks / H100[0]
    if (B, H, S) == (1, 64, 2048):
        assert plan.blocks > H100[0] and plan.waves > 1


def test_p_tile_refuses_a_state_that_cannot_fit():
    """bf16 q/k: what bounds a block is its 128-row query block, every n
    slab of it resident, so N: at chunk 256 N 320 keeps the k ring's 4
    stages, N 384 fits with 3, N 448
    does not fit (at chunk 128, whose cumsum is smaller, it does with 2
    stages; where it does not, bf16 q/k take the f32-q/k kernel), nor does
    a chunk of 16384 steps (its cumsum).  f32 q/k: the chunk (and P > 64, which keeps every score
    tile of the chunk): a chunk of 1024 steps with P 128 does not fit, nor
    one of 16384 steps at any P."""
    assert launch_plan(1, 1, 256, 320, 64, 256, *H100).k_stages == 4
    assert launch_plan(1, 1, 256, 384, 64, 256, *H100).k_stages == 3
    plan = launch_plan(1, 1, 256, 448, 64, 128, *H100)
    assert plan.k_stages == 2 and plan.smem <= H100[1]
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(1, 1, 256, 448, 64, 256, *H100)
    assert wgmma_fits(384, 256, 384, H100[1])
    assert not wgmma_fits(448, 256, 64, H100[1])
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(1, 1, 16384, 384, 384, 16384, *H100)
    f32 = torch.float32
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(1, 1, 1024, 8, 128, 1024, *H100, qk_dtype=f32)
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(1, 1, 16384, 8, 64, 16384, *H100, qk_dtype=f32)
    plan = launch_plan(1, 1, 512, 8, 128, 512, *H100, qk_dtype=f32)
    assert plan.smem == smem_bytes(128, 512) <= H100[1]
    assert (plan.p_tile, plan.score_tiles) == (128, 8)


def _blocks(B, H, S, P, Q, plan):
    """The kernel's decode of its tickets (csrc/ssd_scan.cu, chunk-major):
    ticket -> (chunk, b * H + h, P tile)."""
    npt = -(-P // plan.p_tile)
    for ticket in range(plan.blocks):
        yield (ticket // (B * H * npt), ticket % (B * H * npt) // npt,
               ticket % npt)


@pytest.mark.parametrize("B,H,S,N,P,Q", [
    (1, 4, 1000, 384, 384, 256), (1, 4, 1000, 384, 1, 256),
    (2, 3, 77, 16, 130, 32), (1, 2, 255, 384, 65, 256),
    (1, 1, 300, 64, 7, 128)])
def test_blocks_cover_every_output_and_state_column_once(B, H, S, N, P, Q):
    """The plan's blocks, as the kernel decodes their tickets, cover every
    y element and, in every chunk, every state column exactly once, and a
    block waits only for the same P tile of the chunk before, which took
    an earlier ticket (the chain cannot deadlock)."""
    plan = launch_plan(B, H, S, N, P, Q, *H100)
    y = np.zeros((B * H, S, P), np.int32)
    cols = np.zeros((-(-S // Q), B * H, P), np.int32)
    ticket_of = {}
    for ticket, (c, bh, pt) in enumerate(_blocks(B, H, S, P, Q, plan)):
        p0, p1 = pt * plan.p_tile, min((pt + 1) * plan.p_tile, P)
        y[bh, c * Q:min(c * Q + Q, S), p0:p1] += 1
        cols[c, bh, p0:p1] += 1
        ticket_of[c, bh, pt] = ticket
        if c > 0:
            assert ticket_of[c - 1, bh, pt] < ticket
    assert (y == 1).all() and (cols == 1).all()


def test_every_model_path_plan_fits_a_block():
    """Every ``ssd_scan`` call of Zamba2-1.2B's and xLSTM-125m's prefill
    (traced on fake tensors at full width), at S 2048 and B 1 or 4, on all
    heads and on a rank's half of them, plans a block within the H100's
    232,448 bytes of shared memory, Zamba2's with the k ring's 4 stages
    and xLSTM's numerator with 3."""
    from repro_torch.configs import get
    from repro_torch.core.plan import single_device_plan
    from repro_torch.kernels import ssd_scan as module
    from repro_torch.launch import dryrun
    seen, plan_of = set(), module.launch_plan

    def record(*args, **kwargs):
        seen.add(args[:6])
        return plan_of(*args, **kwargs)
    try:
        module.launch_plan = record
        for arch in ("zamba2-1.2b", "xlstm-125m"):
            dryrun.dry_step(get(arch), "prefill", 1, 256,
                            single_device_plan("cpu"), cuda_path=True)
    finally:
        module.launch_plan = plan_of
    assert {(H, N, P) for _, H, _, N, P, _ in seen} == {
        (64, 64, 64), (4, 384, 384), (4, 384, 1)}
    for _, H, _, N, P, Q in seen:
        for B in (1, 4):
            for h in (H, H // 2):
                plan = launch_plan(B, h, 2048, N, P, Q, *H100)
                assert plan.smem <= 232448
                assert plan.k_stages == (3 if P == 384 else 4)


def test_plain_version_returns_state_for_empty_sequence():
    q, k, v, la = _t(*_inputs(2, 1, 2, 0, 4, 3))
    y, state = ssd_scan_plain(q, k, v, la, 16)
    assert tuple(y.shape) == (1, 2, 0, 3)
    assert torch.equal(state, torch.zeros(1, 2, 4, 3))


def _tf32(x):
    """x rounded to tf32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, on the 13 low bits of the fp32 word."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32_product(eq, a, b, a_exact=False, b_exact=False):
    """A product kept at fp32 accuracy on the tf32 tensor cores, as the
    kernel takes it: each fp32 operand split into tf32 hi and lo, a_lo
    b_hi + a_hi b_lo + a_hi b_hi (lo . lo dropped), or two products where
    one operand is exact in tf32 (bf16 values)."""
    if a_exact:
        b_hi, b_lo = _split(b)
        return torch.einsum(eq, a, b_lo) + torch.einsum(eq, a, b_hi)
    a_hi, a_lo = _split(a)
    if b_exact:
        return torch.einsum(eq, a_lo, b) + torch.einsum(eq, a_hi, b)
    b_hi, b_lo = _split(b)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def _kernel_emulation(q, k, v, log_a, chunk):
    """The bf16 kernel's arithmetic, in torch on the CPU, in its order: per
    chunk and P tile (launch_plan's p_tile), first the tile's whole
    increment, key tile by key tile, k^T (es v) with dk = es k and v split
    into tf32 hi and lo; then the state h_out = exp(tot) h_in + inc, the
    states kept as h^T; then per 128-row query block exp(cum_t) q.h_in
    (q exact, h_in split: two products) and for each key tile the scores
    q k^T summed in fp32 from the bf16 values (exact products), weighted by
    exp(clip(cum_t - cum_s)), masked to s <= t and split with v into three
    tf32 products.  q, k (B,H,S,N), one group per head."""
    B, H, S, N = q.shape
    P = v.shape[-1]
    Q = min(chunk, S)
    pt = p_tile(P)
    v_exact = v.dtype == torch.bfloat16
    qf, kf, vf, la = (t.float() for t in (q, k, v, log_a))
    h_t = torch.zeros(B, H, P, N)        # the chunk states as h^T
    ys = torch.zeros(B, H, S, P)
    for c0 in range(0, S, Q):
        L = min(Q, S - c0)
        qc, kc, vc = (t[:, :, c0:c0 + L] for t in (qf, kf, vf))
        cum = torch.cumsum(la[:, :, c0:c0 + L], -1)
        tot = cum[..., -1]
        es = _exp_clip(tot[..., None] - cum)
        et = _exp_clip(cum)
        h_next = torch.empty_like(h_t)
        for p0 in range(0, P, pt):
            vp = vc[..., p0:p0 + pt]
            inc = torch.zeros(B, H, N, vp.shape[-1])
            for j0 in range(0, L, 64):
                dk = kc[:, :, j0:j0 + 64] * es[:, :, j0:j0 + 64, None]
                inc = inc + _tf32_product("bhsn,bhsp->bhnp", dk,
                                          vp[:, :, j0:j0 + 64],
                                          b_exact=v_exact)
            h_in = h_t[:, :, p0:p0 + pt].transpose(-1, -2)
            h_next[:, :, p0:p0 + pt] = (
                _exp_clip(tot)[..., None, None] * h_in + inc
            ).transpose(-1, -2)
            for i0 in range(0, L, 128):
                t = torch.arange(i0, min(i0 + 128, L))
                acc = et[:, :, t, None] * _tf32_product(
                    "bhtn,bhnp->bhtp", qc[:, :, t], h_in, a_exact=True)
                for j0 in range(0, int(t[-1]) + 1, 64):
                    s = torch.arange(j0, min(j0 + 64, L))
                    sc = torch.einsum("bhtn,bhsn->bhts", qc[:, :, t],
                                      kc[:, :, s])
                    w = sc * _exp_clip(cum[:, :, t, None]
                                       - cum[:, :, None, s])
                    w = torch.where(s[None, :] <= t[:, None], w,
                                    torch.zeros(()))
                    acc = acc + _tf32_product("bhts,bhsp->bhtp", w,
                                              vp[:, :, s], b_exact=v_exact)
                ys[:, :, c0 + t, p0:p0 + pt] = acc
        h_t = h_next
    return ys, h_t.transpose(-1, -2)


def _exp_clip(x):
    return torch.exp(torch.clamp(x, -60.0, 0.0))


@pytest.mark.parametrize("B,H,S,N,P,chunk", [
    (1, 2, 128, 16, 32, 64),
    (2, 3, 256, 32, 64, 128),    # two query tiles a chunk
    (1, 2, 512, 64, 64, 256),    # Zamba2's N = P and chunk, four tiles
    (1, 1, 256, 72, 80, 128),    # N, P past one 64 tile
    (1, 1, 256, 384, 384, 128),  # xLSTM's N = P = 384: 6 P tiles
    (1, 2, 256, 384, 1, 128),    # its P = 1 normaliser: an 8-column tile
])
def test_kernel_numerics_match_pallas_kernel(B, H, S, N, P, chunk):
    """The kernel's numerics with bf16 q/k (scores from the bf16 values in
    fp32, every other product from tf32 hi and lo parts, the kernel's
    tile order) held to the reference's Pallas kernel in interpret mode,
    in fp32, within 1e-4 of the output's scale."""
    q, k, v, la = _inputs(S + N * P, B, H, S, N, P, dtype="bfloat16")
    v = np.random.default_rng(S).standard_normal((B, H, S, P),
                                                 dtype=np.float32)
    want = np.asarray(jssd(*map(jnp.asarray, (q, k, v, la)), chunk))
    tq, tk = _t(q, k, dtype="bfloat16")
    y, _ = _kernel_emulation(tq, tk, torch.from_numpy(v),
                             torch.from_numpy(la), chunk)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-4,
                               atol=1e-4 * scale)


def test_kernel_numerics_state_matches_chunked_gla():
    """The emulation's final state (the kernel's chunk chain) held to the
    reference model path's ``s_final`` within 1e-4 of its scale."""
    B, H, S, N, P, chunk = 1, 2, 384, 16, 8, 128     # a chain of 3 chunks
    q, k, v, la = _inputs(11, B, H, S, N, P, dtype="bfloat16")
    sw = [np.ascontiguousarray(np.swapaxes(a, 1, 2)) for a in (q, k, v, la)]
    _, js = jgla(*map(jnp.asarray, sw), chunk=chunk)
    _, state = _kernel_emulation(*_t(q, k, v, la), chunk)
    scale = max(float(np.abs(np.asarray(js)).max()), 1.0)
    np.testing.assert_allclose(state.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4 * scale)
