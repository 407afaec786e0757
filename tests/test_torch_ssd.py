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
from repro_torch.kernels.ssd_scan import launch_plan, smem_bytes, ssd_scan, \
    ssd_scan_plain

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
    """Backward recomputes through the plain version, as ``ops.py``
    recomputes through ``ref.ssd_scan_ref``."""
    q, k, v, la = _inputs(9, 1, 2, 32, 8, 4)
    gy = np.random.default_rng(10).standard_normal((1, 2, 32, 4),
                                                   dtype=np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jssd(*a, 16) * gy),
                  argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, la)))
    leaves = [t.requires_grad_(True) for t in _t(q, k, v, la)]
    (ssd_scan(*leaves, 16) * torch.from_numpy(gy)).sum().backward()
    for t, g in zip(leaves, jg):
        _close(t.grad, g, 1e-4)


def test_ssd_scan_rejects_shapes_that_do_not_fit():
    q, k, v, la = _t(*_inputs(1, 1, 4, 8, 8, 4, G=2))
    with pytest.raises(ValueError, match="G | H"):
        ssd_scan(q, k, v[:, :3], la[:, :3])
    with pytest.raises(ValueError, match="log_a"):
        ssd_scan(q, k, v, la[..., :-1])
    with pytest.raises(ValueError, match="q, k"):
        ssd_scan(q, k[..., :-1], v, la)


@pytest.mark.parametrize("B,H,S,P,Q,want", [
    (1, 64, 2048, 64, 256, 512),     # Zamba2 prefill: 512 blocks, 132 SMs
    (8, 64, 2048, 64, 256, 4096),    # many blocks already
    (1, 4, 1000, 384, 256, 16),      # xLSTM's mLSTM: N = P = 384
    (1, 4, 1000, 1, 256, 16),        # its P = 1 normaliser
    (1, 2, 128, 64, 64, 4),
])
def test_p_tile_fills_the_card_within_shared_memory(B, H, S, P, Q, want):
    """A block per (b, h, chunk), with no P split: Zamba2's prefill fills
    the card (more than one block per SM) without scoring a chunk twice,
    and every plan fits a block's shared memory."""
    plan = launch_plan(B, H, S, P, Q, *H100)
    assert plan.blocks == want
    assert plan.smem == smem_bytes(P, Q) <= H100[1]
    assert plan.score_tiles == (-(-Q // 64) if P > 64 else 1)
    if (B, H, S) == (1, 64, 2048):
        assert plan.blocks > H100[0] and plan.waves > 1


def test_p_tile_refuses_a_state_that_cannot_fit():
    """What bounds a block now is the chunk (and P > 64, which keeps every
    score tile of the chunk): a chunk of 1024 steps with P 128 does not
    fit, nor one of 16384 steps at any P."""
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(1, 1, 1024, 128, 1024, *H100)
    with pytest.raises(ValueError, match="shared memory"):
        launch_plan(1, 1, 16384, 64, 16384, *H100)
    assert launch_plan(1, 1, 512, 128, 512, *H100).smem <= H100[1]


def test_plain_version_returns_state_for_empty_sequence():
    q, k, v, la = _t(*_inputs(2, 1, 2, 0, 4, 3))
    y, state = ssd_scan_plain(q, k, v, la, 16)
    assert tuple(y.shape) == (1, 2, 0, 3)
    assert torch.equal(state, torch.zeros(1, 2, 4, 3))


def _kernel_emulation(q, k, v, log_a, chunk):
    """The CUDA kernel's arithmetic, in torch on the CPU: per chunk, the
    state h_out = exp(tot) h_in + sum over 64-step tiles of k^T (es v);
    then per 64-row query tile, exp(cum_t) q.h_in first and the weighted
    scores of the key tiles j <= i after, each score tile q_i k_j^T summed
    in fp32 from the inputs' values (bf16 q/k: exact products), weighted by
    exp(clip(cum_t - cum_s)) and masked to s <= t; every product with an
    fp32 operand in fp32.  q, k (B,H,S,N), one group per head."""
    B, H, S, N = q.shape
    P = v.shape[-1]
    Q = min(chunk, S)
    qf, kf, vf, la = (t.float() for t in (q, k, v, log_a))
    h = torch.zeros(B, H, N, P)
    ys = torch.zeros(B, H, S, P)
    for c0 in range(0, S, Q):
        L = min(Q, S - c0)
        qc, kc, vc = (t[:, :, c0:c0 + L] for t in (qf, kf, vf))
        cum = torch.cumsum(la[:, :, c0:c0 + L], -1)
        tot = cum[..., -1]
        es = _exp_clip(tot[..., None] - cum)
        et = _exp_clip(cum)
        inc = torch.zeros(B, H, N, P)
        for j0 in range(0, L, 64):
            inc = inc + torch.einsum("bhsn,bhsp->bhnp", kc[:, :, j0:j0 + 64],
                                     vc[:, :, j0:j0 + 64]
                                     * es[:, :, j0:j0 + 64, None])
        h_in, h = h, _exp_clip(tot)[..., None, None] * h + inc
        for i0 in range(0, L, 64):
            t = torch.arange(i0, min(i0 + 64, L))
            acc = et[:, :, i0:i0 + 64, None] * torch.einsum(
                "bhtn,bhnp->bhtp", qc[:, :, i0:i0 + 64], h_in)
            for j0 in range(0, i0 + 1, 64):
                s = torch.arange(j0, min(j0 + 64, L))
                sc = torch.einsum("bhtn,bhsn->bhts", qc[:, :, i0:i0 + 64],
                                  kc[:, :, j0:j0 + 64])
                w = sc * _exp_clip(cum[:, :, t, None] - cum[:, :, None, s])
                w = torch.where(s[None, :] <= t[:, None], w,
                                torch.zeros(()))
                acc = acc + torch.einsum("bhts,bhsp->bhtp", w,
                                         vc[:, :, j0:j0 + 64])
            ys[:, :, c0 + i0:c0 + i0 + 64] = acc
    return ys, h


def _exp_clip(x):
    return torch.exp(torch.clamp(x, -60.0, 0.0))


@pytest.mark.parametrize("B,H,S,N,P,chunk", [
    (1, 2, 128, 16, 32, 64),
    (2, 3, 256, 32, 64, 128),    # two query tiles a chunk
    (1, 2, 512, 64, 64, 256),    # Zamba2's N = P and chunk, four tiles
    (1, 1, 256, 72, 80, 128),    # N, P past one 64 tile
])
def test_kernel_numerics_match_pallas_kernel(B, H, S, N, P, chunk):
    """The kernel's numerics with bf16 q/k (scores from the bf16 values in
    fp32, every other product fp32, the kernel's tile order) held to the
    reference's Pallas kernel in interpret mode, in fp32, within 1e-4 of
    the output's scale."""
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
