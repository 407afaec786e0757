"""The port's attention backward against the reference's VJP, on the CPU.

The reference has no backward kernel: ``repro.kernels.ops``'s VJP rule
(``_fa_bwd``) is ``jax.vjp`` of ``ref.attention_ref``, which these tests
call directly (the Pallas forward would only slow them down).  On a CPU
tensor the port's ``flash_attention_bwd`` is ``flash_attention_bwd_plain``,
the decomposition its kernel computes (``csrc/flash_attention_bwd.cu``:
P from the forward's log-sum-exp, delta = rowsum(P o dP), dS, and each
query head's dk and dv rounded to the inputs' type before a GQA group
sums them in fp32); the kernel itself is held against it on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Inputs come from
numpy seeds.  Tolerances: f32 as ``test_flash_attention_grad_matches_
reference`` (rtol 1e-4, atol 1e-5); bf16 within 2e-2 of each gradient's
largest magnitude, the bf16 tolerance of ``tests/test_kernels.py`` (the
reference rounds its bf16 gradients and sums a GQA group's heads in bf16:
against the fp32 sums its dk reaches 1.3e-2 of the scale at a group of 6,
dq 2.2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_lse_plain,
                                                 no_key_rows)

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_SCALE_TOL = 2e-2

# (H, Hkv, Sq, Sk): GQA groups of 1, 4 and 6 at Sq = Sk, a context-parallel
# prefix block (Sq < Sk), cross attention at 1 and 32 queries, and rows
# that see no key (Sq > Sk: causal rows before the first key)
SHAPES = [(2, 2, 48, 48), (4, 1, 40, 40), (6, 1, 33, 33), (4, 2, 24, 72),
          (2, 2, 1, 80), (2, 2, 32, 80), (2, 2, 40, 24)]
MASKS = [(True, 0), (False, 0), (True, 16)]


def _inputs(seed, B, H, Hkv, Sq, Sk, D, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D),
                      (B, H, Sq, D))]
    return ([jnp.asarray(a).astype(JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _reference(jq, jk, jv, jdo, causal, window):
    """``ops.py:_fa_bwd``: ``jax.vjp`` of the oracle, in its output's type
    (the cotangent in q's type, as the forward's output is)."""
    _, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(
        q, k, v, causal=causal, window=window), jq, jk, jv)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]


def _check(got, want, dtype):
    for g, w in zip(got, want):
        g = g.float().numpy()
        assert np.isfinite(g).all()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        else:
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= BF16_SCALE_TOL * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("H,Hkv,Sq,Sk", SHAPES)
def test_bwd_plain_matches_the_references_vjp(H, Hkv, Sq, Sk, causal, window,
                                              D, dtype):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(
        H * 7 + Sq + Sk + D + window, 1, H, Hkv, Sq, Sk, D, dtype)
    want = _reference(jq, jk, jv, jdo, causal, window)
    o, lse = flash_attention_lse_plain(q, k, v, causal, window)
    got = flash_attention_bwd_plain(q, k, v, o, lse, do, causal, window)
    for g, x in zip(got, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
    _check(got, want, dtype)


def _scores(q, k, D, causal, window, Sq, Sk):
    """The reference's masked fp32 scores, numpy, GQA by repetition."""
    H, Hkv = q.shape[1], k.shape[1]
    kf = np.repeat(np.asarray(k, np.float32), H // Hkv, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", np.asarray(q, np.float32), kf) \
        / np.sqrt(np.float32(D))
    qpos = np.arange(Sq)[:, None] + (Sk - Sq)
    kpos = np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return s, mask


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("H,Hkv,Sq,Sk", SHAPES)
def test_saved_lse_is_the_references_log_sum_exp(H, Hkv, Sq, Sk, causal,
                                                 window):
    """The forward's saved row statistic: the log-sum-exp of each row's
    scaled scores over the keys it sees (natural base, from the
    reference's fp32 scores), +inf for a row that sees none; and the
    forward's output is unchanged by keeping it."""
    (jq, jk, _, _), (q, k, v, _) = _inputs(Sq + Sk, 2, H, Hkv, Sq, Sk, 64,
                                           "bfloat16")
    o, lse = flash_attention_lse_plain(q, k, v, causal, window)
    assert torch.equal(o, FA.flash_attention_plain(q, k, v, causal, window))
    s, mask = _scores(jq.astype(jnp.float32), jk.astype(jnp.float32), 64,
                      causal, window, Sq, Sk)
    seen = mask.any(-1)
    want = np.where(seen, np.asarray(jax.nn.logsumexp(
        jnp.where(mask, s, -jnp.inf), axis=-1)), np.inf)
    assert lse.dtype == torch.float32 and lse.shape == (2, H, Sq)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)
    assert int(np.isinf(lse.numpy()).sum()) == 2 * H * no_key_rows(
        Sq, Sk, causal)


def _split_bf16(x):
    """x as the kernel feeds an fp32 operand to a bf16 product: hi =
    bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _kernel_emulation(q, k, v, lse, do, causal, window):
    """The bf16 kernel's rounding, in torch on the CPU: q.k and dO.v from
    the bf16 inputs summed in fp32; P = 2^(s log2(e)/sqrt(D) - lse
    log2(e)) on the keys a row sees; delta = rowsum(P o dP) from the fp32
    P and dP; dS = P (dP - delta) / sqrt(D); dv, dk and dq with P and dS
    each split into two bf16 halves, hi and lo, whose products sum in
    fp32; each query head's dk and dv rounded to bf16, a group's heads
    summed in fp32 and rounded once; the no-key rows' dO / Sk in dv."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = k.float().repeat_interleave(G, 1)
    vf = v.float().repeat_interleave(G, 1)
    qf, dof = q.float(), do.float()
    log2e = 1.4426950408889634
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    mask = FA._mask(Sq, Sk, causal, window, "cpu")
    p = torch.where(mask, torch.exp2(s * (log2e / D ** 0.5)
                                     - lse[..., None] * log2e), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta) * (1.0 / D ** 0.5)
    ph, pl = _split_bf16(p)
    sh, sl = _split_bf16(ds)
    dq = (torch.einsum("bhqk,bhkd->bhqd", sh, kf)
          + torch.einsum("bhqk,bhkd->bhqd", sl, kf))
    dk = (torch.einsum("bhqk,bhqd->bhkd", sh, qf)
          + torch.einsum("bhqk,bhqd->bhkd", sl, qf))
    dv = (torch.einsum("bhqk,bhqd->bhkd", ph, dof)
          + torch.einsum("bhqk,bhqd->bhkd", pl, dof))
    n0 = no_key_rows(Sq, Sk, causal)
    if n0:
        dv = dv + dof[:, :, :n0].sum(2, keepdim=True) / Sk

    def group(t):
        t = t.to(torch.bfloat16).float().view(B, Hkv, G, Sk, D).sum(2)
        return t.to(torch.bfloat16)
    return dq.to(torch.bfloat16), group(dk), group(dv)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("H,Hkv,Sq,Sk,D", [
    (4, 1, 64, 64, 64), (6, 1, 33, 97, 128), (2, 2, 40, 24, 16),
    (2, 2, 32, 80, 256)])
def test_kernel_rounding_matches_the_reference(H, Hkv, Sq, Sk, D, causal,
                                               window):
    """The bf16 kernel's arithmetic, emulated, holds the reference's VJP
    within the bf16 tolerance, and its hi/lo halves keep P and dS near
    fp32: within 2**-7 of each gradient's scale of the plain backward."""
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(Sq * 3 + D, 2, H, Hkv, Sq, Sk,
                                               D, "bfloat16")
    want = _reference(jq, jk, jv, jdo, causal, window)
    o, lse = flash_attention_lse_plain(q, k, v, causal, window)
    got = _kernel_emulation(q, k, v, lse, do, causal, window)
    _check(got, want, "bfloat16")
    plain = flash_attention_bwd_plain(q, k, v, o, lse, do, causal, window)
    for g, w in zip(got, plain):
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= 2 ** -7 * scale


def test_cpu_backward_runs_the_plain_backward(monkeypatch):
    """``_FlashAttention.backward`` on CPU tensors calls
    ``flash_attention_bwd_plain`` once, with the forward's o and lse, and
    launches nothing; without autograd the forward keeps no lse."""
    (_, _, _, _), (q, k, v, do) = _inputs(9, 1, 4, 2, 20, 30, 16, "float32")
    calls = []
    real = FA.flash_attention_bwd_plain

    def spy(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(FA, "flash_attention_bwd_plain", spy)
    before = (FA.flash_attention.launches, FA.flash_attention_bwd.launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, True, 8)
    grads = torch.autograd.grad(out, leaves, do)
    assert len(calls) == 1
    o, lse = flash_attention_lse_plain(q, k, v, True, 8)
    assert torch.equal(calls[0][3], o) and torch.equal(calls[0][4], lse)
    want = flash_attention_bwd(q, k, v, o, lse, do, True, 8)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)
    assert (FA.flash_attention.launches,
            FA.flash_attention_bwd.launches) == before
    with torch.no_grad():
        assert torch.equal(flash_attention(*leaves, True, 8), o)


def test_work_backward_counts_the_kernels_products():
    """Five products over the visible pairs, eight at the bf16 rate as the
    kernel issues them (P and dS in two halves), five at the f32 rate."""
    from repro_torch.core.perf_model import H100_SXM
    shape = (4, 32, 2048, 64)
    pairs = FA.visible_pairs(2048, 2048, True, 0)
    w = FA.work_backward(shape, 32, 2048, torch.bfloat16, True, 0)
    assert w.flops == 5 * 2 * 64 * pairs * 4 * 32
    assert w.ops_s == pytest.approx(8 / 5 * w.flops
                                    / H100_SXM.peak_flops_bf16)
    assert w.bound_by == "operations"
    f = FA.work_backward(shape, 32, 2048, torch.float32, True, 0)
    assert f.ops_s == pytest.approx(f.flops / H100_SXM.peak_flops_f32)
    assert f.bytes == 2 * w.bytes - 4 * 4 * 32 * 2048


# phase 5c's four training shapes (chip_smoke.FLASH_BWD_CASES[:4]: Zamba2's
# shared block, Mixtral, Gemma-7B, Whisper-medium's encoder), (B, H, Hkv,
# Sq, Sk, D), with the plan's bf16 kernel and its (dq, dk/dv) grids
TRAIN_PLANS = [
    ((4, 32, 32, 2048, 2048, 64), "wgmma", (16, 32, 4), (16, 32, 4)),
    ((2, 32, 8, 2048, 2048, 128), "wgmma", (16, 32, 2), (16, 8, 2)),
    ((2, 16, 16, 2048, 2048, 256), "mma", (32, 16, 2), (32, 16, 2)),
    ((8, 16, 16, 1500, 1500, 64), "wgmma", (12, 16, 8), (12, 16, 8))]
SMEM_LIMIT = 232448          # an H100's opt-in shared memory a block


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", FA.HEAD_DIMS)
def test_bwd_plan_picks_the_kernel_by_type_and_head_dim(D, dtype):
    """bf16 at D 16-128 on the wgmma kernels (blocks of 128 rows or keys,
    384 threads), at D 256 on mma.sync, f32 on the FMA units; every
    block's shared memory within an H100's 227 KB."""
    plan = FA.bwd_plan(1, 4, 2, 100, 100, D, TDT[dtype])
    want = "fma" if dtype == "float32" else "wgmma" if D <= 128 else "mma"
    assert plan.kernel == want
    assert 0 < max(plan.dq_smem, plan.kv_smem) <= SMEM_LIMIT
    if want == "wgmma":
        assert (plan.dq_rows, plan.kv_keys, plan.kv_threads) == (128, 128, 384)
        assert plan.dq_keys == 64
        assert plan.kv_queries == (32 if D == 128 else 64)
    else:
        assert plan.dq_rows == plan.kv_keys == 64


@pytest.mark.parametrize("shape,kernel,dq_grid,kv_grid", TRAIN_PLANS)
def test_bwd_plan_grids_at_the_training_shapes(shape, kernel, dq_grid,
                                               kv_grid):
    """The grids of phase 5c's four calls: a dq block a (query tile, head,
    batch), a dk/dv block a (key tile, kv head, batch); the workspace is
    each row's delta and, with a GQA group in bf16, the group's fp32 dk and
    dv sums."""
    B, H, Hkv, Sq, Sk, D = shape
    plan = FA.bwd_plan(*shape, torch.bfloat16)
    assert (plan.kernel, plan.dq_grid, plan.kv_grid) == \
        (kernel, dq_grid, kv_grid)
    sums = 2 * B * Hkv * Sk * D if H != Hkv else 0
    assert plan.workspace == B * H * Sq + sums
    f32 = FA.bwd_plan(*shape, torch.float32)
    assert f32.workspace == B * H * Sq


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D", [
    (1, 4, 2, 1, 129, 64), (2, 12, 2, 127, 257, 128), (1, 4, 4, 257, 63, 64),
    (1, 2, 1, 129, 129, 16), (3, 4, 4, 65, 1, 256), (1, 6, 3, 300, 200, 32)])
def test_bwd_plan_grids_cover_ragged_lengths(B, H, Hkv, Sq, Sk, D, dtype):
    """At ragged Sq and Sk the grids take the fewest tiles that cover every
    query row (dq) and every key (dk/dv), the workspace as above."""
    plan = FA.bwd_plan(B, H, Hkv, Sq, Sk, D, TDT[dtype])
    nq, nk = plan.dq_grid[0], plan.kv_grid[0]
    assert (nq - 1) * plan.dq_rows < Sq <= nq * plan.dq_rows
    assert (nk - 1) * plan.kv_keys < Sk <= nk * plan.kv_keys
    assert plan.dq_grid[1:] == (H, B) and plan.kv_grid[1:] == (Hkv, B)
    sums = 2 * B * Hkv * Sk * D if H != Hkv and dtype == "bfloat16" else 0
    assert plan.workspace == B * H * Sq + sums == FA.bwd_workspace(
        B, H, Hkv, Sq, Sk, D, TDT[dtype])


def test_bwd_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="head dims"):
        FA.bwd_plan(1, 2, 2, 8, 8, 48, torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.bwd_plan(1, 2, 2, 8, 8, 64, torch.float16)
