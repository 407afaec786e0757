"""The port's ``flash_attention`` against the reference's, on the CPU.

On a CPU tensor the port's wrapper runs its plain version; the reference's
``repro.kernels.ops.flash_attention`` runs the Pallas kernel in interpret
mode.  Inputs come from numpy seeds and go to both packages.  Tolerances are
those of ``tests/test_kernels.py``: f32 2e-5, bf16 2e-2.  The kernel itself
is held against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ops import flash_attention as jflash
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, H, Hkv, Sq, Sk, D, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]
    return ([jnp.asarray(a).astype(JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# the grid of tests/test_kernels.py:22-30, and Gemma-7B's head dim 256
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D", [
    (1, 2, 2, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),     # GQA 2:1
    (1, 4, 1, 128, 256, 32),     # MQA, chunked-prefill alignment
    (1, 2, 2, 128, 128, 128),
    (1, 2, 1, 128, 128, 256),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_kernel(B, H, Hkv, Sq, Sk, D, causal,
                                               window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(Sq + Sk + D, B, H, Hkv, Sq, Sk, D,
                                      dtype)
    want = jflash(jq, jk, jv, causal, window, 128)
    got = flash_attention(q, k, v, causal, window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, TOL[dtype])


# ragged lengths the Pallas kernel does not take (block multiples only)
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window", [
    (1, 4, 2, 37, 37, 16, True, 0),
    (2, 4, 1, 13, 50, 32, True, 0),       # chunked prefill, ragged
    (1, 2, 2, 70, 70, 16, True, 32),      # longer than the window
    (1, 4, 2, 9, 200, 64, True, 64),      # window, q at the end of the keys
    (1, 2, 1, 33, 33, 128, False, 0),
    (1, 2, 1, 70, 70, 256, True, 0),      # Gemma-7B's head dim
    (1, 2, 1, 6, 70, 256, True, 0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_matches_reference_oracle(
        B, H, Hkv, Sq, Sk, D, causal, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(Sq * 7 + Sk, B, H, Hkv, Sq, Sk, D,
                                      dtype)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    got = flash_attention(q, k, v, causal, window)
    _close(got, want, TOL[dtype])


def test_flash_attention_grad_matches_reference():
    # tests/test_kernels.py:44-58: the gradient of the kernel's wrapper
    (jq, jk, jv), (q, k, v) = _inputs(5, 1, 2, 2, 128, 128, 32, "float32")
    jg = jax.grad(lambda q, k, v: jflash(q, k, v).sum(),
                  argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*leaves).sum().backward()
    for got, want in zip(leaves, jg):
        assert torch.isfinite(got.grad).all()
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    _, (q, k, v) = _inputs(1, 1, 4, 2, 16, 16, 16, "float32")
    before = flash_attention.launches
    got = flash_attention(q, k, v, True, 8)
    assert flash_attention.launches == before
    assert torch.equal(got, flash_attention_plain(q, k, v, True, 8))


def test_shapes_that_do_not_fit_raise():
    q = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError, match="Hkv"):
        flash_attention(q, torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError, match="needs q"):
        flash_attention(q[0], q[0], q[0])
    with pytest.raises(RuntimeError, match="no kernel"):
        m = torch.zeros(1, 2, 8, 16, device="meta")
        flash_attention(m, m, m)


def _split_bf16(p):
    """P as the kernel feeds it to P V: hi = bf16(p), lo = bf16(p - hi)."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def _tc_kernel_emulation(q, k, v, causal, window, split=True):
    """The bf16 tensor-core kernel's rounding, in torch on the CPU: q.k from
    the bf16 inputs summed in fp32, the scale (with log2 e) applied to the
    fp32 scores, 64-key tiles (32 at D 256) in order with an fp32 running
    max and sum in base 2, P V as hi V + lo V with P split into two bf16
    halves (``split=False``: P rounded to bf16, the kernel before the
    split), l summed from the fp32 P, the output divided by max(l, 1e-30)
    and rounded to bf16."""
    B, H, Sq, D = q.shape
    BK = 32 if D > 128 else 64
    Hkv, Sk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // Hkv, dim=1)
    vf = v.float().repeat_interleave(H // Hkv, dim=1)
    qf = q.float()
    scale_log2 = float(np.float32(1.4426950408889634 / np.sqrt(D)))
    qpos = torch.arange(Sq)[:, None] + (Sk - Sq)
    m = torch.full((B, H, Sq), -1.0e38)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, D)
    for k0 in range(0, Sk, BK):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + BK]) \
            * scale_log2
        kpos = torch.arange(k0, min(k0 + BK, Sk))[None, :]
        ok = torch.ones(Sq, kpos.shape[1], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, torch.tensor(-1.0e38))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        vt = vf[:, :, k0:k0 + BK]
        if split:
            hi, lo = _split_bf16(p)
            pv = (torch.einsum("bhqk,bhkd->bhqd", hi, vt)
                  + torch.einsum("bhqk,bhkd->bhqd", lo, vt))
        else:
            pv = torch.einsum("bhqk,bhkd->bhqd",
                              p.to(torch.bfloat16).float(), vt)
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(torch.bfloat16)


TC_SHAPES = [
    (1, 2, 2, 128, 128, 64),
    (1, 4, 1, 128, 256, 32),     # MQA, q at the end of the keys
    (1, 2, 2, 128, 128, 128),
    (1, 2, 1, 128, 128, 16),
    (1, 2, 1, 64, 128, 256),     # Gemma's D 256: 32-key tiles
]
TC_MASKS = [(True, 0), (True, 64), (False, 0)]


@functools.lru_cache(maxsize=None)
def _tc_case(B, H, Hkv, Sq, Sk, D, causal, window):
    """The bf16 inputs (torch) and the Pallas kernel's output (numpy) of
    one case; 1500 keys take 100-key blocks (the kernel takes block
    multiples only)."""
    (jq, jk, jv), tq = _inputs(Sq * 3 + D, B, H, Hkv, Sq, Sk, D, "bfloat16")
    want = jflash(jq, jk, jv, causal, window, 128 if Sk % 128 == 0 else 100)
    return tq, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D", TC_SHAPES)
@pytest.mark.parametrize("causal,window", TC_MASKS)
def test_tensor_core_numerics_match_pallas_kernel(B, H, Hkv, Sq, Sk, D,
                                                  causal, window):
    """The bf16 kernel's numerics (scale on the fp32 scores, P V from P's
    two bf16 halves, l from the fp32 P, 64-key tiles) held to the
    reference's Pallas kernel in interpret mode within the bf16 tolerance
    2e-2."""
    (q, k, v), want = _tc_case(B, H, Hkv, Sq, Sk, D, causal, window)
    got = _tc_kernel_emulation(q, k, v, causal, window)
    _close(got, want, TOL["bfloat16"])


def _bf16_differs(got: torch.Tensor, want: np.ndarray) -> tuple:
    """The share of bf16 outputs that differ, and the largest difference
    over max |want|."""
    w = torch.tensor(want)
    d = (got.float() - w).abs()
    return float((d > 0).float().mean()), float(d.max() / w.abs().max())


# the share of bf16 outputs allowed to differ from the reference's, and
# the largest difference allowed: one bf16 ulp at the output's scale
MAX_DIFFER_SHARE = 0.01
MAX_DIFF_SCALE = 2.0 ** -8


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window", [
    s + m for s in TC_SHAPES for m in TC_MASKS
] + [(2, 4, 4, 32, 1500, 64, False, 0)])   # Whisper's cross attention
def test_tensor_core_p_v_keeps_the_references_precision(B, H, Hkv, Sq, Sk, D,
                                                        causal, window):
    """P V at the reference's fp32 precision: with P split into two bf16
    halves the kernel's emulation rounds to the Pallas kernel's bf16
    outputs but for at most 1% of them, each at most one bf16 ulp of the
    output's scale away; P rounded to bf16 (the kernel before the split,
    planted here) changes more than 10% of them."""
    (q, k, v), want = _tc_case(B, H, Hkv, Sq, Sk, D, causal, window)
    share, worst = _bf16_differs(
        _tc_kernel_emulation(q, k, v, causal, window), want)
    assert share <= MAX_DIFFER_SHARE, share
    assert worst <= MAX_DIFF_SCALE, worst
    planted, _ = _bf16_differs(
        _tc_kernel_emulation(q, k, v, causal, window, split=False), want)
    assert planted > 0.10, planted
