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
from repro_torch.kernels.flash_attention import (SMS, flash_attention,
                                                 flash_attention_plain,
                                                 launch_plan, split_keys)

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


@pytest.mark.parametrize("H,Hkv,Sq,Sk,D,window", [
    (4, 2, 100, 60, 64, 0), (2, 2, 40, 24, 16, 16), (6, 1, 33, 5, 128, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_rows_that_see_no_key_match_reference_oracle(H, Hkv, Sq, Sk, D,
                                                           window, dtype):
    """Causal with Sq > Sk: the first Sq - Sk rows see no key, and the
    reference's softmax over their all-NEG_INF scores is uniform, so its
    output there is the mean of v over the Sk keys.  The plain version,
    which the kernels are held to on the card, gives the reference's
    output on every row, that mean on those."""
    (jq, jk, jv), (q, k, v) = _inputs(Sq * 5 + Sk, 2, H, Hkv, Sq, Sk, D,
                                      dtype)
    want = jref.attention_ref(jq, jk, jv, causal=True, window=window)
    got = flash_attention_plain(q, k, v, True, window)
    _close(got, want, TOL[dtype])
    n0 = Sq - Sk
    mean = v.float().mean(2).repeat_interleave(H // Hkv, 1)[:, :, None]
    _close(got[:, :, :n0], mean.expand(2, H, n0, D).numpy(), TOL[dtype])


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
    fp32 scores, the KV tiles of ``launch_plan`` (128 keys, 64 at D 256) in
    order within each of its key splits with an fp32 running max and sum in
    base 2, P V as hi V + lo V with P split into two bf16 halves
    (``split=False``: P rounded to bf16, the kernel before the split), l
    summed from the fp32 P; one split's output divided by max(l, 1e-30),
    several merged in fp32 as the kernel's last block merges them (M = max
    m_s, O = sum 2^(m_s - M) O_s / max(sum 2^(m_s - M) l_s, 1e-30)); then
    rounded to bf16.  Tiles the kernel skips for a row hold only masked
    keys and add exact zeros, so every row walks every tile of its split."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    plan = launch_plan(B, H, Hkv, Sq, Sk, D)
    kf = k.float().repeat_interleave(H // Hkv, dim=1)
    vf = v.float().repeat_interleave(H // Hkv, dim=1)
    qf = q.float()
    scale_log2 = float(np.float32(1.4426950408889634 / np.sqrt(D)))
    qpos = torch.arange(Sq)[:, None] + (Sk - Sq)

    def walk(tiles):
        m = torch.full((B, H, Sq), -1.0e38)
        l = torch.zeros(B, H, Sq)
        acc = torch.zeros(B, H, Sq, D)
        for k0, k1 in tiles:
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k1]) \
                * scale_log2
            kpos = torch.arange(k0, k1)[None, :]
            ok = torch.ones(Sq, k1 - k0, dtype=torch.bool)
            if causal:
                ok &= kpos <= qpos
            if window > 0:
                ok &= kpos > qpos - window
            s = torch.where(ok, s, torch.tensor(-1.0e38))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            vt = vf[:, :, k0:k1]
            if split:
                hi, lo = _split_bf16(p)
                pv = (torch.einsum("bhqk,bhkd->bhqd", hi, vt)
                      + torch.einsum("bhqk,bhkd->bhqd", lo, vt))
            else:
                pv = torch.einsum("bhqk,bhkd->bhqd",
                                  p.to(torch.bfloat16).float(), vt)
            acc = acc * corr[..., None] + pv
            m = m_new
        return m, l, acc

    parts = [walk(tiles) for tiles in split_keys(plan, Sk)]
    if len(parts) == 1:
        m, l, acc = parts[0]
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(torch.bfloat16)
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros(B, H, Sq)
    O = torch.zeros(B, H, Sq, D)
    for m, l, acc in parts:
        w = torch.exp2(m - M)
        L = L + w * l
        O = O + w[..., None] * acc
    return (O / torch.clamp(L, min=1e-30)[..., None]).to(torch.bfloat16)


TC_SHAPES = [
    (1, 2, 2, 128, 128, 64),
    (1, 4, 1, 128, 256, 32),     # MQA, q at the end of the keys: 2 splits
    (1, 2, 2, 128, 128, 128),
    (1, 2, 1, 128, 128, 16),
    (1, 2, 1, 64, 128, 256),     # Gemma's D 256: 64-key tiles, 2 splits
    (1, 2, 1, 256, 256, 256),    # 4 KV tiles of 64 split 4 ways
    (1, 2, 2, 40, 300, 64),      # 40 queries against 3 tiles: 3 splits
    (1, 1, 1, 64, 640, 128),     # 64 queries against 5 tiles: 5 splits
]
TC_MASKS = [(True, 0), (True, 64), (False, 0)]
# two query tiles of 128 at D 128 over 3 KV tiles of 128, one a split.  Held
# to 2e-2 only: without a mask one output, 0.2637 where the largest is
# 0.3926, rounds one bf16 ulp (2^-9) away from the Pallas kernel's, which is
# past the precision test's bound of 2^-8 of the largest output
TC_TWO_Q_TILES = [(1, 1, 1, 256, 384, 128) + m for m in TC_MASKS]
# Whisper's cross attention at prefill and decode against its 1500 frames,
# where the plan splits the keys (B2 H4: 8 blocks, 12 tiles one a split)
TC_SPLIT_CASES = [(2, 4, 4, 32, 1500, 64, False, 0),
                  (2, 4, 4, 1, 1500, 64, False, 0)]


@functools.lru_cache(maxsize=None)
def _tc_case(B, H, Hkv, Sq, Sk, D, causal, window):
    """The bf16 inputs (torch) and the Pallas kernel's output (numpy) of
    one case; 1500 keys take 100-key blocks (the kernel takes block
    multiples only)."""
    (jq, jk, jv), tq = _inputs(Sq * 3 + D, B, H, Hkv, Sq, Sk, D, "bfloat16")
    want = jflash(jq, jk, jv, causal, window, 128 if Sk % 128 == 0 else 100)
    return tq, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,window", [
    s + m for s in TC_SHAPES for m in TC_MASKS] + TC_SPLIT_CASES
    + TC_TWO_Q_TILES)
def test_tensor_core_numerics_match_pallas_kernel(B, H, Hkv, Sq, Sk, D,
                                                  causal, window):
    """The bf16 kernel's numerics (scale on the fp32 scores, P V from P's
    two bf16 halves, l from the fp32 P, ``launch_plan``'s tiles and key
    splits merged in fp32) held to the reference's Pallas kernel in
    interpret mode within the bf16 tolerance 2e-2."""
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
] + TC_SPLIT_CASES)   # Whisper's cross attention
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


def test_split_cases_split_the_keys():
    """The cases above that stand for the split form do split, and causal
    at B1 H2 S256 D256 has a split whose every key is masked for rows 0-191
    (its last, keys 192-255: for the first query tile an empty split, for
    the second one its first warpgroup skips)."""
    for B, H, Hkv, Sq, Sk, D, _c, _w in TC_SPLIT_CASES:
        assert launch_plan(B, H, Hkv, Sq, Sk, D).splits > 1
    assert (1, 2, 1, 256, 256, 256) in TC_SHAPES
    plan = launch_plan(1, 2, 1, 256, 256, 256)
    assert plan.splits == 4 and plan.q_tiles == 2
    assert split_keys(plan, 256)[-1] == [(192, 256)]


def _chip_smoke():
    """``chip_smoke.py`` loaded by path (it imports torch and the port)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card_shapes():
    """(B, H, Hkv, Sq, Sk, D) of every bf16 case of chip_smoke.py's phase 2
    (FLASH_CASES with the tile edges at every head dim and the split
    cases) and of the timed rows of tools/time_flash.py."""
    cs = _chip_smoke()
    shapes = {c[:6] for c in cs.FLASH_CASES if torch.bfloat16 in c[8]}
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "time_flash.py"
    spec = importlib.util.spec_from_file_location("time_flash_rows", path)
    tf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tf)
    shapes |= {row[1:7] for row in tf.SHAPES}
    return sorted(shapes)


def test_launch_plan_covers_every_key_once():
    """Over its splits and their tiles the plan walks every key of [0, Sk)
    exactly once, in order, with no split empty, at every shape the card
    checks or times; a split takes at most ``tiles_per_split`` tiles."""
    shapes = _card_shapes()
    assert len(shapes) > 60
    for B, H, Hkv, Sq, Sk, D in shapes:
        plan = launch_plan(B, H, Hkv, Sq, Sk, D)
        splits = split_keys(plan, Sk)
        assert len(splits) == plan.splits >= 1
        assert all(0 < len(t) <= plan.tiles_per_split for t in splits)
        ranges = [r for t in splits for r in t]
        assert ranges[0][0] == 0 and ranges[-1][1] == Sk
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(0 < b - a <= plan.block_k for a, b in ranges)
        assert plan.blocks == B * H * plan.q_tiles * plan.splits


def test_launch_plan_splits_exactly_where_two_splits_fit_one_wave():
    """The keys are split exactly where two splits of the (B, H, q tile)
    grid fit in one wave of 132 blocks and the keys span two KV tiles or
    more; a split call then runs in one wave; a grid of 67-131 blocks
    (Whisper's cross attention, B8 H16) is not split."""
    shapes = _card_shapes() + [(B, H, 1, Sq, Sk, D)
                               for B in (1, 2, 8) for H in (1, 8, 16, 33)
                               for Sq in (1, 32, 64, 128, 129, 2048)
                               for Sk in (64, 128, 129, 1500, 4096)
                               for D in (64, 256)]
    seen = set()
    for B, H, Hkv, Sq, Sk, D in shapes:
        plan = launch_plan(B, H, Hkv, Sq, Sk, D)
        grid = B * H * plan.q_tiles
        split = 2 * grid <= SMS and plan.kv_tiles >= 2
        assert (plan.splits > 1) == split, (B, H, Sq, Sk, D, plan)
        if split:
            assert 2 <= plan.splits <= plan.kv_tiles
            assert plan.blocks <= SMS
            assert plan.partial_floats == B * H * plan.splits * Sq * (D + 2)
            assert plan.tickets == grid
        else:
            assert plan.partial_floats == plan.tickets == 0
        seen.add((split, 2 * grid > SMS and grid < SMS))
    assert seen >= {(True, False), (False, True), (False, False)}
    assert launch_plan(8, 16, 16, 1, 1500, 64).splits == 1
    assert launch_plan(8, 8, 8, 1, 1500, 64).splits == 2
