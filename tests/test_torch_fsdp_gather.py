"""ZeRO-3 at the layer: the port's use-site ``gather_fsdp`` on two gloo
ranks on the CPU against the JAX package on two fake XLA devices.

One module-scoped launch spawns the two ranks once (``core.spmd.launch``,
one intra-op thread a rank); on a (``data`` 2, ``model`` 1) mesh with
``fsdp_params`` they run ``tests/fsdp_gather_cases.py`` over reduced
Mixtral, Zamba2 and xLSTM — two train steps, a prefill, a decode step —
while one JAX subprocess (``tests/fsdp_gather_reference.py``) runs the
reference's jitted steps on the same numpy inputs, made here from a seed.

Bounds: the train steps as ``tests/test_torch_spmd.py`` holds them: each
step's loss within 2e-3 relative; each leaf's update over the steps
within 0.15 of the reference's in the L2 norm for Mixtral (its model),
and within ``tests/test_torch_tp.py``'s 0.3 for Zamba2 and xLSTM, whose
zero-initialised Mamba2 vectors (``A_log``, ``dt_bias``) take gradients
near the packages' difference (AdamW moves an element by about lr x its
gradient's sign; measured up to 0.156, as test_torch_tp.py measures up to
0.17 for the same models); and each leaf's update within 1e-3 of the
port's own one-device step in two micro-batches
(``tests/test_torch_spmd.py``'s ``ONE_DEVICE_TOL``: the same function,
only the order of the sums over the ranks differs).  The prefill's whole
logits within ``tests/test_torch_tp.py``'s ``PREFILL_TOL``, 1e-2 of their
scale (the model's bf16 activations over whole blocks).

No rank ever holds the whole parameter tree: the counter that
``gather_fsdp`` keeps of the weights it gathered and that are still alive
(``core.plan.FSDP_GATHERED``) peaks at or under the largest block's
weights, whole over the data axis, in every step; and every weight the
data axis splits is gathered at its use (the bytes gathered in a step at
least the split weights' whole bytes), so a step that gathered the whole
tree before the forward, and never at the use, fails here too.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import fsdp_gather_cases as C
from repro_torch.configs import get
from repro_torch.core import spmd
from repro_torch.core.plan import ShardingPlan, spec_axes
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models.lm import LM
from repro_torch.models.params import walk_defs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL, PREFILL_TOL, ONE_DEVICE_TOL = 2e-3, 1e-2, 1e-3
UPDATE_TOL = {"mixtral-8x7b": 0.15, "zamba2-1.2b": 0.3, "xlstm-125m": 0.3}
# attention's q/k/v and Mamba2's B/C at the fan-in of the d_model they
# contract, as tests/test_torch_tp.py draws them (else the attention is
# nearly one-hot and the reduced models chaotic)
CONTRACT_D = ("wq", "wk", "wv", "wB", "wC")


def _inputs():
    rng = np.random.default_rng(0)
    inp = {}
    for name in C.CONFIGS:
        cfg = get(name).reduced()
        pre = C.prefix(name)
        for path, d in walk_defs(LM(cfg).param_defs()):
            k = pre + "/" + "/".join(path)
            if d.init in ("zeros", "ones"):
                inp[k] = np.full(d.shape, 0.0 if d.init == "zeros" else 1.0,
                                 np.float32)
                continue
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            if path[-1] in CONTRACT_D and ("attn" in path
                                           or path[-1] in ("wB", "wC")):
                fan_in = cfg.d_model
            std = d.scale if d.init == "embed" else d.scale / np.sqrt(fan_in)
            inp[k] = (rng.standard_normal(d.shape) * std).astype(np.float32)
        tok = lambda *s: rng.integers(0, cfg.vocab, s, dtype=np.int32)
        inp[f"{pre}_train"] = tok(C.TRAIN_STEPS, C.B_TRAIN, C.S_TRAIN)
        inp[f"{pre}_prompt"] = tok(C.B_PROMPT, C.S_PROMPT)
        inp[f"{pre}_decode"] = tok(C.B_PROMPT, 1)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp_gather")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    log = open(d / "ref.log", "w")
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "fsdp_gather_reference.py"),
         str(d / "in.npz"), str(d / "ref.npz")],
        env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        ranks = spmd.launch(C.rank_main, 2, str(d / "in.npz"), device="cpu",
                            timeout_s=300)
        ref.wait(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
        log.close()
    assert ref.returncode == 0, (d / "ref.log").read_text()[-3000:]
    return inp, ranks, dict(np.load(d / "ref.npz"))


def _split_leaves(name):
    """(path, def, whole bytes of one layer) of every leaf the data axis
    splits on the test's mesh (the test's parameters are fp32)."""
    plan = ShardingPlan(abstract_mesh(C.MESH, ("data", "model")))
    out = []
    for path, d in walk_defs(LM(get(name).reduced()).param_defs()):
        spec = plan.param_spec(d.axes, d.shape)
        if any("data" in spec_axes(e) for e in spec):
            shape = d.shape[1:] if path[0] == "stacks" else d.shape
            out.append((path, d, int(np.prod(shape)) * 4))
    return out


def _largest_block(name) -> int:
    """The largest block's weights whole over the data axis, in bytes: a
    layer of a stack, the shared block, the embedding, the lm_head."""
    blocks = {}
    for path, _, n in _split_leaves(name):
        key = path[:2] if path[0] in ("stacks", "embed") else path[:1]
        blocks[key] = blocks.get(key, 0) + n
    return max(blocks.values())


def _all_split_bytes(name) -> int:
    cfg = get(name).reduced()
    layers = cfg.stack_sizes()
    return sum(n * (layers[p[1]] if p[0] == "stacks" else 1)
               for p, _, n in _split_leaves(name))


def _update_err(got, p0, want):
    d_ref = want - p0
    n = float(np.linalg.norm(d_ref))
    return float(np.linalg.norm((got - p0) - d_ref)) / max(n, 1e-30)


@pytest.mark.parametrize("name", C.CONFIGS)
def test_train_steps_match_the_reference(runs, name):
    inp, ranks, ref = runs
    pre = C.prefix(name)
    keys = [k for k in ref if k.startswith(f"{pre}/params/")]
    assert keys
    for got in ranks:
        np.testing.assert_allclose(got[f"{pre}/losses"],
                                   ref[f"{pre}/losses"], rtol=LOSS_RTOL)
        worst = max((_update_err(got[k], inp[pre + k[len(pre) + 7:]],
                                 ref[k]), k) for k in keys)
        print(f"{name}: worst update {worst[0]:.3e} ({worst[1]})")
        assert worst[0] <= UPDATE_TOL[name], worst


@pytest.mark.parametrize("name", C.CONFIGS)
def test_train_steps_match_the_one_device_steps(runs, name):
    inp, ranks, _ = runs
    pre = C.prefix(name)
    for got in ranks:
        keys = [k for k in got if k.startswith(f"{pre}/one/params/")]
        assert keys
        worst = max((_update_err(got[pre + k[len(pre) + 4:]],
                                 inp[pre + k[len(pre) + 11:]], got[k]), k)
                    for k in keys)
        print(f"{name}: worst update against one device {worst[0]:.3e}")
        assert worst[0] <= ONE_DEVICE_TOL, worst


@pytest.mark.parametrize("name", C.CONFIGS)
def test_prefill_logits_match_the_reference(runs, name):
    _, ranks, ref = runs
    pre = C.prefix(name)
    want = np.asarray(ref[f"{pre}/prefill_logits"], np.float64)
    for got in ranks:
        g = np.asarray(got[f"{pre}/prefill_logits"], np.float64)
        assert g.shape == want.shape
        err = float(np.abs(g - want).max() / np.abs(want).max())
        print(f"{name}: prefill logits {err:.3e} of the scale")
        assert err <= PREFILL_TOL, err


@pytest.mark.parametrize("name", C.CONFIGS)
def test_ranks_hold_their_shards(runs, name):
    """Between steps each rank holds half of every leaf the data axis
    splits (and there are such leaves)."""
    _, ranks, _ = runs
    split = {p for p, _, _ in _split_leaves(name)}
    assert split
    want = [int(np.prod(d.shape)) // (2 if path in split else 1)
            for path, d in sorted(walk_defs(LM(get(name).reduced())
                                            .param_defs()),
                                  key=lambda pd: pd[0])]
    for r in ranks:
        np.testing.assert_array_equal(r[f"{C.prefix(name)}/local_numel"],
                                      want)


@pytest.mark.parametrize("step", ["train0", "train1", "prefill", "decode"])
@pytest.mark.parametrize("name", C.CONFIGS)
def test_no_rank_holds_more_than_a_block(runs, name, step):
    """The live gathered bytes' high-water mark stays at or under the
    largest block's weights; the step gathered every split weight at its
    use (the decode step, one token, gathers them all too)."""
    _, ranks, _ = runs
    pre = C.prefix(name)
    bound, total = _largest_block(name), _all_split_bytes(name)
    for r in ranks:
        peak = int(r[f"{pre}/{step}/peak"])
        gathered = int(r[f"{pre}/{step}/bytes"])
        print(f"{name} {step}: peak {peak} B of a block's {bound} B (the "
              f"tree's {total} B); {int(r[f'{pre}/{step}/gathers'])} "
              f"gathers, {gathered} B")
        assert 0 < peak <= bound, (peak, bound)
        assert gathered >= total, (gathered, total)
