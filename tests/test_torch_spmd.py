"""The port's multi-device plan on four gloo ranks on the CPU against the JAX
package on four fake XLA devices.

One module-scoped launch spawns the four ranks once (``core.spmd.launch``:
the spawn start method, a ``file://`` rendezvous, one intra-op thread a
rank); they run every case of ``tests/spmd_cases.py`` while one JAX
subprocess (``tests/spmd_reference.py``, ``--xla_force_host_platform_
device_count=4``) computes the reference's side on the same numpy inputs,
made here from a seed.  Tolerances, each from the reduction order that
changes:

* fp32 products and sums (farm_map, tensor_map, pipeline_shard,
  flash_decode_combine, the vocab-parallel loss and its gradients): XLA's
  CPU dot and torch's sum in other orders, 1e-5 of each output's scale;
* the vocab-parallel embedding is a lookup rounded to bf16 and the a2a
  hop elementwise: equal bit for bit; the embedding's gradient sums bf16
  rows of repeated tokens in another order, 2**-8 of its scale;
* the train steps (fp32 parameters, peak rate 1e-6, two steps) as
  ``tests/test_torch_train.py`` holds them: each step's loss within 2e-3
  relative, each leaf's update over the steps within 0.15 of the
  reference's in the L2 norm (AdamW moves an element by about lr x its
  gradient's sign, so an element whose gradient lies below the packages'
  difference moves the other way; Adafactor's normalised step likewise);
* the restore: each rank's block equals the reference's addressable shard
  of the same device index bit for bit.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import spmd_cases as C
from repro_torch.configs import get
from repro_torch.core import spmd
from repro_torch.models.lm import LM
from repro_torch.models.params import walk_defs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCALE_TOL = 1e-5
ONE_DEVICE_TOL = 1e-3


def _param_arrays(rng, cfg, prefix):
    """Random fp32 parameters for ``cfg``'s defs: zeros and ones where the
    def says, else normal at the def's fan-in scale."""
    out = {}
    for path, d in walk_defs(LM(cfg).param_defs()):
        key = prefix + "/" + "/".join(path)
        if d.init in ("zeros", "ones"):
            out[key] = np.full(d.shape, 0.0 if d.init == "zeros" else 1.0,
                               np.float32)
            continue
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.init == "embed" else d.scale / np.sqrt(fan_in)
        out[key] = (rng.standard_normal(d.shape) * std).astype(np.float32)
    return out


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    mix, kimi = get("mixtral-8x7b").reduced(), C.kimi_wide(get)
    inp = {
        "farm_x": f(8, 16), "farm_w": f(16, 16) * 0.3,
        "tm_a": f(4, 8), "tm_b": f(8, 4), "tm_x": f(4, 8), "tm_w": f(8, 12),
        "pipe_w": f(4, 16, 16) * 0.3, "pipe_b": f(4, 16) * 0.1,
        "pipe_x": f(8, 4, 16),
        "fd_q": f(2, 4, 16), "fd_k": f(2, 64, 4, 16), "fd_v": f(2, 64, 4, 16),
        "a2a_x": f(16, 4), "a2a_c": f(4), "a2a_d": f(4),
        "vp_tok": rng.integers(0, 64, (4, 8), dtype=np.int32),
        "vp_emb": f(64, 16), "vp_x": f(4, 8, 16), "vp_w": f(16, 64) * 0.3,
        "vp_lab": rng.integers(0, 64, (4, 8), dtype=np.int32),
        "vp_mask": (rng.random((4, 8)) > 0.2).astype(np.float32),
        "train_steps": np.asarray(C.TRAIN_STEPS),
        "train_lr": np.asarray(C.TRAIN_LR),
        "kimi_widths": np.asarray(C.KIMI_WIDTHS),
    }
    shape = (C.TRAIN_STEPS, C.B_TRAIN, C.S_TRAIN)
    inp["mix_tok"] = rng.integers(0, mix.vocab, shape, dtype=np.int32)
    inp["kimi_tok"] = rng.integers(0, kimi.vocab, shape, dtype=np.int32)
    inp.update(_param_arrays(rng, mix, "mix"))
    inp.update(_param_arrays(rng, kimi, "kimi"))
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spmd")
    inp = _inputs()
    np.savez(d / "in.npz", **inp)
    (d / "ckpt").mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "spmd_reference.py"),
         str(d / "in.npz"), str(d / "ref.npz"), str(d / "ckpt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = spmd.launch(C.rank_main, 4, str(d / "in.npz"),
                            str(d / "ckpt"), device="cpu", timeout_s=240)
        _, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    return inp, ranks, dict(np.load(d / "ref.npz"))


def _close(got, want, tol=SCALE_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


@pytest.mark.parametrize("case", ["farm", "farm_reduce", "tm_reduce",
                                  "tm_gather", "pipe", "flash_decode",
                                  "vp_loss", "vp_gx", "vp_gw"])
def test_skeletons_match_the_reference(runs, case):
    _, ranks, ref = runs
    for r in ranks:                      # every rank holds the whole result
        _close(r[case], ref[case])


def test_pipeline_matches_the_serial_stages(runs):
    inp, ranks, _ = runs
    x = inp["pipe_x"]
    for s in range(4):
        x = np.tanh(x @ inp["pipe_w"][s] + inp["pipe_b"][s])
    _close(ranks[0]["pipe"], x)


@pytest.mark.parametrize("case", ["a2a", "vp_embed"])
def test_sharded_hop_and_embedding_are_exact(runs, case):
    _, ranks, ref = runs
    for r in ranks:
        np.testing.assert_array_equal(r[case], ref[case])


def test_vocab_parallel_embedding_gradient(runs):
    _, ranks, ref = runs
    for r in ranks:
        _close(r["vp_embed_grad"], ref["vp_embed_grad"], 2.0 ** -8)


def _update_err(got, p0, want):
    d_ref = want - p0
    n = float(np.linalg.norm(d_ref))
    return float(np.linalg.norm((got - p0) - d_ref)) / max(n, 1e-30)


@pytest.mark.parametrize("tag,rank,ref_tag,prefix", [
    ("train_fsdp", 0, "train", "mix"), ("train_dp", 2, "train", "mix"),
    ("adafactor", 0, "adafactor", "kimi")])
def test_train_step_matches_the_reference(runs, tag, rank, ref_tag, prefix):
    inp, ranks, ref = runs
    got = ranks[rank]
    np.testing.assert_allclose(got[f"{tag}/losses"], ref[f"{ref_tag}/losses"],
                               rtol=2e-3)
    keys = [k for k in ref if k.startswith(f"{ref_tag}/params/")]
    assert keys
    for k in keys:
        path = k[len(f"{ref_tag}/params"):]
        p0 = inp[prefix + path]
        err = _update_err(got[f"{tag}/params{path}"], p0, ref[k])
        assert err <= 0.15, (path, err)
    # the other rank of the pair ends with the same whole parameters
    mate = ranks[rank + 1]
    for k in keys:
        path = k[len(f"{ref_tag}/params"):]
        np.testing.assert_array_equal(got[f"{tag}/params{path}"],
                                      mate[f"{tag}/params{path}"])


@pytest.mark.parametrize("tag,rank,one_tag,one_rank,prefix", [
    ("train_fsdp", 0, "train_one", 1, "mix"),
    ("train_dp", 2, "train_one", 1, "mix"),
    ("adafactor", 0, "adafactor_one", 0, "kimi")])
def test_train_step_matches_the_one_device_step(runs, tag, rank, one_tag,
                                                one_rank, prefix):
    """The ranks' step against the port's own step on one device in two
    micro-batches (the same function: each half of the batch routed
    apart): only the order of the sums over the ranks differs, so every
    leaf's update within 1e-3 of the one-device update's L2 norm (measured
    <= 5.2e-5; a rank's gradient not summed over the ranks, or Adafactor's
    row and column statistics taken from one rank's block, fail it)."""
    inp, ranks, _ = runs
    got, one = ranks[rank], ranks[one_rank]
    keys = [k for k in one if k.startswith(f"{one_tag}/params/")]
    assert keys
    for k in keys:
        path = k[len(f"{one_tag}/params"):]
        err = _update_err(got[f"{tag}/params{path}"], inp[prefix + path],
                          one[k])
        assert err <= ONE_DEVICE_TOL, (path, err)


@pytest.mark.parametrize("tag,rank,halved", [("train_fsdp", 0, True),
                                             ("train_dp", 2, False)])
def test_fsdp_ranks_hold_their_shards(runs, tag, rank, halved):
    """Between steps, with fsdp_params each rank holds half of every leaf
    whose fsdp dim divides by 2; without it, every leaf whole."""
    inp, ranks, _ = runs
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.launch.mesh import abstract_mesh
    cfg = get("mixtral-8x7b").reduced()
    plan = ShardingPlan(abstract_mesh((2, 1), ("data", "model")))
    want = []
    for path, d in sorted(walk_defs(LM(cfg).param_defs()),
                          key=lambda pd: pd[0]):
        split = "data" in [a for e in plan.param_spec(d.axes, d.shape)
                           for a in ((e,) if isinstance(e, str) else e or ())]
        want.append(int(np.prod(d.shape)) // (2 if split and halved else 1))
    for r in (rank, rank + 1):
        np.testing.assert_array_equal(ranks[r][f"{tag}/local_numel"], want)
    assert halved == any(w < int(np.prod(d.shape)) for w, (_, d) in zip(
        want, sorted(walk_defs(LM(cfg).param_defs()), key=lambda pd: pd[0])))


def test_reshard_state_places_the_reference_checkpoint(runs):
    """Each rank's block of every leaf is the reference's addressable shard
    on the device of the same index, bit for bit."""
    _, ranks, ref = runs
    keys = [k for k in ranks[2] if k.startswith("restore/")]
    assert len(keys) > 10
    for r, dev in ((ranks[2], 0), (ranks[3], 1)):
        for k in keys:
            np.testing.assert_array_equal(r[k], ref[f"{k}@{dev}"], err_msg=k)
