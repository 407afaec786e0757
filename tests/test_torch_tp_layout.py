"""The model axis's layout on one rank and on two: the transitions of
``core/plan.py`` are identities without a model axis to shard over, the
steps on a ``(1, 1)`` mesh equal the one-device steps bit for bit,
``reshard_state`` places a one-device checkpoint
onto a ``(1, 2)`` mesh, and two lock-step ``InferenceEngine``s on two
ranks emit the same tokens whatever their timing, the greedy tokens of
the one-device steps on the same weights.

The two-rank cases run in one module-scoped launch of two gloo ranks on
the CPU (``tests/tp_layout_cases.py``).  The one-device steps are the
port's forms before the model axis: ``tests/test_torch_models.py``,
``test_torch_train.py`` and ``test_torch_serving.py`` hold them to the
reference, unchanged.
"""

import numpy as np
import pytest
import torch

import tp_layout_cases as L
from repro_torch.core import spmd
from repro_torch.core.plan import ShardingPlan, model_plan
from repro_torch.launch.mesh import abstract_mesh, make_mesh
from repro_torch.models.layers import mlp_defs

torch.set_num_threads(1)

SERVE_TOL = 3e-2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_layout")
    return spmd.launch(L.rank_main, 2, str(d / "ckpt"), device="cpu",
                       timeout_s=240)


@pytest.mark.parametrize("mesh", [
    lambda: make_mesh((1, 1), ("data", "model"), "cpu"),
    lambda: abstract_mesh((2, 2), ("data", "model")),
    lambda: abstract_mesh((1, 16), ("data", "model"))],
    ids=["one_device", "abstract_2x2", "abstract_1x16"])
def test_transitions_are_identities_without_a_manual_model_axis(mesh):
    """On a one-device mesh, and outside a manual region of any mesh, no
    tensor is a rank's block: every transition returns its input."""
    plan = ShardingPlan(mesh())
    x = torch.randn(2, 16, 8)
    split, whole = mlp_defs(8, 32)["wo"], mlp_defs(8, 3)["wo"]
    assert plan.model_axis() is None and model_plan(plan) is None
    assert not plan.seq_split(16)
    for sp in (False, True):
        assert plan.seq_gather(x, sp) is x
        assert plan.compose(x, sp, split) is x
        assert plan.compose(x, sp, whole) is x
    assert plan.block(x, 1) is x and plan.block(x, 2, "sp") is x
    assert plan.constrain(x, "batch", "sp", "tp") is x
    if plan.mesh.size == 1:              # a one-device mesh is manual too
        with spmd.manual(plan.mesh, plan.mesh.axis_names):
            assert plan.model_axis() is None
            assert plan.compose(x, True, split) is x
            assert plan.constrain(x, "batch", "sp", "tp") is x


def test_model_split_follows_spec_for_shape():
    """The dims a parameter's def splits over the model axis are those
    ``spec_for_shape`` gives it: a dim that does not divide stays
    replicated (reduced configs' 2 kv heads on a model axis of 4)."""
    plan = ShardingPlan(abstract_mesh((1, 4), ("data", "model")))
    assert plan.model_split((64, 4, 16), ("fsdp", "tp", None)) == (1,)
    assert plan.model_split((64, 2, 16), ("fsdp", "tp", None)) == ()
    assert plan.model_split((2, 8, 2, 16), ("batch", None, None, "tp")) \
        == (3,)
    assert plan.model_split((8, 64), ("fsdp", None)) == ()


@pytest.mark.parametrize("name", L.ONE_RANK)
def test_one_rank_mesh_is_the_one_device_port_bit_for_bit(ranks, name):
    """Two train steps, a prefill and two decode steps of the reduced
    config over a live (data 1, model 1) mesh: every loss, grad norm,
    parameter, logit, cache leaf and token equal to the one-device
    plan's bit for bit."""
    assert ranks[0]["one_rank"][name] is True
    assert ranks[1]["one_rank"] is None


def test_backward_on_another_thread_recomputes_in_the_manual_region(ranks):
    """The gradient of the loss over a model axis of 2 taken in another
    thread, outside the manual region (autograd's device thread runs a
    CUDA backward so), equals the same-thread gradient bit for bit: the
    checkpointed blocks recompute with their collectives."""
    assert all(r["backward_thread"] for r in ranks)


def test_reshard_places_a_one_device_checkpoint_on_a_model_axis(ranks):
    for r in ranks:
        got = r["reshard"]
        assert got["equal"] and got["split"] > 0, got


def _hold_lock_step(a, b, one):
    """Both ranks' engines served alike, every request in full but the
    last (its deadline had passed), and each token within ``SERVE_TOL`` of
    the one-device logits' maximum."""
    assert a == b
    n = L.ENGINE_REQUESTS
    assert a["reasons"][:n - 1] == ["max_tokens"] * (n - 1)
    assert a["reasons"][-1] == "Overloaded"       # its deadline had passed
    assert all(len(t) == L.ENGINE_NEW for t in a["tokens"][:n - 1])
    worst = 0.0
    for toks, rows in zip(a["tokens"], one):
        assert len(rows) == len(toks)
        for t, lg in zip(toks, rows):
            scale = float(np.abs(lg).max())
            worst = max(worst, float(lg.max() - lg[t]) / scale)
            assert lg[t] >= lg.max() - SERVE_TOL * scale, (t, lg.argmax())
    return worst


def test_lock_step_engines_emit_the_same_tokens(ranks):
    """Rank 1 starts its engine late and submits each request after a
    random pause, rank 0 at once: both admit, shed and finish alike, every
    token equal, in the same number of decode steps.  Each token is the
    greedy token of a one-device loop of the steps on the same weights fed
    the engines' tokens (``test_torch_serving.py`` holds that loop to the
    reference), but at a near tie of its logits: within ``SERVE_TOL`` of
    their scale below the maximum (the row-parallel partials are summed
    in another order; ``test_torch_tp.py``'s allowance; measured: 23 of
    25 tokens the argmax, the others at gaps of 0 and 6.6e-3)."""
    _hold_lock_step(ranks[0]["lock_step"], ranks[1]["lock_step"],
                    ranks[0]["lock_step_one_device"])


@pytest.mark.parametrize("arch", L.ENGINE_FAMILIES)
def test_lock_step_engines_serve_every_family(ranks, arch):
    """The lock-step engines over the families the encdec, vlm and ssm
    slice runs on a model axis: Llama-3.2-3B with context-parallel
    attention (prompts of 3-19 tokens: odd ones stay whole on both ranks,
    even ones split), Qwen2-VL fed tokens, xLSTM with its mLSTM and sLSTM
    states in the slots; held as the test above holds Mixtral."""
    a, one = ranks[0]["lock_step_families"][arch]
    b, _ = ranks[1]["lock_step_families"][arch]
    worst = _hold_lock_step(a, b, one)
    print(f"[margin] {arch} lock-step tokens: worst gap below the "
          f"one-device maximum {worst:.2e} of the scale ({SERVE_TOL})")


@pytest.mark.parametrize("arch", L.RESHARD_FAMILIES)
def test_reshard_places_every_kind_on_a_model_axis(ranks, arch):
    """``reshard_state`` places a one-device checkpoint of Whisper (enc,
    dec with its cross attention), Qwen2-VL (cp attention's replicated
    weights) and xLSTM (mlstm, slstm) on a model axis of 2: every block
    its slice of the whole, some leaves split."""
    for r in ranks:
        got = r["reshard_families"][arch]
        assert got["equal"] and got["split"] > 0, got


@pytest.mark.parametrize("name", ["mixtral-8x7b", "kimi-k2-1t-a32b",
                                  "zamba2-1.2b", "whisper-medium",
                                  "qwen2-vl-2b", "xlstm-125m",
                                  "llama3.2-3b"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_init_blocks_are_the_whole_draws_blocks(monkeypatch, name, shape):
    """Each rank's blocks drawn alone equal the whole draw's blocks bit for
    bit, with the draw in pieces of 1000 elements (pieces that cut a
    block's runs), and have ``block_shapes``' shapes."""
    from repro_torch.configs import get
    from repro_torch.core.tree import jax_leaves
    from repro_torch.models import params as pp
    from repro_torch.models.lm import LM
    monkeypatch.setattr(pp, "_DRAW", 1000)
    cfg = get(name).reduced()
    defs = LM(cfg).param_defs()
    plan = ShardingPlan(abstract_mesh(shape, ("data", "model")))
    whole = jax_leaves(pp.init_params(defs, torch.Generator().manual_seed(4)))
    sh = jax_leaves(pp.shardings(defs, plan))
    for r in range(4):
        coords = {"data": r // shape[1], "model": r % shape[1]}
        got = jax_leaves(pp.init_blocks(
            defs, torch.Generator().manual_seed(4), plan, coords))
        shapes = pp.block_shapes(defs, plan, coords)
        for t, w, s in zip(got, whole, sh):
            want = w[s.local_slices(w.shape, coords)]
            assert torch.equal(t, want)
        assert [tuple(t.shape) for t in got] == [
            tuple(x) for _, x in sorted(pp.walk_defs(shapes))]
