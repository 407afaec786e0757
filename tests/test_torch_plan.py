"""The port's ShardingPlan against the reference's: the twin of
``tests/test_plan.py`` (the same cases and the same hypothesis property),
every parameter and optimizer-state leaf's spec of the ten configs on the
16 x 16 and 2 x 16 x 16 production meshes (abstract meshes in the port, a
JAX ``AbstractMesh`` in the reference), the meshes' construction, and the
collective cost model (``collective_link_bytes``, ``roofline_fraction``)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # bare interpreter: deterministic cases still run
    given = settings = st = None

from jax.sharding import AbstractMesh

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import get as jget
from repro.core import perf_model as JPM
from repro.core.plan import ShardingPlan as JPlan
from repro.models.lm import LM as JLM
from repro.models.params import pspecs as j_pspecs
from jax.sharding import PartitionSpec as JP
from repro.runtime.steps import state_shardings as j_state_shardings
from repro_torch.configs import get as tget
from repro_torch.core import perf_model as TPM
from repro_torch.core.plan import (DEFAULT_RULES, P, ShardingPlan,
                                   TorchMesh, TorchSharding)
from repro_torch.core.tree import jax_leaves
from repro_torch.launch.mesh import (abstract_mesh, make_host_mesh,
                                     make_mesh, make_production_mesh)
from repro_torch.models import params as tparams
from repro_torch.models.lm import LM
from repro_torch.runtime.steps import state_shardings, state_structs

torch.set_num_threads(1)


def _mesh_1dev(names=("data", "model")):
    return make_mesh((1,) * len(names), names, device="cpu")


def _plan():
    return ShardingPlan(mesh=_mesh_1dev())


def test_logical_resolution_drops_absent_axes():
    plan = _plan()
    assert plan.axes("batch") == "data"       # 'pod' absent -> dropped
    assert plan.axes("tp") == "model"
    assert plan.axes(None) is None
    assert plan.axes("layers") is None


def test_sp_toggle():
    plan = _plan()
    assert plan.axes("sp") == "model"
    plan.sequence_parallel = False
    assert plan.axes("sp") is None


def test_fsdp_toggle():
    plan = _plan()
    spec = plan.param_spec(("fsdp", "tp"))
    assert spec == P("data", "model")
    plan.fsdp_params = False
    assert plan.param_spec(("fsdp", "tp")) == P(None, "model")


def _check_fitted_specs_divide(dims):
    """Property: every mesh axis kept in a fitted spec divides its dim."""
    plan = _plan()
    logicals = ["batch", "tp", "fsdp", None][:len(dims)]
    spec = plan.spec_for_shape(dims, logicals)
    for d, s in zip(dims, spec):
        if s is None:
            continue
        axes = s if isinstance(s, tuple) else (s,)
        n = 1
        for a in axes:
            n *= plan.mesh.shape[a]
        assert d % n == 0


def test_fitted_specs_divide_deterministic():
    for dims in ([8], [3, 5], [1, 1, 1], [64, 7, 2, 9], [2, 64, 32]):
        _check_fitted_specs_divide(dims)


if st is not None:
    @given(dims=st.lists(st.integers(1, 64), min_size=1, max_size=4))
    @settings(max_examples=60, deadline=None)
    def test_fitted_specs_always_divide(dims):
        _check_fitted_specs_divide(dims)
else:
    def test_fitted_specs_always_divide():
        pytest.importorskip("hypothesis")


def test_fit_drops_non_dividing_on_multi_axis_mesh():
    """On an abstract 4 x 2 mesh: axes that do not divide a dim drop."""
    plan = ShardingPlan(abstract_mesh((4, 2), ("data", "model")))
    assert plan.rules == DEFAULT_RULES
    # batch=6: 'data'(4) does not divide -> dropped entirely
    assert plan._fit_dim(6, "batch") is None
    # batch=8: divides 4 -> kept
    assert plan._fit_dim(8, "batch") == "data"
    # dim=2 with tp(2) -> kept; dim=3 -> dropped
    assert plan._fit_dim(2, "tp") == "model"
    assert plan._fit_dim(3, "tp") is None


def test_axis_sizes():
    plan = _plan()
    assert plan.dp == 1 and plan.tp == 1


# ---------------------------------------------------------------------------
# every state leaf's spec against the reference's, on the production meshes
# ---------------------------------------------------------------------------
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _fitted(spec, shape, sizes) -> tuple:
    """``spec`` with each dim's mesh axes fitted to ``shape`` as
    ``spec_for_shape`` fits them: an axis that does not divide what is
    left of its dim dropped."""
    out = []
    for e, n in zip(tuple(spec), shape):
        keep, prod = [], 1
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            if n % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        out.append(None if not keep else keep[0] if len(keep) == 1
                   else tuple(keep))
    return tuple(out)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(J_ASSIGNED))
def test_state_specs_match_the_reference(arch, mesh):
    """Every state leaf's spec is the reference's, fitted to the leaf's
    shape: the reference resolves the optimizer moments' axes without
    their shapes (GSPMD reshards a dim they do not divide), the port keeps
    such a dim whole, as its parameter keeps it; where the dims divide
    the two are the same."""
    shape, names = MESHES[mesh]
    jsh = j_state_shardings(jget(arch), JPlan(AbstractMesh(shape, names)))
    tmesh = make_production_mesh(multi_pod=(mesh == "2x16x16"))
    assert tmesh.abstract and tmesh.shape == dict(zip(names, shape))
    tsh = state_shardings(tget(arch), ShardingPlan(tmesh))
    shapes = [tuple(t.shape) for t in jax_leaves(
        state_structs(tget(arch), ShardingPlan(tmesh)))]
    sizes = dict(zip(names, shape))
    want = [_fitted(s.spec, n, sizes)
            for s, n in zip(jax.tree.leaves(jsh), shapes)]
    got = [tuple(s.spec) for s in jax_leaves(tsh)]
    assert got == want
    # the parameters' specs as pspecs gives them, fitted to the shapes
    jp = JPlan(AbstractMesh(shape, names))
    jspecs = j_pspecs(JLM(jget(arch)).param_defs(), jp)
    tspecs = tparams.pspecs(LM(tget(arch)).param_defs(), ShardingPlan(tmesh))
    assert [tuple(s) for _, s in sorted(tparams.walk_defs(tspecs))] == [
        tuple(s) for s in jax.tree.leaves(
            jspecs, is_leaf=lambda x: isinstance(x, JP))]


def test_state_structs_allocate_nothing_and_carry_shardings():
    cfg = tget("mixtral-8x7b")
    plan = ShardingPlan(make_production_mesh())
    st = state_structs(cfg, plan)
    sh = state_shardings(cfg, plan)
    leaves = jax_leaves(st)
    assert all(t.device.type == "meta" for t in leaves)
    assert [t.sharding for t in leaves] == jax_leaves(sh)
    emb = st["params"]["embed"]["emb"]
    assert tuple(emb.shape) == (cfg.vocab, cfg.d_model)
    assert emb.dtype == torch.bfloat16
    assert emb.sharding.spec == P("model", "data")
    assert emb.sharding.local_shape(emb.shape, {"data": 3, "model": 5}) \
        == (cfg.vocab // 16, cfg.d_model // 16)


def test_sharding_gives_dtensor_placements_and_blocks():
    from torch.distributed.tensor import Replicate, Shard
    mesh = abstract_mesh((2, 4, 2), ("pod", "data", "model"))
    sh = TorchSharding(mesh, P(("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert TorchSharding(mesh, P(None, "data")).placements == (
        Replicate(), Shard(1), Replicate())
    coords = {"pod": 1, "data": 2, "model": 1}
    assert sh.block(0, coords) == (6, 8)         # pod-major
    assert sh.local_slices((16, 3, 4), coords) == (
        slice(12, 14), slice(0, 3), slice(2, 4))


def test_sharding_blocks_and_gathers_without_ranks():
    """``local_block`` slices a tensor or a numpy array alike; on a mesh
    without ranks the block is the whole and ``gather`` is the identity
    (the ranks' case is held in ``test_torch_spmd.py``)."""
    x = np.arange(24.0).reshape(4, 6)
    sh = TorchSharding(abstract_mesh((2, 3), ("data", "model")),
                       P("data", "model"))
    assert sh.local_block(x).shape == (2, 2)
    assert torch.equal(sh.local_block(torch.from_numpy(x)),
                       torch.from_numpy(x[:2, :2]))
    one = TorchSharding(_mesh_1dev(), P("data", None))
    t = torch.from_numpy(x)
    assert torch.equal(one.local_block(t), t)
    assert one.gather(t) is t
    scalar = TorchSharding(_mesh_1dev(), P())
    assert scalar.local_block(np.float32(3.0)) == 3.0


def test_launch_runs_ranks_on_the_card_unless_asked(monkeypatch):
    """``spmd.launch`` and ``init_from_env`` take the GPU by default: with
    none they raise before any rank starts, as ``resolve_device`` does."""
    from repro_torch.core import spmd
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmd.launch(print, 2)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmd.init_from_env()
    assert not torch.distributed.is_initialized()


def test_meshes_without_ranks():
    # one position: on the device named, cuda:0 by default
    m = make_host_mesh(data=4, model=2, device="cpu")
    assert m.shape == {"data": 1, "model": 1} and not m.live
    assert m.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((1, 1), ("data", "model"))
    big = make_mesh((4, 2), ("data", "model"))
    assert big.abstract and big.device is None
    from repro_torch.core import spmd
    with pytest.raises(RuntimeError, match="abstract"):
        spmd.shard_map(lambda x: x, big, P("data"), P("data"))(
            torch.zeros(8))
    assert isinstance(m, TorchMesh) and hash(m) == hash(_mesh_1dev())


def test_one_device_plan_equals_the_torch_plan_on_the_model():
    """On one device, the vocab-parallel loss and embedding the plan's tp
    axis selects equal cross_entropy and the plain lookup bit for bit, the
    gradients too."""
    from repro_torch.core.plan import single_device_plan
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    cfg = tget("mixtral-8x7b").reduced()
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (2, 16),
                        generator=torch.Generator().manual_seed(1))

    def run(plan):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        loss, _ = model.loss(tree_unflatten(params, leaves), {"tokens": tok},
                             plan)
        return loss, torch.autograd.grad(loss, leaves)
    a, ga = run(single_device_plan("cpu"))
    b, gb = run(_plan())
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


# ---------------------------------------------------------------------------
# the collective cost model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute", "send"])
def test_collective_link_bytes_match_the_reference(kind):
    for n in (1, 2, 3, 16, 256):
        for b in (0.0, 1.0, 4096.0, 3.5e9):
            assert TPM.collective_link_bytes(kind, b, n) == \
                JPM.collective_link_bytes(kind, b, n)


def test_roofline_fraction_matches_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        c, m, k, mf = (float(v) for v in rng.random(4))
        kw = dict(compute_s=c, memory_s=m, collective_s=k, model_flops=mf,
                  model_flops_s=mf / 2)
        assert TPM.RooflineTerms(**kw).roofline_fraction == \
            JPM.RooflineTerms(**kw).roofline_fraction
    zero = dict(compute_s=0.0, memory_s=0.0, collective_s=0.0)
    assert TPM.RooflineTerms(**zero).roofline_fraction == 0.0
    t = TPM.roofline(2e12, 1e9, 0.0, 1, model_flops=1e12)
    assert t.model_flops_s == 1e12 / TPM.H100_SXM.peak_flops_bf16
    assert 0.0 < t.roofline_fraction <= 1.0
    assert dataclasses.asdict(t)["model_flops"] == 1e12
