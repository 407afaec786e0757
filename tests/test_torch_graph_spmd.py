"""The compiled graph over a plan with ranks behind its ``data`` axis: the
port on two gloo ranks on the CPU against the JAX package on two fake XLA
devices and against the port's own one-rank run.

One module-scoped launch spawns the two ranks once (``core.spmd.launch``,
one intra-op thread a rank); each compiles and runs every graph of
``tests/graph_spmd_cases.py`` over ``ShardingPlan(make_mesh((2,),
("data",)))`` — each rank the whole stream, each device segment's
microbatch split over the ranks by its ``farm_map``/``a2a_dispatch``
lowerings, a partial microbatch padded — and again over
``single_device_plan``.  One JAX subprocess (``tests/graph_spmd_reference.
py``) compiles the same graphs over a plan across two devices.  Every
graph runs 37 items, so its last microbatch is partial and padded.

Bounds: the two ranks and the one-rank run apply the same torch ops to the
same items, so their outputs are equal byte for byte, in input order.
Against the reference, the a2a hop's outcome (the rows it drops) is equal
exactly, and every float row within 1e-5 of the output's scale (XLA's
CPU ``tanh`` and fused multiply-adds against torch's).  The reference's
host farm collects in arrival order, so the hybrid graph's reference rows
are matched to the port's one to one; the port's rows are held in input
order to the item function composed serially in numpy.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import graph_spmd_cases as C
from repro_torch.core import spmd

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCALE_TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("graph_spmd")
    rng = np.random.default_rng(0)
    stream = rng.standard_normal((C.N_ITEMS, C.WIDTH)).astype(np.float32)
    np.savez(d / "in.npz", stream=stream)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    log = open(d / "ref.log", "w")
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "graph_spmd_reference.py"),
         str(d / "in.npz"), str(d / "ref.npz")],
        env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        ranks = spmd.launch(C.rank_main, 2, str(d / "in.npz"), device="cpu",
                            timeout_s=240)
        ref.wait(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
        log.close()
    assert ref.returncode == 0, (d / "ref.log").read_text()[-3000:]
    return stream, ranks, dict(np.load(d / "ref.npz"))


def _scale_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("case", C.CASES)
def test_ranks_equal_the_one_rank_run(runs, case):
    """Both ranks emit the whole stream, byte-equal to each other and to
    the port's run of the same graph on one rank, in input order (the
    hybrid's one-rank farm collects in arrival order: its rows as a
    set)."""
    stream, ranks, _ = runs
    got = [r[f"{case}/ranks"] for r in ranks]
    assert got[0].shape == (C.N_ITEMS, C.WIDTH)
    assert got[0].tobytes() == got[1].tobytes()
    one = ranks[0][f"{case}/one"]
    if case == "hybrid":
        assert sorted(r.tobytes() for r in got[0]) == \
            sorted(r.tobytes() for r in one)
    else:
        assert got[0].tobytes() == one.tobytes()


@pytest.mark.parametrize("case", ["a2a", "a2a_cap", "feedback_steps",
                                  "feedback_cond"])
def test_device_graphs_match_the_reference(runs, case):
    _, ranks, ref = runs
    got, want = ranks[0][f"{case}/ranks"], ref[case]
    err = _scale_err(got, want)
    print(f"{case}: {err:.2e} of the scale")
    assert err <= SCALE_TOL, err
    if case.startswith("a2a"):
        # the hop's outcome: the rows it dropped (zeros, then - 0.125)
        dropped = lambda y: np.all(y == np.float32(-0.125), axis=1)
        np.testing.assert_array_equal(dropped(got), dropped(want))
        assert dropped(want).any() == (case == "a2a_cap")


def test_hybrid_rows_keep_input_order_and_match_the_reference(runs):
    stream, ranks, ref = runs
    got = ranks[0]["hybrid/ranks"]
    np.testing.assert_array_equal(got, C.serial_hybrid(stream))
    want = ref["hybrid"]
    # each reference row to its nearest port row, one to one
    dist = np.abs(want[:, None, :] - got[None, :, :]).max(-1)
    match = dist.argmin(1)
    assert sorted(match.tolist()) == list(range(C.N_ITEMS))
    assert _scale_err(want, got[match]) <= SCALE_TOL


def test_hybrid_boundary_pads_its_last_microbatch(runs):
    """The boundary stacks microbatches of 4 (the last of 37 items one,
    padded to two), retires the 37 items only, and the farm in front of it
    is the sequence-ordered one."""
    _, ranks, _ = runs
    for r in ranks:
        assert int(r["hybrid/flushes"]) == -(-C.N_ITEMS // 4)
        assert int(r["hybrid/retired"]) == C.N_ITEMS
        assert any(str(d).startswith("ordered_farm")
                   for d in r["hybrid/stages"])


def test_two_segments_over_ranks_are_refused(runs):
    _, ranks, _ = runs
    assert all(int(r["two_segments_raised"]) == 1 for r in ranks)


def test_a_mesh_without_ranks_is_refused():
    """With no ranks behind the mesh's two positions, compile raises: it
    never runs the segment on one rank."""
    import repro_torch.core as T
    from repro_torch.core.graph import GraphError
    from repro_torch.core.plan import ShardingPlan
    from repro_torch.launch.mesh import abstract_mesh
    g, kw = C.build("a2a", "torch")
    plan = ShardingPlan(abstract_mesh((2,), ("data",)))
    with pytest.raises(GraphError, match="no ranks"):
        g.compile(config=T.CompileConfig(plan=plan, **kw))
