"""The port's data pipeline, checkpoints and fault-tolerant driver, on the
CPU: twins of ``tests/test_data_checkpoint.py`` and
``tests/test_fault_tolerance.py``, and checkpoints carried across the two
packages in both directions (bit for bit: bf16 leaves cross as fp32)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get as jget
from repro.core.plan import single_device_plan as jplan
from repro.data import SyntheticLMSource as JSource
from repro.runtime.steps import init_state as jinit_state
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get
from repro_torch.core.params import state_from_numpy
from repro_torch.core.plan import single_device_plan
from repro_torch.data import (DataPipeline, MemmapTokenSource,
                              SyntheticLMSource, make_pipeline)
from repro_torch.data.sources import write_token_file
from repro_torch.optim.schedules import linear_warmup
from repro_torch.runtime.driver import DriverConfig, TrainDriver
from repro_torch.runtime.monitor import StragglerWatchdog
from repro_torch.runtime.steps import init_state, make_train_step

torch.set_num_threads(1)

CPU = single_device_plan("cpu")


# -- data ------------------------------------------------------------------------
def test_synthetic_source_yields_the_reference_batches():
    ours, ref = SyntheticLMSource(100, 16, 4, seed=7), JSource(100, 16, 4,
                                                               seed=7)
    for _ in range(5):
        a, b = ours.next_batch()["tokens"], ref.next_batch()["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    st = ours.state()
    more = [ours.next_batch()["tokens"] for _ in range(3)]
    resumed = SyntheticLMSource(100, 16, 4, seed=7)
    resumed.restore(st)
    for m in more:
        np.testing.assert_array_equal(resumed.next_batch()["tokens"], m)


def test_memmap_source_sharded(tmp_path):
    f = tmp_path / "tokens.bin"
    write_token_file(f, np.arange(16 * 64, dtype=np.int32))
    a = MemmapTokenSource(f, seq_len=16, batch_size=2, shard_id=0,
                          num_shards=2)
    b = MemmapTokenSource(f, seq_len=16, batch_size=2, shard_id=1,
                          num_shards=2)
    ba, bb = a.next_batch()["tokens"], b.next_batch()["tokens"]
    assert set(ba[:, 0].tolist()).isdisjoint(bb[:, 0].tolist())
    st = a.state()
    nxt = a.next_batch()["tokens"]
    a2 = MemmapTokenSource(f, seq_len=16, batch_size=2)
    a2.restore(st)
    np.testing.assert_array_equal(a2.next_batch()["tokens"], nxt)


def test_pipeline_prefetch_and_backpressure():
    src = SyntheticLMSource(50, 8, 2, seed=1)
    pipe = DataPipeline(src, "cpu", n_batches=6, prefetch=2).start()
    got = []
    while True:
        b = pipe.get(timeout=10)
        if b is None:
            break
        got.append(b["tokens"])
    assert len(got) == 6
    ref = JSource(50, 8, 2, seed=1)
    for g in got:
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), ref.next_batch()["tokens"])
    stats = pipe.stats()
    # the bounded lanes held the reader back: never more than the prefetch
    # depth queued ahead of the consumer
    assert stats["results_max_depth"] <= 2
    assert max(stats["graph"]["lane_max_depth"]) <= 2
    assert [p.target for _, p in pipe.placements] == ["host", "host"]


def test_pipeline_compute_stage_transforms_the_host_batch():
    src = SyntheticLMSource(50, 8, 2, seed=2)
    pipe = make_pipeline(src, CPU, n_batches=3,
                         compute=lambda b: {"tokens": b["tokens"] + 1})
    ref = JSource(50, 8, 2, seed=2)
    for _ in range(3):
        np.testing.assert_array_equal(pipe.get(timeout=10)["tokens"].numpy(),
                                      ref.next_batch()["tokens"] + 1)
    assert pipe.get(timeout=10) is None


def _bump(batch):
    return {"tokens": batch["tokens"] + 1}


# compute_workers > 1 runs on the process tier (tests/test_torch_process.py)
# and adaptive=True under the adaptive runtime (tests/test_torch_runtime.py)
@pytest.mark.parametrize("knob", [{"compute_workers": 2, "adaptive": True},
                                  {"adaptive": True}])
def test_pipeline_unported_options_raise(knob):
    """An adaptive pipeline delivers the static pipeline's batches in
    order, and its ``stop()`` and ``replacement_events()`` work."""
    def batches(**kw):
        pipe = DataPipeline(SyntheticLMSource(50, 8, 2, seed=4), "cpu",
                            n_batches=6, compute=_bump, **kw).start()
        got = []
        while (b := pipe.get(timeout=30)) is not None:
            got.append(b["tokens"].numpy())
        return pipe, got

    pipe, got = batches(**knob)
    _, want = batches(compute_workers=knob.get("compute_workers", 1))
    assert len(got) == 6
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert pipe.supervisor is not None
    pipe.stop()
    pipe.stop()                      # idempotent
    assert "supervisor" in pipe.stats()
    assert isinstance(pipe.replacement_events(), list)
    if "compute_workers" in knob:    # the farm became one adaptive stage
        assert "adaptive" in pipe.placements[1][1].reason


@pytest.mark.parametrize("lanes", [{"shm_slot_bytes": 1 << 12},
                                   {"transport": {"ring_slots": 4,
                                                  "slot_bytes": 1 << 14}}])
def test_pipeline_sizes_the_process_lanes(lanes):
    """``shm_slot_bytes=`` and ``transport=`` reach the process farm's
    lanes (reference ``src/repro/data/pipeline.py:72-76``); the batches
    stay those of one compute stage."""
    def batches(**kw):
        pipe = DataPipeline(SyntheticLMSource(50, 8, 2, seed=5), "cpu",
                            n_batches=5, compute=_bump, **kw).start()
        got = []
        while (b := pipe.get(timeout=30)) is not None:
            got.append(b["tokens"].numpy())
        return pipe, got

    pipe, got = batches(compute_workers=2, **lanes)
    _, want = batches()
    assert [p.target for _, p in pipe.placements][1] == "host_process"
    assert len(got) == 5 and all(np.array_equal(a, b)
                                 for a, b in zip(got, want))


def test_pipeline_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is taken")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DataPipeline(SyntheticLMSource(50, 8, 2))


# -- checkpoints -------------------------------------------------------------------
def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    state = {"params": {"w": torch.arange(12.0).reshape(3, 4),
                        "b": torch.arange(3.0).to(torch.bfloat16)},
             "step": torch.tensor(5, dtype=torch.int32)}
    save_checkpoint(tmp_path, 5, state, extras={"data": {"index": 9}})
    assert latest_step(tmp_path) == 5
    assert not list(tmp_path.glob("*.tmp"))
    manifest = json.loads((tmp_path / "step_00000005" /
                           "manifest.json").read_text())
    # jax.tree.flatten's order (sorted keys), bf16 widened to fp32
    assert manifest["dtypes"] == ["float32", "float32", "int32"]
    assert manifest["shapes"] == [[3], [3, 4], []]
    like = {"params": {"w": torch.zeros(3, 4),
                       "b": torch.zeros(3, dtype=torch.bfloat16)},
            "step": torch.tensor(0, dtype=torch.int32)}
    restored, extras = load_checkpoint(tmp_path, like)
    assert extras["data"]["index"] == 9
    assert list(restored["params"]) == ["w", "b"]     # the caller's order
    for k in ("w", "b"):
        assert restored["params"][k].dtype == state["params"][k].dtype
        assert torch.equal(restored["params"][k], state["params"][k])
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 5


def test_checkpoint_gc_keeps_latest(tmp_path):
    state = {"w": torch.zeros(2)}
    for s in [1, 2, 3, 4, 5]:
        save_checkpoint(tmp_path, s, state, keep=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000004", "step_00000005"]


def test_async_checkpoint_snapshot_isolation(tmp_path):
    """save_async snapshots the values at call time, though the train step
    then updates the same tensors in place."""
    mgr = CheckpointManager(tmp_path)
    state = {"w": torch.ones(4)}
    mgr.save_async(1, state)
    state["w"].zero_()                        # in place, after the call
    mgr.wait()
    restored, _ = mgr.restore({"w": torch.zeros(4)})
    assert torch.equal(restored["w"], torch.ones(4))
    assert mgr.latest() == 1


@pytest.fixture(scope="module")
def jstate():
    """The reference's ff-tiny train state after one optimizer step, so the
    moments and counters are not zero."""
    from repro.optim import make_optimizer
    cfg = jget("ff-tiny").reduced()
    st = jinit_state(cfg, jplan(), jax.random.PRNGKey(0))
    opt = make_optimizer("adamw")
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype),
                         st["params"])
    params, st["opt"] = opt.update(grads, st["opt"], st["params"], 1e-2)
    st["params"], st["step"] = params, st["step"] + 1
    return st


def _equal_trees(port, ref):
    for (path, a), b in zip(_paths(port), jax.tree.leaves(ref)):
        b = np.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16
                       else b)
        a = a.float() if a.dtype == torch.bfloat16 else a
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)


def _paths(tree, pre=""):
    """(path, leaf) in sorted-key order, as jax.tree.leaves orders them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


def test_reference_checkpoint_restores_into_the_port(tmp_path, jstate):
    mgr = JCheckpointManager(tmp_path)
    mgr.save(1, jstate, extras={"data": {"index": 3, "seed": 0}})
    cfg = get("ff-tiny").reduced()
    like = init_state(cfg, CPU, torch.Generator().manual_seed(5))
    restored, extras = CheckpointManager(tmp_path).restore(like)
    assert extras == {"data": {"index": 3, "seed": 0}}
    assert int(restored["step"]) == 1 and int(restored["opt"]["count"]) == 1
    _equal_trees(restored, jstate)
    for (_, a), (_, b) in zip(_paths(restored), _paths(like)):
        assert a.dtype == b.dtype and a.shape == b.shape


def test_port_checkpoint_restores_into_the_reference(tmp_path, jstate):
    state = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    CheckpointManager(tmp_path).save(1, state)
    like = jax.tree.map(jnp.zeros_like, jstate)
    restored, _ = JCheckpointManager(tmp_path).restore(like)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    _equal_trees(state, restored)


def test_state_from_numpy_keeps_the_optimizer_types(jstate):
    st = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu",
                          dtype=torch.float32)
    assert all(t.dtype == torch.float32 for _, t in _paths(st["params"]))
    assert all(t.dtype == torch.float32
               for _, t in _paths({"m": st["opt"]["m"], "v": st["opt"]["v"]}))
    assert st["step"].dtype == st["opt"]["count"].dtype == torch.int32


# -- the driver ----------------------------------------------------------------------
def _driver(tmp_path, total=12, fail_at=None, fail_times=1):
    cfg = get("ff-tiny").reduced()
    state = init_state(cfg, CPU, torch.Generator().manual_seed(0))
    pipe = make_pipeline(SyntheticLMSource(cfg.vocab, 16, 2, seed=3), CPU,
                         n_batches=total * 3)
    step = make_train_step(cfg, CPU, linear_warmup(1e-3, 5))
    fired = [0]

    def hook(s):
        if fail_at is not None and s == fail_at and fired[0] < fail_times:
            fired[0] += 1
            raise RuntimeError("injected preemption")

    return TrainDriver(step, state, pipe,
                       DriverConfig(total_steps=total, ckpt_every=4,
                                    ckpt_dir=str(tmp_path), max_retries=3,
                                    retry_backoff_s=0.01, log_every=1000),
                       fault_hook=hook)


def test_training_completes_without_failures(tmp_path):
    d = _driver(tmp_path, total=8)
    out = d.run()
    assert out["final_step"] == 8 and out["restarts"] == 0
    assert d.ckpt.latest() == 8
    assert int(d.state["step"]) == 8
    assert all(np.isfinite(h["loss"]) for h in out["history"])


def test_restart_after_injected_failure(tmp_path):
    d = _driver(tmp_path, total=12, fail_at=6)
    out = d.run()
    assert out["final_step"] == 12
    assert out["restarts"] == 1                      # restored from step 4
    kinds = [e["kind"] for e in d.monitor.events]
    assert "step_failure" in kinds and "restart" in kinds
    steps = [h["step"] for h in out["history"]]
    assert steps.count(5) == 2                       # 4 and 5 re-run


def test_repeated_failure_exhausts_retries(tmp_path):
    d = _driver(tmp_path, total=12, fail_at=2, fail_times=99)
    with pytest.raises(RuntimeError, match="injected"):
        d.run()


def test_failure_before_first_checkpoint_retries_in_place(tmp_path):
    d = _driver(tmp_path, total=6, fail_at=1, fail_times=2)
    out = d.run()
    assert out["final_step"] == 6 and out["restarts"] == 0


def test_straggler_watchdog_flags_outliers():
    wd = StragglerWatchdog(k=3.0, warmup=3)
    flagged = [wd.observe(0.01 if i != 30 else 0.2) for i in range(50)]
    assert flagged[30] is True and sum(flagged) == 1 and wd.count == 1
    assert wd.mean < 0.02


def test_train_launcher_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
          "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "final step 3" in out and "device=cpu" in out
    assert latest_step(tmp_path) == 3
    # --tuned re-execs the program (launch/tuned.py, tested in
    # tests/test_torch_process.py); --adaptive attaches the Supervisor
    main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
          "--ckpt-dir", str(tmp_path / "adaptive"), "--adaptive"])
    out = capsys.readouterr().out
    assert "final step 2" in out and "re-placement events:" in out
    assert '"supervisor"' in out
