"""The dry run (``repro_torch.launch.dryrun``) against the reference's specs
and against real ranks.

* (a, b) the input specs and the train state: ``configs.batch_specs`` and
  ``cache_specs`` equal the reference's in global shape, type and
  per-device shard shape for every config, shape cell and production
  mesh, and the state a rank of the dry run builds holds exactly the bytes
  of one device's shard of the reference's ``state_structs`` — the
  reference's side from one subprocess over 512 fake XLA devices
  (``tests/dryrun_reference.py``);
* (c) a reduced config of each family on a ``(2, 2)`` mesh, traced on the
  plain path (``--device cpu``) at ranks 0 and 3 of a fake world, against
  the same steps run for real on four gloo CPU ranks with the recorders on
  (``tests/dryrun_cases.py``): the same collective records in order, the
  FLOPs ``FlopCounterMode`` counts, the same kernel-wrapper calls and
  work, the same bytes, and the same peak of live storage but for the
  buffers gloo's worker threads may hold a moment past a collective;
* (d) each kernel's ``work()`` at the shapes of ``PERF.md`` section 6
  gives its bound column within 1%;
* (e) the NVLink/network split, ``roofline`` and the records' totals
  against the reference's ``collective_link_bytes``, ``count_kinds``,
  ``total_link_bytes`` and ``roofline`` on the same records;
* (f) a full-size production cell traced on the CUDA path;
* the kernels' count-only branch is taken by fake tensors alone.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import dryrun_cases as C
from repro.core import perf_model as ref_pm
from repro.launch import hlo_analysis as ref_hlo
from repro_torch.configs import ASSIGNED, SHAPES, batch_specs, cache_specs, get
from repro_torch.core import perf_model as pm
from repro_torch.core import spmd
from repro_torch.core.plan import ShardingPlan
from repro_torch.kernels import backend
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.optim import make_optimizer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable,
                          str(ROOT / "tests" / "dryrun_reference.py"),
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _spec(t, coords):
    return [list(t.shape), str(t.dtype).removeprefix("torch."),
            list(t.sharding.local_shape(t.shape, coords))]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                         "2x16x16"])
def test_input_specs_match_the_reference(reference, multi_pod):
    tag = "mp" if multi_pod else "sp"
    mesh = make_production_mesh(multi_pod=multi_pod)       # abstract here
    plan = ShardingPlan(mesh=mesh)
    coords = {a: 0 for a in mesh.axis_names}
    n = 0
    for arch in ASSIGNED:
        cfg = get(arch)
        for shape, sh in SHAPES.items():
            key = f"{arch}|{shape}|{tag}"
            got = {p: _spec(t, coords)
                   for p, t in _leaves(batch_specs(cfg, shape, plan))}
            assert got == reference["batch"][key], key
            n += 1
            if sh["mode"] == "decode":
                got = {p: _spec(t, coords) for p, t in _leaves(
                    cache_specs(cfg, sh["batch"], sh["seq"], plan))}
                assert got == reference["cache"][key], key
                n += 1
    assert n == 60


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                         "2x16x16"])
def test_a_ranks_state_holds_the_references_shard_bytes(reference,
                                                        multi_pod):
    from torch._subclasses.fake_tensor import FakeTensorMode
    tag = "mp" if multi_pod else "sp"
    with dryrun.fake_world(0, 512 if multi_pod else 256,
                           torch.device("cpu")):
        plan = ShardingPlan(mesh=make_production_mesh(multi_pod=multi_pod))
        assert plan.mesh.live
        for arch in ASSIGNED:
            cfg = get(arch)
            with FakeTensorMode():
                state = dryrun._train_state(cfg, plan, torch.device("cpu"),
                                            make_optimizer(cfg.optimizer))
                got = sum(t.numel() * t.element_size()
                          for _, t in _leaves(state))
            assert got == reference["state"][f"{arch}|{tag}"], arch


# ---------------------------------------------------------------------------
# (c) the dry run at ranks 0 and 3 against four real CPU ranks
# ---------------------------------------------------------------------------
DRY_RANKS = (0, 3)


@pytest.fixture(scope="module")
def real_ranks():
    return spmd.launch(C.rank_main, 4, device="cpu", timeout_s=400)


@pytest.fixture(scope="module")
def dry_ranks():
    out = {}
    for r in DRY_RANKS:
        with dryrun.fake_world(r, 4, torch.device("cpu")):
            plan = C.plan_of()
            for name in C.CONFIGS:
                for mode in C.MODES:
                    out[(r, name, mode)] = dryrun.dry_step(
                        C.config(name), mode, C.B, C.S, plan,
                        cuda_path=False)
    return out


def _buffers(kind: str, operand: float, n: int) -> float:
    """A collective's input and output bytes."""
    out = {"all-gather": operand * n,
           "reduce-scatter": operand / n}.get(kind, operand)
    return operand + out


@pytest.mark.parametrize("name", C.CONFIGS)
def test_the_dry_run_sees_what_real_ranks_run(real_ranks, dry_ranks, name):
    for r in DRY_RANKS:
        for mode in C.MODES:
            real, dry = real_ranks[r][(name, mode)], dry_ranks[(r, name,
                                                                 mode)]
            where = f"{name} {mode} rank {r}"
            got = [(c["kind"], c["operand_bytes"], c["group_size"],
                    c["axis"], c["net"]) for c in dry["collectives"]]
            assert got == real["collectives"], where
            assert got, where                   # the mesh has collectives
            assert dry["flops_aten"] == real["flop_counter"], where
            assert dry["flops_aten"] == real["flops"], where
            assert dry["flops_aten"] > 0, where
            assert dry["kernel_work"] == real["kernels"], where
            assert dry["bytes_aten"] == real["bytes"], where
            # gloo's two worker threads drop their hold on a collective's
            # input and output buffers just after the call returns, so a
            # real rank's peak may pass the trace's by two collectives'
            # buffers, never fall below it; the fake group holds nothing
            late = 2 * max(_buffers(*c[:3]) for c in real["collectives"])
            assert 0 <= real["peak"] - dry["mem"]["peak_bytes"] <= late, \
                where
            assert dry["kernel_launches"] == {}, where   # the plain path


def test_every_family_calls_its_kernels(dry_ranks):
    calls = {name: set() for name in C.CONFIGS}
    for (_, name, _), d in dry_ranks.items():
        calls[name] |= set(d["kernel_work"])
    assert "router_topk" in calls["mixtral-8x7b"]
    assert {"ssd_scan", "ssd_scan_bwd"} <= calls["zamba2-1.2b"] \
        & calls["xlstm-125m"]
    gelu = {"gelu_stepwise", "gelu_stepwise_bwd"}
    silu = {"silu_stepwise", "silu_stepwise_bwd"}
    for name in ("gemma-7b", "whisper-medium"):
        assert gelu <= calls[name] and not silu & calls[name], name
    for name in ("mixtral-8x7b", "xlstm-125m", "qwen2-vl-2b", "llama3.2-3b"):
        assert silu <= calls[name] and not gelu & calls[name], name
    assert gelu | silu <= calls["zamba2-1.2b"]     # the shared block's gelu
    assert all({"flash_attention", "flash_attention_bwd"} <= calls[n]
               for n in C.CONFIGS if n != "xlstm-125m")


def _chip_smoke():
    """``chip_smoke.py`` (beside ``tests/``), loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", C.CONFIGS)
def test_each_familys_traced_launches_are_the_cards_formula(name):
    """Every family's train step and prefill, traced on the CUDA path at a
    reduced size, launch each kernel as often as ``chip_smoke.py``'s
    ``expected_launches`` (the count phases 5c and 13 hold the card to):
    a train step's forward twice (activation checkpointing recomputes
    it) and each backward kernel once, ``ssd_scan_bwd`` once per Mamba2
    layer and twice per mLSTM layer, ``flash_attention_bwd`` once per
    attention launch of the forward."""
    from repro_torch.core.plan import single_device_plan
    cs = _chip_smoke()
    cfg = get(name).reduced()
    plan = single_device_plan("cpu")
    for mode, want in (("train", cs.expected_launches(cfg, 2, 0, 1)),
                       ("prefill", cs.expected_launches(cfg, 1, 0))):
        got = dryrun.dry_step(cfg, mode, 2, 64, plan,
                              cuda_path=True)["kernel_launches"]
        assert got == cs.nonzero(want), (name, mode)


# ---------------------------------------------------------------------------
# (d) each kernel's work at PERF.md's rows: its bound column
# ---------------------------------------------------------------------------
BF16, F32 = torch.bfloat16, torch.float32
FA = "repro_torch.kernels.flash_attention"
# (row of PERF.md section 6, work, bound ms in its column, bound by)
BOUND_ROWS = [
    ("flash Mixtral D128 serve", lambda K: K.flash_attention.work(
        (1, 32, 2048, 128), 8, 2048, BF16, True, 4096), 0.0348, "operations"),
    ("flash Mixtral D128 train B2", lambda K: K.flash_attention.work(
        (2, 32, 2048, 128), 8, 2048, BF16, True, 4096), 0.0695, "operations"),
    ("flash Zamba2 D64 serve", lambda K: K.flash_attention.work(
        (1, 32, 2048, 64), 32, 2048, BF16, True, 4096), 0.0174, "operations"),
    ("flash Gemma D256", lambda K: K.flash_attention.work(
        (1, 16, 2048, 256), 16, 2048, BF16, True, 0), 0.0348, "operations"),
    ("flash Whisper encoder", lambda K: K.flash_attention.work(
        (8, 16, 1500, 64), 16, 1500, BF16, False, 0), 0.0745, "operations"),
    ("flash Whisper cross decode", lambda K: K.flash_attention.work(
        (8, 16, 1, 64), 16, 1500, BF16, False, 0), 0.0147, "bytes"),
    ("flash Whisper cross prefill", lambda K: K.flash_attention.work(
        (8, 16, 32, 64), 16, 1500, BF16, False, 0), 0.0150, "bytes"),
    ("router E8 K2 T2048", lambda K: K.router_topk.work(2048, 8, 2),
     0.0000355, "bytes"),
    ("router E8 K2 train T4096", lambda K: K.router_topk.work(4096, 8, 2),
     0.0000709, "bytes"),
    ("router Kimi E384 K8 T2048", lambda K: K.router_topk.work(2048, 384, 8),
     0.00100, "bytes"),
    ("ssd Zamba2 serve B1", lambda K: K.ssd_scan.work(
        1, 64, 1, 2048, 64, 64, 256, BF16, F32, F32, F32), 0.0261,
     "operations"),
    ("ssd Zamba2 train B4", lambda K: K.ssd_scan.work(
        4, 64, 1, 2048, 64, 64, 256, BF16, F32, F32, F32), 0.1044,
     "operations"),
    ("ssd xLSTM P384", lambda K: K.ssd_scan.work(
        1, 4, 4, 2048, 384, 384, 256, BF16, F32, F32, F32), 0.0301,
     "operations"),
    ("ssd xLSTM P1", lambda K: K.ssd_scan.work(
        1, 4, 4, 2048, 384, 1, 256, BF16, F32, F32, F32), 0.0038, "bytes"),
    # the backward's bound counts each product's cheaper exact form: an
    # fp32 operand against bf16 q or k as three bf16 parts (1.5 TF32
    # products' time, csrc/ssd_scan_bwd_wgmma.cu's way) where PR 31 counted
    # two TF32 products (0.2871 and 0.0379 ms then)
    ("ssd backward Zamba2 train B4", lambda K: K.ssd_scan.work_backward(
        4, 64, 1, 2048, 64, 64, 256, BF16, F32, F32, F32), 0.2567,
     "operations"),
    ("ssd backward xLSTM P384 a rank", lambda K: K.ssd_scan.work_backward(
        1, 2, 2, 2048, 384, 384, 256, BF16, F32, F32, F32), 0.0334,
     "operations"),
    ("ssd backward xLSTM P1 a rank", lambda K: K.ssd_scan.work_backward(
        1, 2, 2, 2048, 384, 1, 256, BF16, F32, F32, F32), 0.0038, "bytes"),
    # the attention backward's: five products a visible pair, eight as the
    # bf16 kernel issues them (P and dS in two bf16 halves)
    ("flash backward Zamba2 D64 train B4", lambda K:
     K.flash_attention.work_backward((4, 32, 2048, 64), 32, 2048, BF16, True,
                                     4096), 0.2781, "operations"),
    ("flash backward Mixtral D128 train B2", lambda K:
     K.flash_attention.work_backward((2, 32, 2048, 128), 8, 2048, BF16, True,
                                     4096), 0.2781, "operations"),
    ("flash backward Gemma D256 train B2", lambda K:
     K.flash_attention.work_backward((2, 16, 2048, 256), 16, 2048, BF16,
                                     True, 0), 0.2781, "operations"),
    ("flash backward Whisper encoder", lambda K:
     K.flash_attention.work_backward((8, 16, 1500, 64), 16, 1500, BF16,
                                     False, 0), 0.2982, "operations"),
    ("a2a route T4096 E8", lambda K: K.a2a_fused.route_work(4096, 8),
     0.0000501, "bytes"),
    ("gelu Whisper B8x1500x4096", lambda K: K.gelu_stepwise.work(
        8 * 1500 * 4096, BF16), 0.0587, "bytes"),
    ("gelu Whisper backward", lambda K: K.gelu_stepwise.work(
        8 * 1500 * 4096, BF16, True), 0.0880, "bytes"),
    ("gelu Gemma 2567x24576", lambda K: K.gelu_stepwise.work(
        2567 * 24576, BF16), 0.0753, "bytes"),
    ("gelu Gemma backward", lambda K: K.gelu_stepwise.work(
        2567 * 24576, BF16, True), 0.1130, "bytes"),
    ("silu Mixtral experts T5000", lambda K: K.silu_stepwise.work(
        8 * 1568 * 14336, BF16), 0.2147, "bytes"),
    ("silu Mixtral experts backward", lambda K: K.silu_stepwise.work(
        8 * 1568 * 14336, BF16, True), 0.3221, "bytes"),
    ("silu Zamba2 gate B4xS2048", lambda K: K.silu_stepwise.work(
        4 * 2048 * 4096, BF16), 0.0401, "bytes"),
    ("silu Zamba2 gate backward", lambda K: K.silu_stepwise.work(
        4 * 2048 * 4096, BF16, True), 0.0601, "bytes"),
]


@pytest.mark.parametrize("row", BOUND_ROWS, ids=[r[0] for r in BOUND_ROWS])
def test_work_gives_the_bound_column(row):
    from repro_torch import kernels as K
    from repro_torch.kernels import (a2a_fused, flash_attention,  # noqa: F401
                                     gelu_stepwise, router_topk,
                                     silu_stepwise, ssd_scan)
    _, work, bound_ms, by = row
    w = work(K)
    assert w.bound_s * 1e3 == pytest.approx(bound_ms, rel=0.01)
    assert w.bound_by == by


# ---------------------------------------------------------------------------
# (e) the link split and the roofline against the reference's functions
# ---------------------------------------------------------------------------
def _records():
    """A record of every kind over a node's ranks, a model axis of 16 and
    a data axis, as a 16 x 16 world's rank 3 makes them."""
    groups = {"node": list(range(8)), "model": list(range(16)),
              "data": list(range(3, 256, 16))}
    out = []
    for i, op in enumerate(H.KINDS):
        for axis, ranks in groups.items():
            out.append(H.collective_record(op, 1000.0 * (i + 1) + len(ranks),
                                           ranks, axis, 8))
    return out


def test_net_split_and_totals_match_the_reference():
    recs = _records()
    assert [r["net"] for r in recs[:3]] == [False, True, True]
    assert not H.is_net(range(8, 16), 8) and H.is_net(range(4, 12), 8)
    for r in recs:
        assert r["link_bytes"] == ref_pm.collective_link_bytes(
            r["kind"], r["operand_bytes"], r["group_size"])
    ref = [dict(r, dci=r["net"]) for r in recs]
    assert H.count_kinds(recs) == ref_hlo.count_kinds(ref)
    assert H.total_link_bytes(recs) == ref_hlo.total_link_bytes(ref)
    nvlink, net = H.total_link_bytes(recs)
    assert nvlink > 0 and net > 0


def test_roofline_prices_the_network_as_the_reference_prices_dci():
    hw = pm.H100_SXM
    ref_hw = ref_pm.HardwareSpec(
        name="h100", peak_flops_bf16=hw.peak_flops_bf16, hbm_bw=hw.hbm_bw,
        ici_bw=hw.link_bw, dci_bw=hw.net_bw, hbm_bytes=hw.hbm_bytes)
    args = (3.1e17, 4.4e14, 2.5e9, 256)
    got = pm.roofline(*args, coll_bytes_net_per_card=7.5e9, model_flops=2e17)
    want = ref_pm.roofline(*args, hw=ref_hw, coll_bytes_dci_per_chip=7.5e9,
                           model_flops=2e17)
    for k in ("compute_s", "memory_s", "collective_s", "step_time_s",
              "roofline_fraction", "dominant"):
        assert getattr(got, k) == pytest.approx(getattr(want, k)), k
    assert got.collective_s == pytest.approx(2.5e9 / 450e9 + 7.5e9 / 50e9)
    assert (hw.net_bw, hw.cards_per_node) == (50e9, 8)


# ---------------------------------------------------------------------------
# (f) a full-size production cell on the CUDA path; the fake branch
# ---------------------------------------------------------------------------
def test_a_production_cell_traces_on_the_cuda_path():
    res = dryrun.run_cell("llama3.2-3b", "decode_32k", verbose=False)
    assert res["ok"], res.get("error")
    assert res["fits_hbm"] and res["mem"]["peak_gib"] > res["mem"][
        "argument_gib"] > 0
    assert res["trace_s"] < 30
    # the model axis spans two nodes of 8: every collective rides the
    # network on a 16 x 16 mesh of H100s
    assert res["coll_net_calls"] == sum(res["collectives"].values()) > 0
    assert res["coll_nvlink_per_dev"] == 0 < res["coll_net_per_dev"]
    r = res["roofline"]
    assert r["step_time_s"] == max(r["compute_s"], r["memory_s"],
                                   r["collective_s"]) > 0
    assert spmd.backend() is None        # the fake world is left


def test_only_fake_tensors_take_the_count_only_branch(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    def no_library(name):
        raise AssertionError(f"library {name} loaded")
    monkeypatch.setattr(backend, "load", no_library)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 8, 16, generator=g) for _ in range(3))
    before = flash_attention.launches
    fake_launches = []
    with backend.noting(lambda name, work: None, fake_launches.append):
        with backend.fake_cuda():             # a real tensor: the plain path
            out = flash_attention(q, k, v)
        assert fake_launches == []
        assert torch.equal(out, flash_attention_plain(q, k, v))
        with FakeTensorMode():
            fq, fk, fv = (torch.empty(1, 2, 8, 16) for _ in range(3))
            flash_attention(fq, fk, fv)         # outside: plain
            assert fake_launches == []
            with backend.fake_cuda():
                o = flash_attention(fq, fk, fv)
    assert fake_launches == ["flash_attention"]
    # the wrapper's own count is of real launches only
    assert flash_attention.launches == before
    assert backend.is_fake(o) and o.shape == q.shape
    assert not backend.is_fake(q)


def _fake_call(name):
    """Each wrapper on small fake inputs (inside a FakeTensorMode)."""
    from repro_torch.kernels import wrappers
    fn = wrappers()[name]
    x = lambda *shape: torch.empty(shape)
    calls = {
        "flash_attention": lambda: fn(x(1, 2, 8, 16), x(1, 2, 8, 16),
                                      x(1, 2, 8, 16)),
        "flash_attention_bwd": lambda: fn(x(1, 2, 8, 16), x(1, 2, 8, 16),
                                          x(1, 2, 8, 16), x(1, 2, 8, 16),
                                          x(1, 2, 8), x(1, 2, 8, 16)),
        "router_topk": lambda: fn(x(16, 8), 2, 16),
        "ssd_scan": lambda: fn(x(1, 1, 8, 4), x(1, 1, 8, 4), x(1, 2, 8, 4),
                               x(1, 2, 8), 4),
        "ssd_scan_bwd": lambda: fn(x(1, 1, 8, 4), x(1, 1, 8, 4),
                                   x(1, 2, 8, 4), x(1, 2, 8), x(1, 2, 8, 4),
                                   x(1, 2, 4, 4), 4),
        "gelu_stepwise": lambda: fn(x(4, 8)),
        "gelu_stepwise_bwd": lambda: fn(x(4, 8), x(4, 8)),
        "silu_stepwise": lambda: fn(x(4, 8)),
        "silu_stepwise_bwd": lambda: fn(x(4, 8), x(4, 8)),
        "a2a_route": lambda: fn(x(16, 4), 8),
        "a2a_combine": lambda: fn(x(4, 16, 3),
                                  torch.zeros(16, dtype=torch.int32),
                                  torch.ones(16, dtype=torch.bool)),
    }
    return fn, calls[name]


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd",
                                  "router_topk",
                                  "ssd_scan", "ssd_scan_bwd", "gelu_stepwise",
                                  "gelu_stepwise_bwd", "silu_stepwise",
                                  "silu_stepwise_bwd", "a2a_route",
                                  "a2a_combine"])
def test_a_fake_launch_counts_in_the_recorder_not_the_wrapper(name,
                                                              monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_library(lib):
        raise AssertionError(f"library {lib} loaded")
    monkeypatch.setattr(backend, "load", no_library)
    calls, launches = [], []
    with FakeTensorMode():
        fn, call = _fake_call(name)
        before = fn.launches
        with backend.noting(lambda n, w: calls.append(n), launches.append), \
                backend.fake_cuda():
            call()
    assert calls == launches == [name]
    assert fn.launches == before


@pytest.mark.parametrize("op", ["softmax_backward", "logsumexp"])
def test_the_cuda_path_counts_the_kernels_hidden_temporaries(op):
    """The CUDA softmax backward computes ``grad * output`` and logsumexp
    ``exp(x - max)`` into temporaries the dispatcher never sees: on the
    CUDA path the peak holds them beside the op's inputs and output."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    n = 4 * 256 * 512 * 4                       # one f32 (4, 256, 512)
    peaks = {}
    for temps in (False, True):
        stat = H.StepAnalysis(cuda_temps=temps)
        with FakeTensorMode():
            g, y = torch.empty(4, 256, 512), torch.empty(4, 256, 512)
            stat.hold((g, y))
            with stat.recording():
                if op == "softmax_backward":
                    out = torch.ops.aten._softmax_backward_data(
                        g, y, -1, torch.float32)
                else:
                    out = torch.logsumexp(y, -1)
            del out
        peaks[temps] = stat.peak
    out_bytes = n if op == "softmax_backward" else n // 512
    assert peaks[False] == 2 * n + out_bytes
    assert peaks[True] == 3 * n + out_bytes
