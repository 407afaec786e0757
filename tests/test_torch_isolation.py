"""The port stands alone: ``repro_torch`` imports neither JAX nor anything of
the reference package, its entry points default to the GPU, and every host
tier compiles and runs: the process tier, the adaptive runtime, and the
remote tier, which refuses without a worker pool as the reference does and
leaves a farm it cannot ship (a lambda) on host threads with the reason in
its placement."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch.core as T
from repro_torch.core.compiler import Placement
from repro_torch.launch.worker import demo_fn
from repro_torch.core.plan import single_device_plan

torch.set_num_threads(1)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _modules():
    return sorted("repro_torch." + ".".join(
        p.relative_to(PKG).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


# the host tiers' modules, which the import checks must walk too
TIER_MODULES = ("repro_torch.core.shm", "repro_torch.core.process",
                "repro_torch.core.accelerator", "repro_torch.core.runtime",
                "repro_torch.core.net", "repro_torch.launch.tuned",
                "repro_torch.launch.worker")


def test_importing_every_module_loads_no_jax_and_no_reference():
    assert set(TIER_MODULES) <= set(_modules())
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "from repro_torch.kernels import backend\n"
            "print(bad, backend._libs)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[] {}"   # and no kernel built or loaded


def test_no_source_file_imports_jax_or_the_reference():
    bad = []
    paths = sorted(PKG.rglob("*.py"))
    assert {PKG.joinpath(*m.split(".")[1:]).with_suffix(".py")
            for m in TIER_MODULES} <= set(paths)
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(SRC)}: {name}")
    assert bad == []


def test_the_plan_defaults_to_cuda():
    if torch.cuda.is_available():
        assert single_device_plan().device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            single_device_plan()
    plan = single_device_plan(device="cpu")
    assert plan.device == torch.device("cpu")
    assert dict(plan.mesh.shape) == {"data": 1}
    assert plan == single_device_plan(device="cpu")   # equal plans hash equal
    assert hash(plan.mesh) == hash(single_device_plan(device="cpu").mesh)


def _runs_on_processes(runner) -> None:
    # the process tier is ported: its farm is one ProcessFarmNode whose
    # collector keeps the input order
    assert type(runner).__name__ == "ProcessRunner"
    assert runner.placements[0][1].target == "host_process"
    assert runner.run(list(range(20))) == [i + 1 for i in range(20)]


@pytest.mark.parametrize("knob", [{"mode": "process"}, {"mode": "remote"},
                                  {"adaptive": True},
                                  {"remote_workers": ["localhost:1"]}])
def test_unported_tiers_raise(knob):
    g = T.pipeline(T.farm(lambda x: x + 1, n=2))
    if knob.get("mode") == "process":
        _runs_on_processes(g.compile(config=T.CompileConfig(**knob)))
        return
    if knob.get("adaptive"):
        # the adaptive runtime is ported: the farm becomes one
        # AdaptiveFarmNode, whose collector keeps the input order
        runner = g.compile(config=T.CompileConfig(**knob))
        assert [type(st) for st in runner._top_members()] == \
            [T.AdaptiveFarmNode]
        assert runner.run(list(range(20))) == \
            sorted(g.compile(config=T.CompileConfig()).run(list(range(20))))
        return
    if knob.get("mode") == "remote":
        # no pool to reach: refused, as the reference refuses it
        with pytest.raises(T.GraphError, match="remote_workers"):
            g.compile(config=T.CompileConfig(**knob))
        return
    # a pool given, but a lambda cannot cross hosts: the farm stays on
    # host threads (auto placement never reaches the pool), and forced to
    # the remote tier its placement says why it stayed
    for mode in ("auto", "remote"):
        runner = g.compile(config=T.CompileConfig(mode=mode, **knob))
        assert type(runner).__name__ == "HostRunner"
        p = runner.placements[0][1]
        assert p.target == "host", p
        assert ("pickle" in p.reason) == (mode == "remote"), p
        assert sorted(runner.run(list(range(20)))) == \
            [i + 1 for i in range(20)]


@pytest.mark.parametrize("target", ["host_process", "host_remote"])
def test_unported_placements_raise(target):
    if target == "host_process":
        g = T.pipeline(T.farm(lambda x: x + 1, n=2))
        for value in (target, Placement(target)):
            _runs_on_processes(g.compile(config=T.CompileConfig(
                placements={0: value})))
        return
    # the remote tier is ported: with no pool the override is refused, as
    # the reference refuses it; over a loopback pool of 2 the farm runs
    # there, in input order
    g = T.pipeline(T.farm(demo_fn, n=2))
    for value in (target, Placement(target)):
        with pytest.raises(T.GraphError, match="remote-placed"):
            g.compile(config=T.CompileConfig(placements={0: value}))
    addrs, procs = T.spawn_loopback_pool(2)
    try:
        for value in (target, Placement(target)):
            runner = g.compile(config=T.CompileConfig(
                placements={0: value}, remote_workers=addrs))
            assert type(runner).__name__ == "RemoteRunner"
            assert runner.placements[0][1].target == "host_remote"
            xs = [float(i) for i in range(20)]
            assert runner.run(xs, timeout=60) == [x * x for x in xs]
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(timeout=10)


def test_host_runner_is_the_reference_runtime():
    # the copied host tier runs a farm of threads, results in any order
    r = T.pipeline(T.farm(lambda x: x * 2, n=3)).compile(
        config=T.CompileConfig(mode="host"))
    assert type(r).__name__ == "HostRunner"
    assert sorted(r.run(list(range(20)))) == [2 * i for i in range(20)]
    assert sorted(T.farm(lambda x: x + 1, n=2).lower().run([1, 2])) == [2, 3]


def test_device_mode_without_a_plan_raises():
    with pytest.raises(T.GraphError, match="needs a plan"):
        T.pipeline(lambda x: x).compile(config=T.CompileConfig(mode="device"))


def test_kernel_choice_follows_the_tensor_device():
    from repro_torch.kernels import backend
    assert backend.use_kernel(torch.zeros(1)) is False
    with pytest.raises(RuntimeError, match="no kernel"):
        backend.use_kernel(torch.zeros(1, device="meta"))


def test_library_path_hashes_the_headers_a_source_includes(tmp_path,
                                                           monkeypatch):
    """An edited ``csrc/*.cuh`` header renames the library of every source
    that includes it (directly or through another header), so it never
    meets a stale build; a source that does not include it keeps its
    name."""
    import shutil

    from repro_torch.kernels import backend
    src = tmp_path / "csrc"
    shutil.copytree(backend.CSRC, src)
    monkeypatch.setattr(backend, "CSRC", src)
    names = ("router_topk", "a2a_fused", "ssd_scan", "flash_attention")
    before = {n: backend.library_path(n) for n in names}
    assert [p.name for p in backend.sources("router_topk")] == [
        "router_topk.cu", "route_scan.cuh"]
    with open(src / "route_scan.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: backend.library_path(n) for n in names}
    assert after["router_topk"] != before["router_topk"]
    assert after["a2a_fused"] != before["a2a_fused"]
    assert after["ssd_scan"] == before["ssd_scan"]
    assert after["flash_attention"] == before["flash_attention"]
    # a header reached through another header counts too
    (src / "inner.cuh").write_text("// inner\n")
    with open(src / "route_scan.cuh", "a") as f:
        f.write('#include "inner.cuh"\n')
    nested = backend.library_path("router_topk")
    (src / "inner.cuh").write_text("// inner, edited\n")
    assert backend.library_path("router_topk") != nested
