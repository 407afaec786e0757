#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. card — its name and power limit; the CUDA kernels built from the sources
   in ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a;
2. kernels — ``a2a_route`` and ``a2a_combine`` against their plain PyTorch
   versions on the card (exact indices, byte-equal outputs);
3. main path — ``pipeline(pre, all_to_all([left]*2, experts), post)``
   compiled for the device and run through ``FFGraph.compile(...).run`` at
   the widths of the repo's Mixtral-8x7B config (d_model 4096, moe_d_ff
   14336, 8 SwiGLU experts, bf16, top-1), T = 4096 tokens, weights from a
   seed: once lossless, once with ``a2a_capacity_factor=1.25``; the kernels'
   launch counts must rise, and the outputs must agree with a plain
   composition on the card (route with the plain version, each expert
   applied to its routed tokens);
4. overlapped hybrid — the same segment between host stages, microbatch
   512 and 4 in flight: byte-equal to the synchronous boundary, rows in
   stream order;
5. times — each kernel and its plain version at the phase-3 shapes (CUDA
   events, median of repeats) beside its bound, and the phase-3 items/s.

The last line of standard output is a JSON object with ``"ok": true`` and
the device; the line before it the ``kernels`` record.  Without a CUDA
device, or without the ``src/repro_torch`` package beside this file, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# phase 1: the card and the build
# ---------------------------------------------------------------------------
def phase_card() -> dict:
    from repro_torch.kernels import backend
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    say(f"[card] {card}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    secs = backend.build_all(verbose=True)
    for name, s in secs.items():
        say(f"[build] {name}.cu {s:.2f} s")
    return {"card": card, "build_s": secs}


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version on the card
# ---------------------------------------------------------------------------
def phase_kernels(dev: torch.device) -> dict:
    from repro_torch.kernels.a2a_fused import (a2a_combine, a2a_combine_plain,
                                               a2a_route, a2a_route_plain)
    g = torch.Generator().manual_seed(1)
    checks = 0
    err = {"a2a_route": 0.0, "a2a_combine": 0.0}
    for E in (2, 8, 64):
        for T in (1, 37, 1000, 4099):
            logits = torch.randn(T, E, generator=g).to(dev)
            for cap in (T, max(1, T // E - 3), 1):
                idx, pos, keep = a2a_route(logits, cap)
                pidx, ppos, pkeep = a2a_route_plain(logits, cap)
                err["a2a_route"] = max(
                    err["a2a_route"], float((idx - pidx).abs().max()),
                    float((pos - ppos).abs().max()),
                    float((keep != pkeep).sum()))
                if not (torch.equal(idx, pidx) and torch.equal(pos, ppos)
                        and torch.equal(keep, pkeep)):
                    fail(f"a2a_route != plain at T={T} E={E} cap={cap}")
                checks += 1
                for dtype in (torch.float32, torch.bfloat16, torch.int32):
                    for item in ((), (5,), (3, 64)):
                        shape = (E, T) + item
                        if dtype == torch.int32:
                            ys = torch.randint(-1000, 1000, shape, generator=g,
                                               dtype=torch.int32).to(dev)
                        else:
                            ys = torch.randn(shape, generator=g).to(dtype).to(dev)
                        out = a2a_combine(ys, idx, keep)
                        ref = a2a_combine_plain(ys, idx, keep)
                        if out.dtype != ref.dtype or out.shape != ref.shape:
                            fail(f"a2a_combine gave {out.dtype} "
                                 f"{tuple(out.shape)}, plain {ref.dtype} "
                                 f"{tuple(ref.shape)}")
                        err["a2a_combine"] = max(
                            err["a2a_combine"],
                            float((out.double() - ref.double()).abs().max()))
                        if not torch.equal(out.view(torch.uint8),
                                           ref.view(torch.uint8)):
                            fail(f"a2a_combine != plain (bytes) at T={T} "
                                 f"E={E} cap={cap} {dtype} item={item}")
                        checks += 1
    say(f"[kernels] a2a_route, a2a_combine equal their plain versions "
        f"({checks} cases, max |err| {err})")
    return {"checks": checks, "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------
# src/repro/configs/mixtral_8x7b.py: d_model 4096, moe_d_ff 14336, 8 experts
D_MODEL, D_FF, N_EXPERTS, N_LEFT, T_TOKENS = 4096, 14336, 8, 2, 4096
CAPACITY_FACTOR = 1.25
# bf16 products on the card: the runner computes every expert on all 4096
# tokens, the plain composition only on each expert's routed rows, and
# cuBLAS may tile and sum the two shapes differently; each of the three
# bf16 roundings per expert may then differ by one ulp (2**-8 relative),
# so outputs must agree within 2**-5 of the largest output magnitude
REL_TOL = 2.0 ** -5


def make_model(dev: torch.device, seed: int = 0) -> dict:
    """Expert, router and norm weights from a seeded torch.Generator, moved
    to the card through ``from_numpy`` as bf16.  The router favours expert 0
    (bias 1.0), as a trained router is seldom balanced, so a capacity of
    1.25x the mean load drops tokens."""
    from repro_torch.core.params import from_numpy
    g = torch.Generator().manual_seed(seed)

    def randn(*shape: int, scale: float):
        return (torch.randn(*shape, generator=g) * scale).numpy()

    experts = []
    for _ in range(N_EXPERTS):   # one expert at a time bounds host memory
        experts.append(from_numpy(
            {"w1": randn(D_MODEL, D_FF, scale=D_MODEL ** -0.5),
             "w3": randn(D_MODEL, D_FF, scale=D_MODEL ** -0.5),
             "w2": randn(D_FF, D_MODEL, scale=D_FF ** -0.5)},
            dev, dtype=torch.bfloat16))
    rest = from_numpy({"router": randn(D_MODEL, N_EXPERTS,
                                       scale=D_MODEL ** -0.5),
                       "norm": 1.0 + randn(D_MODEL, scale=0.1)}, dev)
    bias = torch.zeros(N_EXPERTS, device=dev)
    bias[0] = 1.0
    return {"experts": experts, "router": rest["router"],
            "norm": rest["norm"], "bias": bias}


def make_fns(model: dict) -> dict:
    """The per-item stage functions (each maps one token)."""
    import torch.nn.functional as F

    def pre(x):                      # f32 token from the host -> bf16
        return x.to(torch.bfloat16)

    def left(x):                     # RMSNorm, the left workers of the hop
        x32 = x.float()
        y = x32 * torch.rsqrt((x32 * x32).mean() + 1e-6) * model["norm"]
        return y.to(torch.bfloat16)

    def router(y, n):                # learned top-1 router
        return torch.argmax(y.float() @ model["router"] + model["bias"])

    def expert(w):
        def swiglu(x):
            return (F.silu(x @ w["w1"]) * (x @ w["w3"])) @ w["w2"]
        return swiglu

    def post(y):
        return y.float()

    return {"pre": pre, "left": left, "router": router, "post": post,
            "experts": [expert(w) for w in model["experts"]]}


def build_graph(fns: dict, host_stages: bool = False):
    from repro_torch.core import all_to_all, pipeline
    hop = all_to_all([fns["left"]] * N_LEFT, fns["experts"],
                     router=fns["router"])
    if not host_stages:
        return pipeline(fns["pre"], hop, fns["post"])
    return pipeline(host_in, fns["pre"], hop, fns["post"], host_out)


def host_in(x):                      # host side of the boundary: the token
    import numpy as np               # as the f32 array the device stage takes
    return np.asarray(x, dtype=np.float32)


def host_out(y):
    return y


def plain_composition(fns: dict, xs: torch.Tensor, cap: int):
    """The hop without the runner or the kernels: left map, router, the
    plain route, each expert on its routed tokens, dropped tokens zero."""
    from repro_torch.kernels.a2a_fused import a2a_route_plain
    vmap = torch.func.vmap
    y = vmap(fns["left"])(vmap(fns["pre"])(xs))
    e = vmap(lambda t: fns["router"](t, N_EXPERTS))(y).to(torch.int32)
    logits = torch.nn.functional.one_hot(e.long() % N_EXPERTS,
                                         N_EXPERTS).float()
    idx, _pos, keep = a2a_route_plain(logits, cap)
    out = torch.zeros_like(y)
    for j, fn in enumerate(fns["experts"]):
        rows = ((idx == j) & keep).nonzero().squeeze(1)
        if rows.numel():
            out[rows] = vmap(fn)(y[rows])
    return vmap(fns["post"])(out), keep


def compare(name: str, got, want: torch.Tensor) -> float:
    import numpy as np
    got_t = torch.from_numpy(np.stack(got)).to(want.device)
    if got_t.shape != want.shape or got_t.dtype != want.dtype:
        fail(f"{name}: output {tuple(got_t.shape)} {got_t.dtype}, expected "
             f"{tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got_t).all()):
        fail(f"{name}: non-finite outputs")
    err = float((got_t - want).abs().max())
    scale = float(want.abs().max())
    if err > REL_TOL * scale:
        fail(f"{name}: max |err| {err} > {REL_TOL} x max |ref| {scale}")
    return err


def phase_main_path(dev: torch.device) -> dict:
    import numpy as np
    from repro_torch.core import CompileConfig
    from repro_torch.core.device import expert_capacity
    from repro_torch.core.plan import single_device_plan
    from repro_torch.kernels.a2a_fused import a2a_combine, a2a_route
    t0 = time.perf_counter()
    model = make_model(dev)
    fns = make_fns(model)
    say(f"[main] weights: {N_EXPERTS} experts {D_MODEL}x{D_FF} bf16 from "
        f"seed 0 in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    tokens = rng.standard_normal((T_TOKENS, D_MODEL), dtype=np.float32)
    stream = list(tokens)
    xs = torch.from_numpy(tokens).to(dev)
    cap = expert_capacity(T_TOKENS, N_EXPERTS, 1, CAPACITY_FACTOR)
    plan = single_device_plan()
    runs = {}
    a2a_route.launches = 0
    a2a_combine.launches = 0
    for label, cf in (("lossless", None), ("capacity", CAPACITY_FACTOR)):
        runner = build_graph(fns).compile(config=CompileConfig(
            plan=plan, mode="device", a2a_capacity_factor=cf))
        t1 = time.perf_counter()
        out = runner.run(stream)
        dt = time.perf_counter() - t1
        runs[label] = (runner, out, dt)
    launches = {"a2a_route": a2a_route.launches,
                "a2a_combine": a2a_combine.launches}
    say(f"[main] kernel launches on the main path: {launches}")
    for name, n in launches.items():
        if n < 1:
            fail(f"{name} was not launched on the main path")
    result = {"launches": launches, "cap": cap, "stream": stream,
              "fns": fns, "plan": plan, "xs": xs}
    for label, cf in (("lossless", None), ("capacity", CAPACITY_FACTOR)):
        runner, out, dt = runs[label]
        want, keep = plain_composition(fns, xs, T_TOKENS if cf is None
                                       else cap)
        err = compare(f"main path ({label})", out, want)
        dropped = int((~keep).sum())
        if cf is not None and dropped == 0:
            fail("capacity run dropped no token: the check is vacuous")
        if cf is None and dropped:
            fail("lossless run dropped tokens")
        where = [f"{d}->{p.target}" for d, p in runner.placements]
        say(f"[main] {label}: {type(runner).__name__} {where}, "
            f"{len(out)} items in {dt:.3f} s (first run), max |err| {err:.3g} "
            f"vs plain composition, {dropped} dropped (cap "
            f"{T_TOKENS if cf is None else cap})")
        result[label] = out
    return result


# ---------------------------------------------------------------------------
# phase 4: the same segment behind host stages, overlapped
# ---------------------------------------------------------------------------
def phase_hybrid(main: dict) -> dict:
    import numpy as np
    from repro_torch.core import CompileConfig
    placements = {0: "host", 1: "device", 2: "device", 3: "device",
                  4: "host"}
    outs, times = {}, {True: [], False: []}
    # the first two runs warm up each form (cuBLAS's 512-row kernels, the
    # pinned host buffers); then the two alternate
    for k, overlap in enumerate((True, False, True, False, False, True)):
        runner = build_graph(main["fns"], host_stages=True).compile(
            config=CompileConfig(plan=main["plan"], placements=placements,
                                 microbatch=512, inflight=4,
                                 overlap=overlap))
        if type(runner).__name__ != "HybridRunner":
            fail(f"hybrid graph compiled to {type(runner).__name__}")
        t1 = time.perf_counter()
        outs[overlap] = runner.run(main["stream"])
        if k >= 2:
            times[overlap].append(time.perf_counter() - t1)
        if k == 5:
            stats = [s for s in runner.stats()["graph"]["stages"]
                     if s.get("backend") == "device"]
            say(f"[hybrid] boundary {stats[0]['boundary']}")
    times = {o: sum(ts) / len(ts) for o, ts in times.items()}
    a, b = outs[True], outs[False]
    if len(a) != len(b) or any(x.tobytes() != y.tobytes()
                               for x, y in zip(a, b)):
        fail("overlapped hybrid run differs from the synchronous one")
    ref = main["lossless"]
    want = torch.from_numpy(np.stack(ref))
    err = compare("hybrid vs main path", a, want)
    say(f"[hybrid] {len(a)} items, overlapped {times[True]:.4f} s, sync "
        f"{times[False]:.4f} s (mean of 2 alternating runs each); "
        f"byte-equal; in stream order (max |err| {err:.3g} vs the "
        f"whole-batch run)")
    return {"overlap_s": times[True], "sync_s": times[False]}


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM, f32 outside the tensor cores


def time_ms(fn, reps: int = 5, iters: int = 20) -> float:
    """Median over ``reps`` of the mean of ``iters`` back-to-back eager
    calls, timed with CUDA events: the host's launch cost shows where it
    exceeds the device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    meds = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        meds.append(start.elapsed_time(end) / iters)
    return sorted(meds)[len(meds) // 2]


def graph_ms(fn, reps: int = 5, iters: int = 20) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, timed with CUDA events (median of ``reps``), so no host
    launch cost is in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    meds = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        meds.append(start.elapsed_time(end) / iters)
    return sorted(meds)[len(meds) // 2]


def phase_times(dev: torch.device, main: dict, card: str) -> list:
    from repro_torch.core import CompileConfig
    from repro_torch.core.compiler import make_device_batched
    from repro_torch.core import perf_model
    from repro_torch.kernels.a2a_fused import (a2a_combine, a2a_combine_plain,
                                               a2a_route, a2a_route_plain)
    T, E, D, cap = T_TOKENS, N_EXPERTS, D_MODEL, main["cap"]
    # the phase-3 shapes: one-hot router logits, the (E, T, D) expert stack
    g = torch.Generator().manual_seed(2)
    e = torch.randint(0, E, (T,), generator=g)
    e[: T // 4] = 0                          # the skewed load of phase 3
    logits = torch.nn.functional.one_hot(e, E).float().to(dev)
    ys = torch.randn(E, T, D, generator=g).to(torch.bfloat16).to(dev)
    idx, _pos, keep = a2a_route(logits, cap)
    kept = int(keep.sum())
    rows = []
    route_bytes = T * E * 4 + T * (4 + 4 + 1)
    route_ops = T * E * 5                    # sub, exp, add, div, compare
    combine_bytes = T * (4 + 1) + kept * D * 2 + T * D * 2
    for name, kern, plain, args, nbytes, ops in (
            ("a2a_route", a2a_route, a2a_route_plain, (logits, cap),
             route_bytes, route_ops),
            ("a2a_combine", a2a_combine, a2a_combine_plain, (ys, idx, keep),
             combine_bytes, 0)):
        ms = graph_ms(lambda: kern(*args))
        eager_ms = time_ms(lambda: kern(*args))
        plain_ms = time_ms(lambda: plain(*args))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/a2a_fused.cu",
                     "replaces": "src/repro/kernels/a2a_fused.py:48",
                     "launches": main["launches"][name],
                     "max_abs_err": main["kernels"]["max_abs_err"][name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": None})
        say(f"[time] {name}: {ms:.4f} ms on the device (CUDA graph), "
            f"{eager_ms:.4f} ms per eager call, plain {plain_ms:.4f} ms per "
            f"eager call, bound {bound:.6f} ms ({rows[-1]['bound_by']}, "
            f"{nbytes} B) on {card}")
    runner = build_graph(main["fns"]).compile(config=CompileConfig(
        plan=main["plan"], mode="device"))
    runner.run(main["stream"])
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run(main["stream"])
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    batched, _ = make_device_batched(build_graph(main["fns"]), main["plan"])
    seg_ms = time_ms(lambda: batched(main["xs"], 0), reps=3, iters=2)
    say(f"[time] main path lossless: {T / wall:.1f} items/s "
        f"({wall * 1e3:.1f} ms for {T} items, median of 3); the fused "
        f"device segment alone on resident tokens {seg_ms:.1f} ms, the rest "
        f"({wall * 1e3 - seg_ms:.1f} ms) is the host side of the boundary "
        f"(stack, copies, per-item results) on {card}")
    say(f"[time] CUDA dispatch (tiny kernel, back to back): "
        f"{perf_model.measure_cuda_dispatch() * 1e6:.2f} us on {card}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = phase_card()
    kernels = phase_kernels(dev)
    main = phase_main_path(dev)
    main["kernels"] = kernels
    phase_hybrid(main)
    rows = phase_times(dev, main, card["card"])
    say(f"[done] {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(card["card"])
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
