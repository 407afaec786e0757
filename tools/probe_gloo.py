#!/usr/bin/env python3
"""Which collectives gloo carries for CUDA tensors: for each collective
``core/spmd.py`` uses, two fresh ranks sharing ``cuda:0``
(``core.spmd.launch``, which gives them gloo) run it on a CUDA tensor and
check the result (a collective gloo does not carry may abort the
process, hence a pair each).  Prints one
line per collective and a JSON object last; ``spmd.HOST_ROUTED`` should
name the ones that are not ``ok``.  Then it times each collective that
gloo does carry, on the device tensor and through pinned host memory, in
GB/s of a rank's operand.

    PYTHONPATH=src python3 tools/probe_gloo.py
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def _probe(name: str) -> str:
    """One collective on a CUDA tensor in this rank; its outcome."""
    r, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", 0)

    def all_reduce():
        x = torch.full((4,), float(r + 1), device=dev)
        dist.all_reduce(x)
        return torch.equal(x.cpu(), torch.full((4,), 3.0))

    def all_gather():
        x = torch.full((2,), float(r), device=dev)
        dst = torch.empty(2 * n, device=dev)
        dist.all_gather(list(dst.chunk(n)), x)
        return dst.cpu().tolist() == [0.0, 0.0, 1.0, 1.0]

    def reduce_scatter():
        x = torch.arange(4.0, device=dev) + r
        dst = torch.empty(2, device=dev)
        rs = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        rs(dst, x)
        return dst.cpu().tolist() == ([1.0, 3.0] if r == 0 else [5.0, 7.0])

    def all_to_all():
        x = torch.arange(4.0, device=dev) + 10 * r
        dst = torch.empty(4, device=dev)
        dist.all_to_all_single(dst, x)
        want = [0.0, 1.0, 10.0, 11.0] if r == 0 else [2.0, 3.0, 12.0, 13.0]
        return dst.cpu().tolist() == want

    def ppermute():
        x = torch.full((3,), float(r), device=dev)
        dst = torch.empty(3, device=dev)
        ops = [dist.P2POp(dist.isend, x, (r + 1) % n),
               dist.P2POp(dist.irecv, dst, (r - 1) % n)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return dst.cpu().tolist() == [float((r - 1) % n)] * 3

    def broadcast():
        x = torch.full((2,), float(r), device=dev)
        dist.broadcast(x, 0)
        return x.cpu().tolist() == [0.0, 0.0]

    fn = {"all_reduce": all_reduce, "all_gather": all_gather,
          "reduce_scatter": reduce_scatter, "all_to_all": all_to_all,
          "ppermute": ppermute, "broadcast": broadcast}[name]
    try:
        return "ok" if fn() else "wrong result"
    except Exception as e:                      # noqa: BLE001 - reported
        return f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"


OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
       "ppermute", "broadcast")
RATE_OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")


def _rates(mbytes: int) -> dict:
    """GB/s of each collective over a bf16 CUDA tensor of ``mbytes`` MB in
    this rank, carried by gloo on the device tensor and through pinned host
    memory (``core.spmd``'s two transports), median of 3 after a warm-up."""
    import time
    from repro_torch.core import spmd
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=2)
    x = torch.randn(mbytes * 2 ** 19, device="cuda").to(torch.bfloat16)
    run = {"all_reduce": lambda: spmd.all_sum(x, mesh, "data"),
           "all_gather": lambda: spmd.gather_dim(x, mesh, "data", 0),
           "reduce_scatter": lambda: spmd.scatter_sum(x, mesh, "data", 0),
           "all_to_all": lambda: spmd._all_to_all(x, mesh, "data", 0, 0)}
    out = {}
    base = spmd.HOST_ROUTED
    for name in RATE_OPS:
        for route, routed in (("gloo-cuda", base - {name}),
                              ("host", base | {name})):
            spmd.HOST_ROUTED = routed
            times = []
            for _ in range(4):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                run[name]()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out[f"{name} {route}"] = x.numel() * 2 / 1e9 / sorted(
                times[1:])[1]
    spmd.HOST_ROUTED = base
    return out


def main() -> int:
    from repro_torch.core import spmd
    if torch.cuda.device_count() != 1:
        # two ranks take gloo only where they share one card
        print("probe_gloo: needs a host with one CUDA device",
              file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = {}
    for name in OPS:            # each in a fresh pair: a failure may abort
        try:
            res = spmd.launch(_probe, 2, name, timeout_s=60)
            out[name] = res[0] if res[0] == res[1] else f"{res}"
        except Exception as e:                  # noqa: BLE001 - reported
            out[name] = f"a rank died: {str(e).splitlines()[-1][:120]}"
        print(f"{name}: {out[name]}", flush=True)
    mb = 512
    rates = spmd.launch(_rates, 2, mb, timeout_s=300)[0]
    for k, v in rates.items():
        print(f"{k}: {v:.3f} GB/s over a {mb} MB bf16 tensor a rank")
    print(json.dumps({"gloo_cuda": out, "gb_s": rates}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
