#!/usr/bin/env python3
"""ptxas's report of attention's kernels on one NVIDIA GPU's machine.

    python3 tools/flash_bwd_probe.py

Builds ``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu`` and
``csrc/flash_attention_bwd_wgmma.cu`` with ``-Xptxas -v`` (into this
checkout's ``build/``, as the port builds them) and prints each kernel's
registers and spill bytes, and every ptxas advisory (the ``C75xx`` notes:
a ``wgmma`` serialised because a register it uses was written while it
ran, C7510-C7515).  Then compiles the ``wgmma`` backward at head dim 256,
which the port does not build: a copy of its source with the tiling
:data:`D256_TILING` appended (K/V and Q/dO tiles of 64 rows, one stage;
shared memory aside), under ``build/flash_bwd_probe/``, and prints its
figures: the reason ``flash_attention.bwd_plan`` keeps D 256 on the
``mma.sync`` kernels.  One JSON line at the end.  Needs ``nvcc`` (the
card's machine).
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)

LIBS = ("flash_attention", "flash_attention_bwd", "flash_attention_bwd_wgmma")
# appended to a copy of csrc/flash_attention_bwd_wgmma.cu: the design's
# tiling at D 256 and the two instances it takes
D256_TILING = """
namespace {
template <> struct Wt<256> {
  static constexpr int SW = 128, CE = 64, NCH = 4;
  static constexpr int ROW_TILE = kRows * 256 * 2;
  static constexpr int DQ_BK = 64, DQ_ST = 1, DQ_TILE = DQ_BK * 256 * 2;
  static constexpr int DQ_SMEM = 0;
  static constexpr int KV_BQ = 64, KV_ST = 1, KV_TILE = KV_BQ * 256 * 2;
  static constexpr int KV_SMEM = 0;
  static constexpr bool KV_PP = false;
};
void* const probe_d256[2] = {reinterpret_cast<void*>(fa_bwd_wg_dq<256>),
                             reinterpret_cast<void*>(fa_bwd_wg_dkdv<256>)};
}  // namespace
"""


def advisories(report: str) -> list:
    """ptxas's advisory lines (``C7xxx``) of one report."""
    return [ln.strip() for ln in report.splitlines() if re.search(r"C7\d\d\d",
                                                                 ln)]


def probe_d256(backend) -> dict:
    """The wgmma backward's two kernels at D 256, compiled (not linked)."""
    out_dir = ROOT / "build" / "flash_bwd_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in backend.CSRC.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    src = out_dir / "flash_attention_bwd_wgmma_d256.cu"
    src.write_text((backend.CSRC / "flash_attention_bwd_wgmma.cu").read_text()
                   + D256_TILING)
    cmd = [backend._nvcc(), *backend.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xptxas=-v", "-c", "-o", str(out_dir / "d256.o"), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        cs.fail(f"the D 256 probe did not compile:\n{res.stderr}")
    usage = {k: v for k, v in cs.ptxas_usage(res.stderr).items()
             if k.endswith("<256>")}
    return {"usage": usage, "advisories": advisories(res.stderr)}


def main() -> int:
    from repro_torch.kernels import backend
    secs = backend.build_all(LIBS, verbose=True)
    res = {"build_s": secs, "usage": {}, "advisories": {}}
    for name in LIBS:
        report = backend.PTXAS_REPORT.get(name)
        if report is None:
            cs.say(f"[probe] {name}: built before this run, no report")
            continue
        res["usage"][name] = cs.ptxas_usage(report)
        res["advisories"][name] = advisories(report)
        cs.say(f"[probe] {name}: (registers, spill store B, spill load B) "
               f"{res['usage'][name]}; advisories "
               f"{res['advisories'][name] or 'none'}")
    res["d256"] = probe_d256(backend)
    cs.say(f"[probe] wgmma backward at D 256 (not built by the port): "
           f"{res['d256']['usage']}; advisories "
           f"{res['d256']['advisories'] or 'none'}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
