#!/usr/bin/env python3
"""Print the dry run's sweep as one markdown table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    python3 tools/dryrun_table.py [results/dryrun_torch]

One row a (config x shape), both production meshes in it: the peak of
live storage a card (GiB), the roofline's compute / memory / collective
seconds a step on the 16 x 16 mesh, its dominant term and roofline
fraction, the link bytes a card over NVLink and over the network (GB),
and the three terms on 2 x 16 x 16.  A context-parallel config's rank 15
(the model axis's last rank) adds its compute and memory seconds where
they differ from rank 0's.  The figures price the traced counts at the
H100 SXM data sheet's rates (700 W); none is a reading from a card.
"""

from __future__ import annotations

import json
import pathlib
import sys


def _terms(r: dict) -> str:
    return "{:.4f} / {:.4f} / {:.4f}".format(
        r["compute_s"], r["memory_s"], r["collective_s"])


def main(path: str = "results/dryrun_torch") -> int:
    cells = {}
    for f in sorted(pathlib.Path(path).glob("*.json")):
        d = json.loads(f.read_text())
        if d.get("skipped"):
            continue
        if not d.get("ok"):
            print(f"{f.name}: {d.get('error')}", file=sys.stderr)
            continue
        cells[(d["arch"], d["shape"], d["mesh"], d.get("rank", 0))] = d
    print("| config × shape | peak GiB, 16x16 / 2x16x16 | 16x16: compute / "
          "memory / collective s | dominant, fraction | NVLink / net GB a "
          "card | 2x16x16: compute / memory / collective s |")
    print("|---|---|---|---|---|---|")
    fits = True
    for arch, shape in sorted({(a, s) for a, s, _, _ in cells}):
        sp, mp = cells[(arch, shape, "16x16", 0)], \
            cells[(arch, shape, "2x16x16", 0)]
        fits &= sp["fits_hbm"] and mp["fits_hbm"]
        r, rm = sp["roofline"], mp["roofline"]
        sp_terms, mp_terms = _terms(r), _terms(rm)
        last = cells.get((arch, shape, "16x16", 15))
        if last and _terms(last["roofline"]) != sp_terms:
            lr = last["roofline"]
            sp_terms += " (rank 15: {:.4f} / {:.4f})".format(
                lr["compute_s"], lr["memory_s"])
        peak = "{:.2f} / {:.2f}".format(sp["mem"]["peak_gib"],
                                        mp["mem"]["peak_gib"])
        if last and last["mem"]["peak_gib"] != sp["mem"]["peak_gib"]:
            peak += " (16x16 rank 15: {:.2f})".format(
                last["mem"]["peak_gib"])
        print(f"| {arch} × {shape} | {peak} | {sp_terms} | {r['dominant']}, "
              f"{r['roofline_fraction']:.3f} | "
              f"{sp['coll_nvlink_per_dev'] / 1e9:.2f} / "
              f"{sp['coll_net_per_dev'] / 1e9:.2f} | {mp_terms} |")
    print(f"\n{len(cells)} traces; every cell fits the card's 80 GB: {fits}")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
