"""Summarize dry-run artifacts into the roofline table.

The port of ``repro.launch.summarize`` (framework-free, copied): the
dry-run's ``trace_s`` stands where the reference reads ``compile_s``.

    PYTHONPATH=src python -m repro_torch.launch.summarize results/baseline
"""
from __future__ import annotations

import glob
import json
import os
import sys

from ..configs import skipped_cells


def load(dirpath: str, pod: str = "pod1") -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dirpath, f"*__{pod}.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def table(recs: list[dict]) -> str:
    hdr = ("| arch | shape | t_comp | t_mem | t_coll | bound | "
           "useful_frac | MFU-bound | mem/dev |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['t_compute_s'])} | "
            f"{fmt_s(rf['t_memory_s'])} | {fmt_s(rf['t_collective_s'])} | "
            f"{rf['bottleneck']} | {rf['useful_flop_fraction']:.2f} | "
            f"{rf['mfu_bound']*100:.1f}% | "
            f"{r['memory']['per_device_total']/2**30:.2f} GiB |")
    for arch, shape, reason in skipped_cells():
        rows.append(f"| {arch} | {shape} | — | — | — | SKIPPED | — | — | — |")
    return hdr + "\n".join(rows) + "\n"


def dryrun_table(recs1: list[dict], recs2: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compile | mem/dev | collectives "
           "(AR/AG/RS/A2A/CP per step) |\n|---|---|---|---|---|---|\n")
    rows = []
    for recs, tag in ((recs1, "16×16"), (recs2, "2×16×16")):
        for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
            c = r["collectives"]["counts"]
            cs = "/".join(str(c.get(k, 0)) for k in
                          ("all-reduce", "all-gather", "reduce-scatter",
                           "all-to-all", "collective-permute"))
            rows.append(
                f"| {r['arch']} | {r['shape']} | {tag} | "
                f"{r['trace_s']}s | "
                f"{r['memory']['per_device_total']/2**30:.2f} GiB | {cs} |")
    return hdr + "\n".join(rows) + "\n"


def main() -> int:
    d = sys.argv[1] if len(sys.argv) > 1 else "results/baseline"
    recs1 = load(d, "pod1")
    recs2 = load(d, "pod2")
    print(f"### Roofline (single pod, {len(recs1)} cells)\n")
    print(table(recs1))
    print(f"\n### Dry-run ({len(recs1)+len(recs2)} traces)\n")
    print(dryrun_table(recs1, recs2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
