"""Aggregate dry-run artifacts into roofline tables, one per mesh.

  PYTHONPATH=src python -m repro_torch.launch.report [--dir artifacts/dryrun_torch]

Reads the port's artifacts (`repro_torch.launch.dryrun`) and the JAX
package's alike (the same keys).  A row per (arch, shape): the three
roofline terms, the dominant bottleneck, MODEL_FLOPS over the step's
FLOPs, and one device's peak memory.  The port's terms are at the H100
peaks of `repro_torch.roofline` (the header names them); the JAX
package's at the TPU v5e's.  Every number is a count from shapes, not a
measured time.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.roofline import HARDWARE

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")


def load_cells(d: str) -> list[dict]:
    cells = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            cells.append(json.load(f))
    return cells


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def header() -> str:
    return (f"Roofline terms of the dry run (counts from shapes, not "
            f"measured times) at {HARDWARE}.")


def table(cells: list[dict], mesh: str) -> str:
    rows = [
        "| arch | shape | compute | memory | collective | bottleneck "
        "| useful (6ND/HLO) | GiB/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c.get("mesh") != mesh or c.get("variant"):
            continue
        if "skipped" in c:
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | "
                        f"skipped: {c['skipped']} | — | — |")
            continue
        r = c.get("roofline", {})
        mem = c.get("memory", {}).get("total_nonalias_bytes", 0) / 2**30
        rows.append(
            f"| {c['arch']} | {c['shape']} | {fmt_s(r.get('compute_s', 0))} "
            f"| {fmt_s(r.get('memory_s', 0))} "
            f"| {fmt_s(r.get('collective_s', 0))} "
            f"| **{r.get('bottleneck', '?')}** "
            f"| {r.get('useful_ratio', 0):.2f} | {mem:.2f} |")
    return "\n".join(rows)


def multipod_table(cells: list[dict]) -> str:
    """The collective kinds each multi-pod cell issues, and its memory."""
    rows = [
        "| arch | shape | GiB/dev | collective kinds |",
        "|---|---|---|---|",
    ]
    for c in cells:
        if c.get("mesh") != "multipod_512" or c.get("variant"):
            continue
        if "skipped" in c:
            rows.append(f"| {c['arch']} | {c['shape']} | — | skipped: "
                        f"{c['skipped']} |")
            continue
        mem = c.get("memory", {}).get("total_nonalias_bytes", 0) / 2**30
        coll = (c.get("collectives") or
                c.get("collectives_scan_pass", {})).get("bytes", {})
        kinds = ", ".join(sorted(k for k, v in coll.items() if v)) or "none"
        rows.append(f"| {c['arch']} | {c['shape']} | {mem:.2f} | {kinds} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)
    cells = load_cells(args.dir)
    print(header())
    for mesh in sorted({c.get("mesh") for c in cells if c.get("mesh")}):
        n = sum(1 for c in cells if c.get("mesh") == mesh
                and not c.get("variant"))
        print(f"\n### Mesh {mesh} — roofline ({n} cells)\n")
        print(table(cells, mesh))
        if mesh == "multipod_512":
            print(f"\n### Mesh {mesh} — collective kinds\n")
            print(multipod_table(cells))


if __name__ == "__main__":
    main()
