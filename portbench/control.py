"""The readings the limits of ``correct`` are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 [--out control.jsonl]

For each seed, in one process on the card and at the cell's own sizes:
set-up as a run makes it, a short window of the program as the
configuration states it (the lower reading), then a short window of the
control on the same index, pool and reference: the program with its
paper-mode Light Alignment switched on, which accepts a gap hypothesis
only with no mismatch beside it and so breaks the configuration's
guarantee of the best single-gap alignment (the upper reading).  Both
are compared with the plain reference exactly as a run compares.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: the program's own cheaper path that breaks a stated guarantee
CONTROL = {"light_mode": "paper"}


def readings(cell, seed: int, seconds: float, device, log) -> dict:
    from portbench.manifest import lane_module

    lane = lane_module(cell.traffic.get("lane", "pairs")).Lane(
        cell, seed, device)
    lane.setup(log)
    out = {"seed": seed}
    for kind in ("program", "control"):
        if kind == "control":
            lane.reconfigure(**CONTROL)
        win = lane.window(seconds)
        chk = lane.check(log)
        out[kind] = {**chk["compared"], "batches": win["batches"],
                     "checked_pairs": chk["checked_pairs"]}
        log(f"seed {seed} {kind}: {out[kind]}")
    return out


def main(argv=None) -> int:
    import torch

    from portbench.cell import log
    from portbench.manifest import find_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("the control readings need a CUDA device")
        return 2
    cell = find_cell(args.workload)
    rows = []
    for s in args.seeds.split(","):
        t = time.perf_counter()
        row = readings(cell, int(s), args.seconds, torch.device("cuda"), log)
        row["workload"] = cell.name
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
