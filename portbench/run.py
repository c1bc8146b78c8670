"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  Set-up (``setup_s``) runs from the start of this script through
the index build and the warm-up; the window then streams batches for
``--seconds``; ``--trace 1`` adds a traced window after it and reports
the per-layer metrics instead of the end-to-end ones.  Once the windows
are over the program's session is freed and the plain reference decides
``correct``.  The last line of standard output is the result's JSON
object; the numbers compared, each beside its limit, are the last lines
of standard error.  Exits 2, printing no result, without the cards, and 3
where JAX or the JAX package got loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import cell as cell_run
    from portbench.manifest import find_cell

    cell = find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        cell_run.log(f"{cell.name} needs {cell.chips} CUDA device(s); "
                     f"this machine has {n}")
        return 2
    out = cell_run.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda"), T_START)
    if out is None:
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
