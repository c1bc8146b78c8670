"""Find a cell, its configuration, its traffic mix and its metrics by name.

``BENCHMARK.json`` at the checkout's root names every cell.  A cell's
configuration is the file its ``configs`` entry names; its traffic mix is
``portbench/traffic/<traffic>.json``; an end-to-end metric is
``portbench/metrics/<name>.json`` (what the run records under that name,
its unit and direction) and a per-layer metric is
``portbench/metrics/<name>.py`` (a reader: ``read(run) -> float | None``).
A lane (``traffic["lane"]``, "pairs" by default) is
``portbench/lanes/<lane>.py``.  Adding a configuration, a mix, a metric
or a lane is adding files and entries; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str                    # "end_to_end" or "per_layer"
    spec: dict                   # the metric's own file (end to end)
    reader: object = None        # the reader module (per layer)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict                 # the configuration file, as run
    traffic: dict                # the traffic file
    end_to_end: tuple            # Metric entries this cell reports
    per_layer: tuple


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _load_reader(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lane_module(name: str):
    """The lane's module, ``portbench/lanes/<name>.py``."""
    path = BENCH_DIR / "lanes" / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no lane {name!r} ({path} is missing)")
    return importlib.import_module(f"portbench.lanes.{name}")


def _metric(entry: dict, kind: str, root: Path) -> Metric:
    name = entry["name"]
    base = root / "portbench" / "metrics"
    spec, reader = {}, None
    if kind == "end_to_end":
        spec = json.loads((base / f"{name}.json").read_text())
        if spec["unit"] != entry["unit"] or spec["better"] != entry["better"]:
            raise ValueError(f"metric {name}: BENCHMARK.json and its file "
                             f"disagree on unit or direction")
    else:
        reader = _load_reader(base / f"{name}.py")
    return Metric(name, entry["unit"], entry["better"], entry["source"],
                  kind, spec, reader)


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its files loaded."""
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())

    def metrics(kind):
        return tuple(_metric(entry, kind, root) for entry in man[kind])

    return Cell(name, int(w["chips"]), config, traffic,
                metrics("end_to_end"), metrics("per_layer"))
