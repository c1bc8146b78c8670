"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, metric and lane is found by its name, and the manifest keeps
to the limits of its format."""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import manifest  # noqa: E402

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(MAN) == TOP_KEYS
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_with_its_files(name):
    cell = manifest.find_cell(name)
    assert cell.chips == 1
    assert cell.config["read_len"] in (150, 250)
    assert cell.traffic.get("lane", "pairs") == "pairs"
    assert manifest.lane_module("pairs").Lane
    names = {m.name for m in cell.end_to_end}
    assert {"setup_s", "mbp_per_s", "peak_mem_gib"} <= names
    assert cell.per_layer


def test_cells_in_order_and_unique():
    assert CELLS == ["pe150-775m.illumina", "pe250-775m.illumina",
                     "pe150-775m.diverged"]
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").exists()


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("portbench/configs/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert len(entry["source"]) <= 200
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    for k in entry["reduced"]:
        assert NAME.match(k) and k in cfg
        assert not k.endswith(("_dim", "_rank"))
    assert "assumed" in cfg and "guarantees" in cfg
    used = [w for w in MAN["workloads"] if w["config"] == entry["name"]]
    assert used


def test_metrics_files_and_moves():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        spec = json.loads((ROOT / "portbench" / "metrics"
                           / f"{m['name']}.json").read_text())
        assert spec["unit"] == m["unit"] and spec["better"] == m["better"]
    for m in MAN["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves"}
        assert m["moves"] in e2e
        assert UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))


def test_missing_cell_and_lane_raise():
    with pytest.raises(KeyError):
        manifest.find_cell("no-such.cell")
    with pytest.raises(KeyError):
        manifest.lane_module("no_such_lane")
