"""A whole run at a tiny size on the CPU: the result line's shape, the
check that JAX and the JAX package stay out of the process, the control
and the faults that ``correct`` has to catch.  The look for a card is
skipped (`cell.run_cell` is what ``run.py`` calls once it found one);
``run.py`` itself must refuse to run without one.  One test, on the card,
reads the control at a cell's widths."""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import cell as cell_run  # noqa: E402
from portbench import control, manifest  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 4242
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


def tiny(name, **sizes):
    cell = manifest.find_cell(name)
    cfg = dict(cell.config, genome_bases=1 << 16, table_bits=14, batch=256)
    cfg.update(sizes)
    return dataclasses.replace(cell, config=cfg)


def run(cell, trace=False, **kw):
    return cell_run.run_cell(cell, SEED, 0.2, trace, CPU,
                             time.perf_counter(), trace_batches=4, **kw)


def test_result_line_untraced():
    out = run(tiny("pe150-775m.illumina"))
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0 and out["attempted"] % 256 == 0
    assert set(out["metrics"]) == {"mbp_per_s", "peak_mem_gib", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert out["metrics"]["mbp_per_s"]["value"] > 0
    assert out["device"]["count"] == 1
    assert set(out["compared"]) == {"pair_mismatches", "total_mismatches"}
    json.dumps(out)


def test_result_line_traced():
    out = run(tiny("pe250-775m.illumina"), trace=True)
    assert list(out) == KEYS[:5] + ["breakdown", "compared"]
    # on the CPU no device activity is traced: the device readers return
    # nothing and only the host's metric is reported
    assert set(out["metrics"]) == {"host_ms_per_batch"}
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0
    bd = out["breakdown"]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert out["correct"] is True


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import repro_torch  # noqa: F401  (the program's name begins with repro)
    assert cell_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert cell_run.forbidden_modules() == ["jax", "repro"]
    out = run(tiny("pe150-775m.illumina"))
    assert out is None


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "pe150-775m.illumina", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_control_fails_the_check(monkeypatch):
    from portbench.lanes import pairs

    cell = tiny("pe150-775m.diverged", batch=512)
    r = control.readings(cell, SEED, 0.2, CPU, cell_run.log)
    assert r["program"]["pair_mismatches"] == 0
    assert r["program"]["total_mismatches"] == 0
    assert r["control"]["pair_mismatches"] > 0
    # the control in the program's place for a whole run
    setup = pairs.Lane.setup

    def control_setup(self, log):
        setup(self, log)
        self.reconfigure(**control.CONTROL)

    monkeypatch.setattr(pairs.Lane, "setup", control_setup)
    out = run(cell)
    assert out["correct"] is False and out["failed"] > 0


def _break_step(monkeypatch, fault):
    """Break the program's pair step underneath the stream."""
    from repro_torch.engine import mapper as mapper_mod

    good = mapper_mod.Mapper._step
    prev = {}

    def broken(self, reads1, reads2, n):
        res = good(self, reads1, reads2, n)
        if fault == "stale":           # hands back the last batch's result
            out, prev["res"] = prev.get("res", res), res
            return out
        if fault == "half":            # maps half the batch, skips the rest
            keep = torch.arange(res.pos1.shape[0]) < reads1.shape[0] // 2
            return res._replace(
                pos1=torch.where(keep, res.pos1, 2**31 - 1),
                pos2=torch.where(keep, res.pos2, 2**31 - 1),
                method=torch.where(keep, res.method, 0))
        if fault == "altered":         # one answer off where it is made
            pos1 = res.pos1.clone()
            pos1[3] += 1
            return res._replace(pos1=pos1)
        raise ValueError(fault)

    monkeypatch.setattr(mapper_mod.Mapper, "_step", broken)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    _break_step(monkeypatch, fault)
    out = run(tiny("pe150-775m.illumina"))
    assert out["correct"] is False
    assert out["compared"]["pair_mismatches"]["value"] > 0 or \
        out["compared"]["total_mismatches"]["value"] > 0


@pytest.mark.cuda
def test_control_on_the_card_at_the_cells_widths():
    """The control against the program at the cell's widths and 65,536
    pairs a batch on a 2^24-base genome (the full cell's readings are
    ``control.py``'s)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    cell = tiny("pe150-775m.diverged", genome_bases=1 << 24,
                table_bits=23, batch=65_536)
    r = control.readings(cell, SEED, 1.0, torch.device("cuda"),
                         cell_run.log)
    assert r["program"]["pair_mismatches"] == 0
    assert r["program"]["total_mismatches"] == 0
    assert r["control"]["pair_mismatches"] > 0


def test_the_stream_keeps_no_pulled_batch():
    """The window hands the stream the same pool batches round and round;
    no mapping job sends a batch twice, so reuse keyed on a batch's
    identity or address (a cached pinned copy, device copy or result)
    would be a gain no job gets.  The program must let go of every pulled
    batch within a batch of the next pull (one batch of look-ahead is
    fair), and of all of them once the stream returns."""
    import gc
    import weakref

    from portbench.lanes import pairs

    lane = pairs.Lane(tiny("pe150-775m.illumina"), SEED, CPU)
    lane.setup(cell_run.log)
    pulled = []

    def alive(refs):
        gc.collect()
        return [i for i, pair in refs if any(r() is not None for r in pair)]

    def feed():
        for k in range(12):
            assert alive(pulled[:-2]) == []
            a, b = (x.copy() for x in lane.pool[k % len(lane.pool)])
            pulled.append((k, (weakref.ref(a), weakref.ref(b))))
            yield a, b

    sr = lane.mapper.map_stream(feed())
    assert sr.n_batches == 12
    assert alive(pulled) == []
