"""repro_torch's serve CLI against repro's on the CPU (``--device cpu``):
every key of `serve` (stream and legacy loops), `serve_long`,
`serve_frontdoor` and `save_index` -> ``--index`` that is not a timing
equals repro's output for the same arguments; the shared ``--sub-rate``
flag keeps its per-workload defaults.  ``--chaos`` and ``--health-out``
are held against repro's in `tests/test_torch_multihost.py`."""
import os

import pytest

import repro.launch.serve as jserve
import repro_torch.launch.serve as tserve

TINY = dict(ref_len=60_000, batch=16, batches=2, table_bits=15,
            verbose=False)
#: keys that are times or rates, or name a path
TIMING = {"pairs_per_s", "reads_per_s", "mbp_per_s", "index_build_s",
          "seconds", "save_s", "latency", "store", "manifest"}
#: keys only the port's output has: the pair stream's trace (spans,
#: device markers, counters)
PORT_ONLY = {"trace"}


def _same(got, want):
    assert set(got) - PORT_ONLY == set(want) - PORT_ONLY
    for k in set(want) - TIMING - PORT_ONLY:
        assert got[k] == want[k], k


@pytest.mark.parametrize("loop", ["stream", "legacy"])
def test_serve_matches_repro(loop):
    got = tserve.serve(loop=loop, device="cpu", **TINY)
    _same(got, jserve.serve(loop=loop, **TINY))
    assert got["pairs"] == 32 and got["mapped_frac"] > 0.9
    if loop == "stream":
        assert got["trace"]["batches"] == 2
        assert got["trace"]["spans"]["step"]["count"] == 2


def test_serve_long_matches_repro():
    kw = dict(TINY, batch=4, read_len=600)
    got = tserve.serve_long(device="cpu", **kw)
    _same(got, jserve.serve_long(**kw))
    assert got["reads"] == 8 and got["mapped_frac"] > 0.5


def test_serve_frontdoor_matches_repro():
    kw = dict(TINY, read_len=600)
    got = tserve.serve_frontdoor(device="cpu", **kw)
    _same(got, jserve.serve_frontdoor(**kw))
    assert got["pairs"] == 32 and got["long_reads"] > 0
    assert got["completed"] == got["accepted"] > 0


def test_save_index_then_index_matches_repro(tmp_path):
    """Each package saves a store and serves the pair, long and front
    door loops from it; the port also serves from repro's store."""
    saved = {}
    for name, mod, kw in (("t", tserve, {"device": "cpu"}),
                          ("j", jserve, {})):
        path = str(tmp_path / name)
        saved[name] = mod.save_index(path, **TINY, **kw)
    assert saved["t"]["layout"] == saved["j"]["layout"] == "SeedMap"
    # the same payloads; the manifests differ by repro's backend fields
    payload = {name: sum(os.path.getsize(tmp_path / name / f)
                         for f in os.listdir(tmp_path / name)
                         if f.endswith(".npy")) for name in saved}
    assert payload["t"] == payload["j"] > 0
    for name in saved:
        assert saved[name]["store_mb"] * 1e6 == pytest.approx(
            payload[name] + os.path.getsize(tmp_path / name
                                            / "manifest.json"))
    built = tserve.serve(device="cpu", **TINY)
    for store in ("t", "j"):
        idx = str(tmp_path / store)
        _same(tserve.serve(device="cpu", index_path=idx, **TINY), built)
    _same(tserve.serve(device="cpu", index_path=str(tmp_path / "t"), **TINY),
          jserve.serve(index_path=str(tmp_path / "j"), **TINY))
    fd = dict(TINY, read_len=600)
    _same(tserve.serve_frontdoor(device="cpu", index_path=str(tmp_path / "t"),
                                 **fd),
          jserve.serve_frontdoor(index_path=str(tmp_path / "j"), **fd))


def test_cli_sub_rate_defaults_and_device(monkeypatch):
    """--sub-rate defaults per workload (1e-3 pairs, 0.01 long) and
    --device reaches the entry point (cuda unless asked)."""
    calls = {}
    monkeypatch.setattr(tserve, "serve_long",
                        lambda **kw: calls.__setitem__("long", kw) or {})
    monkeypatch.setattr(tserve, "serve",
                        lambda **kw: calls.__setitem__("pairs", kw) or {})
    tserve.main(["--workload", "long"])
    assert calls["long"]["sub_rate"] == 0.01
    assert calls["long"]["device"] == "cuda"
    tserve.main(["--device", "cpu"])
    assert calls["pairs"]["sub_rate"] == 1e-3
    assert calls["pairs"]["device"] == "cpu"
    tserve.main(["--workload", "long", "--sub-rate", "5e-3"])
    assert calls["long"]["sub_rate"] == 5e-3
