"""BENCHMARK.json against the benchmark's own rules: every name found as a
file, every cell with set-up, another end-to-end metric and a per-layer
one, names and units in their alphabets, bounds in range."""
import json
import re

import pytest

from conftest import ROOT
from perfbench.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
    n = 24       # the check's cost at the most cells a later PR may add
    assert (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200


def _line(text):
    return 1 <= len(text) <= 200 and not re.search(r"[\n\r\t]", text)


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
    assert all(_line(word) for word in BENCH["command"])


def test_names_units_and_files():
    seen = set()
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(cfg["reduced"]) <= set(cfg)
        assert set(cfg["published"]) == set(c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) or
                       k == "head_dim" for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        mix = spec.traffic(w["traffic"])
        assert spec.driver(mix["kind"]).run
        assert spec.cell_params(w["name"]) is not None
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(spec.reader(m["name"]).read)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = {m["name"] for m in spec.metrics_for(BENCH, cell, False)}
    per = spec.metrics_for(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in per:
        assert m["moves"] in e2e
