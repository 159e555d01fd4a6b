"""The manifest against the contract's shape: names, units, keys, bounds,
the files each entry names, and which cells report what."""

import json
import re
from pathlib import Path

import pytest

from ocm_bench import run

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["ocm_bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_and_names(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for e in MANIFEST[section]:
        extra = set(e) - KEYS[section] - ({"workloads"} if section in (
            "end_to_end", "per_layer") else set())
        assert not extra and KEYS[section] <= set(e), (e["name"], extra)
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and section != "per_layer":
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        if section == "configs":
            assert all(NAME.match(k) for k in e["reduced"])
            assert (ROOT / e["file"]).is_file()


def test_bounds_and_sources():
    names = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in names
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in names


def test_check_fits_the_budget_at_24_cells():
    r = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("w", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_reports(w):
    cell = run.load_cell(w["name"], ROOT)
    assert w["chips"] in (1, 4)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"], "every cell reports a per-layer metric"
    for m in cell["per_layer"]:
        assert m["moves"] in e2e, (m["name"], "moves a metric the cell lacks")
        assert callable(run.reader(m["name"]))
    kind = cell["traffic"]["kind"]
    assert (ROOT / "ocm_bench" / "drivers" / f"{kind}.py").is_file()
    assert cell["limits"]


def test_every_config_has_a_cell():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
