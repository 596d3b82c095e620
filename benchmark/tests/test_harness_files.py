"""The benchmark's files: BENCHMARK.json against the contract's shape, and
every configuration, traffic mix, limit and metric it names found and
loaded by name.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import re
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\t\n]{1,200}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.fullmatch(w["why"])
        for k in ("name", "config", "traffic"):
            assert NAME.fullmatch(w[k]), w[k]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["workloads"]
        assert LINE.fullmatch(m["layer"])
    names += CELLS
    assert all(NAME.fullmatch(n) for n in names)
    assert len(set(names)) == len(names)
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads(cell):
    c = harness.load_cell(cell)
    assert c.config["script_text"]
    assert (harness.HERE / "traffic" / f"{c.traffic['kind']}.py").exists()
    limits = json.loads((harness.HERE / "limits" / f"{cell}.json")
                        .read_text())
    assert "gap_db" in limits
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_moves_what_its_cells_report(metric):
    """A per-layer metric's ``moves`` is an end-to-end metric that each of
    its cells reports."""
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    for cell in m["workloads"]:
        assert cell in CELLS
        reported = {x["name"] for x in harness.load_cell(cell).end_to_end}
        assert m["moves"] in reported, (cell, m["moves"])


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_and_frozen_script(conf):
    """The configuration's file names its script, a frozen copy whose
    hash it records; nothing is cut."""
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert data["reduced"] == conf["reduced"] == []
    text = (harness.HERE / "configs" / data["script"]).read_bytes()
    assert hashlib.sha256(text).hexdigest() == data["script_sha256"]
    assert (data["voices"], data["sample_rate"], data["channels"],
            data["block"]) == (64, 44100, 2, 512)
    assert conf["file"].startswith("benchmark/")


def test_every_config_used_once_per_traffic():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
