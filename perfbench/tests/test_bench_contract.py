"""BENCHMARK.json against the benchmark's contract, and every cell resolved
to its files by name."""

import json
import re

import pytest

from perfbench.cells import HERE, ROOT, load_cell, load_json
from perfbench.tests.helpers import SEARCH, bench_with_tiny_cells

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_text_ok(w) for w in BENCH["command"])
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_entries(kind):
    keys = {"end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[kind]
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH[kind]:
        assert set(m) - {"workloads"} == keys, m
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
    if kind == "end_to_end":
        names = {m["name"] for m in BENCH[kind]}
        assert "setup_s" in names
        for m in BENCH[kind]:
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
    else:
        e2e = {m["name"] for m in BENCH["end_to_end"]}
        for m in BENCH[kind]:
            assert m["moves"] in e2e and _text_ok(m["layer"])
            if m["unit"] == "%" and "roofline" in m["name"]:
                assert m["name"].endswith("_roofline")


def test_configs_and_cells():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert (ROOT / c["file"]).exists() and _text_ok(c["source"]) and _text_ok(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        config = load_json(ROOT / c["file"])
        assert set(c["reduced"]) <= set(config)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _text_ok(w["why"]) and NAME.match(w["traffic"])


def test_run_seconds_fit_the_check():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    assert (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = load_cell(cell)
    assert c.config["name"] == [w for w in BENCH["workloads"] if w["name"] == cell][0]["config"]
    assert {"width", "height", "spp", "max_depth", "light_selection"} <= set(c.traffic)
    assert set(c.readers) == {m["name"] for m in c.per_layer}
    assert {m["name"] for m in c.end_to_end} == {"frame_ms", "setup_s"}
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()


def test_cell_and_metric_from_data_alone():
    """A cell, a mix and a metric that exist only as files and entries
    resolve with no change to the harness."""
    bench = bench_with_tiny_cells()
    c = load_cell("tiny-village", bench, search=SEARCH)
    assert "frames_traced" in c.readers
    assert c.traffic["width"] == 40
    other = load_cell("tiny-terrain", bench, search=SEARCH)
    assert "frames_traced" not in other.readers
