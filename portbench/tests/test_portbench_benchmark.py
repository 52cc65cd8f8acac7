"""BENCHMARK.json against the benchmark format's character rules, every
name it holds found as a file, and a cell, configuration, mix and metric
added as files and entries only found by the harness."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import REPO
from portbench import harness

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert all(not p.endswith("_torch") and (REPO / p).is_dir() for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert entry["file"].startswith("portbench/") and (REPO / entry["file"]).is_file()
    cfg = json.loads((REPO / entry["file"]).read_text())
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_entries(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert all(NAME.match(cell[k]) for k in ("name", "config", "traffic"))
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    here = REPO / "portbench"
    mix = json.loads((here / "mixes" / f"{cell['traffic']}.json").read_text())
    assert (here / "kinds" / f"{mix['kind']}.py").is_file()
    assert (here / "limits" / f"{cell['name']}.json").is_file()
    reported = {m["name"] for m in BENCH["end_to_end"]
                if "workloads" not in m or cell["name"] in m["workloads"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert any(m.get("workloads") is None or cell["name"] in m["workloads"]
               for m in BENCH["per_layer"])


def test_workloads_are_distinct_and_few_take_four_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs)) and 1 <= len(pairs) <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    e2e = metric in BENCH["end_to_end"]
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if e2e else {"layer", "moves"})
    assert keys <= set(metric) <= keys | {"workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert (REPO / "portbench" / "metrics" / f"{metric['name']}.py").is_file()
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", metric["workloads"]))
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_names_are_unique_and_setup_is_bounded_at_a_quarter():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    layers = {}
    for m in BENCH["per_layer"]:  # one layer, one name
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_files_under_paths_are_named_from_name_characters():
    for path in (REPO / "portbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert PATH.match(str(path.relative_to(REPO))), path


def test_a_cell_added_as_files_only_is_found(tmp_path):
    """A new configuration, mix, kind, metric and cell need new files and
    entries only: the harness finds them by their names."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp_path / "portbench"
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (here / "configs" / "dummy.json").write_text(json.dumps({"width": 3}))
    (here / "mixes" / "dummy-mix.json").write_text(json.dumps({"kind": "dummy", "rate": 2}))
    (here / "kinds" / "dummy.py").write_text("class Run:\n    pass\n")
    (here / "metrics" / "dummy_ms.py").write_text("def read(view):\n    return 1.5\n")
    (here / "limits" / "dummy-cell.json").write_text(json.dumps({"limits": {"gap": 0.1}}))
    bench["configs"].append({"name": "dummy", "source": "x", "file": "portbench/configs/dummy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy", "traffic": "dummy-mix",
                               "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "dummy_rate", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["dummy-cell"]})
    bench["per_layer"].append({"name": "dummy_ms", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "x", "moves": "dummy_rate",
                               "workloads": ["dummy-cell"]})
    # without "workloads", a metric is read in every cell that reports what it moves
    (here / "metrics" / "dummy_share.py").write_text("def read(view):\n    return None\n")
    bench["per_layer"].append({"name": "dummy_share", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "x", "moves": "dummy_rate"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(tmp_path, "dummy-cell")
    assert cell.config == {"width": 3} and cell.mix["rate"] == 2
    assert hasattr(cell.kind, "Run") and cell.limits == {"limits": {"gap": 0.1}}
    assert {m["name"] for m in cell.end_to_end} == {"dummy_rate", "peak_mem_gib", "setup_s"}
    assert [(m["name"], r.read(None)) for m, r in cell.per_layer] == [
        ("dummy_ms", 1.5), ("dummy_share", None)]
    # the cells already there are found as before
    assert [m["name"] for m, _ in harness.load_cell(tmp_path, "train256").per_layer] == [
        m["name"] for m, _ in harness.load_cell(REPO, "train256").per_layer]
