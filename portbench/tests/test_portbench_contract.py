"""BENCHMARK.json against the benchmark's contract, and the shape of a run's last line."""

import json
import re

import pytest

from portbench.bench import ROOT, load_cell

from .tiny import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher") and e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        cell = load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert all(m["moves"] in reported for m in cell.per_layer)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").exists()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:  # a layer's name is one string, letter for letter
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_last_line_keys(tiny_root):
    result = run(tiny_root, "tiny_wavlm.extract")
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks", "readings"]
    result.pop("readings")  # the printed line ends with "checks"
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"extract_utt_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == {"hidden_rel_err"}
    json.dumps(result)
