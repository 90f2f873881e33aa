"""BENCHMARK.json against the benchmark contract, and every name it uses
found in a file of its own."""
import json
import re

import pytest

from nkbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nkbench"]
    assert BENCH["command"][1].startswith("nkbench/")
    assert (spec.REPO / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_found_by_name():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        path = spec.path_of("config", c["name"])
        assert c["file"] == str(path.relative_to(spec.REPO))
        data = spec.load_json("config", c["name"])
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_and_reports_what_the_contract_asks(cell):
    w = spec.workload(BENCH, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    spec.load_json("config", w["config"])
    mix = spec.load_json("traffic", w["traffic"])
    assert mix["check"]["limits"].keys() == {"res_ratio", "unsolved",
                                             "bad_counts"}
    e2e = [m["name"] for m in spec.metrics_for(BENCH, "end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_for(BENCH, "per_layer", cell)
    pairs = [(x["config"], x["traffic"]) for x in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    if m["name"] != "setup_s":
        assert callable(spec.reader("end_to_end", m["name"]).read)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader_and_a_sound_entry(m):
    mod = spec.reader("per_layer", m["name"])
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert m["moves"] in E2E
    for cell in m["workloads"]:
        assert cell in CELLS
        assert m["moves"] in [e["name"] for e in
                              spec.metrics_for(BENCH, "end_to_end", cell)]
    assert callable(mod.read)


def test_one_layer_one_name():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_split_metric_is_read_by_its_base_reader():
    assert spec.reader("per_layer", "accept_ms.serve").read is not None
    assert (spec.reader("per_layer", "accept_ms.serve").__file__
            == spec.reader("per_layer", "accept_ms").__file__)


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        spec.load_json("traffic", "no-such-mix")
    with pytest.raises(FileNotFoundError):
        spec.reader("per_layer", "no_such_metric.serve")
    with pytest.raises(ValueError):
        spec.path_of("config", "../escape")
