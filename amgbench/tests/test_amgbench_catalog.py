"""``BENCHMARK.json`` against the contract the harness is built to, and
discovery of each configuration, mix, setup, entry and metric reader by
name from its own file."""

import json
import re

import pytest

from amgbench import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
BENCH = catalog.benchmark()


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["amgbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "amgbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in BENCH[kind]:
            assert NAME.match(item["name"]), item["name"]
            names.append((kind, item["name"]))
            if "unit" in item:
                assert UNIT.match(item["unit"])
                assert item["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in item:
                    assert line(item[key]), (item["name"], key)
    assert len(names) == len(set(names))


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_file_found_by_name(config):
    data = catalog.config(BENCH, config["name"])
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert config["file"] == f"amgbench/configs/{config['name']}.json"
    assert catalog.setup(data["setup"]["solver"]).build
    assert data["problem"]["kind"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_names_a_config_and_a_mix(cell):
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert cell["chips"] == 1
    assert line(cell["why"])
    catalog.config(BENCH, cell["config"])
    mix = catalog.traffic(cell["traffic"])
    entry = catalog.entry(mix["entry"])
    assert entry.prepare and entry.prepare_control
    e2e = {m["name"] for m in catalog.metrics_of(BENCH, "end_to_end",
                                                 cell["name"])}
    assert {"setup_s", "solve_ms"} <= e2e
    assert catalog.metrics_of(BENCH, "per_layer", cell["name"])


def test_bounds():
    bounds = {m["name"]: m["bound"] for m in BENCH["end_to_end"]}
    assert bounds["setup_s"] == 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in BENCH["end_to_end"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert callable(catalog.reader(metric["name"]))
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        catalog.cell(BENCH, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        catalog.traffic("no-such-mix")
