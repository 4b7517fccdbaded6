"""BENCHMARK.json against the rules of its format (names, units, keys,
bounds, sizes), and every file it names found by name."""

import importlib
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
# widths that a configuration may never cut
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|per_tok")

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    MANIFEST = json.load(f)
CELLS = [c["name"] for c in MANIFEST["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["command"]) <= 32 and all(map(_line, m["command"]))
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells at this length fits in 12 hours
    assert ((2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_configs_found_by_name():
    names = [c["name"] for c in MANIFEST["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {c["config"] for c in MANIFEST["workloads"]}
    assert set(names) == used
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"] == f"pfbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k) and k in body and k in body["source_values"]
            assert not WIDTH.search(k)
        importlib.import_module(f"pfbench.drivers.{body['entry']}")


def test_cells_found_by_name():
    m = MANIFEST
    assert 1 <= len(CELLS) <= 24 and len(set(CELLS)) == len(CELLS)
    pairs = {(c["config"], c["traffic"]) for c in m["workloads"]}
    assert len(pairs) == len(CELLS)
    assert sum(c["chips"] == 4 for c in m["workloads"]) <= max(
        1, len(CELLS) // 4)
    for c in m["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(c["name"]) and NAME.match(c["traffic"])
        assert c["chips"] in (1, 4) and _line(c["why"])
        with open(os.path.join(ROOT, "pfbench", "traffic",
                               c["traffic"] + ".json")) as f:
            traffic = json.load(f)
        importlib.import_module(f"pfbench.generators.{traffic['generator']}")
        with open(os.path.join(ROOT, "pfbench", "configs",
                               c["config"] + ".json")) as f:
            config = json.load(f)
        # the scale is the configuration's, the data model the traffic's,
        # and the traffic says what of its model is assumed
        assert not (set(traffic) & set(config)) - {"assumed"}
        assert traffic["assumed"]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    m = MANIFEST
    metrics = m[kind]
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for x in metrics:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if kind == "end_to_end" else {"layer", "moves"})
        assert set(x) - {"workloads"} == keys
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        assert x["source"] in SOURCES
        assert set(x.get("workloads", CELLS)) <= set(CELLS)
        if kind == "end_to_end":
            assert x["source"] in ("host_clock", "device_trace")
            assert 0.01 <= x["bound"] <= 0.25
        else:
            assert _line(x["layer"]) and x["moves"] in e2e
            assert set(x.get("workloads", CELLS)) <= set(
                e2e[x["moves"]].get("workloads", CELLS))
            assert os.path.exists(os.path.join(
                ROOT, "pfbench", "metrics", x["name"] + ".py"))
        if x["name"].endswith("_roofline"):
            assert x["unit"] == "%"
    assert e2e["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_enough(cell):
    def reports(x):
        return cell in x.get("workloads", CELLS)

    e2e = [x["name"] for x in MANIFEST["end_to_end"] if reports(x)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(x) for x in MANIFEST["per_layer"])


def test_layers_spelled_alike():
    layers = {}
    for x in MANIFEST["per_layer"]:
        layers.setdefault(x["layer"].lower(), set()).add(x["layer"])
    assert all(len(v) == 1 for v in layers.values())
