"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration, traffic mix, check and metric it names loads by name."""

import importlib
import json
import os
import re

import pytest

from portbench import metrics, roofline, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS["top"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.endswith("_torch")
               for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == KEYS["config"]
    assert NAME.match(c["name"]) and TEXT.match(c["source"])
    assert TEXT.match(c["why"])
    assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert not any(k.endswith(("_dim", "_rank", "_size")) and k != "vocab_size"
                   for k in c["reduced"])
    with open(os.path.join(spec.ROOT, c["file"])) as f:
        body = json.load(f)
    assert body["reduced"] == c["reduced"]
    importlib.import_module(f"portbench.models.{body['builder']}")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_loads_by_name(w):
    assert set(w) == KEYS["workload"]
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and TEXT.match(w["why"])
    cell = spec.load_cell(w["name"])
    assert cell.config["name"] == w["config"]
    assert cell.traffic["generator"] in ("offline", "closed_loop",
                                         "open_loop")
    assert cell.limits and all(v["limit"] > 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer


def test_cell_names_unique_and_pairs_once():
    names = [w["name"] for w in BENCH["workloads"]]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names) and len(set(pairs)) == len(pairs)
    assert len(set(metrics)) == len(metrics)
    assert {w["config"] for w in BENCH["workloads"]} == \
        {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == KEYS["end_to_end"]
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(m):
    assert set(m) - {"workloads"} == KEYS["per_layer"]
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and TEXT.match(m["layer"])
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for cell in m["workloads"]:   # each cell reports what the metric moves
        assert cell in e2e[m["moves"]].get("workloads", [cell])
    assert callable(metrics.reader(m["name"]))
    if "_roofline" in m["name"]:
        assert m["unit"] == "%"
        assert m["name"].split("_roofline")[0] in roofline.KERNELS


def test_every_cell_reports_a_share_of_the_peak():
    for w in BENCH["workloads"]:
        per = spec.load_cell(w["name"]).per_layer
        assert any("mfu" in m["name"] for m in per), w["name"]


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH["paths"]:
        for root, _, files in os.walk(os.path.join(spec.ROOT, p)):
            if "__pycache__" in root or os.sep + "out" in root:
                continue
            for f in files:
                rel = os.path.relpath(os.path.join(root, f), spec.ROOT)
                assert PATH.match(rel), rel


def test_a_metric_of_its_own_name_is_read_before_its_family():
    names = {m["name"] for m in BENCH["per_layer"]}
    assert "mfu_pct.decode" in names and "mfu_pct.prompt" in names
    assert metrics.reader("mfu_pct.decode").__module__ != \
        metrics.reader("mfu_pct.prompt").__module__
    assert metrics.reader("matmul_w4_roofline.decode").__module__ == \
        metrics.reader("matmul_w4_roofline.prompt").__module__
