"""`BENCHMARK.json` and the files it names, read by name."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)          # the checkout: BENCHMARK.json is here
OUT = os.path.join(PKG, "out")       # traces, scratch, caches (ignored)

__all__ = ["Cell", "load_cell", "load_benchmark", "ROOT", "OUT", "PKG"]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json, with "name"
    traffic: dict         # traffic/<mix>.json, with "name"
    limits: dict          # checks/<cell>.json: {number: {"limit": ...}}
    end_to_end: List[dict]
    per_layer: List[dict]


def _mine(metric: dict, cell: str, e2e_names) -> bool:
    """Whether a metric is reported in `cell`: listed there, or unlisted
    and (per-layer) moving an end-to-end metric the cell reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names or \
        "moves" not in metric


def load_cell(name: str, bench: dict = None) -> Cell:
    bench = bench if bench is not None else load_benchmark()
    by = {w["name"]: w for w in bench["workloads"]}
    if name not in by:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by)})")
    w = by[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = dict(_json(os.path.join(ROOT, cfg_entry["file"])),
                  name=w["config"])
    traffic = dict(_json(os.path.join(PKG, "traffic", w["traffic"] + ".json")),
                   name=w["traffic"])
    limits = _json(os.path.join(PKG, "checks", name + ".json"))["limits"]
    e2e = [m for m in bench["end_to_end"] if _mine(m, name, ())]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _mine(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per)
