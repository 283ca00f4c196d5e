"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, a cell's file ``workloads/<cell>.json``, its configuration
(the file ``BENCHMARK.json`` names) and its traffic mix
``traffic/<mix>.json``.  Nothing here knows a cell, a mix or a metric by
its name.

A mix's file may name another under ``extends``: it is that mix with the
file's own keys on top.  A mix that keeps its base's ``name`` draws the
base's requests, so one population can be offered at several loads, each
(configuration, mix) pair a cell of its own."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def traffic(name: str) -> dict:
    """The mix ``traffic/<name>.json``, with what it ``extends`` below it."""
    mix = load_json(HERE / "traffic" / f"{name}.json")
    base = mix.pop("extends", None)
    return dict(traffic(base), **mix) if base else mix


def _reported(metrics: List[dict], cell: str) -> List[dict]:
    """The metrics of ``metrics`` that ``cell`` reports: those without a
    ``workloads`` key, and those whose key lists it."""
    return [m for m in metrics if cell in m.get("workloads", [cell])]


@dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    file: dict           # workloads/<cell>.json
    config: dict         # the configuration's file
    traffic: dict        # traffic/<mix>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def cell(name: str, bench: dict = None) -> Cell:
    """Everything ``name`` needs, read from its files."""
    bench = bench or benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in bench['workloads']]}")
    entry = entries[0]
    conf = [c for c in bench["configs"] if c["name"] == entry["config"]][0]
    return Cell(
        name=name, entry=entry,
        file=load_json(HERE / "workloads" / f"{name}.json"),
        config=load_json(ROOT / conf["file"]),
        traffic=traffic(entry["traffic"]),
        end_to_end=_reported(bench["end_to_end"], name),
        per_layer=_reported(bench["per_layer"], name))
