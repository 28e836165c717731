"""Find a cell's configuration, traffic mix, driver, limits and per-layer
metric readers by name.

``BENCHMARK.json`` at the root names the cells; every other file is found
under one of its ``paths`` by the name alone:

    <path>/configs/<config>.json     (or the file the config entry names)
    <path>/mixes/<traffic>.json      a traffic mix: parameters and "driver"
    <path>/drivers/<driver>.py       run(ctx) for every mix of that kind
    <path>/limits/<workload>.json    the limits of the cell's compared numbers
    <path>/metrics/<metric>.py       read(run) -> a number or None; a
                                     "<quantity>.<group>" metric without
                                     a file of its own is read by
                                     <path>/metrics/<quantity>.py

so a later change adds a cell, a configuration, a mix or a metric by
adding files, and edits none.  The first of ``paths`` that holds a file
wins.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path


@dataclasses.dataclass
class Cell:
    root: Path
    name: str
    config_name: str
    config: dict
    traffic: str
    mix: dict
    chips: int
    end_to_end: list          # metric entries the cell reports, trace 0
    per_layer: list           # metric entries the cell reports, trace 1
    limits: dict
    paths: list


def load_benchmark(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def find(root: Path, paths: list, kind: str, name: str, ext: str) -> Path:
    """``<root>/<path>/<kind>/<name><ext>`` for the first of ``paths`` that
    holds it."""
    for p in paths:
        cand = Path(root) / p / kind / f"{name}{ext}"
        if cand.is_file():
            return cand
    raise FileNotFoundError(f"no {kind}/{name}{ext} under {paths}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A driver or metric file as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = load_benchmark(root)
    paths = list(bench["paths"])
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    mix = load_json(find(root, paths, "mixes", entry["traffic"], ".json"))
    return Cell(
        root=root, name=workload, config_name=conf["name"],
        config=load_json(root / conf["file"]), traffic=entry["traffic"],
        mix=mix, chips=int(entry["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        limits=load_json(find(root, paths, "limits", workload, ".json")),
        paths=paths)


def driver(c: Cell):
    return load_module(find(c.root, c.paths, "drivers", c.mix["driver"],
                            ".py"))


def reader(c: Cell, metric: str):
    """The metric's own reader, or its quantity's (the name up to the
    first dot): one reader serves a quantity's groups, which the
    benchmark keeps apart by the end-to-end metric each moves."""
    try:
        return load_module(find(c.root, c.paths, "metrics", metric, ".py"))
    except FileNotFoundError:
        if "." not in metric:
            raise
        return load_module(find(c.root, c.paths, "metrics",
                                metric.split(".")[0], ".py"))
