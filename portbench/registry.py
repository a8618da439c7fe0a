"""Finds what a cell names, by name, in files of their own:

  BENCHMARK.json             the cells, configurations and metrics
  configs/<config>.json      a configuration (as its `file` names it)
  traffic/<traffic>.json     a traffic mix's parameters
  metrics/<metric>.py        a metric's reader: read(run) -> number/None
  roofline/<kernel>.py       a kernel's bytes or operations function
  peaks.json                 the card's published peaks

A later cell, mix, metric or kernel count is a new file and a new entry;
no file here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as fh:
                return json.load(fh)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, here: str = HERE) -> dict:
    with open(os.path.join(here, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def peaks(here: str = HERE) -> dict:
    with open(os.path.join(here, "peaks.json")) as fh:
        return json.load(fh)


def _module(kind: str, name: str, here: str):
    path = os.path.join(here, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, here: str = HERE):
    """The read(run) function of metrics/<name>.py."""
    return _module("metrics", name, here).read


def roofline(kernel: str, here: str = HERE):
    """The module of roofline/<kernel>.py."""
    return _module("roofline", kernel, here)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def metrics_of(bench: dict, workload: str, trace: bool):
    """The metrics a run of `workload` reports: its end-to-end ones
    (trace off) or its per-layer ones (trace on)."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if applies(m, workload)]
