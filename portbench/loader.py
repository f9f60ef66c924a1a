"""Finds everything of a cell by the names in ``BENCHMARK.json``.

* a configuration: the ``file`` its manifest entry names;
* its graph: ``portbench/generators/<generator>.py``, the generator the
  configuration names, whose ``generate(config, seed, device)`` returns
  the cleaned undirected edge list;
* its reference: ``portbench/references/<reference>.py``, which the
  configuration names (see ``references/__init__.py``);
* a traffic mix: ``portbench/traffic/<traffic>.json``;
* a metric: ``portbench/metrics/<name>.py``, whose ``read(run)`` returns
  the metric's value, or None where the run holds nothing to read.

A later cell, configuration, generator, reference, mix or metric is one
more file and one more manifest entry; no file here names any of them.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the manifest's workload entry
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    end_to_end: list  # manifest metric entries this cell reports
    per_layer: list


def manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` is the listed cells'; a per-layer metric
    without it is every cell's that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    man = manifest(root)
    entries = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; known: {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in man["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{entry['traffic']}.json")
                         .read_text())
    e2e = [m for m in man["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _applies(m, name, reported)]
    return Cell(name, entry, config, traffic, e2e, per_layer)


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, loaded by its file name."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} named {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name}", path)
    loaded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loaded)
    return loaded


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return module("metrics", metric).read
