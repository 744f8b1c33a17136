"""The benchmark's files, found by the names in BENCHMARK.json.

A configuration is `configs/<config>.json` (its `file` entry), a traffic
mix `traffic/<traffic>.json`, a cell `workloads/<cell>.json` (its limits),
and a metric `metrics/<metric>.py`: a reader `read(ctx)` that returns the
metric's value, or None where it finds nothing to read. A metric's unit,
layer, source, the metric it moves and the cells it is read in are its
BENCHMARK.json entry's alone.

A configuration's scene is of a kind, `kinds/<kind>.py` by its `scene`
entry's `kind`, which supplies what differs from kind to kind:

  * `inputs(scene)`: what the benchmark makes from the scene entry's own
    seeds and hands to both sides (for meshes: the meshes);
  * `device_scene(inputs, scene, device)` and, where the kind can be
    partitioned, `partitioned_scene(inputs, scene, device)`: the port's
    build of those inputs through its public entries (program.py renders
    it; a kind without `partitioned_scene` builds no partitioned scene);
  * `reference(inputs, scene, neural, device, dtype)`: the reference's
    scene of those inputs and, where `neural`, the partition boxes
    (check.py traces through its queries, reference/pathtrace.py), written
    under `reference/`, which imports nothing of the port;
  * `SIZE`: the scene entry's key that sets its size.

The frame loop, the view, the nets, the check and the traffic are shared.
Adding a configuration, a scene kind, a mix, a cell or a metric adds files
and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re

# the benchmark's folder, under the checkout's root
DIR = "portbench"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def by_name(entries: list, name: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{len(found)} entries named {name!r}")
    return found[0]


def cell(bench: dict, root: str, name: str) -> dict:
    """Everything one cell runs from: its BENCHMARK.json entry, its
    configuration, traffic mix and limits, and the metrics it reports."""
    work = by_name(bench["workloads"], name)
    conf = by_name(bench["configs"], work["config"])
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return dict(entry=work, name=name, chips=work["chips"],
                config=_json(os.path.join(root, conf["file"])),
                traffic=_json(os.path.join(root, DIR, "traffic", f"{work['traffic']}.json")),
                limits=_json(os.path.join(root, DIR, "workloads", f"{name}.json"))["limits"],
                end_to_end=end_to_end, per_layer=per_layer)


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, root: str):
    """The reader module of metric `name`."""
    return _load(os.path.join(root, DIR, "metrics", f"{name}.py"), f"{DIR}.metrics.{name}")


def sibling_reader(path: str, name: str):
    """The `read` of metric `name`, whose reader lies beside the file
    `path`: for a metric that reads the same quantity as another one."""
    return _load(os.path.join(os.path.dirname(os.path.abspath(path)), f"{name}.py"),
                 f"{DIR}.metrics.{name}").read


def kind_file(name: str, root: str) -> str:
    """The file of scene kind `name`, `kinds/<name>.py`; FileNotFoundError,
    naming the file, where there is none."""
    path = os.path.join(root, DIR, "kinds", f"{name}.py")
    if not (NAME.fullmatch(name) and os.path.isfile(path)):
        raise FileNotFoundError(f"unknown scene kind {name!r}: no file {path}")
    return path


def kind(name: str, root: str):
    """The module of scene kind `name` (kind_file)."""
    return _load(kind_file(name, root), f"{DIR}.kinds.{name}")
