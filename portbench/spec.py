"""``BENCHMARK.json`` and the files it names, found by name: a cell's file
``workloads/<cell>.json``, a configuration's file (its ``file`` entry), a
per-layer metric's reader ``metrics/<metric>.py`` and a cell's scene
generator and imaging steps ``scenes/<name>.py``. Adding a cell, a
configuration, a metric, a generator or an imaging step adds files and
entries; no code here changes."""

from __future__ import annotations

import importlib.util
import json
import os
import re


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, package: str):
    """The module of the file ``path``, loaded by its path as
    ``<package>.<file name>``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(package + "." + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    def __init__(self, root: str):
        self.root = root
        self.dir = os.path.join(root, "portbench")
        self.doc = load_json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return load_json(os.path.join(self.dir, "workloads", f"{name}.json"))

    def metrics_for(self, section: str, workload: str):
        """The entries of ``section`` ("end_to_end" or "per_layer") that the
        cell reports: those without a ``workloads`` key, and those whose key
        lists it."""
        return [m for m in self.doc[section] if workload in m.get("workloads", [workload])]

    def reader(self, name: str):
        """The ``read`` function of ``metrics/<name>.py``."""
        return load_module(os.path.join(self.dir, "metrics", f"{name}.py"), "portbench.metrics").read

    @property
    def scenes(self) -> str:
        """The directory of the scene generators and imaging steps."""
        return os.path.join(self.dir, "scenes")
