"""Find the benchmark's pieces by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix; each is a file of its
own (`configs/<name>.json`, `traffic/<name>.json`), the configuration
names its driver (`drivers/<name>.py`), and each per-layer metric is a
reader of its own (`metrics/<name>.py`). So a later change adds a cell,
a mix or a metric as new files and an entry in BENCHMARK.json, with no
edit to the harness.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def check_name(name: str, what: str = "name") -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"{what} {name!r}: a name is 1-64 of A-Z a-z 0-9 "
                         f"_ . - and starts with a letter, digit or _")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise ValueError(f"unit {unit!r}: 1-16 of A-Z a-z 0-9 _ / % . -")
    return unit


class Registry:
    """The benchmark under `base` (the folder holding configs/, traffic/,
    drivers/ and metrics/) and the BENCHMARK.json that lists its cells."""

    def __init__(self, benchmark_json: Path = ROOT / "BENCHMARK.json",
                 base: Path = HERE):
        self.base = Path(base)
        with open(benchmark_json) as f:
            self.spec = json.load(f)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            for entry in self.spec[key]:
                check_name(entry["name"], key)
        for m in self.spec["end_to_end"] + self.spec["per_layer"]:
            check_unit(m["unit"])
        for w in self.spec["workloads"]:
            check_name(w["config"], "config")
            check_name(w["traffic"], "traffic")

    def _file(self, folder: str, name: str, suffix: str) -> Path:
        path = self.base / folder / f"{check_name(name)}{suffix}"
        if not path.is_file():
            raise FileNotFoundError(f"{folder}: no {name!r} ({path})")
        return path

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        with open(self._file("configs", name, ".json")) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self._file("traffic", name, ".json")) as f:
            return json.load(f)

    def _module(self, folder: str, name: str):
        path = self._file(folder, name, ".py")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{folder}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def driver(self, name: str):
        return self._module("drivers", name)

    def metric_reader(self, name: str):
        return self._module("metrics", name)

    def end_to_end(self, workload: str) -> list:
        """The cell's end-to-end metrics: those without a workloads list,
        and those whose list names the cell."""
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        """The cell's per-layer metrics: those whose workloads list names
        the cell, and those without one that move an end-to-end metric
        the cell reports."""
        moves = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.spec["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in moves)]
