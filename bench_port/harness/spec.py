"""Finds a cell's parts by name: ``BENCHMARK.json`` at the checkout's
root, the configuration file it names, ``traffic/<mix>.json`` and
``metrics/<metric>.py``.  Adding a configuration, a mix or a metric is
adding files and entries; nothing here changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class SpecError(RuntimeError):
    pass


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no {path.name} at {root}")
    return json.loads(path.read_text())


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration and mix."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        self.bench = bench
        self.workload = _by_name(bench["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.workload["chips"])
        entry = _by_name(bench["configs"], self.workload["config"], "config")
        self.config = json.loads((root / entry["file"]).read_text())
        self.traffic_name = self.workload["traffic"]
        self.traffic = json.loads(
            (BENCH_DIR / "traffic" / f"{self.traffic_name}.json").read_text())

    def module(self, package: str):
        """The configuration's ``datagen``, ``queries`` or ``reference``
        module, named in its file."""
        return importlib.import_module(
            f"bench_port.{package}.{self.config[package]}")

    def metrics(self, section: str) -> list:
        """``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.bench[section]
                if self.name in m.get("workloads", [self.name])]


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read`` function."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no reader {path.relative_to(ROOT)} for metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"bench_port.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
