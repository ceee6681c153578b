"""Find a cell's pieces by the names in BENCHMARK.json and its files:

* its configuration (`file`), which names its plain reference
  (`reference`: `benchmark/reference/<reference>.py`);
* its traffic mix (`benchmark/traffic/<traffic>.json`), which names its
  loop (`loop`: `benchmark/loops/<loop>.py`, how the program is built,
  set up, driven and judged);
* its check's limits (`benchmark/limits/<cell>.json`) and its metrics;
* each per-layer metric's file (`benchmark/metrics/<metric>.py`): a
  function `read(reading)`, and the spans (`SPANS`) and kernel sites
  (`SITES`) it reads, which the harness hooks onto the program's modules
  in a traced run (trace.py says how);
* each kernel site's work count (`benchmark/work/<site>.py`, a function
  `work(shape, itemsize, co, image)`).

A cell, a configuration, a reference model, a loop, a mix, a metric or a
site is added by adding its files and entries; no code here changes."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    root: Path = REPO
    chips: int = 1

    def reference(self):
        """The configuration's plain reference module."""
        return module(self.root / "benchmark" / "reference" / f"{self.config['reference']}.py")

    def loop(self):
        """The mix's loop module (it imports the program)."""
        return module(self.root / "benchmark" / "loops" / f"{self.mix['loop']}.py")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = REPO) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def cell(name: str, root: Path = REPO) -> Cell:
    root = Path(root)
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have {[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return Cell(name=name, config=_json(root / conf["file"]),
                mix=_json(root / "benchmark" / "traffic" / f"{entry['traffic']}.json"),
                limits=_json(root / "benchmark" / "limits" / f"{name}.json"), end_to_end=e2e, per_layer=layer,
                root=root, chips=entry["chips"])


_MODULES: dict = {}


def module(path: Path):
    """The Python file at `path`, loaded once per process."""
    path = Path(path).resolve()
    if path not in _MODULES:
        name = "benchmark_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None or not path.is_file():
            raise SystemExit(f"benchmark: no file {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def metric(name: str, root: Path = REPO):
    """The per-layer metric's file: `read(reading) -> float | None`, and
    optionally `SPANS` and `SITES`."""
    return module(Path(root) / "benchmark" / "metrics" / f"{name}.py")


def reader(name: str, root: Path = REPO):
    return metric(name, root).read


def site_work(site: str, root: Path = REPO):
    """A kernel site's least work: `work(shape, itemsize, co, image) ->
    parts`, each a dict of `bytes` and operations by kind (`products`,
    `f32`, `exps`); `image` is the mix's (height, width)."""
    return module(Path(root) / "benchmark" / "work" / f"{site}.py").work
