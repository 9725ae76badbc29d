"""Finding a cell's pieces by name: ``workloads/<cell>.json``,
``configs/<config>.json``, ``traffic/<kind>.py`` and every
``metrics/<metric>.py``. Adding a cell, a configuration, a traffic kind
or a metric is adding a file; nothing here lists them."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str, what: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad {what} name {name!r}")
    return name


def _json(kind: str, name: str) -> dict:
    path = BENCH_DIR / kind / f"{_checked(name, kind)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.name}")
    with open(path) as f:
        spec = json.load(f)
    if spec.get("name") != name:
        raise ValueError(f"{path.name} names itself {spec.get('name')!r}")
    return spec


def workload(name: str) -> dict:
    return _json("workloads", name)


def config(name: str) -> dict:
    return _json("configs", name)


def names(kind: str) -> list[str]:
    """Every name of ``kind`` (workloads, configs, traffic, metrics)."""
    suffix = ".py" if kind in ("traffic", "metrics") else ".json"
    return sorted(p.name[:-len(suffix)] for p in (BENCH_DIR / kind).iterdir()
                  if p.name.endswith(suffix) and not p.name.startswith("_"))


def _module(kind: str, name: str):
    path = BENCH_DIR / kind / f"{_checked(name, kind)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.name}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def traffic(kind: str):
    """The driver module of a traffic kind."""
    return _module("traffic", kind)


def metric(name: str):
    """A per-layer metric's module: ``UNIT``, ``LAYER``, ``MOVES`` (the
    end-to-end metric it should move) and ``read(reading) -> float |
    None``, None where the run has nothing for it to read."""
    module = _module("metrics", name)
    module.NAME = name
    return module


def metrics_for(end_to_end) -> list:
    """The metrics read in a cell that reports ``end_to_end``: every one
    that moves one of them. A metric whose kernels did not run in the
    cell reads None, and is left out of its line."""
    return [m for m in map(metric, names("metrics"))
            if m.MOVES in end_to_end]
