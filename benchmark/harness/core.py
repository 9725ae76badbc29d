"""One run of one cell: set-up, the measured window, the traced pass
(``--trace 1``), the correctness check, the result line.

A traffic driver (``traffic/<kind>.py``) provides ``UNITS`` (its
end-to-end metrics) and ``Cell(ctx)``, whose construction is the set-up
(inputs, the program's objects, every shape warmed), with
``window(seconds) -> dict`` (the end-to-end values, ``attempted`` and
``failed``), ``profiled(count) -> callable`` (``count`` steps or frames
for the profiler) and ``checks() -> [Check]`` (frees the program's state,
runs the reference).
"""

from __future__ import annotations

import json
import math
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from . import port, specs, trace

# top-level module names that may not be loaded in a run: JAX, its
# libraries, and the JAX package the port was made from (whose name the
# port's begins with, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nerf_replication_tpu")


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


@dataclass
class Context:
    cell: str
    workload: dict
    config: dict
    seed: int
    device: torch.device

    @property
    def params(self) -> dict:
        return self.workload["params"]

    @staticmethod
    def log(*args) -> None:
        print(*args, file=sys.stderr, flush=True)

    @contextmanager
    def stage(self, label: str):
        """Log a set-up stage's seconds (the card synchronised)."""
        t = time.perf_counter()
        yield
        port.sync(self.device)
        self.log(f"set-up {label}: {time.perf_counter() - t:.2f} s")


@dataclass
class Check:
    """A number compared with its limit: correct while value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks(ctx: Context, readings: dict) -> list[Check]:
    """The readings that the cell's ``limits`` name, each beside its
    limit; the others are logged for information."""
    limits = ctx.workload["limits"]
    for name, value in readings.items():
        if name not in limits:
            ctx.log(f"reading {name}: {value!r} (not compared)")
    return [Check(name, readings[name], limit)
            for name, limit in limits.items()]


def run(args, t0: float, device: torch.device | None = None) -> int:
    """Run the cell named by ``args`` (workload, seed, seconds, trace);
    ``t0`` is the process's start on the host clock. ``device`` is for the
    harness's own tests only: without it the run needs the cards the cell
    asks for."""
    workload = specs.workload(args.workload)
    config = specs.config(workload["config"])
    chips = int(workload["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            found = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            print(f"benchmark: the cell needs {chips} CUDA device(s), found "
                  f"{found}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    # the configurations state float32 products where they say float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = specs.traffic(workload["traffic"])
    ctx = Context(args.workload, workload, config, int(args.seed), device)

    def sync():
        port.sync(device)

    cell = driver.Cell(ctx)
    sync()
    setup_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    timed = cell.window(float(args.seconds))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in the run: {bad}", file=sys.stderr)
        return 4
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips}
    result = {}
    if int(args.trace):
        reading = trace.Reading(args.workload, workload, config, timed=timed)
        count = int(workload["profile"]["count"])
        trace.profile(cell.profiled(count), count, reading, sync)
        metrics = {}
        for m in specs.metrics_for(workload["end_to_end"]):
            value = m.read(reading)
            if value is not None:
                metrics[m.NAME] = {"value": value, "unit": m.UNIT}
        dev.update(busy_s=reading.busy_s, window_s=reading.window_s)
        result["breakdown"] = reading.breakdown()
    else:
        units = {**driver.UNITS, "setup_s": "s"}
        values = {**timed, "setup_s": setup_s}
        metrics = {name: {"value": values[name], "unit": units[name]}
                   for name in workload["end_to_end"]}
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    checks = cell.checks()
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in the run: {bad}", file=sys.stderr)
        return 4
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    result = {"correct": bool(checks) and all(c.ok for c in checks),
              "attempted": int(timed["attempted"]),
              "failed": int(timed["failed"]), "metrics": metrics,
              "device": dev, **result,
              "checks": {c.name: {"value": c.value, "limit": c.limit}
                         for c in checks}}
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
