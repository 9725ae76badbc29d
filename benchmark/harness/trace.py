"""The traced run's profiler pass and the reading every per-layer metric
reads from.

A ``--trace 1`` run measures its window first, with no profiler, and
only then profiles a fixed count of steps or frames: a profiler session
slows the launches that come after it in the process. The trace stays in
memory. From it:

* ``busy_s``: the union of the intervals in which a device operation
  (kernel, copy, set) ran, inside the profiled window; overlapping
  operations count once;
* ``window_s``: the length of the profiled window (a range opened after
  a synchronisation and closed after the next one);
* device seconds by operation name, summed;
* the idle gaps between device operations, each labelled with the
  innermost host operation that spans its middle.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import torch

from . import yardstick

WINDOW = "benchmark.profiled_window"
# the kineto activity types of work on the card
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Reading:
    """What the traced run measured, for the metric readers."""
    cell: str
    workload: dict
    config: dict
    count: int = 0                    # steps or frames profiled
    window_s: float = 0.0
    busy_s: float = 0.0
    device_s_by_name: dict = field(default_factory=dict)
    idle_by_host_op: dict = field(default_factory=dict)
    timed: dict = field(default_factory=dict)   # the window's end-to-end

    def device_s(self, names) -> float | None:
        """Device seconds of the operations whose name contains one of
        ``names``; None when none ran."""
        hits = [s for n, s in self.device_s_by_name.items()
                if any(k in n for k in names)]
        return sum(hits) if hits else None

    def device_s_except(self, names) -> float:
        return sum(s for n, s in self.device_s_by_name.items()
                   if not any(k in n for k in names))

    def breakdown(self) -> dict:
        top = sorted(self.device_s_by_name.items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_by_host_op.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:120], s] for n, s in top[:10]],
                "idle_gaps": [[n[:120], s] for n, s in gaps[:10]]}


def idle_pct(r: Reading) -> float | None:
    """Share of the profiled window in which no operation ran on the
    card: 100 x (1 - busy / window)."""
    if r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)


def torch_ops_ms(r: Reading) -> float | None:
    """Device milliseconds a profiled step or frame of every operation
    that is none of the port's hand kernels."""
    if r.count <= 0:
        return None
    return r.device_s_except(yardstick.HAND_KERNELS) / r.count * 1e3


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _kind(e) -> str:
    """A kineto event's activity type; where this PyTorch has no
    ``activity_type()``, told from the device it ran on."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return "cpu_op"
    if getattr(e, "is_user_annotation", lambda: False)():
        return "gpu_user_annotation"
    return "kernel"


def read_events(events, reading: Reading) -> Reading:
    """Fill ``reading`` from kineto events (``name()``, ``start_ns()``,
    ``end_ns()``, and ``activity_type()`` or ``device_type()``). A
    record_function range shows on the card's timeline too, under its
    host name: a device event of a host op's name is such a mirror, and
    no work."""
    host, device, window = [], [], None
    for e in events:
        s, t, kind = e.start_ns(), e.end_ns(), _kind(e)
        if kind in DEVICE_OPS:
            device.append((s, t, e.name()))
        elif kind.startswith("gpu_"):
            continue
        elif e.name() == WINDOW:
            window = (s, t)
        else:
            host.append((s, t, e.name()))
    mirrors = {n for _, _, n in host} | {WINDOW}
    device = [d for d in device if d[2] not in mirrors]
    if window is None:
        raise RuntimeError("the profiled window's range is not in the trace")
    w0, w1 = window
    device = [(max(s, w0), min(t, w1), n) for s, t, n in device
              if t > w0 and s < w1]
    by_name: dict = {}
    for s, t, n in device:
        by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-9
    busy = _union([(s, t) for s, t, _ in device])
    reading.window_s = (w1 - w0) * 1e-9
    reading.busy_s = sum(t - s for s, t in busy) * 1e-9
    reading.device_s_by_name = by_name
    # idle gaps: before the first, between, and after the last operation;
    # the host op that spans a gap's middle and started last is the
    # innermost one (a heap by start time, spent ops dropped as the
    # middles advance)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    host.sort()
    heap, at, idle = [], 0, {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        while at < len(host) and host[at][0] <= mid:
            heapq.heappush(heap, (-host[at][0], host[at][1], host[at][2]))
            at += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        label = heap[0][2] if heap else "no host op"
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    reading.idle_by_host_op = idle
    return reading


def profile(run, count: int, reading: Reading, sync) -> Reading:
    """Profile ``run()`` (``count`` steps or frames) between two
    synchronisations and read the trace."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with torch_profile(activities=activities) as prof:
        with record_function(WINDOW):
            sync()
            run()
            sync()
    reading.count = count
    return read_events(prof.profiler.kineto_results.events(), reading)

