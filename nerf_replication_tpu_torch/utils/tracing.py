"""Spans and counters of the port: where a training step or a frame spends
its card and host time, and which kernels and plain versions ran.

:func:`span` marks a stage (``train.step``, ``render.resample``, ...). It
is on only while a torch profiler records
(``torch.autograd._profiler_enabled()``); there is no other switch. Off,
it returns a shared no-op context: nothing is allocated or recorded. On,
it opens ``torch.profiler.record_function(name)``, so the range sits on
the profiler's timeline (and in ``prof.export_chrome_trace``) beside the
device ops, and keeps in an in-memory store its name, its parent's index,
its root's id (the global step of a training step, a frame counter), its
host start and end (``perf_counter_ns``) and, once CUDA is in use, a pair
of timing events on the current stream at its edges (none while that
stream is being captured into a CUDA graph). The store holds at most
:data:`LIMIT` spans and counts those it drops past that.

:func:`totals` resolves the store's events (one synchronisation) and sums
it by name: ``count``, ``host_ms``, ``device_ms`` (the card's time from
the span's start event to its end event: its work and any idle while the
host enqueued it; None off CUDA) and ``self_device_ms`` (less its
children's). :func:`reset` empties the store.

:data:`counts` counts, always, each kernel wrapper's launches and each
plain version's calls, under ``"<owner>.<what>"``: e.g.
``"fused_nerf_mlp.launches"``, ``"fused_ngp_eval.bf16_launches"``,
``"fused_nerf_mlp_reference.calls"``, ``"Network.calls"``. A D-NeRF
adds the span ``dnerf.deform`` (its deformation MLP's forward, once per
pass), the count of the points it moves (``"DNeRF.deform_points"``) and
the backward's input-gradient launches
(``"fused_nerf_mlp_bwd.input_grad_launches"``); its deformation's kernels
add the span ``dnerf.deform_backward`` (their backward, once per pass)
and ``"fused_deform_mlp.launches"``, ``"fused_deform_mlp_bwd.launches"``
and their plain versions' ``.calls``. The training route's encodes:
``"fused_nerf_mlp_bwd.encode_launches"`` (#5's delta kernel encoding its
tiles), ``"fused_nerf_mlp_bwd.encode_grad_launches"`` (the encoding's
gradient, where the points need one), ``"encode_grad_reference.calls"``
(its plain version) and ``"freq_encode.calls"`` (an encoding in PyTorch,
none on the card's training route).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch

LIMIT = 1 << 16

counts: collections.Counter = collections.Counter()

_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class Record:
    """One span: ``parent`` is the index of the span that encloses it (-1
    for a root), ``root`` the id given to it or inherited."""
    name: str
    parent: int
    root: object
    host_start_ns: int
    host_end_ns: int = 0
    device_ms: float | None = None
    events: tuple | None = None     # (start, end) until resolved


class _Store:
    def __init__(self):
        self.records: list[Record] = []
        self.open: list[int] = []     # the open spans, innermost last
        self.dropped = 0
        self.generation = 0           # bumped by reset(): older spans stale


_store = _Store()


class _Span:
    __slots__ = ("name", "root", "_fn", "_index", "_generation")

    def __init__(self, name: str, root):
        self.name, self.root = name, root

    def __enter__(self):
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        store = _store
        self._generation = store.generation
        if len(store.records) >= LIMIT:
            store.dropped += 1
            self._index = -1
            return self
        parent = store.open[-1] if store.open else -1
        root = self.root if self.root is not None or parent < 0 \
            else store.records[parent].root
        events = None
        if torch.cuda.is_initialized() \
                and not torch.cuda.is_current_stream_capturing():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        self._index = len(store.records)
        store.records.append(Record(self.name, parent, root,
                                    time.perf_counter_ns(), events=events))
        store.open.append(self._index)
        return self

    def __exit__(self, *exc):
        store = _store
        if self._index >= 0 and self._generation == store.generation:
            rec = store.records[self._index]
            if rec.events is not None:
                rec.events[1].record()
            rec.host_end_ns = time.perf_counter_ns()
            store.open.pop()
        self._fn.__exit__(*exc)
        return False


def span(name: str, root=None):
    """A context manager around one stage; ``root`` is the id of a span
    that starts a tree (the global step, a frame counter), which its
    children inherit. A no-op unless a torch profiler records."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, root)


def reset() -> None:
    """Empty the store (and its count of dropped spans)."""
    _store.records = []
    _store.open = []
    _store.dropped = 0
    _store.generation += 1


def dropped() -> int:
    """Spans not stored since the last reset: the store was full."""
    return _store.dropped


def records() -> list[Record]:
    """The closed spans, in the order they opened, their device times
    resolved."""
    _resolve()
    return [r for r in _store.records if r.host_end_ns]


def _resolve() -> None:
    pending = [r for r in _store.records if r.events is not None
               and r.host_end_ns]
    if not pending:
        return
    torch.cuda.synchronize()
    for r in pending:
        start, end = r.events
        r.device_ms = start.elapsed_time(end)
        r.events = None


def totals() -> dict:
    """Per span name: ``count``, ``host_ms``, ``device_ms`` (None unless
    every such span has device times) and ``self_device_ms`` (less the
    device time of the spans directly inside)."""
    recs = records()
    children = [0.0] * len(_store.records)
    for r in recs:
        if r.parent >= 0 and r.device_ms is not None:
            children[r.parent] += r.device_ms
    out: dict = {}
    for i, r in enumerate(_store.records):
        if not r.host_end_ns:
            continue
        t = out.setdefault(r.name, {"count": 0, "host_ms": 0.0,
                                    "device_ms": 0.0, "self_device_ms": 0.0})
        t["count"] += 1
        t["host_ms"] += (r.host_end_ns - r.host_start_ns) * 1e-6
        if r.device_ms is None or t["device_ms"] is None:
            t["device_ms"] = t["self_device_ms"] = None
        else:
            t["device_ms"] += r.device_ms
            t["self_device_ms"] += r.device_ms - children[i]
    return out
