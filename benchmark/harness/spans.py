"""The port's own spans (``nerf_replication_tpu_torch.utils.tracing``),
read after the traced run's profiled pass for the metrics whose source is
``program_span``: a span records only while a profiler runs, so the store
holds that pass's steps or frames alone.

``per_root(name, root, field)`` is ``field`` of the span ``name`` summed
over the pass, over the count of its root span (``train.step``,
``render.frame``): None where the program has no such span (a port
without the tracing module, a cell whose path does not open it) or no
such field (``device_ms`` off CUDA)."""

from __future__ import annotations


def totals() -> dict:
    try:
        from nerf_replication_tpu_torch.utils import tracing
    except ImportError:
        return {}
    return tracing.totals()


def per_root(name: str, root: str, field: str = "device_ms"):
    t = totals()
    if name not in t or root not in t or not t[root]["count"]:
        return None
    value = t[name][field]
    return None if value is None else value / t[root]["count"]
