"""A dense frame's model FLOPs (the MLP on every point of every ray, from
the configuration's shapes) at the frame time of the traced run's own
measured window, as a share of the configuration's peak."""

from benchmark.harness import yardstick

UNIT = "%"
LAYER = "model step"
MOVES = "dense_frame_ms"


def read(r):
    ms = r.timed.get("dense_frame_ms")
    if not ms:
        return None
    c, p = r.config, r.workload["params"]
    flops = yardstick.frame_flops(c["model"], c["render"], p["H"] * p["W"])
    return 100.0 * flops / (ms * 1e-3) / c["precision"]["peak_flops"]
