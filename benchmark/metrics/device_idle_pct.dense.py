"""Share of the profiled dense frames' window in which no operation ran on
the card: 100 x (1 - busy / window), busy the union of the device
operations' intervals (overlap counted once)."""

from benchmark.harness.trace import idle_pct as read  # noqa: F401

UNIT = "%"
LAYER = "device"
MOVES = "dense_frame_ms"
