"""Share of the profiled training steps' window in which no operation ran
on the card: 100 x (1 - busy / window), busy the union of the device
operations' intervals (overlap counted once)."""

from benchmark.harness.trace import idle_pct as read  # noqa: F401

UNIT = "%"
LAYER = "device"
MOVES = "train_rays_per_s"
