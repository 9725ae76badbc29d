"""Host milliseconds a training step: the ``train.step`` span (one loop
iteration of ``Trainer.train_device``: the draw, ``train_step`` and the
stats' stack) on the host's clock, over the profiled steps. Above the
step's device time the host sets the pace."""

from benchmark.harness import spans

UNIT = "ms"
LAYER = "Trainer.train_step (host)"
MOVES = "train_rays_per_s"


def read(r):
    return spans.per_root("train.step", "train.step", "host_ms")
