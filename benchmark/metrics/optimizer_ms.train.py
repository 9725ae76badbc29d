"""Device milliseconds a training step of the ``train.optimizer`` span
(``ScheduledOptimizer.step``: the value clip, the learning rate and
Adam), from the card's first op of the span to its last, idle time while
the host enqueues them included."""

from benchmark.harness import spans

UNIT = "ms"
LAYER = "train.optimizer"
MOVES = "train_rays_per_s"


def read(r):
    return spans.per_root("train.optimizer", "train.step")
