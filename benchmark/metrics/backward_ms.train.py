"""Device milliseconds a training step of the ``train.backward`` span
(``loss.backward()``: #5 and the renderer's gradients), from the card's
first op of the span to its last, idle time while the host enqueues them
included."""

from benchmark.harness import spans

UNIT = "ms"
LAYER = "autograd (train.backward)"
MOVES = "train_rays_per_s"


def read(r):
    return spans.per_root("train.backward", "train.step")
