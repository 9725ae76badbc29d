"""Device milliseconds a training step of the ``train.forward`` span: the
loss function's render (coarse, resample, fine) and loss, from the card's
first op of the span to its last, idle time while the host enqueues them
included."""

from benchmark.harness import spans

UNIT = "ms"
LAYER = "models.nerf.renderer (train forward)"
MOVES = "train_rays_per_s"


def read(r):
    return spans.per_root("train.forward", "train.step")
