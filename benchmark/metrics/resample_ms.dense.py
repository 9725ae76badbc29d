"""Device milliseconds a dense frame of the ``render.resample`` spans
(``fine_stage``'s ``sample_pdf``, the ``cat`` and the sort of depths, in
every ray chunk), from the card's first op of each span to its last, idle
time while the host enqueues them included."""

from benchmark.harness import spans

UNIT = "ms"
LAYER = "models.nerf.renderer (resample)"
MOVES = "dense_frame_ms"


def read(r):
    return spans.per_root("render.resample", "render.frame")
