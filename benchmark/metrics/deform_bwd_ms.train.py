"""Device milliseconds a training step of the ``dnerf.deform_backward``
span: the D-NeRF deformation MLP's backward kernels (``ops.deform_mlp``),
once a pass (coarse and fine), from the card's first op of the span to
its last. None without a deformation MLP in the configuration or without
the span in the program (a port that runs the deformation's backward
under autograd)."""

from benchmark.harness import dnerf_yardstick, spans

UNIT = "ms"
LAYER = "models.nerf.dnerf_network (deformation)"
MOVES = "train_rays_per_s"


def read(r):
    if not dnerf_yardstick.has_deform(r.config["model"]):
        return None
    return spans.per_root("dnerf.deform_backward", "train.step")
