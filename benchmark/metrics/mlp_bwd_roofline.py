"""#5, the 8x256 MLP's backward kernels (``ops.mlp_train``: deltas,
weight gradients, their reduction), as a share of their roofline in a
training step: the weight-gradient and delta products that a step's
N_rays x (N_samples + N_samples + N_importance) points need (the input
rows' deltas left out: no input gradient is asked for) at bf16, over the
kernels' device time a step."""

from benchmark.harness import yardstick

UNIT = "%"
LAYER = "ops.mlp_train"
MOVES = "train_rays_per_s"
KERNELS = ("nerf_mlp_bwd_delta_kernel", "nerf_mlp_bwd_wgrad_kernel",
           "reduce_rows_kernel")


def read(r):
    t = r.device_s(KERNELS)
    if not t or r.count <= 0:
        return None
    model, render = r.config["model"], r.config["render"]
    c, f = yardstick.points_per_ray(render)
    points = r.config["train"]["N_rays"] * (c + f)
    flops = points * (2 * yardstick.mlp_flops(model)
                      - yardstick.input_side_flops(model))
    b = yardstick.bound(0, flops, "bf16")
    return 100.0 * b["bound_ms"] / (t / r.count * 1e3)
