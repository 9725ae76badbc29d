"""#5, the canonical MLP's backward kernels (``ops.mlp_train``: deltas with
the input gradient arm, weight gradients, their reduction), as a share of
their roofline in a D-NeRF training step: every weight-gradient and delta
product of the step's points, the encoded points' rows included
(``dnerf_yardstick.bwd_dx_flops``), at bf16, over the kernels' device time
a step. None without a deformation MLP in the configuration."""

from benchmark.harness import dnerf_yardstick, yardstick

UNIT = "%"
LAYER = "ops.mlp_train"
MOVES = "train_rays_per_s"
KERNELS = ("nerf_mlp_bwd_delta_kernel", "nerf_mlp_bwd_wgrad_kernel",
           "reduce_rows_kernel")


def read(r):
    if not dnerf_yardstick.has_deform(r.config["model"]):
        return None
    t = r.device_s(KERNELS)
    if not t or r.count <= 0:
        return None
    b = yardstick.bound(0, dnerf_yardstick.bwd_dx_flops(r.config), "bf16")
    return 100.0 * b["bound_ms"] / (t / r.count * 1e3)
