"""#1, the fused encode + 8x256 MLP eval kernel (``ops.mlp_kernel``), as a
share of its roofline in a dense frame: the bound of the MLP's work on
the frame's H x W x (N_samples + N_samples + N_importance) points, by
operations at bf16 (the model's FLOPs from the configuration's shapes)
or by bytes (each point's position, its ray's direction and its raw
output once), over #1's device time a frame."""

from benchmark.harness import yardstick

UNIT = "%"
LAYER = "ops.mlp_kernel"
MOVES = "dense_frame_ms"
KERNELS = ("fused_nerf_mlp_enc_kernel",)


def read(r):
    t = r.device_s(KERNELS)
    if not t or r.count <= 0:
        return None
    p = r.workload["params"]
    model, render = r.config["model"], r.config["render"]
    rays = p["H"] * p["W"]
    c, f = yardstick.points_per_ray(render)
    points = rays * (c + f)
    b = yardstick.bound(points * (12 + 16) + rays * 12,
                        yardstick.frame_flops(model, render, rays), "bf16")
    return 100.0 * b["bound_ms"] / (t / r.count * 1e3)
