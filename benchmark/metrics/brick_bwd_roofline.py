"""#7, the brick hash grid's table gradient (``ops.hashgrid_kernel``), as
a share of its roofline in a training step: the bytes each of a step's
two calls needs (the coarse pass's N_rays x N_samples points and the
fine pass's N_rays x (N_samples + N_importance): their positions and
feature gradients read once, the whole table gradient written once),
over the kernel's device time a step."""

from benchmark.harness import yardstick

UNIT = "%"
LAYER = "ops.hashgrid_kernel"
MOVES = "train_rays_per_s"
KERNELS = ("brick_hash_encode_bwd_kernel",)


def read(r):
    t = r.device_s(KERNELS)
    if not t or r.count <= 0:
        return None
    model, render = r.config["model"], r.config["render"]
    feats = 2 * model["grid"]["num_levels"]
    table = model["grid"]["table_rows"] * 256 * 4
    n = r.config["train"]["N_rays"]
    n_bytes = sum(points * (3 + feats) * 4 + table
                  for points in (n * c for c in
                                 yardstick.points_per_ray(render)))
    b = yardstick.bound(n_bytes, 0, "f32")
    return 100.0 * b["bound_ms"] / (t / r.count * 1e3)
