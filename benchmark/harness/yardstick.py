"""The yardstick: the card's peaks, a kernel's bound, and a model's work
counted from its configuration's shapes, never from what a kernel does.

``PEAK_*`` and :func:`bound` are copied from ``chip_smoke.py``
(``PEAK_BYTES_PER_S``, ``PEAK_OPS_PER_S``, ``bound``); the MLP counts
follow its ``mlp_flops`` and ``input_side_flops`` but read the shapes
from a configuration file instead of a network's weights.
"""

from __future__ import annotations

# the port's hand kernels (nerf_replication_tpu_torch/csrc/*.cu), by the
# names they run under on the card; every other device operation is a
# PyTorch op
HAND_KERNELS = (
    "fused_nerf_mlp_enc_kernel", "fused_nerf_mlp_kernel",
    "nerf_mlp_bwd_delta_kernel", "nerf_mlp_bwd_wgrad_kernel",
    "reduce_rows_kernel", "brick_hash_encode_fwd_kernel",
    "brick_hash_encode_bwd_kernel", "brick_encode_eval_kernel",
    "fused_ngp_kernel")

# one H100 SXM (NVIDIA data sheet, dense rates, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 494.7e12, "f32": 67e12}


def bound(n_bytes: float, n_ops: float, kind: str) -> dict:
    """The least time the card could take to move ``n_bytes`` and do
    ``n_ops`` operations of type ``kind``: ``bound_ms`` and ``bound_by``."""
    ms_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    ms_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(ms_bytes, ms_ops),
            "bound_by": "bytes" if ms_bytes >= ms_ops else "operations"}


def encoded_dims(model: dict) -> tuple[int, int]:
    """(point features, direction features) of a model section."""
    if model["kind"] == "ngp":
        return 2 * model["grid"]["num_levels"], 16
    return 3 * (1 + 2 * model["xyz_freqs"]), 3 * (1 + 2 * model["dir_freqs"])


def mlp_shapes(model: dict) -> dict[str, tuple[int, int]]:
    """(out, in) of every Dense layer of one MLP branch."""
    x_dim, v_dim = encoded_dims(model)
    D, W, skips = model["D"], model["W"], set(model["skips"])
    shapes = {}
    for i in range(D):
        fan_in = x_dim if i == 0 else W + (x_dim if i - 1 in skips else 0)
        shapes[f"pts.{i}"] = (W, fan_in)
    last = W + (x_dim if D - 1 in skips else 0)
    shapes["alpha"] = (1, last)
    shapes["feature"] = (W, last)
    shapes["views.0"] = (W // 2, W + v_dim)
    shapes["rgb"] = (3, W // 2)
    return shapes


def mlp_flops(model: dict) -> int:
    """2 x the multiply-adds of one point through one branch."""
    return 2 * sum(o * i for o, i in mlp_shapes(model).values())


def input_side_flops(model: dict) -> int:
    """2 x the multiply-adds of one point through the weight rows that read
    the encoded inputs: all of pts.0, the input rows of each layer after a
    skip, and the direction rows of views.0. A backward that returns no
    input gradients forms no deltas through them."""
    x_dim, v_dim = encoded_dims(model)
    shapes = mlp_shapes(model)
    readers = ["pts.0"] + [f"pts.{s + 1}" for s in model["skips"]
                           if s + 1 < model["D"]]
    if model["D"] - 1 in model["skips"]:
        readers += ["alpha", "feature"]
    macs = sum(shapes[r][0] * x_dim for r in readers)
    return 2 * (macs + shapes["views.0"][0] * v_dim)


def points_per_ray(render: dict) -> tuple[int, int]:
    """(coarse, fine) points of a ray: the fine pass runs the union."""
    return render["N_samples"], render["N_samples"] + render["N_importance"]


def train_step_flops(model: dict, render: dict, n_rays: int) -> float:
    """Model FLOPs of a training step: each point's forward and its
    backward (twice the forward), coarse and fine."""
    c, f = points_per_ray(render)
    return 3.0 * mlp_flops(model) * n_rays * (c + f)


def frame_flops(model: dict, render: dict, n_rays: int) -> float:
    """Model FLOPs of a dense frame of ``n_rays`` rays."""
    c, f = points_per_ray(render)
    return float(mlp_flops(model)) * n_rays * (c + f)


def weight_shapes(model: dict) -> dict[str, tuple]:
    """Every parameter of the model: both branches' Dense layers and, for
    an NGP model, its table (rows of 256 lanes)."""
    out = {}
    for branch in ("coarse", "fine"):
        for name, (o, i) in mlp_shapes(model).items():
            out[f"{branch}.{name}.weight"] = (o, i)
            out[f"{branch}.{name}.bias"] = (o,)
    if model["kind"] == "ngp":
        out["xyz_encoder.table"] = (model["grid"]["table_rows"], 256)
    return out
