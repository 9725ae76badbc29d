"""D-NeRF's work counted from its configuration's shapes, beside
``yardstick.py``: the deformation MLP Psi_t, the canonical MLP (the
yardstick's NeRF MLP, one branch for both passes), a training step's model
FLOPs and the backward's products with the input gradient.

Per point at the published widths: Psi_t 497,152 multiply-adds (84 -> 256,
six 256 -> 256, the skip layer 319 -> 256, the 3-wide head), the canonical
593,408; a 4096-ray step of 64 + 192 points a ray is 1,048,576 points
through both, 6.86 TFLOP with the backward.
"""

from __future__ import annotations

from . import yardstick


def has_deform(model: dict) -> bool:
    return "deform" in model


def deform_shapes(model: dict) -> dict[str, tuple[int, int]]:
    """(out, in) of every Dense layer of Psi_t: its input is gamma(x) and
    gamma(t); gamma(x) alone is re-joined after each layer in ``skips``."""
    d = model["deform"]
    x_dim = 3 * (1 + 2 * model["xyz_freqs"])
    t_dim = 1 + 2 * d["time_freqs"]
    W, skips = d["W"], set(d["skips"])
    shapes = {}
    for i in range(d["D"]):
        fan_in = x_dim + t_dim if i == 0 else W + (
            x_dim if i - 1 in skips else 0)
        shapes[f"pts.{i}"] = (W, fan_in)
    shapes["out"] = (d["head"], W + (x_dim if d["D"] - 1 in skips else 0))
    return shapes


def deform_flops(model: dict) -> int:
    """2 x the multiply-adds of one point through Psi_t."""
    return 2 * sum(o * i for o, i in deform_shapes(model).values())


def weight_shapes(model: dict) -> dict[str, tuple]:
    """Every parameter: ``deform.*`` and the one canonical MLP's
    ``canonical.*``."""
    out = {}
    for prefix, shapes in (("deform", deform_shapes(model)),
                           ("canonical", yardstick.mlp_shapes(model))):
        for name, (o, i) in shapes.items():
            out[f"{prefix}.{name}.weight"] = (o, i)
            out[f"{prefix}.{name}.bias"] = (o,)
    return out


def step_points(config: dict) -> int:
    """Points a training step runs through both MLPs: N_rays x (coarse +
    fine)."""
    c, f = yardstick.points_per_ray(config["render"])
    return config["train"]["N_rays"] * (c + f)


def train_step_flops(config: dict) -> float:
    """Model FLOPs of a training step: each point's forward through Psi_t
    and the canonical MLP, and its backward (twice the forward)."""
    m = config["model"]
    return 3.0 * (deform_flops(m) + yardstick.mlp_flops(m)) * \
        step_points(config)


def bwd_dx_flops(config: dict) -> float:
    """The products of the canonical MLP's backward (#5) a step with the
    input gradient asked for: every weight gradient and every delta
    product, the encoded points' rows included (d_0 . W_0^T, d_5 .
    W_5x^T); only the direction rows of the view layer take none."""
    m = config["model"]
    _, v_dim = yardstick.encoded_dims(m)
    dir_rows = 2 * yardstick.mlp_shapes(m)["views.0"][0] * v_dim
    return step_points(config) * (2 * yardstick.mlp_flops(m) - dir_rows)
