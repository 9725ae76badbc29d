"""A D-NeRF training step's model FLOPs (each point's forward through the
deformation and the canonical MLP and its backward, twice the forward, at
N_rays x (N_samples + N_samples + N_importance) points; counted from the
configuration by ``harness/dnerf_yardstick.py``) at the step time of the
traced run's own measured window, as a share of the configuration's peak.
None without a deformation MLP in the configuration."""

from benchmark.harness import dnerf_yardstick

UNIT = "%"
LAYER = "model step"
MOVES = "train_rays_per_s"


def read(r):
    c = r.config
    rate = r.timed.get("train_rays_per_s")
    if not rate or not dnerf_yardstick.has_deform(c["model"]):
        return None
    n = c["train"]["N_rays"]
    return (100.0 * dnerf_yardstick.train_step_flops(c) * rate / n
            / c["precision"]["peak_flops"])
