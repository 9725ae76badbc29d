"""The training step's model FLOPs (each point's MLP forward and its
backward, twice the forward, coarse and fine, from the configuration's
shapes) at the step time of the traced run's own measured window, as a
share of the configuration's peak."""

from benchmark.harness import yardstick

UNIT = "%"
LAYER = "model step"
MOVES = "train_rays_per_s"


def read(r):
    rate = r.timed.get("train_rays_per_s")
    if not rate:
        return None
    c = r.config
    n = c["train"]["N_rays"]
    flops = yardstick.train_step_flops(c["model"], c["render"], n)
    return 100.0 * flops * rate / n / c["precision"]["peak_flops"]
