"""Training of the port: loss module, optimizer, schedule, trainer,
recorder (the counterpart of nerf_replication_tpu/train/)."""

from .optimizer import make_optimizer
from .recorder import make_recorder
from .scheduler import make_lr_schedule
from .trainers import img_fit as _img_fit  # noqa: F401 (registry)
from .trainers import nerf as _nerf  # noqa: F401 (registry side effect)
from .trainers.trainer import Trainer, make_trainer

__all__ = ["Trainer", "make_lr_schedule", "make_optimizer", "make_recorder",
           "make_trainer"]
