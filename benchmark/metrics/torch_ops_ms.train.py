"""Device milliseconds a training step of every device operation that is
none of the port's hand kernels (``yardstick.HAND_KERNELS``): the
PyTorch ops of ``models.nerf.renderer`` and ``train.optimizer``
(sampling, sort, compositing, loss, autograd, the clip and Adam)."""

from benchmark.harness.trace import torch_ops_ms as read  # noqa: F401

UNIT = "ms"
LAYER = "PyTorch ops"
MOVES = "train_rays_per_s"
