"""Device milliseconds a dense frame of every device operation that is
none of the port's hand kernels (``yardstick.HAND_KERNELS``): the
PyTorch ops of ``models.nerf.renderer`` (sampling, ``sample_pdf``,
sort, compositing)."""

from benchmark.harness.trace import torch_ops_ms as read  # noqa: F401

UNIT = "ms"
LAYER = "PyTorch ops"
MOVES = "dense_frame_ms"
