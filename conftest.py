"""Settings of every test process: the torch thread budget of an xdist
worker.

A pytest-xdist worker (``PYTEST_XDIST_WORKER_COUNT`` set) takes its share
of the machine's cores for torch's intra-op threads, in this process and,
through ``OMP_NUM_THREADS``, in the processes its tests start. Any other
process keeps torch's default.
"""

import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    # workers that each run torch on every core fight over the CPU
    _threads = max(1, (os.cpu_count() or 1) // int(_workers))
    os.environ.setdefault("OMP_NUM_THREADS", str(_threads))

    import torch

    torch.set_num_threads(_threads)
