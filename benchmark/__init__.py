"""The benchmark of the PyTorch/CUDA port ``nerf_replication_tpu_torch``.

One run measures one cell of ``BENCHMARK.json``:

    python benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Everything a cell needs is found by name: ``workloads/<cell>.json``
(configuration, traffic kind and its parameters, limits of the
correctness check), ``configs/<config>.json`` (the port's config file and
checkpoint, the model's shapes, its precision and peak),
``traffic/<kind>.py`` (the driver of a traffic kind) and
``metrics/<metric>.py`` (a per-layer metric's reader). ``reference/`` is
the plain PyTorch reference that decides ``correct``; ``harness/`` the
shared machinery (inputs, timing, the profiler pass, the result line).
"""
