"""Shared machinery of the benchmark: specs by name, inputs made from the
seed, the yardstick (peaks, bounds, model FLOPs), the profiler pass and
the result line."""
