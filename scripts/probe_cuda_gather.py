#!/usr/bin/env python3
"""Gather and scatter probes of the PyTorch/CUDA port on one GPU.

    python3 scripts/probe_cuda_gather.py

The counterpart of scripts/probe_pallas_gather.py, which asked the TPU how
to fetch brick rows (``dyn``, ``dyn3``, ``dma``) and how fast a lane gather
is (``lane``) before the brick hash-grid kernels were designed. The same
question put to an NVIDIA GPU, at the same sizes (a 4096 x 256 f32 table,
131,072 random rows), by the four kernels of
nerf_replication_tpu_torch/csrc/probe_gather.cu:

(a) ``row_gather``: a whole 1 KB row a point, a warp a row, 16-byte loads;
(b) ``elem_gather``: 8 four-byte elements of a point's row, the access of
    the encode kernels' trilinear corners;
(c) ``lane_gather``: a 128-lane gather within a row held in shared memory,
    the counterpart of ``take_along_axis`` on (131072, 128);
(d) ``atomic_add``: ``atomicAdd`` of 131,072 x 8 values into the table, the
    access of the table-gradient kernel, with the rows drawn from all 4096
    (about one add an address) and from 64 (about 64 adds an address).

Each is held against PyTorch indexing on the same inputs: (a)-(c) bit for
bit, (d) against ``index_add_`` summed in float64, every address within
``adds x 2^-24 x sum |values|`` of it (the first-order bound of an f32 sum
in any order). Each is timed with CUDA events beside that PyTorch call and
its byte bound. CUDA tensors launch the kernels and CPU tensors take the
PyTorch call, so the script's logic runs on a CPU at a small size;
``main`` itself needs a GPU and exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import functools
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from nerf_replication_tpu_torch.ops import _build  # noqa: E402
from nerf_replication_tpu_torch.utils import tracing  # noqa: E402

R = 4096           # table rows
W = 256            # lanes per row
NPTS = 1 << 17     # points
PAIRS = 8          # elements a point in (b) and (d)
LANES = 128        # width of the lane gather
HOT_ROWS = 64      # rows of the contended atomic probe
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM device memory


@functools.cache
def _kernel():
    lib = _build.load("probe_gather")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_row_gather.argtypes = [ptr, ptr, ptr, i32, ptr]
    lib.probe_lane_gather.argtypes = [ptr, ptr, ptr, i32, ptr]
    lib.probe_elem_gather.argtypes = [ptr, ptr, ptr, ptr, i32, ptr]
    lib.probe_atomic_add.argtypes = [ptr, ptr, ptr, ptr, i32, ptr]
    for fn in (lib.probe_row_gather, lib.probe_lane_gather,
               lib.probe_elem_gather, lib.probe_atomic_add):
        fn.restype = i32
    return lib


def _check(*tensors_and_types):
    """Every (tensor, dtype) is contiguous, of that dtype, on one CUDA
    device."""
    device = tensors_and_types[0][0].device
    for t, dtype in tensors_and_types:
        if t.dtype != dtype or not t.is_contiguous() or t.device != device \
                or device.type != "cuda":
            raise ValueError(f"probe kernels take contiguous {dtype} tensors "
                             f"on one CUDA device")


def _launch(wrapper, name: str, n: int, *tensors):
    lib = _kernel()
    device = tensors[0].device
    with torch.cuda.device(device):
        err = getattr(lib, name)(*[t.data_ptr() for t in tensors], n,
                                 torch.cuda.current_stream(device).cuda_stream)
    _build.check_launch(lib, err, name)
    tracing.counts[f"{wrapper.__name__}.launches"] += 1


def row_gather(table, idx):
    """table (R, 256) f32, idx (N,) int32 -> table[idx] (N, 256)."""
    if table.device.type == "cpu":
        return table[idx.long()]
    _check((table, torch.float32), (idx, torch.int32))
    if table.shape[1] != W:
        raise ValueError(f"row_gather: rows of {W} lanes")
    out = torch.empty((idx.shape[0], W), dtype=torch.float32,
                      device=table.device)
    _launch(row_gather, "probe_row_gather", idx.shape[0], table, idx, out)
    return out


def elem_gather(table, idx, lanes):
    """out[i, k] = table[idx[i], lanes[i, k]]; lanes (N, 8) int32."""
    if table.device.type == "cpu":
        return table[idx.long()[:, None], lanes.long()]
    _check((table, torch.float32), (idx, torch.int32), (lanes, torch.int32))
    if table.shape[1] != W or tuple(lanes.shape) != (idx.shape[0], PAIRS):
        raise ValueError(f"elem_gather: rows of {W} lanes, {PAIRS} lanes a "
                         "point")
    out = torch.empty(lanes.shape, dtype=torch.float32, device=table.device)
    _launch(elem_gather, "probe_elem_gather", idx.shape[0], table, idx,
            lanes, out)
    return out


def lane_gather(x, gidx):
    """out[i, j] = x[i, gidx[i, j]]; x (N, 128) f32, gidx (N, 128) int32."""
    if x.device.type == "cpu":
        return torch.gather(x, 1, gidx.long())
    _check((x, torch.float32), (gidx, torch.int32))
    if x.shape[1] != LANES or gidx.shape != x.shape:
        raise ValueError(f"lane_gather: ({LANES},)-wide rows")
    out = torch.empty_like(x)
    _launch(lane_gather, "probe_lane_gather", x.shape[0], x, gidx, out)
    return out


def atomic_add(table, idx, lanes, val):
    """table[idx[i], lanes[i, k]] += val[i, k], in place; returns table."""
    if table.device.type == "cpu":
        flat = (idx.long()[:, None] * W + lanes.long()).reshape(-1)
        table.view(-1).index_add_(0, flat, val.reshape(-1))
        return table
    _check((table, torch.float32), (idx, torch.int32), (lanes, torch.int32),
           (val, torch.float32))
    if table.shape[1] != W or tuple(lanes.shape) != (idx.shape[0], PAIRS) \
            or val.shape != lanes.shape:
        raise ValueError(f"atomic_add: rows of {W} lanes, {PAIRS} values a "
                         "point")
    _launch(atomic_add, "probe_atomic_add", idx.shape[0], table, idx, lanes,
            val)
    return table


PROBES = (row_gather, elem_gather, lane_gather, atomic_add)


def _ms(fn, device, reps: int) -> float:
    """Milliseconds a call: CUDA events on a card, 0.0 on the CPU (a CPU
    time is no device metric)."""
    if device.type != "cuda":
        fn()
        return 0.0
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run(device="cuda", n: int = NPTS, rows: int = R, reps: int = 20,
        seed: int = 0) -> list[dict]:
    """Run every probe on ``device``: one reading each (two for the atomic
    probe), with ``ok``, ``max_abs_err``, ``ms``, ``library_ms`` (the
    PyTorch call on the same inputs) and ``bound_ms`` (its bytes over the
    card's memory rate). Inputs come from ``seed``."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, generator=g)
    table = torch.randn(rows, W, **kw)
    idx = torch.randint(0, rows, (n,), dtype=torch.int32, **kw)
    lanes = torch.randint(0, W, (n, PAIRS), dtype=torch.int32, **kw)
    x = torch.randn(n, LANES, **kw)
    gidx = torch.randint(0, LANES, (n, LANES), dtype=torch.int32, **kw)
    val = torch.randn(n, PAIRS, **kw)
    idx64, lanes64, gidx64 = idx.long(), lanes.long(), gidx.long()
    readings = []

    def reading(name, replaces, ok, err, kernel, library, n_bytes, note=""):
        r = dict(name=name, replaces=replaces, ok=bool(ok),
                 max_abs_err=float(err), ms=_ms(kernel, device, reps),
                 library_ms=_ms(library, device, reps),
                 bound_ms=n_bytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")
        readings.append(r)
        print(f"probe {name}{note}: {'ok' if r['ok'] else 'FAIL'}, "
              f"max_abs_err {r['max_abs_err']:.3e}, kernel {r['ms']:.4f} ms "
              f"({r['ms'] * 1e6 / n:.2f} ns a point), PyTorch "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"bytes", flush=True)

    out, ref = row_gather(table, idx), table[idx64]
    reading("probe_row_gather", "scripts/probe_pallas_gather.py:58",
            torch.equal(out, ref), (out - ref).abs().max(),
            lambda: row_gather(table, idx), lambda: table[idx64],
            _nbytes(table, idx, out))
    out, ref = elem_gather(table, idx, lanes), table[idx64[:, None], lanes64]
    reading("probe_elem_gather", "scripts/probe_pallas_gather.py:82",
            torch.equal(out, ref), (out - ref).abs().max(),
            lambda: elem_gather(table, idx, lanes),
            lambda: table[idx64[:, None], lanes64],
            _nbytes(table, idx, lanes, out))
    out, ref = lane_gather(x, gidx), torch.gather(x, 1, gidx64)
    reading("probe_lane_gather", "scripts/probe_pallas_gather.py:144",
            torch.equal(out, ref), (out - ref).abs().max(),
            lambda: lane_gather(x, gidx), lambda: torch.gather(x, 1, gidx64),
            _nbytes(x, gidx, out))
    for hot in (rows, min(HOT_ROWS, rows)):
        idx_h = idx % hot
        flat = (idx_h.long()[:, None] * W + lanes64).reshape(-1)
        acc = atomic_add(torch.zeros_like(table), idx_h, lanes, val)
        zeros64 = torch.zeros(rows * W, dtype=torch.float64, device=device)
        ref = zeros64.clone().index_add_(0, flat, val.reshape(-1).double())
        mass = zeros64.clone().index_add_(0, flat,
                                          val.reshape(-1).abs().double())
        adds = zeros64.clone().index_add_(0, flat, torch.ones_like(
            flat, dtype=torch.float64))
        err = (acc.view(-1).double() - ref).abs()
        scratch, scratch_lib = torch.zeros_like(table), torch.zeros_like(table)
        touched = int((adds > 0).sum())
        reading("probe_atomic_add", "scripts/probe_pallas_gather.py:124",
                bool((err <= adds * 2.0 ** -24 * mass + 1e-30).all()),
                err.max(), lambda: atomic_add(scratch, idx_h, lanes, val),
                lambda: scratch_lib.view(-1).index_add_(0, flat,
                                                        val.reshape(-1)),
                _nbytes(idx_h, lanes, val) + 2 * 4 * touched,
                note=f", rows drawn from {hot} (up to {int(adds.max())} adds "
                     f"an address)")
    return readings


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_cuda_gather: needs a CUDA GPU", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}; table {R} x {W} f32, "
          f"{NPTS} points")
    return 0 if all(r["ok"] for r in run()) else 1


if __name__ == "__main__":
    sys.exit(main())
