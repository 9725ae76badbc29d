"""Data parallelism over ``torch.distributed``: one process a device.

The counterpart of nerf_replication_tpu/parallel/mesh.py. The JAX package
builds a one-axis ``Mesh`` over the devices of one controller, replicates
the parameters, shards each ray batch on its leading axis and lets XLA
insert the psum of the global mean gradient. Here a process group takes the
place of the mesh: rank r is one process on one device (``cuda:LOCAL_RANK``,
or the CPU), launched the usual way::

    torchrun --standalone --nproc_per_node=N \\
        -m nerf_replication_tpu_torch.train --cfg_file configs/nerf/hard.yaml

with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
``MASTER_PORT`` from the environment. The backend is ``nccl`` when every
rank of a host has a card of its own, ``gloo`` when ranks share a card or
run on the CPU (NCCL refuses two ranks on one device); a caller may name
it. It never changes after a failure.

The semantics are the JAX package's, where a data-parallel step is the
one-device step up to the order of the gradient sum:

* every rank holds the same generator state and makes each random draw at
  the global batch's shape, keeping its own rows (:class:`RowGenerator`),
  so N ranks draw what one process draws (JAX's threefry draws do not
  depend on the sharding either);
* the gradient is the global batch's mean: after ``backward`` the
  gradients go through one ``all_reduce`` of a flat buffer and are divided
  by the group's size (:func:`all_reduce_mean_grads`); the loss stats ride
  in the same buffer;
* eval and frame work is split by whole ray chunks, rank r taking chunks
  r, r + N, ... (:func:`chunk_rows`), and gathered back
  (:func:`gather_rows`) as an ``all_reduce`` sum into a zero-filled
  buffer: exact, since each element has one non-zero contributor, and it
  works on every backend (gloo's ``all_gather`` may refuse CUDA tensors).
  The JAX package splits each chunk by rows instead; on the card that
  changes a ray's arithmetic, since PyTorch's scans are not independent
  of the row count (``cumprod`` over (N, 64) transmittances: 11,589 of
  40,000 rows an ulp apart between N = 40,000 and two halves of 20,000 on
  the H100, which ``sample_pdf`` turns into moved fine samples, up to
  9.5e-4 on a dense 800x800 view). A whole chunk is the one-device
  render's own computation, so the sharded image is bit for bit the
  one-device image.

``torch.nn.parallel.DistributedDataParallel`` would not fit: the fused
training kernels run outside ``forward`` (``Renderer.train_apply``), so
its reducer would never be prepared.
"""

from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 600.0   # a collective that waits longer fails the run


def world_size() -> int:
    """The group's size: the initialised default group's, else the
    environment's ``WORLD_SIZE`` (1 when unset)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class RowGenerator:
    """A rank's share of a data-parallel batch's random stream. Every rank
    holds ``generator`` in the same state; each draw is made at the global
    batch's shape (``total`` rows) and the rank keeps its rows ``index`` (a
    slice, or a tensor of row numbers), so the generator moves on as one
    process's would and the kept values are that process's. The draw sites
    (``ops.ray_ops.draw``) take it in place of a ``torch.Generator``."""

    def __init__(self, generator: torch.Generator, index, total: int):
        self.generator = generator
        self.index = index
        self.total = int(total)

    @property
    def rows(self) -> int:
        if isinstance(self.index, slice):
            return len(range(*self.index.indices(self.total)))
        return int(self.index.numel())

    def draw(self, sample, shape: tuple) -> torch.Tensor:
        """``sample(shape, generator)`` for this rank's rows: drawn at
        (total, *shape[1:]); a scalar draw is the batch's, on every rank."""
        if not shape:
            return sample(shape, self.generator)
        if shape[0] != self.rows:
            raise ValueError(f"a draw of {shape[0]} rows from a rank that "
                             f"holds {self.rows} of {self.total}")
        return sample((self.total, *shape[1:]), self.generator)[self.index]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis: this process's ``rank`` of ``size``, its ``device``
    and the group's ``backend``."""

    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        """Rank 0, the one that prints, logs and writes files."""
        return self.rank == 0

    def sum_(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` summed over the ranks, in place."""
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        return flat

    def mean_(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` averaged over the ranks, in place: the sum, divided by
        the group's size."""
        return self.sum_(flat).div_(self.size)

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=0)
        return t

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading axis of ``n`` (a multiple of the
        group's size)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} ranks")
        part = n // self.size
        return slice(self.rank * part, (self.rank + 1) * part)

    def row_generator(self, generator: torch.Generator | None,
                      n: int) -> RowGenerator | None:
        """``generator`` for this rank's rows (:meth:`rows`) of an
        ``n``-row global batch."""
        if generator is None:
            return None
        return RowGenerator(generator, self.rows(n), n)


def _device_and_backend(kind: str, local_rank: int, local_size: int,
                        backend: str | None) -> tuple[torch.device, str]:
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank needs a card; none is found "
                               "(pass `device cpu` for a CPU group)")
        count = torch.cuda.device_count()
        backend = backend or ("nccl" if count >= local_size else "gloo")
        if backend == "nccl" and local_rank >= count:
            raise RuntimeError(
                f"local rank {local_rank} has no card of its own ({count} "
                "found): NCCL refuses two ranks on one device; use gloo")
        return torch.device("cuda", local_rank % count), backend
    if kind != "cpu":
        raise ValueError(f"unknown device {kind!r}")
    if backend not in (None, "gloo"):
        raise ValueError(f"a CPU group runs over gloo, not {backend}")
    return torch.device("cpu"), "gloo"


def make_mesh(cfg=None, n_devices: int | None = None,
              backend: str | None = None, device: str | None = None,
              timeout_s: float = TIMEOUT_S) -> Mesh:
    """The data mesh of this process, initialising the default process
    group from the environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) unless it is
    initialised already. ``cfg.mesh.data`` (or ``n_devices``) -1 takes the
    whole group; any other value must equal its size (a rank cannot take a
    subset of the devices, as a JAX mesh can). The device kind is
    ``device``, else ``cfg.device``, else ``cuda``; ``backend`` (default:
    ``nccl`` when each rank of the host has a card of its own, else
    ``gloo``). The rank's card becomes the current device. Rank 0 prints
    the group's size, backend and device when it initialises the group."""
    env = os.environ
    if dist.is_initialized():
        size, r = dist.get_world_size(), dist.get_rank()
        backend = backend or dist.get_backend()
    else:
        size, r = int(env.get("WORLD_SIZE", "1")), int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", r))
    local_size = int(env.get("LOCAL_WORLD_SIZE", size))
    kind = device or (cfg.get("device", "cuda") if cfg is not None
                      else "cuda")
    dev, backend = _device_and_backend(torch.device(kind).type, local_rank,
                                       local_size, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs over "
                               f"{dist.get_backend()}, not {backend}")
    else:
        dist.init_process_group(backend, init_method="env://",
                                world_size=size, rank=r,
                                timeout=timedelta(seconds=timeout_s))
        if r == 0:
            print(f"data-parallel mesh: {size} ranks over {backend}, rank "
                  f"0 on {dev}")
    want = n_devices
    if want is None and cfg is not None:
        want = int(cfg.get("mesh", {}).get("data", -1))
    if want is not None and want > 0 and want != size:
        raise ValueError(f"mesh.data {want} must be -1 or the process "
                         f"group's size {size}")
    return Mesh(rank=r, size=size, device=dev, backend=backend)


def default_mesh(cfg=None, device: str | None = None) -> Mesh | None:
    """The mesh (on ``device``'s kind) of an initialised group of more than
    one rank, else None (the JAX package's ``mesh="auto"``)."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return make_mesh(cfg, device=device)
    return None


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """Rank ``mesh.rank``'s rows of every leaf's leading axis (a global
    batch of equal leading sizes, each a multiple of the group's size)."""
    return {k: v[mesh.rows(v.shape[0])] for k, v in batch.items()}


def _ray_axis(batch: dict, size: int):
    """``(lead, axis)``: the leading shape of the batch's rays (``rays_o``,
    else ``uv``, without its last, coordinate axis) and the first of its
    axes divisible by ``size``, or None."""
    for key in ("rays_o", "uv"):
        if key in batch:
            lead = tuple(np.shape(batch[key])[:-1])
            for d, n in enumerate(lead):
                if n > 0 and n % size == 0:
                    return lead, d
            return lead, None
    return (), None


def shard_host_batch(batch: dict, mesh: Mesh) -> dict:
    """Rank ``mesh.rank``'s share of a host-loader batch (numpy): the
    batch's ray axis is the first axis of its rays' leading shape
    (``rays_o`` or ``uv``, e.g. (B=1, N_rays)) that divides by the group's
    size, and every array whose shape starts with that leading shape is
    split on it; other leaves, every leaf when no axis divides, and strings
    and objects stay whole (replicated). The JAX package picks the axis
    leaf by leaf (:47-68), which can split a coordinate axis that XLA then
    keeps right; a split tensor here is computed on, so one axis is taken
    for the batch."""
    lead, axis = _ray_axis(batch, mesh.size)

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        a = np.asarray(x)
        if (axis is None or a.dtype.kind in "OUS"
                or a.shape[:len(lead)] != lead):
            return x
        idx = [slice(None)] * a.ndim
        idx[axis] = mesh.rows(a.shape[axis])
        return a[tuple(idx)]

    return place(batch)


def host_batch_rows(batch: dict, mesh: Mesh):
    """``(index, total)`` of :func:`shard_host_batch`'s split in the rays'
    flattened order: this rank's row numbers (a slice where they are
    contiguous) of ``total`` rays; ``(None, total)`` where the batch stays
    whole."""
    lead, axis = _ray_axis(batch, mesh.size)
    total = int(np.prod(lead))
    if axis is None:
        return None, total
    rows = np.arange(total).reshape(lead)
    idx = [slice(None)] * len(lead)
    idx[axis] = mesh.rows(lead[axis])
    mine = rows[tuple(idx)].ravel()
    if np.array_equal(mine, np.arange(mine[0], mine[0] + mine.size)):
        return slice(int(mine[0]), int(mine[0]) + mine.size), total
    return torch.from_numpy(mine), total


def replicate_tree(tree, mesh: Mesh):
    """Rank 0's values on every rank: each tensor of a module's state (its
    parameters and buffers), or of a list of tensors, broadcast in place.
    Returns ``tree``."""
    tensors = (list(tree.state_dict().values())
               if isinstance(tree, torch.nn.Module) else list(tree))
    with torch.no_grad():
        for t in tensors:
            mesh.broadcast_(t)
    return tree


def all_reduce_mean_grads(params, mesh: Mesh,
                          extra: torch.Tensor | None = None):
    """Every parameter's gradient replaced by its mean over the ranks (the
    global batch's gradient, each rank's being its equal share's mean), in
    one ``all_reduce`` of a flat float32 buffer; ``extra`` (the loss
    stats) rides in the same buffer and its mean is returned. Parameters
    without a gradient are left so (the same ones on every rank)."""
    grads = [p.grad for p in params if p.grad is not None]
    parts = [g.reshape(-1) for g in grads]
    if extra is not None:
        parts.append(extra.detach().reshape(-1))
    if any(p.dtype != torch.float32 for p in parts):
        raise TypeError("the gradient all-reduce takes float32 tensors")
    flat = mesh.mean_(torch.cat(parts))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return None if extra is None else flat[offset:].view_as(extra)


def chunk_rows(x: torch.Tensor, mesh: Mesh, chunk: int) -> torch.Tensor:
    """This rank's chunks of ``x`` (n, ...), n a multiple of ``chunk``:
    chunks ``rank``, ``rank + size``, ... of ``chunk`` rows each,
    concatenated (none where there are fewer chunks than ranks)."""
    n = x.shape[0]
    if n % chunk:
        raise ValueError(f"{n} rows are not whole chunks of {chunk}")
    mine = x.reshape(n // chunk, chunk, *x.shape[1:])[mesh.rank::mesh.size]
    return mine.reshape(mine.shape[0] * chunk, *x.shape[1:])


_GATHER_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.bool)


def gather_rows(parts: tuple, mesh: Mesh, chunk: int, n: int) -> tuple:
    """The inverse of :func:`chunk_rows` for a tuple of tensors: the whole
    (n, ...) tensors on every rank. Each rank's chunks go into a
    zero-filled float32 buffer of the whole, which one ``all_reduce``
    sums: exact (each element has one non-zero contributor) on any
    backend; floats and bools only, cast back after the sum."""
    for p in parts:
        if p.dtype not in _GATHER_DTYPES:
            raise TypeError(f"gather_rows takes float or bool tensors, not "
                            f"{p.dtype}")
    widths = [math.prod(p.shape[1:]) for p in parts]
    local = torch.cat([p.reshape(p.shape[0], w).float()
                       for p, w in zip(parts, widths)], dim=1)
    buf = local.new_zeros(n // chunk, chunk, local.shape[1])
    buf[mesh.rank::mesh.size] = local.reshape(local.shape[0] // chunk, chunk,
                                              local.shape[1])
    whole = mesh.sum_(buf).reshape(n, -1)
    outs, at = [], 0
    for p, w in zip(parts, widths):
        outs.append(whole[:, at:at + w].reshape(n, *p.shape[1:]).to(p.dtype))
        at += w
    return tuple(outs)


def _concat(outs: list):
    """``(keys, parts)``: per-chunk outputs (tuples, or dicts of ``keys``)
    concatenated output by output; ``(None, None)`` for no chunk."""
    if not outs:
        return None, None
    keys = list(outs[0]) if isinstance(outs[0], dict) else None
    cols = ([[o[k] for o in outs] for k in keys] if keys is not None
            else zip(*outs))
    return keys, tuple(torch.cat(c) for c in cols)


def make_dp_eval_render(render_chunk_fn, mesh: Mesh | None, chunk: int):
    """``run(*xs)``: ``render_chunk_fn`` (``(*x_rows) -> tuple or dict`` of
    per-row tensors) over (n, ...) inputs, n a multiple of ``chunk``, one
    whole chunk at a time, its outputs concatenated. Without a mesh this
    process renders every chunk (the JAX package's ``lax.map``); with one
    the chunks are dealt out over the ranks (:func:`chunk_rows`) and the
    outputs gathered on every rank (:func:`gather_rows`), one gather a
    call. Each chunk is computed as one device computes it. When there are
    fewer chunks than ranks, rank 0 (which always holds chunk 0) broadcasts
    the outputs' keys, shapes and dtypes, and a rank without a chunk
    contributes empty outputs of those."""

    def run(*xs):
        n = xs[0].shape[0]
        mine = xs if mesh is None else [chunk_rows(x, mesh, chunk)
                                        for x in xs]
        keys, parts = _concat([render_chunk_fn(*(x[i:i + chunk]
                                                 for x in mine))
                               for i in range(0, mine[0].shape[0], chunk)])
        if mesh is None:
            whole = parts
        else:
            if n // chunk < mesh.size:    # some rank holds no chunk
                head = [(keys, [(p.shape[1:], p.dtype) for p in parts])
                        if mesh.is_main else None]
                dist.broadcast_object_list(head, src=0)
                if parts is None:
                    keys, specs = head[0]
                    parts = tuple(xs[0].new_empty((0, *shape), dtype=dtype)
                                  for shape, dtype in specs)
            whole = gather_rows(parts, mesh, chunk, n)
        return dict(zip(keys, whole)) if keys is not None else whole

    return run


def make_dp_train_step(trainer, mesh: Mesh):
    """``step(batch, generator) -> stats`` over a global batch (every
    leaf's leading axis the rays): this rank's rows (:func:`shard_batch`),
    the global batch's draws (:class:`RowGenerator`) and the mean gradient
    (``trainer``'s step all-reduces; its mesh must be ``mesh``)."""
    if trainer.mesh is not mesh:
        raise ValueError("make_dp_train_step needs a Trainer built with "
                         "this mesh")

    def step(batch: dict, generator: torch.Generator | None = None):
        n = next(iter(batch.values())).shape[0]
        return trainer.train_step(shard_batch(batch, mesh),
                                  mesh.row_generator(generator, n))

    return step


def make_dp_epoch_runner(trainer, pipeline, mesh: Mesh, n_steps: int):
    """``run_epoch(epoch, recorder=None) -> summary``: ``n_steps``
    data-parallel steps of ``trainer`` (built with ``mesh``), each
    sampling the global batch from ``pipeline`` and keeping this rank's
    rays (``Trainer.train_device``)."""
    if trainer.mesh is not mesh:
        raise ValueError("make_dp_epoch_runner needs a Trainer built with "
                         "this mesh")

    def run_epoch(epoch: int, recorder=None) -> dict:
        return trainer.train_device(epoch, pipeline, recorder,
                                    n_steps=n_steps)

    return run_epoch
