"""Trainer: the host-loader and device-resident training loops and
validation.

The counterpart of nerf_replication_tpu/train/trainers/trainer.py. Its
``train_device`` (:144-216) runs an epoch of ``ep_iter`` fused
sample -> render -> loss -> grad -> update steps as compiled ``lax.scan``
chunks; here :meth:`Trainer.train_device` is a Python loop of the same
steps on the device (sample from the GPU-resident split, render, loss,
``backward``, clip 40, optimizer step), with no host synchronisation
inside the epoch. :meth:`Trainer.train` (JAX :95-142) is the host-loader
loop: each batch of a ``make_data_loader`` goes to the device
(:func:`host_batch_to_device`) and through the same step, with the
per-iteration data and batch times, and every ``log_interval`` iterations
and on the last a synchronised log line (ETA, smoothed stats, lr,
memory). The epoch's generator is seeded from ``seed`` and the epoch (the
JAX ``fold_in``), so a resumed run draws what an unbroken one draws.
``val`` drives the evaluator through the wrapper's ``render_eval`` where
it has one (img_fit), else through the eval renderer, with the fused
kernel's weights packed from the current parameters.

Under a torch profiler each loop iteration is a ``train.step`` span
(``utils.tracing``, its id the global step) holding ``train.sample``,
``train.forward``, ``train.backward``, ``train.allreduce`` (with a mesh)
and ``train.optimizer``; ``train_device``'s end of epoch is
``train.epoch_end``.

With a ``mesh`` (``parallel.mesh.Mesh``, JAX :57-66, :101-121, :155-161)
the Trainer is one rank of a data-parallel group: the parameters are
broadcast from rank 0 before the first step, each rank draws its rows of
the global batch (the device sampler's, or its share of each host batch:
``shard_host_batch``, or with ``cfg.distributed`` its own items of the
rank-sharded sampler), and after ``backward`` the gradients and the loss
stats are averaged over the ranks before the optimizer's clip, so the logged
loss and PSNR are the global batch's. Only rank 0 prints and evaluates;
``val`` renders on every rank (the renderer deals its chunks out).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...config import as_bool
from ...parallel.mesh import (
    RowGenerator,
    all_reduce_mean_grads,
    host_batch_rows,
    replicate_tree,
    shard_host_batch,
)
from ...registry import resolve
from ...utils import tracing
from ..optimizer import make_optimizer
from ..scheduler import make_lr_schedule
from .nerf import psnr_from_mse


def host_batch_to_device(batch, device: torch.device):
    """numpy (nested dicts, lists, tuples) -> tensors on ``device``;
    ``meta`` stays on the host. A CUDA copy goes from pinned memory without
    blocking: a copy from pageable memory can wait for the stream."""
    if isinstance(batch, dict):
        return {k: (v if k == "meta" else host_batch_to_device(v, device))
                for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(host_batch_to_device(v, device) for v in batch)
    t = torch.as_tensor(np.asarray(batch))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _rows(batch: dict) -> int:
    """Rays (or pixels) in a host batch: the rows of its first (..., k)
    array among rays_o, uv."""
    for key in ("rays_o", "uv"):
        if key in batch:
            return int(np.prod(np.shape(batch[key])[:-1]))
    return 0


def epoch_seed(seed: int, epoch: int) -> int:
    """The generator seed of ``epoch``: a function of (seed, epoch) only."""
    return int(np.random.SeedSequence([int(seed), int(epoch)])
               .generate_state(1, np.uint64)[0] >> 1)


def _device_mem_mb(device: torch.device) -> float:
    if device.type != "cuda":
        return 0.0
    return torch.cuda.memory_allocated(device) / 2 ** 20


class Trainer:
    def __init__(self, wrapper, cfg, mesh=None):
        self.wrapper = wrapper
        self.cfg = cfg
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self._replicated = mesh is None
        self.network = wrapper.net
        self.lr_schedule = make_lr_schedule(cfg)
        self.optimizer = make_optimizer(cfg, self.network.parameters(),
                                        self.lr_schedule)
        self.ep_iter = int(cfg.get("ep_iter", -1))
        self.log_interval = int(cfg.get("log_interval", 20))
        self.max_epoch = int(cfg.train.epoch)
        self.seed = int(cfg.get("seed", 0))
        self.summaries: list[dict] = []   # one per training epoch
        self.evals: list[dict] = []       # one per val

    @property
    def device(self) -> torch.device:
        return next(self.network.parameters()).device

    @property
    def step(self) -> int:
        """Global step: the number of optimizer updates so far."""
        return self.optimizer.count

    def _replicate(self):
        """Rank 0's parameters on every rank, once, before the first step
        (after any resume or pretrain load)."""
        if not self._replicated:
            replicate_tree(self.network, self.mesh)
            self._replicated = True

    def train_step(self, batch: dict, generator) -> dict:
        """One update; returns the step's loss stats as device tensors. On
        a rank, ``batch`` is its rows and ``generator`` its
        ``RowGenerator``; the gradients and stats are averaged over the
        ranks before the clip (the PSNR from the averaged MSE)."""
        self._replicate()
        with tracing.span("train.forward"):
            loss, (_, stats, _) = self.wrapper.loss_fn(batch, generator,
                                                       train=True)
        self.optimizer.zero_grad()
        with tracing.span("train.backward"):
            loss.backward()
        if self.mesh is not None:
            with tracing.span("train.allreduce"):
                keys = [k for k in stats if k != "psnr"]
                mean = all_reduce_mean_grads(
                    self.optimizer.params, self.mesh,
                    torch.stack([stats[k] for k in keys]))
                stats = dict(zip(keys, mean.unbind()))
                if "color_mse" in stats:
                    stats["psnr"] = psnr_from_mse(stats["color_mse"])
        with tracing.span("train.optimizer"):
            self.optimizer.step()
        return stats

    def _host_batch(self, batch: dict, generator: torch.Generator):
        """A host batch on a rank: ``(its share, its generator, the global
        batch's rays)``; without a mesh the batch as it is."""
        rows = _rows(batch)
        if self.mesh is None:
            return batch, generator, rows
        if as_bool(self.cfg.get("distributed", False), "distributed"):
            # the rank's own items: its rays are the rank-th share of the
            # global batch
            n, size = rows, self.mesh.size
            index = slice(self.mesh.rank * n, (self.mesh.rank + 1) * n)
            return batch, RowGenerator(generator, index, n * size), n * size
        index, total = host_batch_rows(batch, self.mesh)
        if index is not None:
            generator = RowGenerator(generator, index, total)
        return shard_host_batch(batch, self.mesh), generator, rows

    def train(self, epoch: int, loader, recorder) -> dict:
        """One epoch over a host loader. Synchronises with the card only
        on the iterations that log (every ``log_interval`` and the last),
        where the stats of the steps since the last log go to the
        recorder. Returns the epoch's summary as :meth:`train_device`'s,
        plus per-step ``data_time`` and ``batch_time`` (host seconds: a
        step's batch time is its enqueue time unless it logs) and the rays
        (pixels) a step."""
        device = self.device
        gen = torch.Generator(device=device).manual_seed(
            epoch_seed(self.seed, epoch))
        self._replicate()
        self.network.train()
        recorder.epoch = epoch
        max_iter = len(loader)
        stats, pending, rows = [], [], 0
        data_times, batch_times = [], []
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = end = time.perf_counter()
        for iteration, batch in enumerate(loader):
            data_time = time.perf_counter() - end
            with tracing.span("train.step", root=self.step):
                with tracing.span("train.sample"):
                    batch, step_gen, rows = self._host_batch(batch, gen)
                    batch = host_batch_to_device(batch, device)
                s = self.train_step(batch, step_gen)
                pending.append(torch.stack([s["loss"], s["color_mse"],
                                            s["psnr"]]))
            log = ((iteration + 1) % self.log_interval == 0
                   or iteration == max_iter - 1)
            if log:   # the epoch's only synchronisations
                done = torch.stack(pending).cpu().numpy()
                stats.append(done)
                pending = []
            batch_time = time.perf_counter() - end
            end = time.perf_counter()
            recorder.step += 1
            recorder.batch_time.update(batch_time)
            recorder.data_time.update(data_time)
            data_times.append(data_time)
            batch_times.append(batch_time)
            if log:
                for loss, mse, psnr in done:
                    recorder.update_loss_stats(
                        {"loss": loss, "color_mse": mse, "psnr": psnr})
                eta = recorder.batch_time.global_avg * (
                    (self.max_epoch - epoch) * max_iter - iteration)
                if self.is_main:
                    print(f"eta: {int(eta)}s  {recorder}  lr: "
                          f"{self.optimizer.lr():.6f}  mem: "
                          f"{_device_mem_mb(device):.0f}MB")
                recorder.record("train")
        wall = time.perf_counter() - t0
        stats = np.concatenate(stats) if stats else np.zeros((0, 3))
        summary = {"epoch": epoch, "steps": max_iter, "wall": wall,
                   "rays_per_s": max_iter * rows / wall,
                   "loss": stats[:, 0], "psnr": stats[:, 2],
                   "lr": self.optimizer.lr(),
                   "peak_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else 0),
                   "data_time": np.asarray(data_times),
                   "batch_time": np.asarray(batch_times), "rows": rows}
        self.summaries.append(summary)
        return summary

    def train_device(self, epoch: int, pipeline, recorder=None,
                     n_steps: int | None = None) -> dict:
        """One epoch of ``n_steps`` steps (default ``ep_iter``, 500 if
        unset) drawn from ``pipeline``; on a rank, its rows of each global
        batch (``make_dp_epoch_runner``). Returns the epoch's summary:
        steps, wall seconds, rays/s (of the global batch), per-step loss
        and psnr (numpy), lr, peak device memory."""
        if n_steps is None:
            n_steps = self.ep_iter if self.ep_iter > 0 else 500
        device = self.device
        gen = torch.Generator(device=device).manual_seed(
            epoch_seed(self.seed, epoch))
        if self.mesh is not None:
            gen = self.mesh.row_generator(gen, pipeline.n_rays)
        self._replicate()
        self.network.train()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        stats = []
        for _ in range(n_steps):
            with tracing.span("train.step", root=self.step):
                with tracing.span("train.sample"):
                    batch = pipeline.sample(gen, self.step)
                s = self.train_step(batch, gen)
                stats.append(torch.stack([s["loss"], s["psnr"]]))
        with tracing.span("train.epoch_end", root=epoch):
            stats = torch.stack(stats).cpu().numpy()   # the epoch's one sync
            wall = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else 0)
            summary = {"epoch": epoch, "steps": n_steps, "wall": wall,
                       "rays_per_s": n_steps * pipeline.n_rays / wall,
                       "loss": stats[:, 0], "psnr": stats[:, 1],
                       "lr": self.optimizer.lr(), "peak_bytes": peak}
            self.summaries.append(summary)
            if recorder is not None:
                recorder.epoch = epoch
                recorder.step += n_steps
                for loss, psnr in stats:
                    recorder.update_loss_stats({"loss": loss, "psnr": psnr})
                recorder.record("train")
            if self.is_main:
                if recorder is not None and recorder.loss_stats:
                    ls = recorder.loss_stats
                    smoothed = (f"loss: {ls['loss'].median:.5f}  "
                                f"psnr: {ls['psnr'].median:.2f}")
                else:
                    loss, psnr = np.median(stats[-20:], axis=0)
                    smoothed = f"loss: {loss:.5f}  psnr: {psnr:.2f}"
                print(f"epoch {epoch}: {n_steps} steps in {wall:.2f}s "
                      f"({summary['rays_per_s']:,.0f} rays/s)  {smoothed}  "
                      f"lr: {summary['lr']:.6f}  mem: {peak / 2 ** 20:.0f}MB")
        return summary

    def val(self, epoch: int, loader, evaluator, recorder=None) -> dict:
        """Evaluate every batch of ``loader`` with the current weights and
        return the mean metrics. A wrapper with ``render_eval`` (img_fit)
        renders through it on the device, with the batch's MSE and PSNR
        beside the evaluator's (JAX :231-272); a NeRF renders through the
        eval renderer (the fused kernel per ``network.use_pallas_mlp``),
        sharded over the ranks of a group. Every rank renders; rank 0 alone
        evaluates, prints and records (the others return {})."""
        self.network.eval()
        if hasattr(self.wrapper, "render_eval"):
            result = self._val_render_eval(loader, evaluator)
        else:
            from ...run import build_renderer

            renderer = build_renderer(self.cfg, self.network)
            for batch in loader:
                rgb, _ = renderer.render(batch)
                if self.is_main:
                    evaluator.evaluate((rgb, None), batch)
            result = evaluator.summarize() if self.is_main else {}
        if not self.is_main:
            return result
        print("val:", {k: round(v, 4) for k, v in result.items()})
        self.evals.append(result)
        if recorder is not None:
            recorder.record("val", recorder.step, loss_stats=result)
        return result

    def _val_render_eval(self, loader, evaluator) -> dict:
        sums, n = {}, 0
        for batch in loader:
            out = self.wrapper.render_eval(
                host_batch_to_device(batch, self.device))
            if not self.is_main:
                continue
            pred = out["rgb"].detach().cpu().numpy().reshape(-1, 3)
            gt = np.asarray(batch.get("colors", batch.get("rgb")))
            mse = float(np.mean((pred - gt.reshape(-1, 3)) ** 2))
            for k, v in (("loss", mse), ("color_mse", mse),
                         ("psnr", -10.0 * np.log10(max(mse, 1e-10)))):
                sums[k] = sums.get(k, 0.0) + v
            evaluator.evaluate(out, batch)
            n += 1
        if not self.is_main:
            return {}
        result = {k: v / max(n, 1) for k, v in sums.items()}
        result.update(evaluator.summarize())
        return result


def make_trainer(cfg, network, mesh=None) -> Trainer:
    """Wrap ``network`` in the config's loss module, then the Trainer (one
    rank of ``mesh``'s group, or alone)."""
    wrapper = resolve("loss", cfg.loss_module)(cfg, network=network)
    return Trainer(wrapper, cfg, mesh)
