"""Trainer: the device-resident training loop and validation.

The counterpart of nerf_replication_tpu/train/trainers/trainer.py. Its
``train_device`` (:144-216) runs an epoch of ``ep_iter`` fused
sample -> render -> loss -> grad -> update steps as compiled ``lax.scan``
chunks; here :meth:`Trainer.train_device` is a Python loop of the same
steps on the device (sample from the GPU-resident split, render, loss,
``backward``, clip 40, optimizer step), with no host synchronisation
inside the epoch. The epoch's generator is seeded from ``seed`` and the
epoch (the JAX ``fold_in``), so a resumed run draws what an unbroken one
draws. ``val`` drives the evaluator through the eval renderer, with the
fused kernel's weights packed from the current parameters.

Not ported yet (ROADMAP.md A.6): the host-loader ``train`` loop.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...registry import resolve
from ..optimizer import make_optimizer
from ..scheduler import make_lr_schedule


def epoch_seed(seed: int, epoch: int) -> int:
    """The generator seed of ``epoch``: a function of (seed, epoch) only."""
    return int(np.random.SeedSequence([int(seed), int(epoch)])
               .generate_state(1, np.uint64)[0] >> 1)


class Trainer:
    def __init__(self, wrapper, cfg):
        self.wrapper = wrapper
        self.cfg = cfg
        self.network = wrapper.net
        self.lr_schedule = make_lr_schedule(cfg)
        self.optimizer = make_optimizer(cfg, self.network.parameters(),
                                        self.lr_schedule)
        self.ep_iter = int(cfg.get("ep_iter", -1))
        self.max_epoch = int(cfg.train.epoch)
        self.seed = int(cfg.get("seed", 0))
        self.summaries: list[dict] = []   # one per train_device epoch

    @property
    def device(self) -> torch.device:
        return next(self.network.parameters()).device

    @property
    def step(self) -> int:
        """Global step: the number of optimizer updates so far."""
        return self.optimizer.count

    def train_step(self, batch: dict, generator: torch.Generator) -> dict:
        """One update; returns the step's loss stats as device tensors."""
        loss, (_, stats, _) = self.wrapper.loss_fn(batch, generator,
                                                   train=True)
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        return stats

    def train_device(self, epoch: int, pipeline, recorder=None) -> dict:
        """One epoch of ``ep_iter`` steps (500 if unset) drawn from
        ``pipeline``. Returns the epoch's summary: steps, wall seconds,
        rays/s, per-step loss and psnr (numpy), lr, peak device memory."""
        n_steps = self.ep_iter if self.ep_iter > 0 else 500
        device = self.device
        gen = torch.Generator(device=device).manual_seed(
            epoch_seed(self.seed, epoch))
        self.network.train()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        stats = []
        for _ in range(n_steps):
            batch = pipeline.sample(gen, self.step)
            s = self.train_step(batch, gen)
            stats.append(torch.stack([s["loss"], s["psnr"]]))
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
            smoothed = (f"loss: {recorder.loss_stats['loss'].median:.5f}  "
                        f"psnr: {recorder.loss_stats['psnr'].median:.2f}")
        else:
            smoothed = (f"loss: {float(np.median(stats[-20:, 0])):.5f}  "
                        f"psnr: {float(np.median(stats[-20:, 1])):.2f}")
        print(f"epoch {epoch}: {n_steps} steps in {wall:.2f}s "
              f"({summary['rays_per_s']:,.0f} rays/s)  {smoothed}  "
              f"lr: {summary['lr']:.6f}  mem: {peak / 2 ** 20:.0f}MB")
        return summary

    def val(self, epoch: int, loader, evaluator, recorder=None) -> dict:
        """Render every view of ``loader`` with the current weights through
        the eval renderer (the fused kernel per ``network.use_pallas_mlp``)
        and return the evaluator's mean metrics."""
        from ...run import build_renderer

        self.network.eval()
        renderer = build_renderer(self.cfg, self.network)
        for batch in loader:
            rgb, _ = renderer.render(batch)
            evaluator.evaluate((rgb, None), batch)
        result = evaluator.summarize()
        print("val:", {k: round(v, 4) for k, v in result.items()})
        if recorder is not None:
            recorder.record("val", recorder.step, loss_stats=result)
        return result


def make_trainer(cfg, network) -> Trainer:
    """Wrap ``network`` in the config's loss module, then the Trainer."""
    wrapper = resolve("loss", cfg.loss_module)(cfg, network=network)
    return Trainer(wrapper, cfg)
