"""Hierarchical volume renderer, eval and train paths.

The counterpart of nerf_replication_tpu/models/nerf/renderer/
volume_renderer.py: stratified coarse samples -> coarse MLP -> weights ->
inverse-CDF importance samples -> sorted union -> fine MLP -> composite.
PyTorch runs it eagerly, one ray chunk at a time for eval and one ray
batch per training step.

Training (``render_rays(..., generator, train=True)``) jitters the coarse
samples (``perturb``), draws the importance samples at random ``u`` from
the coarse weights with their gradient stopped, and adds ``raw_noise_std``
noise to the densities, all from one ``torch.Generator``. Its MLP is
:attr:`Renderer.train_apply`: the differentiable fused kernels
(ops/mlp_train.py) with ``network.use_pallas_mlp_train`` True, the port's
default, else the ``nn.Module`` with autograd (the JAX package's XLA arm).
A brick hash-grid NGP network trains through the ``nn.Module`` itself,
whose encoder runs the brick-encode CUDA kernels, whatever that flag says:
the JAX package has no fused train MLP for that family either
(``make_fused_train_apply`` returns None there, ops/pallas/mlp_train.py).

Empty-space skipping and early ray termination, three forms:

* ``fast_sampling`` (the reference's ESS/ERT masks, :func:`_ess_ert_mask`):
  fine samples in empty coarse bins or behind the point where the coarse
  transmittance fell under ``ert_threshold`` get zero density. It acts on
  training batches; eval renders without the masks.
* :meth:`Renderer.render_image_fast` (eval with ``fast_sampling``): a
  coarse pass over every ray, then the full render of the rays whose
  coarse opacity is above 1e-3 only; one host read a frame.
* :meth:`Renderer.make_frame_renderer`: a whole frame from a camera pose
  with static ray budgets (occupancy-grid culling, top-k by coarse
  opacity) and no host read; with ``ert_segments`` > 1 its fine pass is
  :func:`fine_stage_ert`, which stops marching the rays whose
  transmittance is spent between segments.

On a rank of a data-parallel group (``parallel.mesh``) the eval ray chunks
are dealt out whole over the ranks (``Renderer``'s ``mesh``, by default the
group's when it has more than one rank) and gathered back on every rank,
and the compacted frame's chunks likewise, between selections that every
rank makes itself on the whole frame; each chunk is the one-device
render's, so the image is too. In training a rank's generator draws the
global batch's values and keeps its rays' (``ops.ray_ops.draw``).

Under a torch profiler the stages are ``utils.tracing`` spans:
``render.coarse`` (:func:`render_rays`), ``render.resample`` and
``render.fine`` (:func:`fine_stage`), inside ``render.frame``
(:meth:`Renderer.render`) or the trainer's ``train.forward``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ....config import as_bool
from ....ops import hashgrid_kernel, mlp_kernel, mlp_train
from ....ops.occupancy import box_scale, rays_active
from ....parallel.mesh import default_mesh, make_dp_eval_render
from ....ops.ray_ops import (
    composite,
    compute_weights,
    density_activation,
    sample_pdf,
    stratified_sample,
)
from ....utils import tracing
from . import ngp_renderer


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    N_samples: int = 64
    N_importance: int = 128
    near: float = 2.0
    far: float = 6.0
    white_bkgd: bool = True
    lindisp: bool = False
    perturb: bool = True           # jitter coarse samples in training
    raw_noise_std: float = 0.0     # density noise in training
    fast_sampling: bool = False    # ESS/ERT masks; compacted eval
    weights_threshold: float = 0.25   # ESS: a coarse bin below is empty
    ert_threshold: float = 0.45       # ERT: transmittance cut-off
    ess_verbose: bool = False      # ESS/ERT mask statistics as outputs
    ray_chunk: int = 8192          # rays per eval chunk
    density_activation: str = "relu"
    # the segmented fine pass of the frame renderer: > 1 splits the sorted
    # samples into that many segments and keeps, between segments, the
    # rays with the most transmittance left (fine_stage_ert); 1 is dense
    ert_segments: int = 1
    ert_eps: float = 1e-4          # transmittance a dropped ray may carry
    ert_frac: tuple = ()           # survivor fractions; () = the default
    ert_split: float = 2.0 / 3.0   # share of the samples in segment 0
    finite_tail: bool = False

    @classmethod
    def from_cfg(cls, cfg) -> "RenderSettings":
        """Read from ``cfg.task_arg`` with a top-level fallback, as the JAX
        package does; flags are parsed strictly, ``ert_frac`` is a list of
        numbers."""
        ta = cfg.get("task_arg", {})

        def get(k, d):
            return ta.get(k, cfg.get(k, d))

        frac = get("ert_frac", ())
        if not isinstance(frac, (list, tuple)):
            raise TypeError(f"config key 'ert_frac' must be a list of "
                            f"numbers, got {frac!r}")
        return cls(
            N_samples=int(get("N_samples", 64)),
            N_importance=int(get("N_importance", 128)),
            near=float(get("near", 2.0)),
            far=float(get("far", 6.0)),
            white_bkgd=as_bool(get("white_bkgd", True), "white_bkgd"),
            lindisp=as_bool(get("lindisp", False), "lindisp"),
            perturb=as_bool(get("perturb", True), "perturb"),
            raw_noise_std=float(get("raw_noise_std", 0.0)),
            fast_sampling=as_bool(get("fast_sampling", False),
                                  "fast_sampling"),
            weights_threshold=float(get("weights_threshold", 0.25)),
            ert_threshold=float(get("ert_threshold", 0.45)),
            ess_verbose=as_bool(get("ess_verbose", False), "ess_verbose"),
            ray_chunk=int(get("ray_chunk", 8192)),
            density_activation=str(get("density_activation", "relu")),
            ert_segments=int(get("ert_segments", 1)),
            ert_eps=float(get("ert_eps", 1e-4)),
            ert_frac=tuple(float(f) for f in frac),
            ert_split=float(get("ert_split", 2.0 / 3.0)),
            finite_tail=as_bool(get("finite_tail", False), "finite_tail"),
        )


def _ess_ert_mask(density, t_coarse, t_fine_idx_below,
                  s: RenderSettings) -> torch.Tensor:
    """Validity (N, N_importance) bool of the fine samples from the
    activated coarse densities (N, N_samples) and each fine sample's coarse
    bin below (``searchsorted(bins, t_fine, right) - 1``): the reference's
    empty-ray, object-ray, ESS empty-bin and ERT rules
    (fine_sample_points:112-192). The weights come from the densities as
    they are (relu of a non-negative value, the 1e10 tail), whatever the
    settings' activation and tail say, as in the JAX package."""
    empty_ray = density.sum(dim=-1) < 1e-3
    object_ray = density.amax(dim=-1) > 0.5

    weights, _, trans = compute_weights(density, t_coarse)
    w = weights[..., 1:-1]
    T = trans[..., 1:-1]
    empty_bins = w < s.weights_threshold                       # (N, S-2)

    # ERT: once the transmittance falls under the threshold, every later
    # bin is invalid (a cummax of the padded test, :161-171)
    ert_padded = torch.cat([torch.zeros_like(T[..., :1], dtype=torch.bool),
                            T < s.ert_threshold], dim=-1)
    ert_bins = torch.cummax(ert_padded.int(), dim=-1).values[..., 1:].bool()

    last = w.shape[-1] - 1
    below = t_fine_idx_below.clamp(0, last)
    above = (t_fine_idx_below + 1).clamp(0, last)
    ert_invalid = ert_bins.gather(-1, below)
    below_empty = empty_bins.gather(-1, below)
    above_empty = empty_bins.gather(-1, above)
    ess_invalid = torch.where(object_ray[..., None],
                              below_empty & above_empty,
                              below_empty | above_empty)
    valid = ~(ess_invalid | ert_invalid)
    return valid & ~empty_ray[..., None]


def fine_stage(apply_fn, rays_o, rays_d, viewdirs, t_coarse, w_c,
               s: RenderSettings, generator: torch.Generator | None = None,
               train: bool = False,
               density_coarse: torch.Tensor | None = None) -> dict:
    """Importance-resample from the coarse weights (their gradient
    stopped), sort the union of coarse and fine depths, run the fine MLP
    and composite. In training the CDF is sampled at random ``u`` and the
    densities get ``raw_noise_std`` noise, both from ``generator``.

    ``density_coarse`` (the activated coarse densities, (N, N_samples))
    switches on the ESS/ERT masks: an invalid fine sample's raw output is
    replaced by zeros (the reference's zero-filled scatter,
    network.py:234-253), so its density is the activation's at 0 and it
    gets no gradient. With ``ess_verbose`` the output holds
    ``ess_stats``."""
    gen = generator if train else None
    with tracing.span("render.resample"):
        bins = 0.5 * (t_coarse[..., 1:] + t_coarse[..., :-1])
        t_fine = sample_pdf(bins, w_c[..., 1:-1].detach(), s.N_importance,
                            generator=gen)
        t_cat = torch.cat([t_coarse, t_fine], dim=-1)
        valid = None
        if density_coarse is None:
            t_all = torch.sort(t_cat, dim=-1).values
        else:
            # the validity flags follow the depths through the sort;
            # stable, as jnp.argsort, so a tie of a coarse and a fine depth
            # keeps the coarse one first
            t_all, order = torch.sort(t_cat, dim=-1, stable=True)
            below = torch.searchsorted(bins.contiguous(),
                                       t_fine.contiguous(), right=True) - 1
            valid_f = _ess_ert_mask(density_coarse.detach(),
                                    t_coarse.detach(), below, s)
            valid = torch.cat([torch.ones_like(valid_f[..., :1]).expand(
                t_coarse.shape), valid_f], dim=-1).gather(-1, order)
    with tracing.span("render.fine"):
        pts = rays_o[:, None] + rays_d[:, None] * t_all[..., None]
        raw = apply_fn(pts, viewdirs[:, None], "fine")
        if valid is not None:
            raw = torch.where(valid[..., None], raw, 0.0)
        w_f, _, _ = compute_weights(
            raw[..., 3], t_all,
            activation=density_activation(s.density_activation),
            finite_tail=s.finite_tail, raw_noise_std=s.raw_noise_std,
            generator=gen)
        rgb, depth, acc = composite(torch.sigmoid(raw[..., :3]), w_f, t_all,
                                    s.white_bkgd)
        out = {"rgb": rgb, "depth": depth, "acc": acc}
        if valid is not None and s.ess_verbose:
            # the reference's ESS/ERT debug statistics (:198-244)
            out["ess_stats"] = {
                "empty_rays": (density_coarse.sum(dim=-1) < 1e-3).sum(),
                "total_rays": t_all.shape[0],
                "valid_fine_frac": valid.float().mean(),
                "skipped_points": (~valid).sum(),
            }
    return out


def ert_bounds(n_samples: int, n_seg: int, split: float) -> list[int]:
    """Segment bounds over ``n_samples`` sorted samples: the first segment
    takes ``split`` of them (the inverse-CDF samples gather around the
    surface, mid-array, so most rays saturate there), the rest is split
    evenly; fewer segments than asked where the tail runs out."""
    first = int(round(n_samples * float(split)))
    first = max(1, min(n_samples - (n_seg - 1), first))
    k_tail = -(-(n_samples - first) // max(n_seg - 1, 1))
    bounds = [0, first]
    while bounds[-1] < n_samples:
        bounds.append(min(n_samples, bounds[-1] + k_tail))
    return bounds


def ert_fractions(n_seg: int, frac: tuple = ()) -> tuple:
    """Survivor fractions at the ``n_seg - 1`` boundaries: ``frac``, or
    ``0.5 * 0.8**i``; a shorter ``frac`` goes on from its last value with
    the same decay."""
    frac = tuple(frac) if frac else tuple(0.5 * (0.8 ** i)
                                          for i in range(n_seg - 1))
    if len(frac) < n_seg - 1:
        last = frac[-1] if frac else 0.5
        frac = frac + tuple(last * (0.8 ** (i + 1))
                            for i in range(n_seg - 1 - len(frac)))
    return frac


def ert_capacity(n: int, frac: float) -> int:
    """Rays kept of ``n`` at a boundary: ``n * frac`` rounded up to a
    multiple of 128, within [1, n]."""
    kk = int(-(-n * float(frac) // 128) * 128)
    return min(n, max(1, kk))


def fine_stage_ert(apply_fn, rays_o, rays_d, viewdirs, t_coarse, w_c,
                   s: RenderSettings, n_seg: int | None = None,
                   surv_frac: tuple | None = None) -> dict:
    """The fine pass in segments with early ray termination (eval only:
    deterministic CDF samples, no noise). The sorted union of coarse and
    fine depths is evaluated ``n_seg`` (``s.ert_segments``) segments at a
    time (:func:`ert_bounds`); between segments only the
    :func:`ert_capacity` rays with the most transmittance left go on (the
    first of a stable descending sort: ``lax.top_k``'s order), the others
    stop there.

    A surviving ray's weights are those of :func:`fine_stage`: the deltas
    come from the whole sorted depth vector (1e10 tail, or the finite
    one), and the carried transmittance has the same +1e-10 a factor, so
    with every ray kept the result is :func:`fine_stage`'s up to f32
    rounding. A dropped ray loses its tail, at most its remaining
    transmittance; ``stats["ert_overflow"]`` counts the rays dropped with
    more than ``ert_eps`` left."""
    n = rays_o.shape[0]
    n_seg = int(s.ert_segments if n_seg is None else n_seg)
    bins = 0.5 * (t_coarse[..., 1:] + t_coarse[..., :-1])
    t_fine = sample_pdf(bins, w_c[..., 1:-1].detach(), s.N_importance)
    t_all = torch.sort(torch.cat([t_coarse, t_fine], dim=-1), dim=-1).values
    bounds = ert_bounds(t_all.shape[-1], n_seg, s.ert_split)
    n_seg = len(bounds) - 1
    d = t_all[:, 1:] - t_all[:, :-1]
    tail = d[:, -1:] if s.finite_tail else torch.full_like(d[:, :1], 1e10)
    delta = torch.cat([d, tail], dim=1)
    act = density_activation(s.density_activation)
    frac = ert_fractions(n_seg, s.ert_frac if surv_frac is None
                         else surv_frac)

    rgb_acc = rays_o.new_zeros((n, 3))
    depth_acc = rays_o.new_zeros((n,))
    acc_acc = rays_o.new_zeros((n,))
    gidx = torch.arange(n, device=rays_o.device)
    ro, rd, vd = rays_o, rays_d, viewdirs
    T = rays_o.new_ones((n,))
    overflow = torch.zeros((), dtype=torch.int64, device=rays_o.device)
    for seg in range(n_seg):
        ts = t_all[:, bounds[seg]:bounds[seg + 1]]
        ds = delta[:, bounds[seg]:bounds[seg + 1]]
        pts = ro[:, None] + rd[:, None] * ts[..., None]
        raw = apply_fn(pts, vd[:, None], "fine")
        rgb = torch.sigmoid(raw[..., :3])
        alpha = 1.0 - torch.exp(-act(raw[..., 3]) * ds)
        trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
        trans_excl = torch.cat([torch.ones_like(trans[:, :1]),
                                trans[:, :-1]], dim=1)
        w = T[:, None] * trans_excl * alpha
        # gidx holds each survivor's row once
        rgb_acc.index_add_(0, gidx, (w[..., None] * rgb).sum(dim=1))
        depth_acc.index_add_(0, gidx, (w * ts).sum(dim=1))
        acc_acc.index_add_(0, gidx, w.sum(dim=1))
        T = T * trans[:, -1]
        if seg < n_seg - 1:
            kk = min(T.shape[0], ert_capacity(n, frac[seg]))
            vals, sel = torch.sort(T, descending=True, stable=True)
            vals, sel = vals[:kk], sel[:kk]
            overflow = overflow + ((T > s.ert_eps).sum()
                                   - (vals > s.ert_eps).sum())
            gidx, ro, rd, vd = gidx[sel], ro[sel], rd[sel], vd[sel]
            t_all, delta, T = t_all[sel], delta[sel], vals
    rgb_map = rgb_acc + (1.0 - acc_acc[..., None]) if s.white_bkgd \
        else rgb_acc
    return {"rgb": rgb_map, "depth": depth_acc, "acc": acc_acc,
            "stats": {"ert_overflow": overflow}}


def render_rays(apply_fn, rays_o: torch.Tensor, rays_d: torch.Tensor,
                s: RenderSettings, generator: torch.Generator | None = None,
                train: bool = False) -> dict:
    """Render a flat batch of rays (N, 3).
    ``apply_fn(pts, viewdirs, model) -> raw (..., 4)``. Deterministic
    unless ``train`` and a ``generator`` are given (the JAX package's
    ``key``). Returns rgb, depth, acc, plus the coarse composite as
    rgb_coarse/depth_coarse/acc_coarse when N_importance > 0, else the
    coarse ``weights`` (N, N_samples), which the compacted frame's fine
    pass reuses. With ``fast_sampling`` the fine pass is masked
    (:func:`fine_stage`), in training and in eval."""
    gen = generator if train else None
    with tracing.span("render.coarse"):
        t_coarse = stratified_sample(
            rays_o.shape[0], s.N_samples, s.near, s.far,
            generator=gen if s.perturb else None, lindisp=s.lindisp,
            device=rays_o.device)
        pts = rays_o[:, None] + rays_d[:, None] * t_coarse[..., None]
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        raw = apply_fn(pts, viewdirs[:, None], "")
        act = density_activation(s.density_activation)
        w_c, _, _ = compute_weights(
            raw[..., 3], t_coarse, activation=act, finite_tail=s.finite_tail,
            raw_noise_std=s.raw_noise_std, generator=gen)
        rgb_c, depth_c, acc_c = composite(torch.sigmoid(raw[..., :3]), w_c,
                                          t_coarse, s.white_bkgd)
    if s.N_importance <= 0:
        return {"rgb": rgb_c, "depth": depth_c, "acc": acc_c, "weights": w_c}
    # the masks read the coarse densities without noise
    density_c = act(raw[..., 3]) if s.fast_sampling else None
    out = fine_stage(apply_fn, rays_o, rays_d, viewdirs, t_coarse, w_c, s,
                     generator=gen, train=train, density_coarse=density_c)
    out.update(rgb_coarse=rgb_c, depth_coarse=depth_c, acc_coarse=acc_c)
    return out


class Renderer:
    """``Renderer(net).render(batch) -> (rgb, depth)``. ``net`` is a port
    Network holding its weights; rays go to the device of its parameters.
    ``settings`` (a :class:`RenderSettings`) takes the place of ``cfg``'s
    renderer keys. ``mesh`` (a ``parallel.mesh.Mesh``) shards the eval ray
    chunks over its ranks; ``"auto"`` (the default, JAX :447-457) takes the
    process group's when it has more than one rank (on the network's
    device), None renders alone."""

    def __init__(self, net, cfg=None, settings: RenderSettings | None = None,
                 mesh="auto"):
        self.net = net
        self.mesh = (default_mesh(cfg, self.device.type) if mesh == "auto"
                     else mesh)
        self.settings = settings or (
            RenderSettings.from_cfg(cfg) if cfg is not None
            else RenderSettings())
        self.apply_fn = net
        network_cfg = cfg.get("network", {}) if cfg is not None else {}
        self.fused_train = as_bool(
            network_cfg.get("use_pallas_mlp_train", True),
            "network.use_pallas_mlp_train")
        self._train_apply = None
        self.frames = 0            # render() calls: the render.frame span ids

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    @property
    def eval_settings(self) -> RenderSettings:
        """The settings of every eval path: no ESS/ERT masks, since at eval
        time the capability is the ray compaction (render_image_fast, the
        frame renderer), so a rendered ray is the dense render's."""
        return dataclasses.replace(self.settings, fast_sampling=False)

    def use_apply(self, apply_fn) -> "Renderer":
        """Route eval through a custom ``apply_fn(pts, viewdirs, model)``
        (e.g. ``ngp_renderer.make_ngp_eval_apply``); training keeps
        :attr:`train_apply`."""
        self.apply_fn = apply_fn
        return self

    def enable_fused_mlp(self) -> bool:
        """Route the MLP through the fused CUDA kernel
        (ops/mlp_kernel.py), with the weights packed now. On a CUDA
        network the kernel is built here, so a failed build raises.
        False when the architecture is not the one the kernel covers
        (``mlp_kernel.unsupported`` says what differs)."""
        fused = mlp_kernel.make_fused_apply(self.net)
        if fused is None:
            return False
        if self.device.type == "cuda":
            mlp_kernel.build()
        self.apply_fn = fused
        return True

    @property
    def train_apply(self):
        """The training apply, made at first use. A brick hash-grid NGP
        network: the ``nn.Module``, whose encoder runs the brick-encode
        kernels (built now on a CUDA network, so a failed build raises). A
        network of the vertex-exact ``xla`` grid: the ``nn.Module``, which
        no kernel covers. Else the differentiable fused MLP kernels with
        ``network.use_pallas_mlp_train`` True (built now likewise; a
        network they do not cover raises), or the ``nn.Module`` with
        autograd."""
        if self._train_apply is None:
            if ngp_renderer.is_brick_ngp(self.net):
                if self.device.type == "cuda":
                    hashgrid_kernel.build()
                self._train_apply = self.net
            elif ngp_renderer.is_xla_ngp(self.net):
                print("xla hash grid: training the nn.Module network (no "
                      "kernel covers it)")
                self._train_apply = self.net
            elif not self.fused_train:
                self._train_apply = self.net
            else:
                fused = mlp_train.make_fused_train_apply(self.net)
                if fused is None:
                    raise ValueError(
                        "network.use_pallas_mlp_train is on, but the fused "
                        "MLP kernels do not cover "
                        f"{mlp_kernel.unsupported(self.net)}; set "
                        "network.use_pallas_mlp_train False for the "
                        "nn.Module MLP")
                if self.device.type == "cuda":
                    mlp_train.build()
                self._train_apply = fused
        return self._train_apply

    def _rays(self, rays_o, rays_d):
        device = self.device
        return (torch.as_tensor(rays_o, dtype=torch.float32, device=device),
                torch.as_tensor(rays_d, dtype=torch.float32, device=device))

    def _render_chunks(self, rays_o, rays_d, s: RenderSettings) -> dict:
        """``render_rays`` over (N, 3) rays ``ray_chunk`` at a time, with a
        mesh the chunks dealt out whole over its ranks (the JAX package
        splits each by rows instead, rounding ``ray_chunk`` up to a
        multiple of the mesh's size, :481-488). The last chunk is padded to
        full size with rays whose direction is (1, 1, 1), so padding never
        divides by zero."""
        n = rays_o.shape[0]
        chunk = min(s.ray_chunk, n)
        n_pad = (-n) % chunk
        ro = torch.nn.functional.pad(rays_o, (0, 0, 0, n_pad))
        rd = torch.nn.functional.pad(rays_d, (0, 0, 0, n_pad), value=1.0)
        out = make_dp_eval_render(
            lambda o, d: render_rays(self.apply_fn, o, d, s), self.mesh,
            chunk)(ro, rd)
        return {k: v[:n] for k, v in out.items()}

    @torch.inference_mode()
    def render_rays_batch(self, rays_o, rays_d) -> dict:
        """Flat (N, 3) rays (numpy or tensors) -> dict of (N, ...) tensors
        on the renderer's device, rendered ``ray_chunk`` rays at a time."""
        return self._render_chunks(*self._rays(rays_o, rays_d),
                                   self.eval_settings)

    @torch.inference_mode()
    def render_image_fast(self, rays_o, rays_d, eps: float = 1e-3) -> dict:
        """Eval with empty-space skipping by ray compaction (reference
        :543-605): a coarse-only pass over every ray, then the full
        hierarchical render of the rays whose coarse opacity exceeds
        ``eps`` only, in padded chunks, scattered back; the other rays keep
        the coarse composite (white where nothing is hit). Finding the
        active rays is the frame's one host read. Returns rgb, depth, acc
        (N, ...) tensors; an active ray's values are the dense render's."""
        rays_o, rays_d = self._rays(rays_o, rays_d)
        s = self.eval_settings
        out = self._render_chunks(rays_o, rays_d,
                                  dataclasses.replace(s, N_importance=0))
        out = {k: out[k] for k in ("rgb", "depth", "acc")}
        active = torch.nonzero(out["acc"] > eps).squeeze(1)
        n_active = active.shape[0]
        if n_active:
            # padding repeats ray 0, as the JAX package's index padding
            chunk = min(s.ray_chunk, rays_o.shape[0])
            idx = torch.nn.functional.pad(active, (0, (-n_active) % chunk))
            fine = self._render_chunks(rays_o[idx], rays_d[idx],
                                       dataclasses.replace(
                                           s, ray_chunk=chunk))
            for k in out:
                out[k][active] = fine[k][:n_active]
        return out

    def make_frame_renderer(self, H: int, W: int, focal: float,
                            capacity: float = 0.5, out_dtype=torch.float32,
                            occupancy=None,
                            coarse_capacity: float | None = None,
                            return_stats: bool = False, mesh="auto"):
        """``fn(c2w) -> rgb (H*W, 3)[, stats]``: a whole frame from a
        camera-to-world pose (4, 4) on the renderer's device, with static
        ray budgets (reference :607-836).

        Rays come from the pose on the device. With ``occupancy`` ((grid,
        bbox) or (grid, bbox, dilate), ops/occupancy.py) the rays whose
        probes on a ``q``-pixel lattice (q = 4 or 2 when the lattice's ray
        divergence stays inside a cell and the grid is dilated >= 2) touch
        no occupied cell skip the coarse pass; the others, actives first
        (a stable partition), fill ``coarse_capacity`` x H*W coarse rays
        (default ``min(1, 1.5 x capacity)``). Of these, the ``capacity`` x
        H*W most opaque take the fine pass, which reuses their saved coarse
        weights (no second coarse MLP) and, with ``ert_segments`` > 1, runs
        :func:`fine_stage_ert`. The image is background, then the coarse
        composite, then the fine one; ``out_dtype=torch.uint8`` rounds
        ``clamp(x, 0, 1) * 255`` to the nearest, ties to even.

        Budgets are rounded up to whole ``ray_chunk`` chunks and capped at
        the frame (``fn.budget`` holds them); a frame reads nothing back
        to the host. ``stats`` are 0-d tensors: ``coarse_rays``, and with
        ``occupancy`` ``active_rays`` and ``coarse_overflow`` (active rays
        beyond the coarse budget, rendered as background), then
        ``fine_overflow`` (rays with coarse opacity > 1e-3 beyond the fine
        budget, left coarse-only). ``mesh`` (a ``parallel.mesh.Mesh``, JAX
        :630-669; by default the renderer's) shards the frame over its
        ranks: every rank makes the
        probe, the partition and the top-k itself, the chunks of the coarse
        and of the fine pass are dealt out whole over the ranks and
        gathered before the next selection, and every rank returns the
        whole frame, the one-device frame bit for bit."""
        if mesh == "auto":
            mesh = self.mesh
        s = self.eval_settings
        coarse_s = dataclasses.replace(s, N_importance=0)
        apply_fn = self.apply_fn
        device = self.device
        n = H * W
        chunk = min(s.ray_chunk, n)
        n_pad = (-n) % chunk
        n_full = n + n_pad
        k = min(n_full, -(-int(n_full * capacity) // chunk) * chunk)
        k1 = int(n_full * (coarse_capacity if coarse_capacity is not None
                           else min(1.0, capacity * 1.5)))
        k1 = max(min(n_full, -(-k1 // chunk) * chunk), k)
        k1_eff = n_full if occupancy is None else k1
        k_eff = min(k, k1_eff)

        if occupancy is not None:
            grid = ngp_renderer._grid_on(occupancy[0], device)
            bbox = tuple(float(b) for b in occupancy[1])
            dilate = int(occupancy[2]) if len(occupancy) > 2 else 1
            r = grid.shape[0]
            cell = max((bbox[3 + d] - bbox[d]) / r for d in range(3))
            n_probe = int(np.ceil((s.far - s.near) / cell)) + 1
            # a probe lattice of q px: neighbouring rays part by at most
            # q * far / focal, which must stay inside the grid's dilation
            # margin beside the probe step (so dilate >= 2)
            sub = 1
            if dilate >= 2:
                sub = next((q for q in (4, 2) if q * s.far / focal <= cell
                            and H % q == 0 and W % q == 0), 1)
            t_probe = torch.from_numpy(ngp_renderer.probe_depths(
                s.near, s.far, n_probe)).to(device)
            scale = box_scale(bbox, device)

        # constants, made on the device once: a copy inside a frame would
        # wait for the host
        dirs = torch.from_numpy(ngp_renderer.pixel_dirs(H, W, focal)).to(
            device)
        n_idx = torch.arange(n_full, device=device)
        live_all = n_idx < n
        t_coarse = stratified_sample(chunk, s.N_samples, s.near, s.far,
                                     lindisp=s.lindisp, device=device)
        counts = {"coarse_rays": torch.full((), k1_eff, device=device)}
        bg = 1.0 if s.white_bkgd else 0.0

        def pad(x, value=0.0):
            return torch.nn.functional.pad(x, (0, 0, 0, n_pad), value=value)

        def coarse_chunk(ro, rd):
            out = render_rays(apply_fn, ro, rd, coarse_s)
            return out["rgb"], out["acc"], out["weights"]

        def fine_chunk(ro, rd, w):
            vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
            if s.ert_segments > 1:
                return (fine_stage_ert(apply_fn, ro, rd, vd, t_coarse, w,
                                       s)["rgb"],)
            return (fine_stage(apply_fn, ro, rd, vd, t_coarse, w, s)["rgb"],)

        coarse_run = make_dp_eval_render(coarse_chunk, mesh, chunk)
        fine_run = make_dp_eval_render(fine_chunk, mesh, chunk)

        @torch.inference_mode()
        def fn(c2w):
            c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
            rays_d = ngp_renderer.rotate_dirs(dirs, c2w)
            ro = pad(c2w[:3, 3].expand(rays_d.shape))
            rd = pad(rays_d, 1.0)
            stats = dict(counts)
            if occupancy is None:
                sel1 = None
                rgb1, acc1, w1 = coarse_run(ro, rd)
                live1 = live_all
            else:
                if sub > 1:
                    rd_s = rays_d.reshape(H, W, 3)[sub // 2::sub,
                                                   sub // 2::sub]
                    rd_s = rd_s.reshape(-1, 3)
                    act = rays_active(c2w[:3, 3].expand(rd_s.shape), rd_s,
                                      t_probe, grid, bbox, scale)
                    h, w = H // sub, W // sub
                    active = torch.nn.functional.pad(
                        act.reshape(h, 1, w, 1).expand(h, sub, w, sub)
                        .reshape(-1), (0, n_pad))
                else:
                    active = rays_active(ro, rd, t_probe, grid, bbox,
                                         scale) & live_all
                sel1 = ngp_renderer.partition(active, k1, n_idx)
                rgb1, acc1, w1 = coarse_run(ro[sel1], rd[sel1])
                n_active = active.sum()
                stats["active_rays"] = n_active
                stats["coarse_overflow"] = torch.clamp(n_active - k1, min=0)
                live1 = sel1 < n
            # the fine set among the coarse rays: the first k of a stable
            # descending sort by opacity (lax.top_k's order), padding rays
            # forced to 0 so that they never take a fine slot
            acc1 = torch.where(live1, acc1, 0.0)
            sel2 = torch.sort(acc1, descending=True, stable=True
                              ).indices[:k_eff]
            stats["fine_overflow"] = torch.clamp(
                (acc1 > 1e-3).sum() - k_eff, min=0)
            sel_full = sel2 if sel1 is None else sel1[sel2]
            fine, = fine_run(ro[sel_full], rd[sel_full], w1[sel2])
            if sel1 is None:
                rgb = rgb1
            else:
                rgb = torch.full((n_full, 3), bg, device=device).index_copy_(
                    0, sel1, rgb1)
            rgb = rgb.index_copy_(0, sel_full, fine)[:n]
            if out_dtype == torch.uint8:
                rgb = torch.round(torch.clamp(rgb, 0.0, 1.0) * 255.0).to(
                    torch.uint8)
            else:
                rgb = rgb.to(out_dtype)
            return (rgb, stats) if return_stats else rgb

        # a frame calls apply_fn coarse_rays / chunk times for the coarse
        # pass and fine_rays / chunk x fine_segments for the fine one
        fn.budget = {"chunk": chunk, "coarse_rays": k1_eff, "fine_rays": k_eff,
                     "fine_segments": (len(ert_bounds(
                         s.N_samples + s.N_importance, s.ert_segments,
                         s.ert_split)) - 1) if s.ert_segments > 1 else 1}
        return fn

    def render(self, batch):
        """Reference-contract entry: ``batch`` holds rays_o/rays_d of shape
        (..., 3); returns (rgb (N, 3), depth (N,)) tensors. With
        ``fast_sampling`` and a fine pass, through
        :meth:`render_image_fast`."""
        rays_o = torch.as_tensor(batch["rays_o"]).reshape(-1, 3)
        rays_d = torch.as_tensor(batch["rays_d"]).reshape(-1, 3)
        with tracing.span("render.frame", root=self.frames):
            if self.settings.fast_sampling and self.settings.N_importance > 0:
                out = self.render_image_fast(rays_o, rays_d)
            else:
                out = self.render_rays_batch(rays_o, rays_d)
        self.frames += 1
        return out["rgb"], out["depth"]
