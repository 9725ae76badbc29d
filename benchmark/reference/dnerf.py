"""D-NeRF in plain PyTorch: the benchmark's own copy of the repository's
``reference/dnerf.py`` (Pumarola et al., CVPR 2021, arXiv:2011.13961, sec.
4-5; the code's ``DirectTemporalNeRF``), with its products through
:class:`~benchmark.reference.field.Precision` and the training step's draws
in the measured program's order.

Per point x at time t with view direction d: the deformation Psi_t,
``dx = Psi_t(gamma(x) | gamma(t))`` (``deform.D`` ReLU layers of
``deform.W``, gamma(x) alone re-joined after each layer in
``deform.skips``, a linear 3-wide head), 0 where t is ``canonical_t``;
then the NeRF paper's MLP (:func:`~benchmark.reference.field.mlp`, branch
``canonical``) on gamma(x + dx) and gamma(d). Both passes of the
hierarchical render run the one model. Departures from the paper are the
program's: softplus density, a white background, Flax's initialisation.

The stand-ins that the cell's controls plant (``fault``): ``no_deform``
(dx dropped), ``no_input_grad`` (the canonical MLP's input gradient
zeroed, so Psi_t never learns: the backward kernel as it was),
``flip_input_grad`` (that gradient's sign flipped) and ``no_skip_grad``
(its second product, through the input re-joined after layer
``skips[0]``, left out). ``deform_prec`` rounds Psi_t's products alone
(``"bfloat16"``: operands and the hidden outputs, as the program's Psi_t
does), for the witness that shows what that rounding moves.

Weights are a dict of float32 tensors under the program's names:
``deform.pts.{i}``, ``deform.out``, ``canonical.{pts.i,alpha,feature,
views.0,rgb}``, each ``.weight`` (out, in) and ``.bias``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .field import Precision, freq_encode, mlp

FAULTS = (None, "no_deform", "no_input_grad", "flip_input_grad",
          "no_skip_grad")


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bfloat16, as f32."""
    return t.to(torch.bfloat16).float()


class Bf16Precision(Precision):
    """:class:`~benchmark.reference.field.Precision` with ``bfloat16``:
    operands and outputs rounded, a straight-through gradient."""

    ROUND = {**Precision.ROUND, "bfloat16": (round_bf16, round_bf16),
             "bfloat16_operands": (round_bf16, None)}


def mlp_no_skip_grad(w: dict, x, v, depth: int, skips, prec: Precision):
    """``field.mlp``'s canonical branch with no gradient through the
    re-joined input: the input gradient's second product left out."""
    def dense(name, h):
        return prec.linear(h, w[f"canonical.{name}.weight"],
                           w[f"canonical.{name}.bias"])

    h = x
    for i in range(depth):
        h = torch.relu(dense(f"pts.{i}", h))
        if i in skips:
            h = torch.cat([x.detach(), h], -1)
    sigma = dense("alpha", h)
    h = torch.cat([dense("feature", h), v], -1)
    h = torch.relu(dense("views.0", h))
    return torch.cat([dense("rgb", h), sigma], -1)


class DNeRFField:
    """``field(w, pts (..., 3), dirs, times) -> raw (..., 4)``, dirs and
    times broadcastable to the points' leading shape; ``model`` is the
    configuration's ``model`` section (with its ``deform``)."""

    def __init__(self, model: dict, prec: Precision | None = None,
                 fault: str | None = None, deform_prec: str | None = None):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.model, self.fault = model, fault
        self.prec = prec or Precision("float32")
        # Psi_t's hidden products and its head (whose output the program
        # keeps in f32)
        self.deform_prec = self.head_prec = self.prec
        if deform_prec is not None:
            self.deform_prec = Bf16Precision(deform_prec)
            self.head_prec = Bf16Precision(deform_prec + "_operands")

    def deform(self, w, x, t):
        """dx (N, 3) of points (N, 3) at times (N,)."""
        m, d = self.model, self.model["deform"]
        gx = freq_encode(x, m["xyz_freqs"])
        h = torch.cat([gx, freq_encode(t[:, None], d["time_freqs"])], -1)
        for i in range(d["D"]):
            h = torch.relu(self.deform_prec.linear(
                h, w[f"deform.pts.{i}.weight"], w[f"deform.pts.{i}.bias"]))
            if i in d["skips"]:
                h = torch.cat([gx, h], -1)
        dx = self.head_prec.linear(h, w["deform.out.weight"],
                                   w["deform.out.bias"])
        return torch.where((t == d["canonical_t"])[:, None],
                           torch.zeros_like(dx), dx)

    def __call__(self, w, pts, dirs, times):
        shape = pts.shape[:-1]
        m = self.model
        x = pts.reshape(-1, 3)
        d = dirs.expand(*shape, 3).reshape(-1, 3)
        t = times.expand(shape).reshape(-1)
        if self.fault != "no_deform":
            x = x + self.deform(w, x, t)
            if self.fault == "no_input_grad":
                x = x.detach()
            elif self.fault == "flip_input_grad":
                x = 2.0 * x.detach() - x      # its value, the gradient's sign
        canonical = mlp_no_skip_grad if self.fault == "no_skip_grad" else \
            lambda w, x, v, *a: mlp(w, "canonical", x, v, *a)
        raw = canonical(w, freq_encode(x, m["xyz_freqs"]),
                        freq_encode(d, m["dir_freqs"]), m["D"],
                        tuple(m["skips"]), self.prec)
        return raw.reshape(*shape, 4)


def weights_of(sigma, z):
    """Compositing weights from raw densities (softplus), 1e10 far tail."""
    delta = z[..., 1:] - z[..., :-1]
    delta = torch.cat([delta, torch.full_like(delta[..., :1], 1e10)], -1)
    alpha = 1.0 - torch.exp(-F.softplus(sigma) * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return alpha * trans


def composite(raw, wts):
    """rgb on a white background."""
    rgb = (wts[..., None] * torch.sigmoid(raw[..., :3])).sum(-2)
    return rgb + (1.0 - wts.sum(-1)[..., None])


def sample_pdf(bins, weights, n: int, u=None):
    """Inverse-CDF depths over ``bins`` from ``weights`` + 1e-5 at ``u``,
    or at ``linspace(0, 1, n)``."""
    wt = weights + 1e-5
    cdf = torch.cumsum(wt / wt.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=cdf.device).expand(
            *cdf.shape[:-1], n).contiguous()
    above = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (above - 1).clamp(min=0)
    above = above.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def render_rays(field: DNeRFField, w, rays_o, rays_d, times, r: dict,
                gen=None):
    """Coarse and fine pass of rays (N, 3) at times (N,) through the one
    model; with ``gen`` the training draws in the program's order (the
    coarse jitter, then the fine ``u``). Returns (rgb, rgb_coarse)."""
    n, S, I = rays_o.shape[0], r["N_samples"], r["N_importance"]
    u = torch.linspace(0.0, 1.0, S, device=rays_o.device)
    z = (r["near"] * (1.0 - u) + r["far"] * u).expand(n, S)
    if gen is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        z = lower + (upper - lower) * torch.rand(
            (n, S), generator=gen, device=rays_o.device)
    dirs = (rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True))[:, None]
    t = times.reshape(-1, 1)
    raw = field(w, rays_o[:, None] + rays_d[:, None] * z[..., None], dirs, t)
    wc = weights_of(raw[..., 3], z)
    bins = 0.5 * (z[..., 1:] + z[..., :-1])
    uf = (None if gen is None else
          torch.rand((n, I), generator=gen, device=rays_o.device))
    zf = sample_pdf(bins, wc[..., 1:-1].detach(), I, uf)
    z_all = torch.sort(torch.cat([z, zf], -1), -1).values
    raw_f = field(w, rays_o[:, None] + rays_d[:, None] * z_all[..., None],
                  dirs, t)
    return composite(raw_f, weights_of(raw_f[..., 3], z_all)), \
        composite(raw, wc)


def loss_of(field: DNeRFField, w, rays_o, rays_d, times, colors, r: dict,
            gen=None):
    """The fine and the coarse image's mean squared error."""
    rgb, rgb_c = render_rays(field, w, rays_o, rays_d, times, r, gen)
    return ((rgb - colors) ** 2).mean() + ((rgb_c - colors) ** 2).mean()
