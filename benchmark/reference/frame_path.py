"""The occupancy-raymarch frame of an NGP field in plain PyTorch: the
semantics of the measured viewer frame, without its ray budgets.

1. Two occupancy grids of the field's own density (the fine branch, zero
   view directions, softplus) over the box [-1.5, 1.5]^3: 64^3 cells
   dilated 2 for the span probe and 128^3 dilated 1 for the candidates. A
   cell is occupied above ``threshold``; the dilation is a max-pool of
   rolls along each axis whose low border planes are reset to the
   undilated grid (so the high border keeps what wrapped round).
2. A ray's span: the first to the last occupied probe along it (probes
   every ``probe_stride`` cells from near to far, on a lattice of one ray
   in ``sub`` x ``sub`` pixels, the widest whose rays part by at most a
   cell at the far plane), widened by two probe steps.
3. ``n_candidates`` depths evenly through the span; ``n_coarse`` of them
   picked evenly through the occupied ones first, then the empty ones.
   A ray with no probe hit, or no occupied candidate, is background.
4. The coarse samples composited with gaps capped at twice the candidate
   spacing; ``n_fine`` inverse-CDF samples from the midpoint weights,
   merged by a stable sort, composited again onto white.

Every live ray takes the fine pass here; the measured frame gives it to
the most opaque rays up to its budget, which a frame that does not
overflow spends on every ray of coarse opacity above 1e-3 and then on
rays whose coarse opacity is under 1e-3, where the fine and the coarse
image differ by less than that opacity.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .field import Field
from .render import sample_pdf, to_uint8

BOX = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)


def _recip(c) -> float:
    return float(np.float32(1.0) / np.float32(c))


@torch.no_grad()
def occupancy_grid(field: Field, w, resolution: int, threshold: float,
                   dilate: int, device, chunk: int = 1 << 18):
    lo = np.asarray(BOX[:3], np.float32)
    hi = np.asarray(BOX[3:], np.float32)
    c = (np.arange(resolution, dtype=np.float32) + 0.5) / resolution
    pts = np.stack(np.meshgrid(*(lo[d] + c * (hi[d] - lo[d])
                                 for d in range(3)), indexing="ij"),
                   -1).reshape(-1, 3)
    pts = torch.from_numpy(pts).to(device)
    zero = pts.new_zeros(1, 3)
    occ = torch.cat([
        F.softplus(field(w, pts[i:i + chunk], zero, "fine")[..., 3])
        > threshold for i in range(0, pts.shape[0], chunk)])
    grid = occ.to(torch.uint8).reshape((resolution,) * 3)
    out = grid.clone()
    for axis in range(3):
        acc = out.clone()
        for s in range(1, dilate + 1):
            acc = torch.maximum(acc, torch.roll(out, s, dims=axis))
            acc = torch.maximum(acc, torch.roll(out, -s, dims=axis))
            sl = [slice(None)] * 3
            sl[axis] = slice(0, s)
            acc[tuple(sl)] = torch.maximum(grid, out)[tuple(sl)]
        out = acc
    return out


def occupied(pts, grid):
    lo = torch.tensor(BOX[:3], dtype=torch.float32, device=pts.device)
    inv = torch.from_numpy(np.float32(1.0) / (np.asarray(BOX[3:], np.float32)
                                              - np.asarray(BOX[:3],
                                                           np.float32)))
    r = grid.shape[0]
    u = (pts - lo) * inv.to(pts.device)
    inside = ((u >= 0.0) & (u < 1.0)).all(-1)
    cell = torch.clamp((u * r).to(torch.int32), 0, r - 1).long()
    flat = (cell[..., 0] * r + cell[..., 1]) * r + cell[..., 2]
    return (grid.reshape(-1)[flat] > 0) & inside


def rotate(dirs, pose):
    r = pose[:3, :3]
    d = [dirs[:, 0] * r[i, 0] + dirs[:, 1] * r[i, 1] + dirs[:, 2] * r[i, 2]
         for i in range(3)]
    norm = torch.sqrt((d[0] * d[0] + d[1] * d[1] + d[2] * d[2]).double())
    return torch.stack([c / norm.float() for c in d], -1)


def gap_weights(sigma, t, span, n_candidates):
    cap = (2.0 * span * _recip(n_candidates))[..., None]
    delta = torch.cat([t[..., 1:] - t[..., :-1], cap.expand(t[..., :1].shape)],
                      -1)
    alpha = 1.0 - torch.exp(-F.softplus(sigma) * torch.minimum(delta, cap))
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    return alpha * torch.cat([torch.ones_like(trans[..., :1]),
                              trans[..., :-1]], -1)


def composite(raw, t, span, C):
    w = gap_weights(raw[..., 3], t, span, C)
    acc = w.sum(-1)
    rgb = (w[..., None] * torch.sigmoid(raw[..., :3])).sum(-2)
    return rgb + (1.0 - acc[..., None])


class FramePath:
    """``frame(pose) -> uint8 (H*W, 3)`` for a field and its weights; the
    grids are built here. ``step`` is (n_candidates, n_coarse, n_fine)."""

    def __init__(self, field: Field, w, H, W, focal, render: dict, view: dict,
                 device):
        self.field, self.w, self.H, self.W = field, w, H, W
        self.near, self.far = render["near"], render["far"]
        self.C, self.M, self.F = view["step"]
        thr = view["occ_threshold"]
        self.grid = occupancy_grid(field, w, view["occ_resolution"], thr, 2,
                                   device)
        self.sel_grid = occupancy_grid(field, w, view["occ_sel_resolution"],
                                       thr, 1, device)
        cell = (BOX[3] - BOX[0]) / self.grid.shape[0]
        sub, stride = view["probe"]
        n_probe = int(np.ceil((self.far - self.near) / (cell * stride))) + 1

        def fits(q):
            return q == 1 or (q * self.far / focal <= cell and H % q == 0
                              and W % q == 0)

        self.sub = (next(q for q in (8, 5, 4, 2, 1) if fits(q))
                    if sub == "auto" else (sub if fits(sub) else 1))
        r = np.float32(_recip(n_probe - 1))
        i = np.arange(n_probe - 1, dtype=np.float32)
        tp = np.float32(self.near) * (np.float32(1) - i * r) \
            + i * (np.float32(self.far) * r)
        self.t_probe = torch.from_numpy(
            np.append(tp, np.float32(self.far)).astype(np.float32)).to(device)
        self.margin = 2.0 * ((self.far - self.near) / (n_probe - 1))
        f = np.float32(_recip(focal))
        v, u = np.meshgrid(np.arange(H, dtype=np.float32),
                           np.arange(W, dtype=np.float32), indexing="ij")
        self.dirs = torch.from_numpy(np.stack(
            [(u.ravel() - np.float32(W / 2.0)) * f,
             -((v.ravel() - np.float32(H / 2.0)) * f),
             -np.ones(H * W, np.float32)], -1)).to(device)
        self.uu = torch.from_numpy(
            (np.arange(self.C, dtype=np.float32) + np.float32(0.5))
            * np.float32(_recip(self.C))).to(device)

    def spans(self, ro, rd):
        t = self.t_probe
        hit = occupied(ro[:, None] + rd[:, None] * t[None, :, None],
                       self.grid)
        active = hit.any(-1)
        big = torch.full((), 1e10, device=t.device)
        te = torch.where(hit, t[None], big).amin(-1)
        tx = torch.where(hit, t[None], -big).amax(-1)
        te = torch.clamp(te - self.margin, t[0], t[-1])
        tx = torch.clamp(tx + self.margin, t[0], t[-1])
        return active, torch.where(active, te, t[0]), \
            torch.where(active, tx, t[-1])

    @torch.no_grad()
    def __call__(self, pose, chunk: int = 65536) -> torch.Tensor:
        H, W, q = self.H, self.W, self.sub
        rd = rotate(self.dirs, pose)
        ro = pose[:3, 3].expand(rd.shape)
        if q > 1:
            rd_s = rd.reshape(H, W, 3)[q // 2::q, q // 2::q].reshape(-1, 3)
            spans = self.spans(pose[:3, 3].expand(rd_s.shape), rd_s)
            active, te, tx = (s.reshape(H // q, 1, W // q, 1)
                              .expand(H // q, q, W // q, q).reshape(-1)
                              for s in spans)
        else:
            active, te, tx = self.spans(ro, rd)
        span = torch.clamp(tx - te, min=1e-3)
        rgb = torch.ones(H * W, 3, device=rd.device)
        for i in range(0, H * W, chunk):
            sl = slice(i, i + chunk)
            o, d, e, s = ro[sl], rd[sl], te[sl], span[sl]
            t_cand = e[:, None] + s[:, None] * self.uu[None]
            occ = occupied(o[:, None] + d[:, None] * t_cand[..., None],
                           self.sel_grid)
            n_occ = occ.sum(-1)
            order = torch.sort((~occ).int(), dim=-1, stable=True).indices
            pool = torch.clamp(n_occ, min=self.M)
            pos = (torch.arange(self.M, device=d.device)[None] * pool[:, None]
                   ) // self.M
            t_c = torch.sort(t_cand.gather(1, order.gather(1, pos)), -1).values
            live = active[sl] & (n_occ > 0)
            if not live.any():
                continue
            o, d, s, t_c = o[live], d[live], s[live], t_c[live]
            raw_c = self.field(self.w,
                               o[:, None] + d[:, None] * t_c[..., None],
                               d[:, None], "fine")
            wc = gap_weights(raw_c[..., 3], t_c, s, self.C)
            t_f = sample_pdf(t_c, 0.5 * (wc[..., :-1] + wc[..., 1:]), self.F)
            raw_f = self.field(self.w,
                               o[:, None] + d[:, None] * t_f[..., None],
                               d[:, None], "fine")
            t_all, order = torch.sort(torch.cat([t_c, t_f], -1), dim=-1,
                                      stable=True)
            raw = torch.cat([raw_c, raw_f], -2).gather(
                -2, order[..., None].expand(*order.shape, 4))
            idx = torch.nonzero(live).squeeze(1) + i
            rgb[idx] = composite(raw, t_all, s, self.C)
        return to_uint8(rgb)
