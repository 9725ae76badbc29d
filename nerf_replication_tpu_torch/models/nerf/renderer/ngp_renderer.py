"""Eval apply of the brick-NGP model family, the counterpart of
``make_ngp_eval_apply`` in
nerf_replication_tpu/models/nerf/renderer/ngp_renderer.py:71-172.

It routes a brick hash-grid network's eval calls through the CUDA kernels
(a network of the vertex-exact ``xla`` grid has no kernel and runs as its
``nn.Module``, :func:`is_xla_ngp`):
with ``fused`` (the default) the whole field goes through
``fused_ngp_eval`` (encode + MLP in one kernel, SH computed per ray and
broadcast per point), in f32 or, with ``mlp_bf16`` (the JAX package's
``NGP_FUSED_BF16=1``), on bf16 operands; without it (``NGP_FUSED=0``) the
encode goes through ``brick_encode_eval`` (from the cell-corner table,
built once here) and the branch's ``nn.Module`` MLP runs on its
features. The JAX package falls back to the unfused chain
where its fused TPU kernel does not fit; here a network the fused kernel
does not cover raises, and the unfused chain is asked for by name.

The occupancy-raymarch frame renderer (``make_ngp_frame_renderer``,
ngp_renderer.py:175-566 of the reference) renders a whole frame from a
camera pose through any eval apply: this module's for NGP networks, the
fused 8x256 MLP's (``mlp_kernel.make_fused_apply``) for frequency ones.
"""

from __future__ import annotations

import numpy as np
import torch

from ....ops import eval_encode, fused_ngp
from ....ops.occupancy import box_scale, points_occupied, ray_spans
from ....ops.ray_ops import density_activation, sample_pdf
from ...encoding.hashgrid import HashGridEncoder


def grid_backend(net) -> str | None:
    """The backend of ``net``'s hash-grid encoder ("brick" or "xla"), or
    None for another encoder."""
    enc = net.xyz_encoder
    return enc.backend if isinstance(enc, HashGridEncoder) else None


def is_brick_ngp(net) -> bool:
    """The NGP networks whose eval and training have kernels."""
    return grid_backend(net) == "brick"


def is_xla_ngp(net) -> bool:
    """The vertex-exact grid's networks: no kernel covers them (the JAX
    package runs them through ``net.apply``), so they run as the
    ``nn.Module``."""
    return grid_backend(net) == "xla"


def unsupported(net) -> str | None:
    """What of ``net`` (a brick-NGP Network) the fused kernel does not
    cover, or None."""
    if not net.use_viewdirs:
        return "a network without view directions"
    for mlp in (net.coarse, net.fine):
        if not all(0 <= s < mlp.depth for s in mlp.skips):
            return f"skips {list(mlp.skips)} outside depth {mlp.depth}"
        reason = fused_ngp.unsupported_mlp(
            mlp.width, net.xyz_encoder.output_dim, net.dir_encoder.output_dim,
            mlp.depth, mlp.view_depth, tuple(mlp.skips))
        if reason is not None:
            return reason
    return None


def fused_inputs(net, pts, viewdirs):
    """The fused kernel's inputs for samples ``pts`` (..., 3) of rays with
    directions ``viewdirs`` (..., 1, 3): points in [0,1] (N, 3) and the SH
    features (N, n_sh), computed per ray and broadcast per point."""
    shape, n_sh = pts.shape[:-1], net.dir_encoder.output_dim
    x = net.xyz_encoder.to_unit(pts.reshape(-1, 3).float()).contiguous()
    vf = net.dir_encoder(viewdirs.reshape(-1, viewdirs.shape[-1]).float())
    sh = vf.reshape(*viewdirs.shape[:-1], n_sh).expand(*shape, n_sh)
    return x, sh.reshape(-1, n_sh).contiguous()


def make_ngp_eval_apply(net, fused: bool = True, mlp_bf16: bool = False):
    """Eval ``apply_fn(pts, viewdirs, model)`` for a brick-NGP ``net`` (a
    port Network), with the table packed and the weights baked now; on a
    CUDA network the kernel is built now, so a failed build raises. None
    when ``net`` is not a brick-NGP network; with ``fused`` a network the
    fused kernel does not cover raises (``unsupported`` says why).
    ``mlp_bf16`` takes the fused kernel's bf16 arm."""
    if not is_brick_ngp(net):
        return None
    if mlp_bf16 and not fused:
        raise ValueError("mlp_bf16 is an arm of the fused kernel")
    enc = net.xyz_encoder
    layout = enc.layout
    packed = eval_encode.pack_eval_table(enc.table.detach())
    on_cuda = packed.device.type == "cuda"
    if not fused:
        if on_cuda:
            eval_encode.build()
        cells = eval_encode.pack_cell_table(packed)

        def apply_unfused(pts, viewdirs, model=""):
            shape = pts.shape[:-1]
            x = enc.to_unit(pts.reshape(-1, 3).float()).contiguous()
            feat = eval_encode.brick_encode_eval(layout, cells, x)
            view_feat = None
            if net.use_viewdirs and viewdirs is not None:
                dirs = viewdirs.expand(*shape, viewdirs.shape[-1])
                view_feat = net.dir_encoder(dirs.reshape(-1, dirs.shape[-1]))
            mlp = net.fine if model == "fine" else net.coarse
            return mlp(feat, view_feat).reshape(*shape, 4)

        return apply_unfused

    reason = unsupported(net)
    if reason is not None:
        raise ValueError(f"the fused NGP kernel does not cover {reason}")
    if on_cuda:
        fused_ngp.build()
    weights = {
        name: fused_ngp.extract_mlp_weights(
            mlp.state_dict(), enc.output_dim, mlp.depth, tuple(mlp.skips),
            mlp.view_depth)
        for name, mlp in (("coarse", net.coarse), ("fine", net.fine))}

    def apply_fused(pts, viewdirs, model=""):
        x, sh = fused_inputs(net, pts, viewdirs)
        ops, meta = weights["fine" if model == "fine" else "coarse"]
        raw = fused_ngp.fused_ngp_eval(layout, meta, packed, ops, x, sh,
                                       mlp_bf16)
        return raw.reshape(*pts.shape[:-1], 4)

    return apply_fused


# --- the occupancy-raymarch frame renderer ---------------------------------

def _gap_capped_weights(sigma, t, span, n_candidates, act, cap_mult=2.0):
    """Compositing weights over non-uniformly selected samples:
    ``delta_i = min(t_{i+1} - t_i, cap)`` with ``cap = cap_mult x span /
    n_candidates`` (the candidate spacing); the tail delta is the cap, so
    a gap wider than it (a skipped empty stretch) absorbs as if the field
    were ~zero there."""
    cap = (cap_mult * span * _recip(n_candidates))[..., None]
    delta = torch.cat([t[..., 1:] - t[..., :-1],
                       cap.expand(t[..., :1].shape)], dim=-1)
    delta = torch.minimum(delta, cap)
    alpha = 1.0 - torch.exp(-act(sigma) * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)
    return alpha * trans


def _recip(c) -> float:
    """The float32 reciprocal of a constant, by which XLA replaces a
    division by that constant: the JAX package's frame divides by
    constants this way, bit for bit."""
    return float(np.float32(1.0) / np.float32(c))


def probe_depths(near: float, far: float, n_probe: int) -> np.ndarray:
    """``jnp.linspace(near, far, n_probe)`` with constant ends as XLA
    computes it, bit for bit: ``near * (1 - i * r) + i * (far * r)`` at
    ``r = 1 / (n - 1)`` in float32, then ``far``."""
    start, stop = np.float32(near), np.float32(far)
    r = np.float32(_recip(n_probe - 1))
    i = np.arange(n_probe - 1, dtype=np.float32)
    out = start * (np.float32(1.0) - i * r) + i * (stop * r)
    return np.append(out, stop).astype(np.float32)


def candidate_fractions(n_candidates: int) -> np.ndarray:
    """The candidates' places in a span, ``(i + 0.5) / C`` as XLA computes
    it (a product by the reciprocal), float32."""
    return ((np.arange(n_candidates, dtype=np.float32) + np.float32(0.5))
            * np.float32(_recip(n_candidates)))


def pixel_dirs(H: int, W: int, focal: float) -> np.ndarray:
    """Camera-space directions (H*W, 3) float32 of the pixel corners, row
    after row (OpenGL: the camera looks along -z)."""
    us, vs = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    u, v = us.ravel(), vs.ravel()
    f = np.float32(_recip(focal))
    return np.stack([(u - np.float32(W / 2.0)) * f,
                     -((v - np.float32(H / 2.0)) * f),
                     -np.ones_like(u)], -1)


def rotate_dirs(dirs: torch.Tensor, c2w: torch.Tensor) -> torch.Tensor:
    """Unit world directions ``dirs @ c2w[:3, :3].T``, normalised, in plain
    float32: elementwise products summed left to right, so no matmul
    precision flag (TF32) can reach them. The norm's square root is taken
    in float64 and rounded, which gives the correctly rounded float32
    root on any device (PyTorch's vectorised CPU root is not)."""
    r = c2w[:3, :3]
    d = [dirs[:, 0] * r[i, 0] + dirs[:, 1] * r[i, 1] + dirs[:, 2] * r[i, 2]
         for i in range(3)]
    sq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    norm = torch.sqrt(sq.double()).float()
    return torch.stack([c / norm for c in d], dim=-1)


def _grid_on(grid, device) -> torch.Tensor:
    if torch.is_tensor(grid):
        return grid.to(device=device, dtype=torch.uint8)
    return torch.as_tensor(np.asarray(grid, np.uint8)).to(device)


def _chunks(fn, chunk: int, *xs):
    """``fn`` on ``chunk`` rows of every ``xs`` at a time (the JAX
    package's ``lax.map``), its outputs concatenated."""
    outs = [fn(*(x[i:i + chunk] for x in xs))
            for i in range(0, xs[0].shape[0], chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def partition(keep: torch.Tensor, count: int,
              idx: torch.Tensor) -> torch.Tensor:
    """The stable partition of ``keep`` (n,) bool (kept first, index order
    kept within each class), its first ``count`` indices; ``idx`` is
    ``arange(n)`` on the device. The argsort(~keep) permutation by cumsum
    slots and one scatter, no sort and no host read."""
    kept = keep.long().cumsum(0)          # cumsum(1 - keep) = i + 1 - kept
    slot = torch.where(keep, kept - 1, kept[-1] + idx - kept)
    return torch.empty_like(idx).scatter_(0, slot, idx)[:count]


def make_ngp_frame_renderer(
    apply_fn, H: int, W: int, focal: float, occupancy, s,
    n_candidates: int = 32, n_coarse: int = 16, n_fine: int = 16,
    capacity: float = 0.35, fine_capacity: float | None = None,
    probe_sub: int | str = 4, out_dtype=torch.uint8,
    return_stats: bool = False, mesh=None, return_depth: bool = False,
    n_fine2: int = 0, stage: str = "full", select_occupancy=None,
    occ_capacity: float | None = None, probe_stride: int = 1,
):
    """Build ``fn(c2w) -> rgb (H*W, 3)[, depth][, stats]``, a whole frame
    from a camera-to-world pose (4, 4) through the eval ``apply_fn(pts,
    viewdirs, model)`` (weights baked in; every sample goes through its
    "fine" branch). The frame runs on the device of the occupancy grid
    (a numpy grid: the CPU).

    Stages, with the reference's lines (ngp_renderer.py): rays from the
    pose; the span probe on a ``probe_sub`` pixel lattice (:331-345);
    stable active compaction to ``capacity`` x H*W rays (:347-363);
    ``n_coarse`` of ``n_candidates`` span positions picked by rank, the
    occupied ones first (:373-399); with ``occ_capacity``, a second
    compaction to the rays with an occupied candidate (:416-441); the
    coarse field and composite (:443-466); the ``fine_capacity`` x H*W
    most opaque rays (:476-484); ``n_fine`` (then ``n_fine2``)
    inverse-CDF samples merged with the coarse ones by a stable sort
    (:487-527); the scatter back (:529-560). ``stage`` "probe" or
    "coarse" stops after the compaction or the coarse composite.

    ``occupancy`` is ``(grid, bbox)`` or ``(grid, bbox, dilate)``
    (:func:`...ops.occupancy.build_occupancy_grid`), the grid dilated >= 2
    cells for ``probe_sub`` > 1; ``select_occupancy`` an optional finer
    grid for the candidate selection alone. ``probe_sub="auto"`` takes the
    largest lattice stride (of 8/5/4/2/1) whose ray divergence stays
    inside one grid cell; ``probe_stride`` widens the depth step to that
    many cells (sound up to 2*(dilate-1)+1).

    Shapes are fixed by the arguments, capacities rounded up to whole ray
    chunks (``s.ray_chunk``; ``fn.budget`` holds the ray counts): a frame
    reads nothing back to the host, and its ``stats`` (active, occupied
    and non-trivial ray counts, overflows) are 0-d tensors. ``mesh``
    (sharding a frame over devices) is not ported (ROADMAP.md item 9,
    multi-GPU) and raises.
    """
    if mesh is not None:
        raise NotImplementedError(
            "a frame sharded over a device mesh is not ported yet: "
            "ROADMAP.md item 9 (multi-GPU)")
    if n_coarse > n_candidates:
        # the rank selection would find no candidate for some samples
        raise ValueError(
            f"n_coarse={n_coarse} must be <= n_candidates={n_candidates}")
    if stage not in ("probe", "coarse", "full"):
        raise ValueError(f"stage must be probe, coarse or full, not {stage!r}")
    n = H * W
    chunk = min(s.ray_chunk, n)
    n_pad = (-n) % chunk
    n_full = n + n_pad
    k1 = min(n_full, -(-int(n_full * capacity) // chunk) * chunk)
    k1m = k1
    if occ_capacity is not None:
        k1m = min(k1, -(-int(n_full * occ_capacity) // chunk) * chunk)
    k2 = int(n_full * (fine_capacity if fine_capacity is not None
                       else capacity * 0.85))
    k2 = min(k1m, -(-k2 // chunk) * chunk)

    device = (occupancy[0].device if torch.is_tensor(occupancy[0])
              else torch.device("cpu"))
    grid = _grid_on(occupancy[0], device)
    bbox = tuple(float(b) for b in occupancy[1])
    dilate = int(occupancy[2]) if len(occupancy) > 2 else 2
    if select_occupancy is not None:
        sel_grid = _grid_on(select_occupancy[0], device)
        sel_bbox = tuple(float(b) for b in select_occupancy[1])
    else:
        sel_grid, sel_bbox = grid, bbox
    if dilate < 2:
        if probe_sub == "auto":
            probe_sub = 1       # auto degrades; an explicit > 1 is an error
        elif probe_sub > 1:
            raise ValueError(
                "ngp frame renderer: probe_sub > 1 needs a grid dilated "
                ">= 2 cells (1 probe step + 1 ray divergence); rebuild "
                "the grid with dilate>=2 or pass probe_sub=1")
    r = grid.shape[0]
    cell = max((bbox[3 + d] - bbox[d]) / r for d in range(3))
    if probe_stride > 1 and probe_stride > 2 * (dilate - 1) + 1:
        raise ValueError(
            f"probe_stride {probe_stride} too coarse for dilate={dilate}: "
            "occupied blobs are 1+2*dilate cells wide and a stride above "
            "2*(dilate-1)+1 can miss one")
    n_probe = int(np.ceil((s.far - s.near) / (cell * probe_stride))) + 1

    def ok_sub(q):
        return q == 1 or (q * s.far / focal <= cell
                          and H % q == 0 and W % q == 0)

    if probe_sub == "auto":
        sub = next(q for q in (8, 5, 4, 2, 1) if ok_sub(q))
    else:
        sub = probe_sub if ok_sub(probe_sub) else 1
    act = density_activation(s.density_activation)
    M, F, C, F2 = n_coarse, n_fine, n_candidates, n_fine2
    bg = 1.0 if s.white_bkgd else 0.0

    # host constants, copied to the device once: a copy inside a frame
    # would wait for the host
    dirs = torch.from_numpy(pixel_dirs(H, W, focal)).to(device)
    t_probe = torch.from_numpy(probe_depths(s.near, s.far, n_probe)).to(device)
    margin = 2.0 * ((s.far - s.near) / (n_probe - 1))   # two probe steps
    uu = torch.from_numpy(candidate_fractions(C)).to(device)
    ranks = torch.arange(C, device=device)
    picks = torch.arange(M, device=device)
    n_idx = torch.arange(n_full, device=device)
    k1_idx = torch.arange(k1, device=device)
    scale, sel_scale = box_scale(bbox, device), box_scale(sel_bbox, device)

    def pad(x):
        return torch.cat([x, x.new_zeros(n_pad, *x.shape[1:])]) \
            if n_pad else x

    def select(ro, rd, te, span):
        """``n_coarse`` of ``n_candidates`` depths a ray: occupied
        candidates first (ascending), unoccupied after, strided evenly
        through the occupied pool (:373-399), then sorted."""
        t_cand = te[:, None] + span[:, None] * uu[None, :]       # (c, C)
        p_cand = ro[:, None] + rd[:, None] * t_cand[..., None]
        occ_c = points_occupied(p_cand, sel_grid, sel_bbox, sel_scale)
        occ_cum = occ_c.long().cumsum(-1)   # cumsum(1 - occ) = k + 1 - occ_cum
        n_occd = occ_cum[:, -1]
        rank = torch.where(occ_c, occ_cum,
                           n_occd[:, None] + ranks + 1 - occ_cum)
        pool = torch.clamp(n_occd, min=M)
        pos = (picks[None, :] * pool[:, None]) // M + 1           # (c, M)
        by_rank = torch.empty_like(rank).scatter_(
            1, rank - 1, ranks.expand_as(rank))
        t_sel = t_cand.gather(1, by_rank.gather(1, pos - 1))
        return torch.sort(t_sel, dim=-1).values, n_occd

    def composite(raw, t, span):
        w = _gap_capped_weights(raw[..., 3], t, span, C, act)
        rgb = torch.sigmoid(raw[..., :3])
        acc = w.sum(-1)
        rgb_map = (w[..., None] * rgb).sum(-2)
        depth_map = (w * t).sum(-1)
        if s.white_bkgd:
            rgb_map = rgb_map + (1.0 - acc[..., None])
        return rgb_map, depth_map, acc

    def coarse_chunk(ro, rd, span, t_c):
        pts = ro[:, None] + rd[:, None] * t_c[..., None]
        raw = apply_fn(pts, rd[:, None], "fine")
        return (*composite(raw, t_c, span), raw)

    def fine_chunk(ro, rd, span, t_c, raw_c):
        def cdf_round(t_prev, raw_prev, n_new):
            """CDF over the merged samples -> ``n_new`` depths ->
            evaluate -> stable sorted merge (:490-505)."""
            w = _gap_capped_weights(raw_prev[..., 3], t_prev, span, C, act)
            w_bins = 0.5 * (w[..., :-1] + w[..., 1:])
            t_new = sample_pdf(t_prev, w_bins, n_new)
            pts = ro[:, None] + rd[:, None] * t_new[..., None]
            raw_new = apply_fn(pts, rd[:, None], "fine")
            t_all, order = torch.sort(torch.cat([t_prev, t_new], -1),
                                      dim=-1, stable=True)
            raw_all = torch.cat([raw_prev, raw_new], -2).gather(
                -2, order[..., None].expand(*order.shape, 4))
            return t_all, raw_all

        t_all, raw_all = cdf_round(t_c, raw_c, F)
        if F2 > 0:
            t_all, raw_all = cdf_round(t_all, raw_all, F2)
        rgb_map, depth_map, _ = composite(raw_all, t_all, span)
        return rgb_map, depth_map

    def scatter(values, at, fill, width=None):
        shape = (n_full,) if width is None else (n_full, width)
        out = torch.full(shape, fill, dtype=torch.float32, device=device)
        return out.index_copy_(0, at, values)

    @torch.inference_mode()
    def fn(c2w):
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
        rays_d = rotate_dirs(dirs, c2w)
        rays_o = c2w[:3, 3].expand(rays_d.shape)

        # --- span probe on the subsampled lattice (:331-345) ----------
        if sub > 1:
            rd_s = rays_d.reshape(H, W, 3)[sub // 2::sub, sub // 2::sub]
            rd_s = rd_s.reshape(-1, 3)
            act_s, te_s, tx_s = ray_spans(
                c2w[:3, 3].expand(rd_s.shape), rd_s, t_probe, grid, bbox,
                margin=margin, scale=scale)
            h, w = H // sub, W // sub

            def rep(x):
                return x.reshape(h, 1, w, 1).expand(h, sub, w, sub) \
                    .reshape(-1)

            active, t_enter, t_exit = rep(act_s), rep(te_s), rep(tx_s)
        else:
            active, t_enter, t_exit = ray_spans(
                rays_o, rays_d, t_probe, grid, bbox, margin=margin,
                scale=scale)
        active = pad(active)

        # --- active compaction (:347-363) ------------------------------
        sel1 = partition(active, k1, n_idx)
        ro1, rd1 = pad(rays_o)[sel1], pad(rays_d)[sel1]
        te1, tx1 = pad(t_enter)[sel1], pad(t_exit)[sel1]
        span1 = torch.clamp(tx1 - te1, min=1e-3)
        n_active = active.sum()
        stats = {"active_rays": n_active,
                 "coarse_overflow": torch.clamp(n_active - k1, min=0)}
        if stage == "probe":
            rgb = scatter(torch.stack([te1, tx1, span1], -1), sel1, 0.0, 3)
            return (rgb[:n], stats) if return_stats else rgb[:n]

        # --- candidate selection, no field eval (:373-409) -------------
        t_c1, n_occ = select(ro1, rd1, te1, span1)
        stats["mean_occupied_candidates"] = n_occ.float().mean()

        # --- mid-coarse compaction (:416-441) ---------------------------
        live1 = (sel1 < n) & active[sel1]
        if occ_capacity is not None:
            occ_any = live1 & (n_occ > 0)
            n_occ_rays = occ_any.sum()
            stats["occ_rays"] = n_occ_rays
            stats["occ_overflow"] = torch.clamp(n_occ_rays - k1m, min=0)
            sel1b = partition(occ_any, k1m, k1_idx)
            ro1b, rd1b = ro1[sel1b], rd1[sel1b]
            sp1b, t_c1b, live1b = span1[sel1b], t_c1[sel1b], occ_any[sel1b]
        else:
            sel1b = k1_idx
            ro1b, rd1b, sp1b, t_c1b, live1b = ro1, rd1, span1, t_c1, live1

        # --- coarse field eval and composite (:443-466) -----------------
        rgb1, depth1, acc1, raw_c1 = _chunks(coarse_chunk, chunk, ro1b, rd1b,
                                             sp1b, t_c1b)
        g1b = sel1[sel1b]
        rgb1 = torch.where(live1b[:, None], rgb1, bg)
        if stage == "coarse":
            rgb = scatter(rgb1, g1b, bg, 3)[:n]
            return (rgb, stats) if return_stats else rgb

        # --- fine-pass compaction by coarse opacity (:476-484) ----------
        # the first k2 of a stable descending sort: lax.top_k's order,
        # ties to the lower index
        acc_key = torch.where(live1b, acc1, -1.0)
        sel2 = torch.sort(acc_key, descending=True, stable=True).indices[:k2]
        n_nontrivial = (acc_key > 1e-3).sum()
        stats["nontrivial_rays"] = n_nontrivial
        stats["fine_overflow"] = torch.clamp(n_nontrivial - k2, min=0)

        # --- inverse-CDF fine rounds, sorted merge (:487-527) -----------
        fine_rgb, fine_depth = _chunks(
            fine_chunk, chunk, ro1b[sel2], rd1b[sel2], sp1b[sel2],
            t_c1b[sel2], raw_c1[sel2])

        # --- scatter back (:529-560): grid-proven empty rays are
        # background even where capacity slack took them in
        sel_full = g1b[sel2]
        act2 = live1b[sel2]
        rgb = scatter(rgb1, g1b, bg, 3)
        rgb = rgb.index_copy_(0, sel_full, torch.where(act2[:, None],
                                                       fine_rgb, bg))[:n]
        if out_dtype == torch.uint8:
            rgb = torch.round(torch.clamp(rgb, 0.0, 1.0) * 255.0).to(
                torch.uint8)
        else:
            rgb = rgb.to(out_dtype)
        out = (rgb,)
        if return_depth:
            depth = scatter(torch.where(live1b, depth1, 0.0), g1b, 0.0)
            depth = depth.index_copy_(
                0, sel_full, torch.where(act2, fine_depth, 0.0))[:n]
            out = out + (depth,)
        if return_stats:
            out = out + (stats,)
        return out if len(out) > 1 else out[0]

    # the static ray budgets: a full frame calls apply_fn
    # coarse_rays / chunk + fine_rays / chunk x fine_rounds times
    fn.budget = {"chunk": chunk, "rays": k1, "coarse_rays": k1m,
                 "fine_rays": k2, "fine_rounds": 2 if F2 > 0 else 1}
    return fn
