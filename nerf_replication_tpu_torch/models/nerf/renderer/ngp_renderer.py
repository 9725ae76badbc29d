"""Eval apply of the brick-NGP model family, the counterpart of
``make_ngp_eval_apply`` in
nerf_replication_tpu/models/nerf/renderer/ngp_renderer.py:71-172.

It routes a brick hash-grid network's eval calls through the CUDA kernels:
with ``fused`` (the default) the whole field goes through
``fused_ngp_eval`` (encode + MLP in one kernel, SH computed per ray and
broadcast per point); without it (the JAX package's ``NGP_FUSED=0``) the
encode goes through ``brick_encode_eval`` and the branch's ``nn.Module``
MLP runs on its features. The JAX package falls back to the unfused chain
where its fused TPU kernel does not fit; here a network the fused kernel
does not cover raises, and the unfused chain is asked for by name.

Not ported yet: the occupancy-raymarch frame renderer
(``make_ngp_frame_renderer``, ROADMAP.md item A.8).
"""

from __future__ import annotations

from ....ops import eval_encode, fused_ngp
from ...encoding.hashgrid import HashGridEncoder


def is_brick_ngp(net) -> bool:
    return isinstance(net.xyz_encoder, HashGridEncoder)


def unsupported(net) -> str | None:
    """What of ``net`` (a brick-NGP Network) the fused kernel does not
    cover, or None."""
    if not net.use_viewdirs:
        return "a network without view directions"
    for mlp in (net.coarse, net.fine):
        reason = fused_ngp.unsupported_mlp(
            mlp.width, net.xyz_encoder.output_dim, net.dir_encoder.output_dim,
            mlp.depth, mlp.view_depth)
        if reason is not None:
            return reason
        if not all(0 <= s < mlp.depth for s in mlp.skips):
            return f"skips {list(mlp.skips)} outside depth {mlp.depth}"
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


def make_ngp_eval_apply(net, fused: bool = True):
    """Eval ``apply_fn(pts, viewdirs, model)`` for a brick-NGP ``net`` (a
    port Network), with the table packed and the weights baked now; on a
    CUDA network the kernel is built now, so a failed build raises. None
    when ``net`` is not a brick-NGP network; with ``fused`` a network the
    fused kernel does not cover raises (``unsupported`` says why)."""
    if not is_brick_ngp(net):
        return None
    enc = net.xyz_encoder
    layout = enc.layout
    packed = eval_encode.pack_eval_table(enc.table.detach())
    on_cuda = packed.device.type == "cuda"
    if not fused:
        if on_cuda:
            eval_encode.build()

        def apply_unfused(pts, viewdirs, model=""):
            shape = pts.shape[:-1]
            x = enc.to_unit(pts.reshape(-1, 3).float()).contiguous()
            feat = eval_encode.brick_encode_eval(layout, packed, x)
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
        raw = fused_ngp.fused_ngp_eval(layout, meta, packed, ops, x, sh)
        return raw.reshape(*pts.shape[:-1], 4)

    return apply_fused
