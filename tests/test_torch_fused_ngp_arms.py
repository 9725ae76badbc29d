"""Port parity for the fused NGP eval kernel's two arms and its 16-level
networks: the plain versions against the JAX package's fused_ngp_eval (the
Pallas kernel in interpret mode), the kernel's weight images against the
pack they are made from (decoded by the PTX fragment layouts, and one
layer's product formed fragment by fragment as the kernel forms it), and
the 3xTF32 emulation of the f32 arm's products against the f32 bound of
chip_smoke.py. Inputs are made from seeds with numpy."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_replication_tpu.config.cfg_node import CN as JaxCN
from nerf_replication_tpu.models.nerf.network import init_params
from nerf_replication_tpu.models.nerf.network import (
    make_network as jax_make_network,
)
from nerf_replication_tpu.models.nerf.renderer.ngp_renderer import (
    make_ngp_eval_apply as jax_make_ngp_eval_apply,
)
from nerf_replication_tpu.ops.pallas import fused_ngp as jax_fused
from nerf_replication_tpu.ops.pallas import hashgrid_kernel as jax_hk
from nerf_replication_tpu.ops.pallas.eval_encode import (
    pack_eval_table as jax_pack_eval_table,
)
import chip_smoke
from nerf_replication_tpu_torch.config import CN, make_cfg, parse_args
from nerf_replication_tpu_torch.models.nerf.network import make_network
from nerf_replication_tpu_torch.models.nerf.renderer import ngp_renderer
from nerf_replication_tpu_torch.ops import eval_encode, fused_ngp
from nerf_replication_tpu_torch.run import load_model
from nerf_replication_tpu_torch.utils import tracing
from nerf_replication_tpu_torch.utils.ckpt_utils import params_from_jax

ROOT = chip_smoke.ROOT


def cfg_dict(levels, width=16, degree=2, skips=(1,), log2_bricks=9,
             finest=64):
    """A brick-NGP network: D=3 with ``skips``, ``levels`` levels from 4
    cells a side up to ``finest``; tests/test_fused_ngp.py's 16-wide MLP
    by default."""
    return {
        "task_arg": {"use_viewdirs": True},
        "network": {
            "dtype": "float32",
            "nerf": {"W": width, "D": 3, "V_D": 1, "skips": list(skips)},
            "xyz_encoder": {
                "type": "cuda_hashgrid", "backend": "brick",
                "input_dim": 3, "num_levels": levels, "level_dim": 2,
                "base_resolution": 4, "desired_resolution": finest,
                "log2_hashmap_size": 10, "log2_bricks": log2_bricks,
                "bounds": [-1.2, -1.2, -1.2, 1.2, 1.2, 1.2],
            },
            "dir_encoder": {"type": "sphere_harmonics", "degree": degree},
        },
    }


@functools.cache
def both(levels, seed):
    """(jax net, jax params, port net) of :func:`cfg_dict`: JAX's init
    with every bias drawn from U(-0.5, 0.5) and the table from U(-1, 1)
    (seeded numpy), so that a bias's bf16 rounding shows in the outputs."""
    d = cfg_dict(levels)
    net = jax_make_network(JaxCN(d))
    params = jax.tree.map(np.asarray, jax.device_get(
        init_params(net, jax.random.key(seed))))
    g = np.random.default_rng(seed)
    for branch in ("coarse", "fine"):
        for layer in params["params"][branch].values():
            layer["bias"] = g.uniform(-0.5, 0.5, layer["bias"].shape).astype(
                np.float32)
    table = params["params"]["xyz_encoder"]["table"]
    params["params"]["xyz_encoder"]["table"] = g.uniform(
        -1, 1, table.shape).astype(np.float32)
    port = make_network(CN(d))
    port.load_state_dict(params_from_jax(params))
    return net, params, port


def samples(port, seed, n_rays=9, n_samples=5):
    """Points in [0,1] (N, 3) and per-point SH (N, n_sh) of seeded rays,
    as the fused route makes them."""
    g = np.random.default_rng(seed)
    pts = g.uniform(-1.3, 1.3, (n_rays, n_samples, 3)).astype(np.float32)
    dirs = g.normal(size=(n_rays, 1, 3)).astype(np.float32)
    return ngp_renderer.fused_inputs(port, torch.from_numpy(pts),
                                     torch.from_numpy(dirs))


def test_plain_fused_matches_jax_at_16_levels(monkeypatch):
    """16 levels (32 encoded features), every level at most 512 rows, so
    JAX's make_ngp_eval_apply takes its fused Pallas kernel: the port's
    plain fused version on the same weights and points. Both read the same
    bf16 table values and multiply in f32; sums run in other orders: atol
    1e-5 + rtol 1e-5."""
    monkeypatch.setenv("NGP_FUSED", "1")
    net, params, port = both(16, 0)
    layout = port.xyz_encoder.layout
    assert len(layout.scales) == 16 and max(
        b - a for a, b in zip(layout.offsets, layout.offsets[1:])) <= 512
    g = np.random.default_rng(7)
    pts = g.uniform(-1.3, 1.3, (9, 5, 3)).astype(np.float32)
    dirs = g.normal(size=(9, 1, 3)).astype(np.float32)
    expect = jax_make_ngp_eval_apply(net, params)(
        params, jnp.asarray(pts), jnp.asarray(dirs), "fine")
    ops, meta = fused_ngp.extract_mlp_weights(
        port.fine.state_dict(), 32, 3, (1,), 1)
    x, sh = ngp_renderer.fused_inputs(port, torch.from_numpy(pts),
                                      torch.from_numpy(dirs))
    out = fused_ngp.fused_ngp_eval(
        layout, meta,
        eval_encode.pack_eval_table(port.xyz_encoder.table.detach()), ops,
        x, sh)
    assert out.shape == (45, 4)
    np.testing.assert_allclose(out.reshape(9, 5, 4).detach().numpy(),
                               np.asarray(expect), atol=1e-5, rtol=1e-5)


# The bf16 arm, plain version against JAX: both multiply the same bf16
# operands exactly and sum in f32, and both round the encoded features to
# bf16; the features come from sums in other orders (the encode against
# JAX's selector matmul), which moves an output by f32 rounding unless it
# moves a feature across a bf16 rounding boundary (none does here). Read
# <= 1.0e-7 of a column's range over seeds 1-3 at 300 points; the f32-bias
# control 6.7e-3 to 1.1e-2, the f32 arm 6.9e-3 to 9.2e-3.
BF16_COL_RTOL = 1e-5


def _bf16_vs_jax(params, x, sh, levels):
    """JAX's fused_ngp_eval(..., mlp_bf16=True) of the fine branch of
    :func:`cfg_dict`'s network with ``params`` on the port's x and sh."""
    jax_layout = jax_hk.make_brick_layout(levels, 4, 64, log2_bricks=9)
    packed = jax_pack_eval_table(jnp.asarray(
        params["params"]["xyz_encoder"]["table"]))
    ops, meta = jax_fused.extract_mlp_weights(
        params["params"]["fine"], 2 * levels, 3, (1,), 1)
    return np.asarray(jax_fused.fused_ngp_eval(
        jax_layout, meta, packed, ops, jnp.asarray(x.numpy()),
        jnp.asarray(sh.numpy()), 1024, True))


def _col_err(out, ref):
    ref = np.asarray(ref)
    return float((np.abs(np.asarray(out) - ref).max(0)
                  / np.abs(ref).max(0)).max())


def test_plain_bf16_arm_matches_jax(monkeypatch):
    """The bf16 arm (``mlp_bf16=True``, reference fused_ngp.py:165-171)
    of the plain version against JAX's fused_ngp_eval(..., mlp_bf16=True)
    in interpret mode, within BF16_COL_RTOL of each column's range; the
    same plain version with its biases left in f32 must fail that bound."""
    _, params, port = both(3, 1)
    layout = port.xyz_encoder.layout
    x, sh = samples(port, 3)
    expect = _bf16_vs_jax(params, x, sh, 3)
    ops, meta = fused_ngp.extract_mlp_weights(
        port.fine.state_dict(), 6, 3, (1,), 1)
    packed = eval_encode.pack_eval_table(port.xyz_encoder.table.detach())
    calls = tracing.counts["fused_ngp_eval_reference.calls"]
    out = fused_ngp.fused_ngp_eval(layout, meta, packed, ops, x, sh,
                                   mlp_bf16=True)
    assert tracing.counts["fused_ngp_eval_reference.calls"] == calls + 1
    assert _col_err(out, expect) <= BF16_COL_RTOL
    monkeypatch.setattr(fused_ngp, "_round_bias", lambda b: b)
    control = fused_ngp.fused_ngp_eval(layout, meta, packed, ops, x, sh,
                                       mlp_bf16=True)
    assert _col_err(control, expect) > BF16_COL_RTOL
    f32 = fused_ngp.fused_ngp_eval(layout, meta, packed, ops, x, sh)
    assert _col_err(f32, expect) > BF16_COL_RTOL


def _lanes():
    lane = np.arange(32)
    return lane // 4, lane % 4


def _decode_tf32(words, rows, cols, permuted):
    """The f32 arm's fragments of a (rows, cols) matrix -> (big, small),
    each (rows, cols), by the PTX layout of a TF32 B fragment (b0 at K row
    t, b1 at t + 4, column g) and the row order [0, 2, 4, 6, 1, 3, 5, 7]
    within each block of 8 where ``permuted``."""
    f = words.reshape(rows // 8, cols // 8, 32, 4)
    order = [0, 2, 4, 6, 1, 3, 5, 7] if permuted else list(range(8))
    big, small = np.full((2, rows, cols), np.nan, np.float32)
    g, t = _lanes()
    for kb in range(rows // 8):
        for nt in range(cols // 8):
            for r, (bi, si) in ((t, (0, 2)), (t + 4, (1, 3))):
                k = kb * 8 + np.array(order)[r]
                big[k, nt * 8 + g] = f[kb, nt, :, bi]
                small[k, nt * 8 + g] = f[kb, nt, :, si]
    return big, small


def _decode_bf16(words, rows, cols):
    """The bf16 arm's fragments -> the (rows rounded up to 16, cols) f32
    values they hold: b0 holds K rows 2t, 2t + 1 and b1 rows 2t + 8, 2t + 9
    of column g, the lower row in the low half; n-tiles in pairs."""
    k = -(-rows // 16) * 16
    w = words.view(np.uint32).reshape(k // 16, cols // 16, 32, 2, 2)
    out = np.full((k, cols), np.nan, np.float32)
    g, t = _lanes()
    for kb in range(k // 16):
        for j in range(cols // 16):
            for half in range(2):
                n = (2 * j + half) * 8 + g
                for reg, r in ((0, 2 * t), (1, 2 * t + 8)):
                    word = w[kb, j, :, half, reg]
                    out[kb * 16 + r, n] = (word << 16).view(np.float32)
                    out[kb * 16 + r + 1, n] = (word & 0xFFFF0000).view(
                        np.float32)
    return out


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


@pytest.mark.parametrize("levels,skips", [(12, (1,)), (16, (1,)),
                                          (12, (0, 2)), (16, (0, 1))])
def test_weight_images_map_back_to_the_pack(levels, skips):
    """Both arms' images of a kernel-sized branch (W=64, degree-4 SH),
    decoded segment by segment, give back MLPOps.flat: on the f32 arm every
    matrix as big + small with big = tf32(w) (the low 13 bits zero) and
    small = tf32(w - big), so big + small is w to within small's TF32
    rounding; on the bf16 arm every matrix and vector rounded to bf16
    (zero rows up to a multiple of 16); the f32 arm's vectors as they
    are."""
    port = make_network(CN(cfg_dict(levels, 64, 4, skips, log2_bricks=6)))
    g = np.random.default_rng(levels)
    with torch.no_grad():
        for p in port.fine.parameters():
            p.copy_(torch.from_numpy(g.normal(0, 0.5, p.shape).astype(
                np.float32)))
    n_feat = 2 * levels
    ops, meta = fused_ngp.extract_mlp_weights(
        port.fine.state_dict(), n_feat, 3, skips, 1)
    flat = ops.flat.numpy()
    images = {False: ops.image.numpy(), True: ops.image_bf16.numpy()}
    at = {False: 0, True: 0}
    pos = 0
    for rows, cols, reads in fused_ngp.pack_segments(meta, n_feat):
        w = flat[pos:pos + rows * cols].reshape(rows, cols)
        pos += rows * cols
        for bf16, image in images.items():
            if reads is None:
                got = image[at[bf16]:at[bf16] + rows * cols].reshape(
                    rows, cols)
                np.testing.assert_array_equal(got, _bf16(w) if bf16 else w)
                at[bf16] += rows * cols
            elif bf16:
                size = -(-rows // 16) * 16 * cols // 2
                got = _decode_bf16(image[at[bf16]:at[bf16] + size], rows, cols)
                np.testing.assert_array_equal(got[:rows], _bf16(w))
                assert not got[rows:].any()
                at[bf16] += size
            else:
                size = 2 * rows * cols
                big, small = _decode_tf32(image[at[bf16]:at[bf16] + size],
                                          rows, cols, reads == "h")
                assert not (big.view(np.uint32) & 0x1FFF).any()
                assert not (small.view(np.uint32) & 0x1FFF).any()
                np.testing.assert_array_equal(
                    big, fused_ngp._tf32(torch.from_numpy(w)).numpy())
                rest = w.astype(np.float64) - big
                assert (np.abs(rest - small)
                        <= 2.0 ** -11 * np.abs(rest)).all()
                at[bf16] += size
    assert pos == flat.size
    assert at == {False: images[False].size, True: images[True].size}
    assert fused_ngp.shared_memory_bytes(meta, n_feat) == \
        4 * images[False].size + 8 * 32 * (fused_ngp.feat_pad(n_feat) + 20) * 4


@pytest.mark.parametrize("mlp_bf16", [False, True])
def test_one_layer_through_the_fragments(mlp_bf16):
    """One 64 -> 64 trunk layer of 16 points formed as the kernel forms it:
    the activation held in m16n8 accumulators (c0, c1 at row g, columns
    2t, 2t + 1 of each n-tile; c2, c3 at row g + 8), A fragments taken from
    them as csrc/fused_ngp.cu takes them, B fragments from the image, each
    mma per the PTX fragment layouts, in float64. The f32 arm's three TF32
    products match h . W to 2^-20 of the sum of |products|; the bf16 arm's
    product is bf16(h) . bf16(W)."""
    g_rng = np.random.default_rng(5)
    port = make_network(CN(cfg_dict(12, 64, 4, log2_bricks=6)))
    with torch.no_grad():
        for p in port.fine.parameters():
            p.copy_(torch.from_numpy(g_rng.normal(0, 0.5, p.shape).astype(
                np.float32)))
    ops, meta = fused_ngp.extract_mlp_weights(
        port.fine.state_dict(), 24, 3, (1,), 1)
    # layer 1's Wh (64, 64): the third segment of the pack
    words = [r * c if reads is None else
             -(-r // 16) * 16 * c // 2 if mlp_bf16 else 2 * r * c
             for r, c, reads in fused_ngp.pack_segments(meta, 24)]
    w = ops.flat.numpy()[24 * 64 + 64:24 * 64 + 64 + 64 * 64].reshape(64, 64)
    image = (ops.image_bf16 if mlp_bf16 else ops.image).numpy()
    frag = image[sum(words[:2]):sum(words[:3])]
    h = np.abs(g_rng.normal(size=(16, 64))).astype(np.float32)
    g, t = _lanes()
    # the accumulators of h: c[lane][nt][i]
    c = np.zeros((32, 8, 4))
    for nt in range(8):
        c[:, nt, 0] = h[g, 8 * nt + 2 * t]
        c[:, nt, 1] = h[g, 8 * nt + 2 * t + 1]
        c[:, nt, 2] = h[g + 8, 8 * nt + 2 * t]
        c[:, nt, 3] = h[g + 8, 8 * nt + 2 * t + 1]
    d = np.zeros((16, 64))
    if mlp_bf16:
        f = frag.view(np.uint32).reshape(4, 4, 32, 4)
        for kb in range(4):
            # A (16 x 16) from the accumulators of n-tiles 2kb, 2kb + 1
            a = np.zeros((16, 16))
            for half, nt in ((0, 2 * kb), (1, 2 * kb + 1)):
                a[g, 8 * half + 2 * t] = _bf16(c[:, nt, 0])
                a[g, 8 * half + 2 * t + 1] = _bf16(c[:, nt, 1])
                a[g + 8, 8 * half + 2 * t] = _bf16(c[:, nt, 2])
                a[g + 8, 8 * half + 2 * t + 1] = _bf16(c[:, nt, 3])
            for j in range(4):
                for half in range(2):
                    b = np.zeros((16, 8))
                    for reg, r in ((0, 2 * t), (1, 2 * t + 8)):
                        word = f[kb, j, :, 2 * half + reg]
                        b[r, g] = (word << 16).view(np.float32)
                        b[r + 1, g] = (word & 0xFFFF0000).view(np.float32)
                    n0 = (2 * j + half) * 8
                    d[:, n0:n0 + 8] += a @ b
        np.testing.assert_allclose(d, _bf16(h).astype(np.float64)
                                   @ _bf16(w).astype(np.float64),
                                   rtol=1e-12, atol=1e-12)
    else:
        f = frag.reshape(8, 8, 32, 4)
        tf32 = lambda v: fused_ngp._tf32(  # noqa: E731
            torch.from_numpy(np.asarray(v, np.float32))).numpy()
        for kb in range(8):
            # A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
            # a3 (g + 8, t + 4) <- the kernel's c0, c2, c1, c3
            a = np.zeros((16, 8))
            a[g, t], a[g + 8, t] = c[:, kb, 0], c[:, kb, 2]
            a[g, t + 4], a[g + 8, t + 4] = c[:, kb, 1], c[:, kb, 3]
            a_big = tf32(a)
            a_small = tf32(a - a_big)
            for nt in range(8):
                b_big, b_small = np.zeros((2, 8, 8))
                b_big[t, g], b_big[t + 4, g] = f[kb, nt, :, 0], f[kb, nt, :, 1]
                b_small[t, g], b_small[t + 4, g] = (f[kb, nt, :, 2],
                                                    f[kb, nt, :, 3])
                d[:, 8 * nt:8 * nt + 8] += (a_small @ b_big + a_big @ b_small
                                            + a_big @ b_big)
        exact = h.astype(np.float64) @ w.astype(np.float64)
        scale = np.abs(h).astype(np.float64) @ np.abs(w).astype(np.float64)
        assert (np.abs(d - exact) <= 2.0 ** -20 * scale).all()


def test_3xtf32_emulation_meets_the_f32_bound(monkeypatch):
    """The f32 arm's products as the kernel forms them (matmul_3xtf32,
    TF32 by bit masks) on data/pretrain/hard_ngp_b9's coarse branch at
    4096 points of rays through the scene: within chip_smoke.py's
    NGP_BOUNDS.col_rtol (1e-5) of each column's range against the f32
    plain version (read 1.2e-6); one TF32 product (matmul_tf32) is not
    (read 3.1e-3)."""
    monkeypatch.chdir(ROOT)
    net = load_model(make_cfg(parse_args(chip_smoke.NGP_ARGV[:-2] + [
        "device", "cpu"])), torch.device("cpu"))
    g = np.random.default_rng(0)
    eye = g.normal(size=(4096, 3))
    eye = 4.0 * eye / np.linalg.norm(eye, axis=-1, keepdims=True)
    d = -eye / 4.0 + 0.3 * g.normal(size=(4096, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = torch.tensor(0.3 * (eye + g.uniform(2, 6, (4096, 1)) * d),
                       dtype=torch.float32)
    x, sh = ngp_renderer.fused_inputs(
        net, pts[:, None], torch.tensor(d, dtype=torch.float32)[:, None])
    layout = net.xyz_encoder.layout
    packed = eval_encode.pack_eval_table(net.xyz_encoder.table.detach())
    ops, meta = fused_ngp.extract_mlp_weights(
        net.coarse.state_dict(), 24, 3, (1,), 1)
    with torch.no_grad():
        ref = fused_ngp.fused_ngp_eval_reference(layout, meta, packed, ops,
                                                 x, sh)
        errs = {}
        for mm in (fused_ngp.matmul_3xtf32, fused_ngp.matmul_tf32):
            monkeypatch.setattr(fused_ngp, "_matmul", mm)
            errs[mm.__name__] = _col_err(fused_ngp.fused_ngp_eval_reference(
                layout, meta, packed, ops, x, sh), ref)
    bound = chip_smoke.NGP_BOUNDS.col_rtol
    assert errs["matmul_3xtf32"] <= bound < errs["matmul_tf32"], errs


def test_16_level_network_takes_the_fused_route():
    """A lego_ngp-shaped network (16 levels, W=64, D=3, skip [1], degree-4
    SH): the fused kernel covers it (32 encoded features, both arms' images
    within shared memory), and make_ngp_eval_apply gives finite raw
    outputs on the CPU in both arms, where it used to raise."""
    port = make_network(CN(cfg_dict(16, 64, 4, log2_bricks=6)))
    assert ngp_renderer.unsupported(port) is None
    ops, meta = fused_ngp.extract_mlp_weights(
        port.fine.state_dict(), 32, 3, (1,), 1)
    assert ops.image is not None and ops.image_bf16 is not None
    assert fused_ngp.shared_memory_bytes(meta, 32) <= fused_ngp.SMEM_LIMIT
    pts = torch.from_numpy(np.random.default_rng(2).uniform(
        -1.3, 1.3, (4, 6, 3)).astype(np.float32))
    dirs = torch.nn.functional.normalize(torch.ones(4, 1, 3), dim=-1)
    for mlp_bf16 in (False, True):
        apply = ngp_renderer.make_ngp_eval_apply(port, mlp_bf16=mlp_bf16)
        raw = apply(pts, dirs, "fine")
        assert raw.shape == (4, 6, 4) and bool(torch.isfinite(raw).all())
    with pytest.raises(ValueError, match="arm of the fused kernel"):
        ngp_renderer.make_ngp_eval_apply(port, fused=False, mlp_bf16=True)
