"""Port parity: the differentiable fused MLP (ops/mlp_train.py, plain
versions on the CPU) against the JAX package's fused_nerf_mlp_diff in
interpret mode (nerf_replication_tpu/ops/pallas/mlp_train.py), at the sizes
of tests/test_mlp_train_kernel.py; an f64 structural oracle of the plain
backward; padding and input gradients; and the power of chip_smoke.py's
backward check. The CUDA kernels are compared with these plain versions on
a GPU by tests/test_torch_cuda.py and chip_smoke.py."""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from nerf_replication_tpu.models.nerf.network import NeRFMLP as JaxMLP
from nerf_replication_tpu.ops.pallas.mlp_train import (
    fused_nerf_mlp_diff as jax_fused_diff,
)
from nerf_replication_tpu.ops.pallas.mlp_train import pack_params_jnp
from nerf_replication_tpu_torch.config import default_cfg, load_cfg_tree
from nerf_replication_tpu_torch.models.nerf.dnerf_network import DeformMLP
from nerf_replication_tpu_torch.models.nerf.network import NeRFMLP, make_network
from nerf_replication_tpu_torch.ops import (
    deform_mlp,
    mlp_kernel,
    mlp_train,
    tile_mlp,
)
from nerf_replication_tpu_torch.utils import tracing
from nerf_replication_tpu_torch.utils.ckpt_utils import (
    load_pretrain,
    params_from_jax,
)

DEPTH, SKIP = 4, 1
IN, VIEW = 63, 27
N = 130
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_mlp(params, dtype=torch.float32) -> NeRFMLP:
    """A port NeRFMLP holding the Flax branch ``params``."""
    mlp = NeRFMLP(IN, VIEW, depth=DEPTH, skips=(SKIP,), dtype=dtype)
    state = params_from_jax({"params": {"b": params}})
    mlp.load_state_dict({k[2:]: v for k, v in state.items()})
    return mlp.to(dtype)


@pytest.fixture(scope="module")
def setup():
    """Flax params of a depth-4 branch, numpy inputs and cotangent."""
    g = np.random.default_rng(0)
    x = g.normal(size=(N, IN)).astype(np.float32)
    v = g.normal(size=(N, VIEW)).astype(np.float32)
    cot = g.normal(size=(N, 4)).astype(np.float32)
    jmlp = JaxMLP(depth=DEPTH, width=256, view_depth=1, skips=(SKIP,),
                  use_viewdirs=True, dtype=jnp.float32)
    params = jmlp.init(jax.random.key(0), jnp.asarray(x),
                       jnp.asarray(v))["params"]
    params = jax.tree.map(np.asarray, params)
    return jmlp, params, x, v, cot


def _features(x, v):
    """numpy f32 features -> the kernels' bf16 (N, 64), (N, 32) inputs."""
    return (F.pad(torch.from_numpy(x), (0, 64 - IN)).to(torch.bfloat16),
            F.pad(torch.from_numpy(v), (0, 32 - VIEW)).to(torch.bfloat16))


def _jax_fused(params, x, v):
    weights, (in_pad, view_pad, d, sk) = pack_params_jnp(
        params, IN, VIEW, depth=DEPTH, skips=(SKIP,))
    return jax_fused_diff((in_pad, view_pad, d, sk, 128), weights, x, v)


def test_forward_matches_jax_kernel(setup):
    """Plain features-in forward vs the JAX Pallas forward: the same
    rounding points, so only f32 summation order differs; relative to each
    column's range almost every output agrees to 1e-5 and all to 1e-2."""
    _, params, x, v, _ = setup
    ref = np.asarray(_jax_fused(params, jnp.asarray(x), jnp.asarray(v)))
    xb, vb = _features(x, v)
    with torch.no_grad():
        out = mlp_train.fused_nerf_mlp_diff(_port_mlp(params), xb, vb, IN,
                                            VIEW).numpy()
    err = np.abs(out - ref) / np.abs(ref).max(axis=0)
    assert err.max() <= 1e-2
    assert np.mean(err <= 1e-5) >= 0.95


def _rel_errs(grads: dict, params) -> dict:
    """Relative-norm error of each port parameter gradient (nn.Linear
    layout) against the Flax gradient tree ``params``."""
    out = {}
    for name, leaf in params.items():
        for k, ref in leaf.items():
            ref = np.asarray(ref)
            key = name.replace("_", ".") + (".weight" if k == "kernel"
                                            else ".bias")
            got = grads[key].numpy()
            got = got.T if k == "kernel" else got
            out[f"{name}/{k}"] = (np.linalg.norm(got - ref)
                                  / (np.linalg.norm(ref) + 1e-12))
    return out


def test_param_grads_match_jax_kernel(setup):
    """Parameter gradients through the autograd Function (plain backward
    on the CPU) vs jax.grad through the JAX custom VJP (Pallas backward in
    interpret mode) on the same cotangent. Same rounding points both
    ways; summation order flips a bf16 rounding of a delta now and then,
    which moves a leaf's gradient by well under 1% of its norm (read:
    4.5e-4 at most), against the ~10% that bf16 against f32 deltas makes
    at this depth (tests/test_mlp_train_kernel.py)."""
    _, params, x, v, cot = setup
    g_ref = jax.grad(lambda p: jnp.sum(
        _jax_fused(p, jnp.asarray(x), jnp.asarray(v)) * jnp.asarray(cot)))(
        params)
    mlp = _port_mlp(params)
    xb, vb = _features(x, v)
    raw = mlp_train.fused_nerf_mlp_diff(mlp, xb, vb, IN, VIEW)
    (raw * torch.from_numpy(cot)).sum().backward()
    errs = _rel_errs({k: p.grad for k, p in mlp.named_parameters()}, g_ref)
    assert max(errs.values()) < 5e-3, errs


def test_backward_structure_exact_in_f64(setup):
    """STRUCTURAL oracle: the plain backward with every bf16 rounding
    replaced by float64, mapped to the parameters by autograd through the
    pack's gathers (``tile_mlp.gather``), against jax.grad of the Flax
    net: a missing term (such as the density head's path into the trunk),
    a wrong transpose, a relu-mask off-by-one or a wrong pack offset fails
    at 1e-5."""
    jmlp, params, x, v, cot = setup
    g_ref = jax.grad(lambda p: jnp.sum(
        jmlp.apply({"params": p}, jnp.asarray(x), jnp.asarray(v))
        * jnp.asarray(cot)))(params)

    def take(flat, at, rows, cols):
        return flat[at:at + rows * cols].view(rows, cols).double(), \
            at + rows * cols

    mlp = _port_mlp(params, torch.float64)
    lay = mlp_kernel.layout(DEPTH, SKIP, IN, VIEW)
    w, b = tile_mlp.gather(lay, tile_mlp.params_of(
        lay, dict(mlp.named_parameters())))
    packed = tile_mlp.Pack(w.detach(), b.detach(), lay)
    xd = F.pad(torch.from_numpy(x).double(), (0, 64 - IN))
    vd = F.pad(torch.from_numpy(v).double(), (0, 32 - VIEW))
    to64 = lambda t: t.double()  # noqa: E731
    with mock.patch.object(mlp_train, "_bf16", to64), \
            mock.patch.object(mlp_train, "_round_delta", to64), \
            mock.patch.object(tile_mlp, "_take", take):
        gw, gb = mlp_train.fused_nerf_mlp_bwd_reference(
            packed, xd, vd, torch.from_numpy(cot).double())
    torch.autograd.backward((w, b), (gw, gb))
    errs = _rel_errs({k: p.grad for k, p in mlp.named_parameters()}, g_ref)
    assert max(errs.values()) < 1e-5, errs


def test_padding_grads_are_exactly_zero(setup):
    """Row 63 of W0 and W_ix, rows 27..31 of Wv_d, columns 3..15 of W_rgb,
    b_alpha[1:] and b_rgb[3:] get exactly zero gradient."""
    _, params, x, v, cot = setup
    mlp = _port_mlp(params)
    packed = tile_mlp.pack(mlp_kernel.layout(DEPTH, SKIP, IN, VIEW),
                           mlp.state_dict())
    keep = {}
    grads = mlp_train.fused_nerf_mlp_bwd(packed, *_features(x, v),
                                         torch.from_numpy(cot), keep)
    planes = keep["planes"]
    a = chip_smoke.backward_agreement(grads, grads, planes, planes, packed)
    assert a["pad_zero"] and a["ok"]
    for leaf, at in (("b_rgb[15]", -1), ("W0 row 63", 63 * 256)):
        bumped = (grads[0].clone(), grads[1].clone())
        bumped[1 if leaf.startswith("b") else 0][at] = 1e-30
        assert not chip_smoke.backward_agreement(
            bumped, grads, planes, planes, packed)["pad_zero"], leaf


def test_input_grads_are_zero_by_contract(setup):
    """The directions' gradient is zero by contract. The encoded points'
    is formed only where x needs one (a D-NeRF's moved points): then it is
    the plain backward's input gradient, and never zeros."""
    _, params, x, v, _ = setup
    xb, vb = _features(x, v)
    vb.requires_grad_(True)
    xb.requires_grad_(True)
    raw = mlp_train.fused_nerf_mlp_diff(_port_mlp(params), xb, vb, IN, VIEW)
    raw.sum().backward()
    assert vb.grad is not None and float(vb.grad.abs().max()) == 0.0
    packed = tile_mlp.pack(mlp_kernel.layout(DEPTH, SKIP, IN, VIEW),
                           _port_mlp(params).state_dict())
    *_, want = mlp_train.fused_nerf_mlp_bwd_reference(
        packed, xb.detach(), vb.detach(), torch.ones(N, 4),
        with_input_grad=True)
    assert float(xb.grad.float().abs().max()) > 0
    assert torch.equal(xb.grad, want.to(torch.bfloat16))


def test_wrappers_take_the_plain_versions_on_cpu(setup):
    _, params, x, v, cot = setup
    counts = (tracing.counts["fused_nerf_mlp.launches"],
              tracing.counts["fused_nerf_mlp_bwd.launches"],
              tracing.counts["fused_nerf_mlp_reference.calls"],
              tracing.counts["fused_nerf_mlp_bwd_reference.calls"])
    raw = mlp_train.fused_nerf_mlp_diff(_port_mlp(params), *_features(x, v),
                                        IN, VIEW)
    (raw * torch.from_numpy(cot)).sum().backward()
    assert (tracing.counts["fused_nerf_mlp.launches"],
            tracing.counts["fused_nerf_mlp_bwd.launches"],
            tracing.counts["fused_nerf_mlp_reference.calls"],
            tracing.counts["fused_nerf_mlp_bwd_reference.calls"]) == (
        counts[0], counts[1], counts[2] + 1, counts[3] + 1)


def _lego_cfg():
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        return load_cfg_tree("configs/nerf/lego.yaml", default_cfg())
    finally:
        os.chdir(cwd)


def test_train_apply_constructor():
    """make_fused_train_apply wires the kernels for the canonical network
    (its raw output is the eval plain version's on the same points) and
    returns None exactly where mlp_kernel.unsupported names something."""
    cfg = _lego_cfg()
    net = make_network(cfg)
    apply_fn = mlp_train.make_fused_train_apply(net)
    assert apply_fn is not None and mlp_kernel.unsupported(net) is None
    g = torch.Generator().manual_seed(1)
    pts = torch.randn(4, 6, 3, generator=g)
    dirs = torch.nn.functional.normalize(torch.randn(4, 1, 3, generator=g),
                                         dim=-1)
    raw = apply_fn(pts, dirs, "fine")
    ref = mlp_kernel.make_fused_apply(net)(pts, dirs.expand(4, 6, 3), "fine")
    torch.testing.assert_close(raw.detach(), ref, atol=0, rtol=0)

    cfg.network.nerf.W = 128   # non-canonical width
    net2 = make_network(cfg)
    assert mlp_kernel.unsupported(net2) is not None
    assert mlp_train.make_fused_train_apply(net2) is None


def _plain_bwd_f64_sums(packed, x, v, g):
    """The plain backward with float64 sums and the same bf16 rounding
    points: a summation order other than the f32 version's, as the CUDA
    kernel's is. (gradients, planes)."""
    def take(flat, at, rows, cols):
        return flat[at:at + rows * cols].view(rows, cols).double(), \
            at + rows * cols

    bf = lambda t: t.to(torch.bfloat16).double()  # noqa: E731
    keep = {}
    with mock.patch.object(tile_mlp, "_take", take), \
            mock.patch.object(mlp_train, "_bf16", bf), \
            mock.patch.object(mlp_train, "_round_delta", bf):
        gw, gb = mlp_train.fused_nerf_mlp_bwd_reference(
            packed, x.double(), v.double(), g.double(), keep)
    return (gw.float(), gb.float()), keep["planes"]


@pytest.fixture(scope="module")
def trained_batch():
    """The trained coarse branch of data/pretrain/hard, 4096 ray points
    with a cotangent shaped like dloss/draw (small, density column
    larger), and the plain backward's gradients and planes."""
    cfg = _lego_cfg()
    net = make_network(cfg)
    net.load_state_dict(params_from_jax(
        load_pretrain(os.path.join(ROOT, "data", "pretrain", "hard"))))
    packed = tile_mlp.pack(mlp_kernel.layout_of(net), net.coarse.state_dict())
    g = np.random.default_rng(5)
    eye = g.normal(size=(4096, 3))
    eye = 4.0 * eye / np.linalg.norm(eye, axis=-1, keepdims=True)
    d = -eye / 4.0 + 0.3 * g.normal(size=(4096, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = eye + g.uniform(2.0, 6.0, size=(4096, 1)) * d
    x, v = mlp_kernel.encode_features(torch.tensor(pts, dtype=torch.float32),
                                      torch.tensor(d, dtype=torch.float32),
                                      10, 4)
    cot = torch.tensor(g.normal(size=(4096, 4)) * [1e-4, 1e-4, 1e-4, 1e-3],
                       dtype=torch.float32)
    keep = {}
    ref = mlp_train.fused_nerf_mlp_bwd_reference(packed, x, v, cot, keep)
    return packed, x, v, cot, ref, keep["planes"]


@pytest.mark.parametrize("variant", ["f64 sums", *chip_smoke.GRAD_CONTROLS])
def test_smoke_backward_check_sees_faults(trained_batch, variant):
    """chip_smoke.py's backward check, on the CPU with the trained
    weights: it accepts a mere change of summation order (its deltas match
    the f32 version's but for a few flipped roundings) and rejects the
    plain backward with its deltas kept in f32 and the one without the
    density head's path into the trunk."""
    packed, x, v, cot, ref, planes = trained_batch
    if variant == "f64 sums":
        out, out_planes = _plain_bwd_f64_sums(packed, x, v, cot)
        a = chip_smoke.backward_agreement(out, ref, out_planes, planes,
                                          packed, x=x, v=v,
                                          weight_grads=mlp_train.weight_grads)
        assert a["ok"], a
    else:
        out, out_planes = chip_smoke.control_bwd(
            chip_smoke.GRAD_CONTROLS[variant], packed, x, v, cot)
        assert not chip_smoke.backward_agreement(
            out, ref, out_planes, planes, packed)["ok"]


def _tile_offset(p, c, cols):
    """Element offset of (point p, column c) inside a tile-order plane of
    ``cols`` columns, written out from the kernel's comment: 64-point
    groups, each the warpgroup tile's core matrices [c / 8][p / 8][p % 8]
    [c % 8]."""
    group, r = p // 64, p % 64
    return (group * 64 * cols + (c // 8) * 64 * 8 + (r // 8) * 64
            + (r % 8) * 8 + c % 8)


def test_workspace_planes_layout():
    """workspace_planes reads #5's tile-order workspace (the C function's
    comment) by the canonical layout: elements of a hand-filled workspace
    land where the kernel writes them."""
    n, n_pad, depth = 70, 128, 2
    plane = n_pad * 256
    act = torch.arange((depth + 1) * plane + n_pad * (128 + 64 + 32),
                       dtype=torch.float64)
    dlt = torch.arange(depth * plane + n_pad * (272 + 128 + 16),
                       dtype=torch.float64)
    p = tile_mlp.workspace_planes(mlp_kernel.layout(depth, 0, IN, VIEW), act,
                                  dlt, n, n_pad)
    # h_1 (point 2, column 5): core matrix 0 of group 0, row 2, element 5
    assert p["h"][1][2, 5] == plane + 2 * 8 + 5
    # point 69: group 1 (64 * 256 elements on), row 5; column 17: block 2
    assert p["h"][0][69, 17] == 64 * 256 + 2 * 512 + 5 * 8 + 1
    assert p["feat"][0, 0] == depth * plane
    # g_act (128 columns): point 9 is core matrix row 1 of point group 1
    assert p["g_act"][9, 8] == (depth + 1) * plane + 512 + 64 + 8
    assert p["d"][1][0, 7] == plane + 7
    # d_af's d_sigma column (256): block 32 of a 272-column group
    assert p["d_af"][66, 256] == depth * plane + 64 * 272 + 32 * 512 + 2 * 8
    assert p["d_gpre"][0, 0] == depth * plane + n_pad * 272
    assert p["d_rgb"][1, 10] == (depth * plane + n_pad * (272 + 128)
                                 + 512 + 8 + 2)
    assert all(t.shape[0] == n for t in (p["feat"], p["d_af"], p["d_rgb"]))


@pytest.mark.parametrize("depth", [2, 8])
@pytest.mark.parametrize("n_pad", [128, 4224])
def test_workspace_planes_detile_every_element(depth, n_pad):
    """An arange-filled workspace, de-tiled: every element of every plane
    is its own offset by the tile-order formula, planes in the order the C
    function's comment gives, the x and v planes (the encodings the delta
    kernel loaded or encoded) last in the activations, and the sizes the
    wrapper allocates."""
    n = n_pad - 61
    a_cols = [256] * (depth + 1) + [128, 64, 32]
    d_cols = [256] * depth + [272, 128, 16]
    lay = mlp_kernel.layout(depth, 0, IN, VIEW)
    assert tile_mlp.workspace_columns(lay) == (tuple(a_cols), tuple(d_cols))
    act = torch.arange(n_pad * sum(a_cols), dtype=torch.int64)
    dlt = torch.arange(n_pad * sum(d_cols), dtype=torch.int64)
    got = tile_mlp.workspace_planes(lay, act, dlt, n, n_pad)
    names = ([("h", i) for i in range(depth)] + [("feat", None),
             ("g_act", None), ("x", None), ("v", None)],
             [("d", i) for i in range(depth)]
             + [("d_af", None), ("d_gpre", None), ("d_rgb", None)])
    pts = torch.arange(n)[:, None]
    for cols_of, named in zip((a_cols, d_cols), names):
        base = 0
        for cols, (key, i) in zip(cols_of, named):
            plane = got[key] if i is None else got[key][i]
            want = base + _tile_offset(pts, torch.arange(cols)[None], cols)
            assert plane.shape == (n, cols)
            assert torch.equal(plane, want), (key, i)
            base += n_pad * cols


def test_bulk_bytes_counts_the_workspace_traffic():
    """The bytes ``fused_nerf_mlp_bwd.bulk_bytes`` grows by a point at
    depth 8 (the paper's model), which tests/test_torch_cuda.py holds the
    C launcher's count to: 9,984 written (the planes the wrapper allocates,
    x and v, in bf16) and 15,776 read as the weight-gradient blocks load
    them, each product's A plane once and its D columns once for each 128
    gradient rows (w_alpha's: the 16 columns that start with d_sigma)."""
    written = 2 * (9 * 256 + 128 + 64 + 32 + 8 * 256 + 272 + 128 + 16)
    # W0 and W_5x (K 64), W_1..7 and W_feat (K 256, two blocks), w_alpha
    # (K 256, 16 columns), Wv_f, Wv_d (K 32), W_rgb (K 128)
    read = 2 * (2 * (64 + 256) + 8 * (256 + 2 * 256) + (256 + 2 * 16)
                + (256 + 2 * 128) + (32 + 128) + (128 + 16))
    assert (written, read) == (9984, 15776)
    lay = mlp_kernel.layout(8, 4, IN, VIEW)
    assert 2 * sum(map(sum, tile_mlp.workspace_columns(lay))) == written
    assert 2 * sum(m.rows + (16 if m.name == "alpha" else m.cols)
                   * -(-m.rows // 128) for m in lay.weights) == read


def _staged_offset(k, n, cols, slab_k):
    """Where the kernels expect element (k, n) of a (K, cols) matrix inside
    its region of an image: K-slabs of ``slab_k`` rows, a slab as 8 x 8
    core matrices ``[k / 8][n / 8][n % 8][k % 8]`` (csrc/nerf_mlp_tile.cuh,
    written out independently of ``tile_mlp._slab_order``)."""
    slab, kk = divmod(k, slab_k)
    return (slab * slab_k * cols + ((kk // 8) * (cols // 8) + n // 8) * 64
            + (n % 8) * 8 + kk % 8)


def _pack_members(part):
    """A module at its published shape (the canonical MLP of hard.yaml,
    or hard_dnerf.yaml's deformation: 8 x 256, skip 4, 10 point bands and
    4 direction or 10 time bands), every parameter element a distinct
    nonzero value, its layout, and its packs' members written out from
    the kernels' comments (csrc/nerf_mlp_tile.cuh,
    csrc/fused_deform_mlp.cu): (name, rows, cols, parameter, its columns)
    of each matrix, (name, size, parameter) of each bias, in pack order."""
    if part == "canonical":
        module = NeRFMLP(IN, VIEW, depth=8, skips=(4,), dtype=torch.float32)
        lay = mlp_kernel.layout(8, 4, IN, VIEW)
        first = [("0", 64, 256, "pts.0", slice(None))]
        heads = [("feat", 256, 256, "feature", slice(None)),
                 ("alpha", 256, 1, "alpha", slice(None)),
                 ("vf", 256, 128, "views.0", slice(0, 256)),
                 ("vd", 32, 128, "views.0", slice(256, None)),
                 ("rgb", 128, 16, "rgb", slice(None))]
        bias_heads = [("feat", 256, "feature"), ("alpha", 16, "alpha"),
                      ("v", 128, "views.0"), ("rgb", 16, "rgb")]
    else:
        module = DeformMLP(IN, 21, depth=8, width=256, skips=(4,))
        lay = deform_mlp.layout(8, 4, IN, 21)
        first = [("0x", 64, 256, "pts.0", slice(0, IN)),
                 ("0t", 32, 256, "pts.0", slice(IN, None))]
        heads = [("out", 256, 16, "out", slice(None))]
        bias_heads = [("out", 16, "out")]
    trunk = []
    for i in range(1, 8):
        if i == 5:
            trunk.append(("5x", 64, 256, "pts.5", slice(0, IN)))
        trunk.append((str(i), 256, 256, f"pts.{i}",
                      slice(IN, None) if i == 5 else slice(None)))
    biases = [(str(i), 256, f"pts.{i}") for i in range(8)] + bias_heads
    with torch.no_grad():
        at = 1
        for q in module.parameters():
            q.copy_(torch.arange(at, at + q.numel()).view(q.shape))
            at += q.numel()
    return module, lay, first + trunk + heads, biases


def _image_slab(part, name, k_dim, transposed):
    """The rows of the K-slabs in which an image stages a member, as the
    kernels' comments give them; None where it keeps the member as in the
    pack."""
    if part == "canonical":
        if name == "alpha" or (transposed and name == "vd"):
            return None   # w_alpha, and what the backward never multiplies by
        return k_dim if name == "rgb" and not transposed else min(k_dim, 64)
    if transposed:
        return 64 if name.isdigit() and name != "0" else None
    return k_dim if name == "out" else min(k_dim, 64)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("part", ["canonical", "deformation"])
def test_packs_and_images_map_back_to_the_parameters(part, transposed):
    """Both tile-core MLPs' packs, by their layouts' two gathers
    (``tile_mlp.gather``): each matrix and bias is its parameter's block,
    transposed, where the kernels look for it and zero-padded; the
    gradient of <pack, R> is R read back at those places, and the
    inverse gather (``tile_mlp.param_grads``) maps it back the same, for
    every parameter element. The image (forward, or transposed) is a
    permutation of the pack with every element where the kernels' slab and
    core-matrix arithmetic looks for it, and the kernels' pack reads it.
    ``tile_mlp.packer`` makes the pack once a parameter version: two calls
    share one, and an in-place update (the optimizer's) makes a new one."""
    module, lay, matrices, biases = _pack_members(part)
    named = dict(module.named_parameters())
    params = tile_mlp.params_of(lay, named)
    w, b = tile_mlp.gather(lay, params)
    r_w, r_b = torch.randn_like(w), torch.randn_like(b)
    grads = dict(zip(named, torch.autograd.grad(
        (w * r_w).sum() + (b * r_b).sum(), list(named.values()))))
    assert [m.name for m in lay.weights] == [m[0] for m in matrices]
    assert [m.name for m in lay.biases] == [m[0] for m in biases]
    at = 0
    for name, rows, cols, param, cut in matrices:
        block = named[f"{param}.weight"][:, cut].t()
        k, c = block.shape
        region = w[at:at + rows * cols].view(rows, cols)
        assert torch.equal(region[:k, :c], block), name
        assert not region[k:].any() and not region[:, c:].any(), name
        assert torch.equal(grads[f"{param}.weight"][:, cut].t(),
                           r_w[at:at + rows * cols].view(rows, cols)[:k, :c])
        at += rows * cols
    assert at == w.numel()
    at = 0
    for name, size, param in biases:
        bias = named[f"{param}.bias"]
        assert torch.equal(b[at:at + bias.numel()], bias), name
        assert not b[at + bias.numel():at + size].any(), name
        assert torch.equal(grads[f"{param}.bias"],
                           r_b[at:at + bias.numel()])
        at += size
    assert at == b.numel()
    inverse = tile_mlp.pack_index(lay)[2]
    assert int(inverse.min()) >= 0
    mapped = tile_mlp.param_grads(r_w, r_b, inverse,
                                  [q.shape for q in params])
    keys = [key for key, _ in tile_mlp.parameters(lay)]
    assert sorted(keys) == sorted(named)
    for key, got in zip(keys, mapped):
        assert torch.equal(got, grads[key]), key

    perm = tile_mlp.image_index(lay, transposed)
    assert torch.equal(perm.sort().values, torch.arange(w.numel()))
    img = w.detach()[perm]
    g = np.random.default_rng(3)
    at = 0
    for name, rows, cols, _, _ in matrices:
        m = w.detach()[at:at + rows * cols].view(rows, cols)
        region = img[at:at + rows * cols]
        at += rows * cols
        slab_k = _image_slab(part, name, cols if transposed else rows,
                             transposed)
        if slab_k is None:
            assert torch.equal(region, m.reshape(-1)), name
            continue
        m = m.t() if transposed else m
        k_dim, n_dim = m.shape
        for k, n in zip(g.integers(0, k_dim, 200), g.integers(0, n_dim, 200)):
            assert region[_staged_offset(int(k), int(n), n_dim, slab_k)] \
                == m[k, n], (name, k, n)

    pack_of = tile_mlp.packer(lay)
    first, inv, got = pack_of(named)
    assert torch.equal(inv, inverse)
    assert all(q is named[key] for q, key in zip(got, keys))
    assert torch.equal(first.w, w.detach().to(torch.bfloat16))
    assert torch.equal(first.b, b.detach())
    assert torch.equal(first.img_t if transposed else first.img,
                       img.to(torch.bfloat16))
    assert pack_of(named)[0] is first
    last = biases[-1][2]
    with torch.no_grad():
        named[f"{last}.bias"].add_(1.0)
    second = pack_of(named)[0]
    assert second is not first
    moved = torch.zeros_like(b)
    moved[b.numel() - biases[-1][1]:][:named[f"{last}.bias"].numel()] = 1.0
    assert torch.equal(second.b - first.b, moved)


class _ExplicitPackFn(torch.autograd.Function):
    """raw = MLP(x, v) with the f32 packs ``w``, ``b`` as the
    differentiable inputs: the kernels' pack gradients (the plain versions
    on the CPU) go back to the parameters by autograd through whatever
    made the packs."""

    @staticmethod
    def forward(ctx, w, b, x, v, lay):
        ctx.packed = tile_mlp.Pack(w.detach().to(torch.bfloat16),
                                   b.detach(), lay)
        ctx.save_for_backward(x, v)
        return mlp_kernel.fused_nerf_mlp(ctx.packed, x, v)

    @staticmethod
    def backward(ctx, g):
        x, v = ctx.saved_tensors
        grad_w, grad_b = mlp_train.fused_nerf_mlp_bwd(
            ctx.packed, x, v, g.float().contiguous())
        return grad_w, grad_b, None, None, None


def _explicit_pack(mlp):
    """The canonical pack of a depth-8, skip-4 NeRFMLP on 63 / 27 encoded
    features, written out by transposes, pads and joins (the layout of
    csrc/nerf_mlp_tile.cuh), differentiable."""
    p = dict(mlp.named_parameters())

    def w(name, rows=None):
        m = p[f"{name}.weight"].t()
        return m if rows is None else F.pad(m, (0, 0, 0, rows - m.shape[0]))

    ws = [w("pts.0", 64)]
    for i in range(1, 8):
        if i == 5:
            ws += [F.pad(w("pts.5")[:IN], (0, 0, 0, 64 - IN)),
                   w("pts.5")[IN:]]
        else:
            ws.append(w(f"pts.{i}"))
    ws += [w("feature"), w("alpha"), w("views.0")[:256],
           F.pad(w("views.0")[256:], (0, 0, 0, 32 - VIEW)),
           F.pad(w("rgb"), (0, 13))]
    bs = [p[f"pts.{i}.bias"] for i in range(8)] + [
        p["feature.bias"], F.pad(p["alpha.bias"], (0, 15)),
        p["views.0.bias"], F.pad(p["rgb.bias"], (0, 13))]
    return torch.cat([m.reshape(-1) for m in ws]), torch.cat(bs)


def test_param_grads_bit_equal_through_an_explicit_pack():
    """A hard.yaml-shaped NeRF MLP (8 x 256, skip 4, 63 / 27 encoded
    widths) run twice, as a D-NeRF's canonical MLP is a step: every
    parameter gradient through ``FusedNeRFMLPFn`` (the packs by gathers,
    their gradients mapped back by the inverse gather) equals, bit for
    bit, the gradient of the same loss by autograd through the pack
    written out by transposes, pads and joins, as are the raw outputs and
    the packs: both routes only permute elements."""
    g = torch.Generator().manual_seed(4)
    mlp = NeRFMLP(IN, VIEW, depth=8, skips=(4,), dtype=torch.float32,
                  generator=g)
    with torch.no_grad():
        for name, q in mlp.named_parameters():
            if name.endswith("bias"):
                q.copy_(0.1 * torch.randn(q.shape, generator=g))
    batches = [(*mlp_kernel.encode_features(
        torch.randn(300, 3, generator=g), torch.randn(300, 3, generator=g),
        10, 4), torch.randn(300, 4, generator=g)) for _ in range(2)]
    lay = mlp_kernel.layout(8, 4, IN, VIEW)

    def run(route):
        mlp.zero_grad(set_to_none=True)
        raws = [route(x, v) for x, v, _ in batches]
        sum((raw * cot).sum() for raw, (_, _, cot) in
            zip(raws, batches)).backward()
        return raws, {k: q.grad.clone() for k, q in mlp.named_parameters()}

    raws, grads = run(lambda x, v: mlp_train.fused_nerf_mlp_diff(
        mlp, x, v, IN, VIEW))
    want_raws, want = run(lambda x, v: _ExplicitPackFn.apply(
        *_explicit_pack(mlp), x, v, lay))
    for a, b in zip(raws, want_raws):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for key in want:
        assert torch.equal(grads[key].view(torch.int32),
                           want[key].view(torch.int32)), key
    packed = tile_mlp.pack(lay, dict(mlp.named_parameters()))
    w, b = _explicit_pack(mlp)
    assert torch.equal(packed.w.view(torch.int16),
                       w.detach().to(torch.bfloat16).view(torch.int16))
    assert torch.equal(packed.b.view(torch.int32), b.detach().view(torch.int32))


@pytest.mark.parametrize("points_need_grad", [False, True])
def test_points_route_matches_the_features_route(points_need_grad):
    """A hard.yaml-shaped NeRF MLP (8 x 256, skip 4, 10 / 4 bands) run
    twice, as a step's coarse and fine passes are: ``FusedNeRFMLPFn``
    handed the raw points and directions (the training route: #1's encode
    in the forward, the encode arm in the backward; their plain versions
    here) gives raw outputs and every parameter gradient bit-equal to the
    features-in route on ``encode_features`` of the same points, whether
    or not the points need a gradient (a D-NeRF's moved points do), and
    then the points' gradient is (N, 3) f32."""
    g = torch.Generator().manual_seed(8)
    mlp = NeRFMLP(IN, VIEW, depth=8, skips=(4,), dtype=torch.float32,
                  generator=g)
    with torch.no_grad():
        for name, q in mlp.named_parameters():
            if name.endswith("bias"):
                q.copy_(0.1 * torch.randn(q.shape, generator=g))
    batches = [(4.0 * torch.rand(300, 3, generator=g) - 2.0,
                F.normalize(torch.randn(300, 3, generator=g), dim=-1),
                torch.randn(300, 4, generator=g)) for _ in range(2)]
    pack_of = tile_mlp.packer(mlp_kernel.layout(8, 4, IN, VIEW))
    assert mlp_kernel.bands(mlp_kernel.layout(8, 4, IN, VIEW)) == (10, 4)

    def run(route):
        mlp.zero_grad(set_to_none=True)
        raws, leaves = [], []
        for p, d, cot in batches:
            p = p.clone().requires_grad_(points_need_grad)
            packed, inverse, params = pack_of(dict(mlp.named_parameters()))
            raw = mlp_train.FusedNeRFMLPFn.apply(packed, inverse,
                                                 *route(p, d), *params)
            (raw * cot).sum().backward()
            raws.append(raw.detach())
            leaves.append(p)
        return raws, leaves, {k: q.grad.clone()
                              for k, q in mlp.named_parameters()}

    calls = tracing.counts["fused_nerf_mlp_enc_reference.calls"]
    raws, pts, grads = run(lambda p, d: (p, d))
    assert tracing.counts["fused_nerf_mlp_enc_reference.calls"] == calls + 2
    want_raws, _, want = run(lambda p, d: mlp_kernel.encode_features(
        p.detach(), d, 10, 4))
    for a, b in zip(raws, want_raws):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for key in want:
        assert torch.equal(grads[key].view(torch.int32),
                           want[key].view(torch.int32)), key
    for p in pts:
        if points_need_grad:
            assert p.grad.shape == (300, 3) and p.grad.dtype == torch.float32
            assert float(p.grad.abs().max()) > 0
        else:
            assert p.grad is None
