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
from nerf_replication_tpu_torch.models.nerf.network import NeRFMLP, make_network
from nerf_replication_tpu_torch.ops import mlp_kernel, mlp_train
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
    replaced by float64, mapped to the parameters by autograd through
    pack_params_torch, against jax.grad of the Flax net: a missing term
    (such as the density head's path into the trunk), a wrong transpose,
    a relu-mask off-by-one or a wrong pack offset fails at 1e-5."""
    jmlp, params, x, v, cot = setup
    g_ref = jax.grad(lambda p: jnp.sum(
        jmlp.apply({"params": p}, jnp.asarray(x), jnp.asarray(v))
        * jnp.asarray(cot)))(params)

    def take(flat, at, rows, cols):
        return flat[at:at + rows * cols].view(rows, cols).double(), \
            at + rows * cols

    mlp = _port_mlp(params, torch.float64)
    w, b = mlp_train.pack_params_torch(mlp, IN, VIEW)
    packed = mlp_kernel.PackedMLP(w.detach(), b.detach(), DEPTH, SKIP)
    xd = F.pad(torch.from_numpy(x).double(), (0, 64 - IN))
    vd = F.pad(torch.from_numpy(v).double(), (0, 32 - VIEW))
    to64 = lambda t: t.double()  # noqa: E731
    with mock.patch.object(mlp_train, "_bf16", to64), \
            mock.patch.object(mlp_train, "_round_delta", to64), \
            mock.patch.object(mlp_train, "_take", take):
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
    packed = mlp_kernel.pack_nerf_params(mlp.state_dict(), IN, VIEW, DEPTH,
                                         SKIP)
    keep = {}
    grads = mlp_train.fused_nerf_mlp_bwd(packed, *_features(x, v),
                                         torch.from_numpy(cot), keep)
    planes = keep["planes"]
    a = chip_smoke.backward_agreement(grads, grads, planes, planes, packed,
                                      IN, VIEW)
    assert a["pad_zero"] and a["ok"]
    for leaf, at in (("b_rgb[15]", -1), ("W0 row 63", 63 * 256)):
        bumped = (grads[0].clone(), grads[1].clone())
        bumped[1 if leaf.startswith("b") else 0][at] = 1e-30
        assert not chip_smoke.backward_agreement(
            bumped, grads, planes, planes, packed, IN, VIEW)["pad_zero"], leaf


def test_input_grads_are_zero_by_contract(setup):
    _, params, x, v, _ = setup
    xb, vb = _features(x, v)
    xb.requires_grad_(True)
    raw = mlp_train.fused_nerf_mlp_diff(_port_mlp(params), xb, vb, IN, VIEW)
    raw.sum().backward()
    assert xb.grad is not None and float(xb.grad.abs().max()) == 0.0


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
    with mock.patch.object(mlp_train, "_take", take), \
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
    packed = mlp_kernel.pack_nerf_params(net.coarse.state_dict(), IN, VIEW,
                                         8, 4)
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
                                          packed, IN, VIEW, x=x, v=v)
        assert a["ok"], a
    else:
        out, out_planes = chip_smoke.control_bwd(
            chip_smoke.GRAD_CONTROLS[variant], packed, x, v, cot)
        assert not chip_smoke.backward_agreement(
            out, ref, out_planes, planes, packed, IN, VIEW)["ok"]


def test_workspace_planes_layout():
    """workspace_planes reads the kernel's workspace layout (the C
    function's comment): planes of a hand-filled workspace land where
    the kernel writes them."""
    n, n_pad, depth = 3, 64, 2
    act = torch.arange((depth + 1) * n_pad * 256 + n_pad * 128,
                       dtype=torch.float64)
    dlt = torch.arange(depth * n_pad * 256 + n_pad * (272 + 128 + 16),
                       dtype=torch.float64)
    p = mlp_train.workspace_planes(act, dlt, n, n_pad, depth)
    plane = n_pad * 256
    assert p["h"][1][2, 5] == plane + 2 * 256 + 5
    assert p["feat"][0, 0] == depth * plane
    assert p["g_act"][1, 0] == (depth + 1) * plane + 128
    assert p["d"][1][0, 7] == plane + 7
    assert p["d_af"][2, 256] == depth * plane + 2 * 272 + 256
    assert p["d_gpre"][0, 0] == depth * plane + n_pad * 272
    assert p["d_rgb"][1, 2] == depth * plane + n_pad * (272 + 128) + 16 + 2
    assert all(t.shape[0] == n for t in (p["feat"], p["d_af"], p["d_rgb"]))


def _staged_offset(k, n, cols, slab_k):
    """Where the kernels expect element (k, n) of a (K, cols) matrix inside
    its region of an image: K-slabs of ``slab_k`` rows, a slab as 8 x 8
    core matrices ``[k / 8][n / 8][n % 8][k % 8]`` (csrc/nerf_mlp_tile.cuh,
    written out independently of ``mlp_kernel._slab_order``)."""
    slab, kk = divmod(k, slab_k)
    return (slab * slab_k * cols + ((kk // 8) * (cols // 8) + n // 8) * 64
            + (n % 8) * 8 + kk % 8)


@pytest.mark.parametrize("transposed", [False, True])
def test_weight_image_maps_back_to_the_canonical_pack(setup, transposed):
    """The kernels' permuted (and transposed) weight image, made from the
    canonical pack by one indexing op: a permutation that maps back to the
    pack exactly, with every element where the kernels' slab and
    core-matrix arithmetic looks for it; and gradients taken through the
    image still reach every parameter of the module."""
    _, params, *_ = setup
    mlp = _port_mlp(params)
    w, _ = mlp_train.pack_params_torch(mlp, IN, VIEW)
    perm = mlp_kernel.image_index(DEPTH, SKIP, transposed)
    img = mlp_kernel.weight_image(w, DEPTH, SKIP, transposed)
    assert perm.sort().values.equal(torch.arange(w.numel()))
    back = torch.empty_like(img)
    back[perm] = img
    assert torch.equal(back, w)
    packed = mlp_kernel.PackedMLP(w=w.detach().to(torch.bfloat16),
                                  b=torch.zeros(1), depth=DEPTH, skip=SKIP)
    kernel_img = packed.img_t if transposed else packed.img
    assert torch.equal(kernel_img, img.detach().to(torch.bfloat16))

    g = np.random.default_rng(3)
    at = 0
    for name, rows, cols in mlp_kernel.pack_matrices(DEPTH, SKIP):
        m = w[at:at + rows * cols].view(rows, cols)
        region = img[at:at + rows * cols]
        at += rows * cols
        moved = name != "alpha" and not (
            transposed and (name in ("0", "vd") or name.endswith("x")))
        if not moved:   # w_alpha, and what the backward never multiplies by
            assert torch.equal(region, m.reshape(-1))
            continue
        if transposed:
            m = m.t()
        k_dim, n_dim = m.shape
        slab_k = k_dim if name == "rgb" and not transposed else min(k_dim, 64)
        for k, n in zip(g.integers(0, k_dim, 200), g.integers(0, n_dim, 200)):
            assert region[_staged_offset(int(k), int(n), n_dim, slab_k)] \
                == m[k, n], (name, k, n)
    assert at == w.numel()

    weights = torch.as_tensor(g.normal(size=img.numel()), dtype=img.dtype)
    (img * weights).sum().backward()
    for name, p in mlp.named_parameters():
        if name.endswith("weight"):
            assert p.grad is not None and bool((p.grad != 0).all()), name
