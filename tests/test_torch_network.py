"""Port parity: checkpoint bridge, Network and the fused MLP's plain
version against the JAX package, on the trained data/pretrain/hard
weights, and the power of chip_smoke.py's kernel-against-plain check. The
CUDA kernel itself is compared with its plain version on a GPU by
tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nerf_replication_tpu.config import default_cfg, load_cfg_tree
from nerf_replication_tpu.models import make_network as jax_make_network
from nerf_replication_tpu.models.nerf.network import init_params
from nerf_replication_tpu.ops.pallas import mlp_kernel as jax_mlp
from nerf_replication_tpu.utils.ckpt_utils import load_pretrain as jax_load
from nerf_replication_tpu_torch.models.nerf.network import make_network
from nerf_replication_tpu_torch.ops import mlp_kernel, tile_mlp
from nerf_replication_tpu_torch.utils import tracing
from nerf_replication_tpu_torch.utils.ckpt_utils import (
    load_network,
    load_pretrain,
    params_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "data", "pretrain", "hard")


@pytest.fixture(scope="module")
def hard():
    """(cfg, jax net, jax params, port net) for configs/nerf/hard.yaml."""
    cwd = os.getcwd()
    os.chdir(ROOT)  # parent_cfg paths are relative to the repo root
    try:
        cfg = load_cfg_tree("configs/nerf/hard.yaml", default_cfg())
    finally:
        os.chdir(cwd)
    tree = load_pretrain(CKPT)
    net = make_network(cfg)
    net.load_state_dict(params_from_jax(tree))
    return cfg, jax_make_network(cfg), jax.tree.map(jnp.asarray, tree), net


def ray_points(n, seed):
    """Points at depths 2..6 along rays from a radius-4 camera sphere and
    their unit directions, as the render path makes them."""
    g = np.random.default_rng(seed)
    eye = g.normal(size=(n, 3))
    eye = 4.0 * eye / np.linalg.norm(eye, axis=-1, keepdims=True)
    d = -eye / 4.0 + 0.3 * g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = eye + g.uniform(2.0, 6.0, size=(n, 1)) * d
    return pts.astype(np.float32), d.astype(np.float32)


def test_load_pretrain_matches_jax_loader():
    ours, theirs = load_pretrain(CKPT), jax_load(CKPT)
    for branch in ("coarse", "fine"):
        for layer, leaf in theirs["params"][branch].items():
            for k, v in leaf.items():
                np.testing.assert_array_equal(
                    ours["params"][branch][layer][k], v)


def test_load_network_picks_checkpoints_as_jax_writes_them(tmp_path):
    """latest.ckpt first, else the highest epoch; ``epoch`` picks one."""
    from nerf_replication_tpu.utils.ckpt_utils import save_model

    def tree(v):
        return {"params": {"coarse": {"rgb": {
            "kernel": np.full((2, 3), v, np.float32),
            "bias": np.zeros(3, np.float32)}}}}

    def kernel_of(net):
        return float(net["params"]["coarse"]["rgb"]["kernel"][0, 0])

    for epoch in (3, 5):
        save_model(tree(epoch), {}, {}, {}, epoch, str(tmp_path))
    assert kernel_of(load_network(str(tmp_path))) == 5.0
    assert kernel_of(load_network(str(tmp_path), epoch=3)) == 3.0
    save_model(tree(7), {}, {}, {}, 7, str(tmp_path), latest=True)
    assert kernel_of(load_network(str(tmp_path))) == 7.0
    with pytest.raises(FileNotFoundError):
        load_network(str(tmp_path), epoch=4)
    with pytest.raises(FileNotFoundError):
        load_network(str(tmp_path / "missing"))


def test_params_from_jax_transposes_every_kernel(hard):
    """Flax (in, out) -> nn.Linear (out, in), including the square
    256x256 layers where a missed transpose would still load."""
    _, _, params, net = hard
    sd = net.state_dict()
    for branch in ("coarse", "fine"):
        for layer, leaf in params["params"][branch].items():
            key = layer.replace("pts_", "pts.").replace("views_", "views.")
            np.testing.assert_array_equal(
                sd[f"{branch}.{key}.weight"].numpy(),
                np.asarray(leaf["kernel"]).T)
            np.testing.assert_array_equal(
                sd[f"{branch}.{key}.bias"].numpy(), np.asarray(leaf["bias"]))


@pytest.mark.parametrize("model", ["", "fine"])
def test_network_matches_flax(hard, model):
    """Port Network vs ``net.apply`` on the trained weights, 128 points.
    Both run bf16 matmuls with bf16 outputs (Flax's Dense(dtype=bf16)),
    but round at different places (Flax adds the bias in bf16 after
    rounding the product; torch rounds once), so raw outputs, which reach
    ~1e3 here where one bf16 step is 4-8, agree to the bf16 tolerance of
    tests/test_pallas_mlp.py:58 relative to each column's range."""
    _, jnet, params, net = hard
    pts, dirs = ray_points(128, seed=1)
    ref = np.asarray(jnet.apply(params, jnp.asarray(pts)[:, None],
                                jnp.asarray(dirs)[:, None], model=model))[:, 0]
    with torch.no_grad():
        out = net(torch.from_numpy(pts)[:, None],
                  torch.from_numpy(dirs)[:, None], model=model)[:, 0].numpy()
    scale = np.abs(ref).max(axis=0)
    np.testing.assert_allclose(out / scale, ref / scale, atol=2e-2, rtol=5e-2)
    assert np.median(np.abs(out - ref) / scale) < 2e-3


@pytest.mark.parametrize("branch", ["coarse", "fine"])
def test_fused_reference_matches_jax_kernel(hard, branch):
    """fused_nerf_mlp_enc_reference (plain PyTorch) vs the JAX Pallas
    fused_nerf_mlp_enc in interpret mode, trained weights, N=70 (a
    ragged tail against the JAX tile of 32). Same rounding points (bf16
    operands, f32 sums, f32 bias/ReLU), so only f32 summation order
    differs: almost every element agrees to 1e-5 of its column's range;
    the few where that order flipped a bf16 rounding of an activation
    (~1e3, one bf16 step 4-8) agree to 1e-2 of the range."""
    _, jnet, params, net = hard
    pts, dirs = ray_points(70, seed=2)
    packed_j = jax_mlp.pack_nerf_params(params["params"][branch], 63, 27)
    ref = np.asarray(jax_mlp.fused_nerf_mlp_enc(
        packed_j, jnp.asarray(pts), jnp.asarray(dirs), 10, 4, tile_n=32,
        interpret=True))
    mlp = getattr(net, branch)
    packed = tile_mlp.pack(mlp_kernel.layout(8, 4, 63, 27), mlp.state_dict())
    out = mlp_kernel.fused_nerf_mlp_enc_reference(
        packed, torch.from_numpy(pts), torch.from_numpy(dirs), 10, 4).numpy()
    err = np.abs(out - ref) / np.abs(ref).max(axis=0)
    assert err.max() <= 1e-2
    assert np.mean(err <= 1e-5) >= 0.95


def test_wrapper_takes_the_plain_version_on_cpu(hard):
    _, _, _, net = hard
    apply_fn = mlp_kernel.make_fused_apply(net)
    assert apply_fn is not None
    pts, dirs = ray_points(24, seed=3)
    launches = tracing.counts["fused_nerf_mlp_enc.launches"]
    calls = tracing.counts["fused_nerf_mlp_enc_reference.calls"]
    out = apply_fn(torch.from_numpy(pts).view(4, 6, 3),
                   torch.from_numpy(dirs).view(4, 6, 3), "fine")
    assert out.shape == (4, 6, 4) and torch.isfinite(out).all()
    assert tracing.counts["fused_nerf_mlp_enc.launches"] == launches
    assert tracing.counts["fused_nerf_mlp_enc_reference.calls"] == calls + 1


def _plain_with_f64_sums(packed, pts, dirs):
    """The plain version with float64 sums and the same bf16 rounding
    points: a summation order other than the f32 version's, as the CUDA
    kernel's is."""
    def take(flat, at, rows, cols):
        return flat[at:at + rows * cols].view(rows, cols).double(), \
            at + rows * cols

    with mock.patch.object(tile_mlp, "_take", take), \
            mock.patch.object(mlp_kernel, "_bf16",
                              lambda x: x.to(torch.bfloat16).double()):
        return mlp_kernel.fused_nerf_mlp_enc_reference(
            dataclasses.replace(packed, b=packed.b.double()), pts.double(),
            dirs.double(), 10, 4).float()


@pytest.mark.parametrize("variant", ["f64 sums", *chip_smoke.CONTROLS])
def test_smoke_check_sees_precision_faults(hard, variant):
    """chip_smoke.py's kernel-against-plain check, on the CPU at 16384
    points: it accepts a mere change of summation order and rejects each
    lower-precision control, which the looser column-range and
    elementwise bounds alone let through."""
    _, _, _, net = hard
    packed = tile_mlp.pack(mlp_kernel.layout(8, 4, 63, 27),
                           net.coarse.state_dict())
    pts, dirs = map(torch.from_numpy, ray_points(16384, seed=4))
    ref = mlp_kernel.fused_nerf_mlp_enc_reference(packed, pts, dirs, 10, 4)
    if variant == "f64 sums":
        assert chip_smoke.agreement(_plain_with_f64_sums(packed, pts, dirs),
                                    ref)["ok"]
    else:
        out = chip_smoke.control_plain(chip_smoke.CONTROLS[variant], packed,
                                       pts, dirs, 10, 4)
        assert not chip_smoke.agreement(out, ref)["ok"]


@pytest.mark.parametrize("change", ["skip_last", "two_view_layers",
                                    "wide_encoding"])
def test_pack_rejects_what_the_kernel_does_not_cover(hard, change):
    _, _, _, net = hard
    sd = dict(net.fine.state_dict())
    in_dim, depth, skip = 63, 8, 4
    if change == "skip_last":
        skip = depth - 1
    elif change == "two_view_layers":
        sd["views.1.weight"] = torch.zeros(128, 128)
    else:
        in_dim = 75
    with pytest.raises(ValueError):
        tile_mlp.pack(mlp_kernel.layout(depth, skip, in_dim, 27), sd)


def test_init_matches_flax_dense():
    """NeRFMLP initialises as Flax's nn.Dense does: kernels lecun_normal
    (a normal truncated at +-2 sigma whose std is 1/sqrt(fan_in)), biases
    zero and the alpha bias density_bias. Each leaf's std against the Flax
    tree's: within 3% on leaves of >= 4096 elements, 15% on smaller ones
    (the alpha kernel has 256); every |w| within 2 sigma; biases exact. The
    draw comes from an explicit generator: the same seed gives the same
    weights."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        cfg = load_cfg_tree("configs/nerf/lego.yaml", default_cfg())
    finally:
        os.chdir(cwd)
    density_bias = -4.0
    cfg.network.nerf.density_bias = density_bias
    flax = jax.tree.map(np.asarray, init_params(jax_make_network(cfg),
                                                jax.random.key(0)))
    net = make_network(cfg)
    ref = params_from_jax(flax)
    sd = net.state_dict()
    for name, value in sd.items():
        ours, theirs = value.numpy(), ref[name].numpy()
        if name.endswith(".bias"):
            expect = density_bias if ".alpha." in name else 0.0
            np.testing.assert_array_equal(ours, np.full_like(ours, expect))
            np.testing.assert_array_equal(theirs, ours)
            continue
        sigma = ours.shape[1] ** -0.5 / 0.87962566103423978
        tol = 0.03 if ours.size >= 4096 else 0.15
        assert ours.std() == pytest.approx(theirs.std(), rel=tol), name
        assert np.abs(ours).max() <= 2 * sigma * (1 + 1e-6), name
    again = make_network(cfg, torch.Generator().manual_seed(0))
    other = make_network(cfg, torch.Generator().manual_seed(1))
    for name, value in again.state_dict().items():
        assert torch.equal(value, sd[name])
    assert not torch.equal(other.state_dict()["coarse.pts.1.weight"],
                           sd["coarse.pts.1.weight"])
