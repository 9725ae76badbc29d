"""The CUDA kernels on a GPU, against their plain PyTorch versions. Every
test is marked ``cuda`` and skips itself where no GPU is found. This file
imports nothing of JAX, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from nerf_replication_tpu_torch.config import make_cfg, parse_args
from nerf_replication_tpu_torch.models.nerf.renderer import ngp_renderer
from nerf_replication_tpu_torch.ops import (
    eval_encode,
    fused_ngp,
    mlp_kernel,
    mlp_train,
)
from nerf_replication_tpu_torch.run import build_renderer, load_model
from nerf_replication_tpu_torch.utils import synthetic_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--type", "evaluate", "--cfg_file", "configs/nerf/hard.yaml",
        "pretrain_path", "data/pretrain/hard", "save_result", "False"]
NGP_ARGV = ["--type", "evaluate", "--cfg_file", "configs/nerf/hard_ngp.yaml",
            "pretrain_path", "data/pretrain/hard_ngp_b9",
            "network.xyz_encoder.log2_bricks", "9", "save_result", "False"]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(monkeypatch, *opts):
    monkeypatch.chdir(ROOT)
    return make_cfg(parse_args(ARGV + list(opts)))


def _ray_points(n, seed, device):
    g = np.random.default_rng(seed)
    eye = g.normal(size=(n, 3))
    eye = 4.0 * eye / np.linalg.norm(eye, axis=-1, keepdims=True)
    d = -eye / 4.0 + 0.3 * g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = eye + g.uniform(2.0, 6.0, size=(n, 1)) * d
    return (torch.as_tensor(pts, dtype=torch.float32, device=device),
            torch.as_tensor(d, dtype=torch.float32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000])
def test_kernel_matches_plain_version(cuda, monkeypatch, n):
    """Ragged point counts around the 64-point tile, trained weights. The
    bound is chip_smoke.py's: where f32 summation order flips a bf16
    rounding, outputs move by up to ~1e-2 of their column's range."""
    net = load_model(_cfg(monkeypatch), cuda)
    for mlp in (net.coarse, net.fine):
        packed = mlp_kernel.pack_nerf_params(mlp.state_dict(), 63, 27, 8, 4)
        pts, dirs = _ray_points(n, seed=n, device=cuda)
        launches = mlp_kernel.fused_nerf_mlp_enc.launches
        out = mlp_kernel.fused_nerf_mlp_enc(packed, pts, dirs, 10, 4)
        torch.cuda.synchronize()
        assert mlp_kernel.fused_nerf_mlp_enc.launches == launches + 1
        ref = mlp_kernel.fused_nerf_mlp_enc_reference(packed, pts, dirs, 10, 4)
        scale = ref.abs().amax(dim=0).clamp_min(1.0)
        assert out.shape == (n, 4) and bool(torch.isfinite(out).all())
        assert float(((out - ref).abs() / scale).max()) <= 1e-2


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, monkeypatch):
    net = load_model(_cfg(monkeypatch), cuda)
    packed = mlp_kernel.pack_nerf_params(net.fine.state_dict(), 63, 27, 8, 4)
    pts, dirs = _ray_points(8, seed=0, device=cuda)
    with pytest.raises(ValueError):
        mlp_kernel.fused_nerf_mlp_enc(packed, pts.double(), dirs, 10, 4)
    with pytest.raises(ValueError):
        mlp_kernel.fused_nerf_mlp_enc(packed, pts.t().contiguous().t(),
                                      dirs, 10, 4)
    with pytest.raises(ValueError):
        mlp_kernel.fused_nerf_mlp_enc(packed, pts, dirs, 11, 4)


@pytest.mark.cuda
def test_render_on_gpu_matches_cpu_plain_render(cuda, monkeypatch):
    """16x16 hard view 0: the kernel on the GPU against the plain
    version on the CPU through the whole renderer."""
    views = synthetic_scene.test_views("hard", 16, 16, [0])
    outs = {}
    for device in ("cpu", "cuda"):
        cfg = _cfg(monkeypatch, "device", device)
        renderer = build_renderer(cfg, load_model(cfg, torch.device(device)))
        outs[device] = renderer.render(views[0])[0].cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], atol=2e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000])
def test_training_kernels_match_plain_versions(cuda, monkeypatch, n):
    """The features-in forward (TPU kernels #3/#4) and the backward (#5) at
    ragged point counts, trained weights, a cotangent shaped like
    dloss/draw: the forward to 1e-2 of each column's range, the backward
    to chip_smoke.py's check (deltas, workspace sums, leaves, padding).
    A summation-order flip that cascades down one point's delta chain
    changes up to about half of that point's deltas, so at a few dozen
    points the share of differing deltas may reach two points' worth
    (read 8.7e-3 at 63 points) where chip_smoke.py's 196608 read 2e-4."""
    net = load_model(_cfg(monkeypatch), cuda)
    g = torch.Generator(device=cuda).manual_seed(n)
    for mlp in (net.coarse, net.fine):
        packed = mlp_kernel.pack_nerf_params(mlp.state_dict(), 63, 27, 8, 4)
        pts, dirs = _ray_points(n, seed=n, device=cuda)
        x, v = mlp_kernel.encode_features(pts, dirs, 10, 4)
        cot = torch.randn(n, 4, device=cuda, generator=g) * torch.tensor(
            [1e-4, 1e-4, 1e-4, 1e-3], device=cuda)
        counts = (mlp_kernel.fused_nerf_mlp.launches,
                  mlp_train.fused_nerf_mlp_bwd.launches)
        out = mlp_kernel.fused_nerf_mlp(packed, x, v)
        keep_k, keep_p = {}, {}
        grads = mlp_train.fused_nerf_mlp_bwd(packed, x, v, cot, keep_k)
        torch.cuda.synchronize()
        assert (mlp_kernel.fused_nerf_mlp.launches,
                mlp_train.fused_nerf_mlp_bwd.launches) == (
            counts[0] + 1, counts[1] + 1)
        ref = mlp_kernel.fused_nerf_mlp_reference(packed, x, v)
        scale = ref.abs().amax(dim=0).clamp_min(1.0)
        assert out.shape == (n, 4) and bool(torch.isfinite(out).all())
        assert float(((out - ref).abs() / scale).max()) <= 1e-2
        ref_grads = mlp_train.fused_nerf_mlp_bwd_reference(packed, x, v, cot,
                                                           keep_p)
        a = chip_smoke.backward_agreement(grads, ref_grads, keep_k["planes"],
                                          keep_p["planes"], packed, 63, 27,
                                          x=x, v=v, delta_diff=max(
                                              chip_smoke.DELTA_DIFF, 2 / n))
        assert a["ok"], a


@pytest.mark.cuda
def test_backward_wrapper_refuses_what_the_kernel_does_not_take(cuda,
                                                                 monkeypatch):
    net = load_model(_cfg(monkeypatch), cuda)
    packed = mlp_kernel.pack_nerf_params(net.fine.state_dict(), 63, 27, 8, 4)
    x, v = mlp_kernel.encode_features(*_ray_points(8, seed=0, device=cuda),
                                      10, 4)
    g = torch.zeros(8, 4, device=cuda)
    with pytest.raises(ValueError):
        mlp_train.fused_nerf_mlp_bwd(packed, x.float(), v, g)
    with pytest.raises(ValueError):
        mlp_train.fused_nerf_mlp_bwd(packed, x, v, g.double())
    with pytest.raises(ValueError):
        mlp_kernel.fused_nerf_mlp(packed, x[:, :63].contiguous(), v)


@pytest.mark.cuda
def test_train_step_on_gpu_matches_cpu(cuda, monkeypatch):
    """One deterministic loss_fn of the fused train path on 64 rays of
    hard view 0, trained weights: the kernels on the GPU against the plain
    versions on the CPU, loss and every parameter gradient."""
    from nerf_replication_tpu_torch.train.trainers.nerf import NetworkWrapper

    views = synthetic_scene.test_views("hard", 16, 16, [0])
    batch = {k: torch.as_tensor(views[0][k][::4].copy())
             for k in ("rays_o", "rays_d", "colors")}
    res = {}
    for device in ("cpu", "cuda"):
        cfg = _cfg(monkeypatch, "device", device)
        net = load_model(cfg, torch.device(device))
        wrap = NetworkWrapper(net, cfg)
        loss, _ = wrap.loss_fn({k: t.to(device) for k, t in batch.items()},
                               None, train=True)
        loss.backward()
        res[device] = (float(loss.detach()),
                       {k: p.grad.cpu() for k, p in net.named_parameters()})
    assert res["cuda"][0] == pytest.approx(res["cpu"][0], rel=1e-3)
    for name, g_cpu in res["cpu"][1].items():
        g_gpu = res["cuda"][1][name]
        assert float((g_gpu - g_cpu).norm() / g_cpu.norm().clamp_min(1e-30)) \
            < 2e-2, name


def _ngp(monkeypatch, device):
    monkeypatch.chdir(ROOT)
    cfg = make_cfg(parse_args(NGP_ARGV + ["device", device.type]))
    return cfg, load_model(cfg, device)


def _ngp_inputs(net, n, seed, device):
    """n world points of rays through the scene's bounds, 0 and 1 of the
    unit cube among them, and per-point SH features of their rays."""
    pts, dirs = _ray_points(n, seed, device)
    pts = pts * 0.3
    pts[:2] = torch.tensor([[-1.2] * 3, [1.2] * 3], device=device)[:n]
    return ngp_renderer.fused_inputs(net, pts[:, None], dirs[:, None])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000])
def test_ngp_kernels_match_plain_versions(cuda, monkeypatch, n):
    """The brick encode (TPU kernels #8/#9) and the fused encode+MLP (#10)
    on the trained hard_ngp_b9 network at ragged point counts around the
    128-thread block. The encode rounds as its plain version does: bit
    for bit. The fused MLP differs only in f32 summation order: within
    1e-5 of each column's range (chip_smoke.py read <= 7.2e-7)."""
    _, net = _ngp(monkeypatch, cuda)
    layout = net.xyz_encoder.layout
    packed = eval_encode.pack_eval_table(net.xyz_encoder.table.detach())
    x, sh = _ngp_inputs(net, n, seed=n, device=cuda)
    launches = eval_encode.brick_encode_eval.launches
    feats = eval_encode.brick_encode_eval(layout, packed, x)
    torch.cuda.synchronize()
    assert eval_encode.brick_encode_eval.launches == launches + 1
    assert feats.shape == (n, 24)
    assert torch.equal(
        feats, eval_encode.brick_encode_eval_reference(layout, packed, x))
    for mlp in (net.coarse, net.fine):
        ops, meta = fused_ngp.extract_mlp_weights(
            mlp.state_dict(), 24, mlp.depth, mlp.skips, mlp.view_depth)
        launches = fused_ngp.fused_ngp_eval.launches
        out = fused_ngp.fused_ngp_eval(layout, meta, packed, ops, x, sh)
        torch.cuda.synchronize()
        assert fused_ngp.fused_ngp_eval.launches == launches + 1
        ref = fused_ngp.fused_ngp_eval_reference(layout, meta, packed, ops,
                                                 x, sh)
        scale = ref.abs().amax(dim=0).clamp_min(1.0)
        assert out.shape == (n, 4) and bool(torch.isfinite(out).all())
        assert float(((out - ref).abs() / scale).max()) <= 1e-5


@pytest.mark.cuda
def test_ngp_wrappers_refuse_what_the_kernels_do_not_take(cuda, monkeypatch):
    _, net = _ngp(monkeypatch, cuda)
    layout = net.xyz_encoder.layout
    packed = eval_encode.pack_eval_table(net.xyz_encoder.table.detach())
    x, sh = _ngp_inputs(net, 8, seed=0, device=cuda)
    ops, meta = fused_ngp.extract_mlp_weights(
        net.fine.state_dict(), 24, net.fine.depth, net.fine.skips, 1)
    strided = torch.empty(8, 6, device=cuda)[:, :3].copy_(x)
    for bad_x in (x.double(), strided):
        with pytest.raises(ValueError):
            eval_encode.brick_encode_eval(layout, packed, bad_x)
        with pytest.raises(ValueError):
            fused_ngp.fused_ngp_eval(layout, meta, packed, ops, bad_x, sh)
    with pytest.raises(ValueError):
        eval_encode.brick_encode_eval(layout, packed.float(), x)
    with pytest.raises(ValueError):
        fused_ngp.fused_ngp_eval(layout, meta, packed, ops, x, sh[:, :9])
    # contiguous, but 4 bytes off the 16-byte alignment of its float4 reads
    misaligned = torch.empty(sh.numel() + 1, device=cuda)[1:].view_as(sh)
    misaligned.copy_(sh)
    with pytest.raises(ValueError):
        fused_ngp.fused_ngp_eval(layout, meta, packed, ops, x, misaligned)


@pytest.mark.cuda
def test_ngp_render_on_gpu_matches_cpu_plain_render(cuda, monkeypatch):
    """16x16 hard view 0 through the fused route: the kernel on the GPU
    against its plain version on the CPU through the whole renderer."""
    views = synthetic_scene.test_views("hard", 16, 16, [0])
    outs = {}
    for device in (torch.device("cpu"), cuda):
        cfg, net = _ngp(monkeypatch, device)
        outs[device.type] = build_renderer(cfg, net).render(views[0])[0].cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], atol=1e-4, rtol=0)
