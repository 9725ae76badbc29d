"""The CUDA kernels on a GPU, against their plain PyTorch versions. Every
test is marked ``cuda`` and skips itself where no GPU is found. This file
imports nothing of JAX, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import chip_smoke
from nerf_replication_tpu_torch.config import make_cfg, parse_args
from nerf_replication_tpu_torch.models import make_network
from nerf_replication_tpu_torch.models.nerf.renderer import ngp_renderer
from nerf_replication_tpu_torch.ops import (
    eval_encode,
    fused_ngp,
    hashgrid_kernel,
    mlp_kernel,
    mlp_train,
)
from nerf_replication_tpu_torch.run import build_renderer, load_model
from nerf_replication_tpu_torch.utils import synthetic_scene, tracing

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
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 257, 1000])
def test_kernel_matches_plain_version(cuda, monkeypatch, n):
    """Ragged point counts around a warpgroup's 64 rows and the 128-point
    tile (one below, at, one above, and one above two tiles), trained
    weights. The
    bound is chip_smoke.py's: where f32 summation order flips a bf16
    rounding, outputs move by up to ~1e-2 of their column's range."""
    net = load_model(_cfg(monkeypatch), cuda)
    for mlp in (net.coarse, net.fine):
        packed = mlp_kernel.pack_nerf_params(mlp.state_dict(), 63, 27, 8, 4)
        pts, dirs = _ray_points(n, seed=n, device=cuda)
        launches = tracing.counts["fused_nerf_mlp_enc.launches"]
        out = mlp_kernel.fused_nerf_mlp_enc(packed, pts, dirs, 10, 4)
        torch.cuda.synchronize()
        assert tracing.counts["fused_nerf_mlp_enc.launches"] == launches + 1
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


def _flipped_points(planes_k, planes_p) -> torch.Tensor:
    """The points (a bool mask) at which the two arms' recomputed
    activations disagree on a ReLU: one is zero where the other is
    positive, because the f32 summation order moved a value across zero."""
    flipped = ((planes_k["g_act"] > 0) != (planes_p["g_act"] > 0)).any(dim=1)
    for h_k, h_p in zip(planes_k["h"], planes_p["h"]):
        flipped |= ((h_k > 0) != (h_p > 0)).any(dim=1)
    return flipped


def _less_points(grads, planes, rows, x, v, packed):
    """``grads`` (weight-pack gradient, bias-pack gradient) less what the
    points ``rows`` (a bool mask) add to them, summed in float64 from the
    workspace ``planes``: the products A^T . D for the weights, the deltas'
    column sums for the biases (the bf16 deltas for the f32 ones: off by at
    most 2^-9 of these points' share)."""
    part = {k: [t[rows].double() for t in p] if isinstance(p, list)
            else p[rows].double() for k, p in planes.items()}
    w = mlp_train.weight_grads(part, x[rows].double(), v[rows].double(),
                               packed)
    b = torch.cat([d.sum(0) for d in part["d"]]
                  + [part[k].sum(0) for k in ("d_af", "d_gpre", "d_rgb")])
    return grads[0].double() - w, grads[1].double() - b


# Share of the points whose ReLUs may disagree between the arms (or two
# points): read 1 of 127, 129 and 257, 2 of 260, 3 of 1000 and of 4096.
FLIPPED_POINTS = 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 257, 260, 385,
                               1000, 4096])
def test_training_kernels_match_plain_versions(cuda, monkeypatch, n):
    """The features-in forward (TPU kernels #3/#4) and the backward (#5) at
    ragged point counts around the 128-point tile (one below, at, one above,
    and one above two and three tiles), trained weights, a cotangent shaped
    like dloss/draw: the forward to 1e-2 of each column's range, the
    backward to chip_smoke.py's check (deltas, workspace sums, leaves,
    padding).
    A summation-order flip that cascades down one point's delta chain
    changes up to about half of that point's deltas, so at a few dozen
    points the share of differing deltas may reach two points' worth
    (read 8.7e-3 at 63 points) where chip_smoke.py's 196608 read 2e-4.
    Where the flip moves a recomputed activation across zero, the two arms
    disagree on that ReLU, the point's deltas below it differ by their own
    size, and at a few hundred points one such point carries several
    percent of a leaf: at 257 points the fine branch's w6 read 5.1e-2 with
    its one such point and 3.7e-4 without it (run with ``-s`` for every
    size's readings). So the leaves are compared without the points whose
    ReLUs disagree (``_flipped_points``; none at most sizes, and then this
    is chip_smoke.py's check as it stands; read at most 2.4e-3), those
    points may be no more than FLIPPED_POINTS of all (or two), and the
    kernel's whole gradient must be the float64 sums of its own workspace,
    which the deltas' check holds against the plain version's element by
    element."""
    net = load_model(_cfg(monkeypatch), cuda)
    g = torch.Generator(device=cuda).manual_seed(n)
    for mlp in (net.coarse, net.fine):
        packed = mlp_kernel.pack_nerf_params(mlp.state_dict(), 63, 27, 8, 4)
        pts, dirs = _ray_points(n, seed=n, device=cuda)
        x, v = mlp_kernel.encode_features(pts, dirs, 10, 4)
        cot = torch.randn(n, 4, device=cuda, generator=g) * torch.tensor(
            [1e-4, 1e-4, 1e-4, 1e-3], device=cuda)
        counts = (tracing.counts["fused_nerf_mlp.launches"],
                  tracing.counts["fused_nerf_mlp_bwd.launches"])
        out = mlp_kernel.fused_nerf_mlp(packed, x, v)
        keep_k, keep_p = {}, {}
        grads = mlp_train.fused_nerf_mlp_bwd(packed, x, v, cot, keep_k)
        torch.cuda.synchronize()
        assert (tracing.counts["fused_nerf_mlp.launches"],
                tracing.counts["fused_nerf_mlp_bwd.launches"]) == (
            counts[0] + 1, counts[1] + 1)
        ref = mlp_kernel.fused_nerf_mlp_reference(packed, x, v)
        scale = ref.abs().amax(dim=0).clamp_min(1.0)
        assert out.shape == (n, 4) and bool(torch.isfinite(out).all())
        assert float(((out - ref).abs() / scale).max()) <= 1e-2
        ref_grads = mlp_train.fused_nerf_mlp_bwd_reference(packed, x, v, cot,
                                                           keep_p)
        planes_k, planes_p = keep_k["planes"], keep_p["planes"]
        delta_diff = max(chip_smoke.DELTA_DIFF, 2 / n)
        a = chip_smoke.backward_agreement(grads, ref_grads, planes_k,
                                          planes_p, packed, 63, 27, x=x, v=v,
                                          delta_diff=delta_diff)
        flipped = _flipped_points(planes_k, planes_p)
        kept = chip_smoke.backward_agreement(
            _less_points(grads, planes_k, flipped, x, v, packed),
            _less_points(ref_grads, planes_p, flipped, x, v, packed),
            planes_k, planes_p, packed, 63, 27, delta_diff=delta_diff)
        print(f"backward, N={n}: {int(flipped.sum())} points with a flipped "
              f"ReLU; leaves, worst rel-norm err: all points {a['rel']:.2e} "
              f"({a['rel_leaf']}), without those {kept['rel']:.2e} "
              f"({kept['rel_leaf']})")
        assert int(flipped.sum()) <= max(2, FLIPPED_POINTS * n)
        assert kept["ok"], chip_smoke.describe_grad(kept)
        assert a["wgrad"] <= chip_smoke.WGRAD_REL and a["pad_zero"], \
            chip_smoke.describe_grad(a)


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
@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 65, 127, 128, 129, 1000])
def test_ngp_kernels_match_plain_versions(cuda, monkeypatch, n):
    """The brick encode (TPU kernels #8/#9) and both arms of the fused
    encode+MLP (#10) on the trained hard_ngp_b9 network, and the f32 arm on
    a random 16-level network, at ragged point counts around the fused
    kernel's 32-point warp tile and its 256-point block. The encode rounds
    as its plain version does: bit for bit. The f32 arm (3xTF32) differs
    from its plain version by f32 rounding: within 1e-5 of each column's
    range (chip_smoke.py read <= 7.2e-7 with the first kernel); the bf16
    arm by where the f32 summation order flips a bf16 rounding: within
    chip_smoke.py's NGP_BF16_BOUNDS.col_rtol."""
    _, net = _ngp(monkeypatch, cuda)
    layout = net.xyz_encoder.layout
    packed = eval_encode.pack_eval_table(net.xyz_encoder.table.detach())
    x, sh = _ngp_inputs(net, n, seed=n, device=cuda)
    launches = tracing.counts["brick_encode_eval.launches"]
    feats = eval_encode.brick_encode_eval(
        layout, eval_encode.pack_cell_table(packed), x)
    torch.cuda.synchronize()
    assert tracing.counts["brick_encode_eval.launches"] == launches + 1
    assert feats.shape == (n, 24)
    assert torch.equal(
        feats, eval_encode.brick_encode_eval_reference(layout, packed, x))
    torch.manual_seed(n)
    lego = make_network(make_cfg(parse_args(list(
        chip_smoke.NGP_16_LEVELS)))).to(cuda)
    packed16 = eval_encode.pack_eval_table(torch.empty_like(
        lego.xyz_encoder.table).uniform_(-1, 1, generator=torch.Generator(
            device=cuda).manual_seed(n)))
    cases = [(net, layout, packed, mlp, mlp_bf16) for mlp in (net.coarse,
                                                             net.fine)
             for mlp_bf16 in (False, True)]
    cases.append((lego, lego.xyz_encoder.layout, packed16, lego.fine, False))
    for model, lay, table, mlp, mlp_bf16 in cases:
        ops, meta = fused_ngp.extract_mlp_weights(
            mlp.state_dict(), model.xyz_encoder.output_dim, mlp.depth,
            mlp.skips, mlp.view_depth)
        count = "bf16_launches" if mlp_bf16 else "launches"
        launches = tracing.counts[f"fused_ngp_eval.{count}"]
        out = fused_ngp.fused_ngp_eval(lay, meta, table, ops, x, sh, mlp_bf16)
        torch.cuda.synchronize()
        assert tracing.counts[f"fused_ngp_eval.{count}"] == launches + 1
        ref = fused_ngp.fused_ngp_eval_reference(lay, meta, table, ops, x,
                                                 sh, mlp_bf16)
        scale = ref.abs().amax(dim=0).clamp_min(1.0)
        assert out.shape == (n, 4) and bool(torch.isfinite(out).all())
        tol = chip_smoke.NGP_BF16_BOUNDS.col_rtol if mlp_bf16 else 1e-5
        assert float(((out - ref).abs() / scale).max()) <= tol


@pytest.mark.cuda
def test_ngp_wrappers_refuse_what_the_kernels_do_not_take(cuda, monkeypatch):
    _, net = _ngp(monkeypatch, cuda)
    layout = net.xyz_encoder.layout
    packed = eval_encode.pack_eval_table(net.xyz_encoder.table.detach())
    cells = eval_encode.pack_cell_table(packed)
    x, sh = _ngp_inputs(net, 8, seed=0, device=cuda)
    ops, meta = fused_ngp.extract_mlp_weights(
        net.fine.state_dict(), 24, net.fine.depth, net.fine.skips, 1)
    strided = torch.empty(8, 6, device=cuda)[:, :3].copy_(x)
    for bad_x in (x.double(), strided):
        with pytest.raises(ValueError):
            eval_encode.brick_encode_eval(layout, cells, bad_x)
        with pytest.raises(ValueError):
            fused_ngp.fused_ngp_eval(layout, meta, packed, ops, bad_x, sh)
    with pytest.raises(ValueError):
        eval_encode.brick_encode_eval(layout, cells.float(), x)
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


def _merge_points(net, kind, device):
    """256 points that put the table gradient's warp merge to work: every
    lane of every warp on one point ("one point": every corner merges
    across all 32 lanes), or lanes alternating between two points at
    opposite corners of the scene, in different bricks on every level
    ("two bricks")."""
    x, _ = _ngp_inputs(net, 2, seed=0, device=device)
    rows = [0] * 256 if kind == "one point" else [0, 1] * 128
    return x[rows].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("log2_bricks", [9, 13])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 3000, "one point",
                               "two bricks"])
def test_brick_training_kernels_match_plain_versions(cuda, monkeypatch, n,
                                                     log2_bricks):
    """The training forward (TPU kernel #6) and the table gradient (#7) at
    ragged point counts around the 256-thread block of the gradient (the
    forward's tile is 32 points), and on point sets
    that merge contributions across a warp's lanes (``_merge_points``), on
    the trained hard_ngp_b9 table (every level on the bf16 branch) and on a
    random table of the ``log2_bricks`` 13 layout (seven f32 levels). The
    forward rounds as its plain version does: bit for bit. The gradient's
    merged atomic f32 sums against the plain backward summed in f64: every
    level within chip_smoke.py's 1e-5 of its max |gradient|, the padding
    exactly zero, and the same from a gradient that is not contiguous."""
    _, net = _ngp(monkeypatch, cuda)
    if isinstance(n, str):
        x = _merge_points(net, n, cuda)
        n = x.shape[0]
    else:
        x, _ = _ngp_inputs(net, n, seed=n, device=cuda)
    if log2_bricks == 9:
        layout, table = net.xyz_encoder.layout, net.xyz_encoder.table.detach()
    else:
        layout = hashgrid_kernel.make_brick_layout(12, 16, 512, log2_bricks)
        table = torch.empty(layout.n_rows, 256, device=cuda).uniform_(
            -1, 1, generator=torch.Generator(device=cuda).manual_seed(n))
    g = torch.randn(n, 24, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(n))
    counts = (tracing.counts["brick_hash_encode.launches"],
              tracing.counts["brick_hash_encode_bwd.launches"])
    out = hashgrid_kernel.brick_hash_encode(layout, table, x)
    dtable = hashgrid_kernel.brick_hash_encode_bwd(layout, x, g)
    strided = hashgrid_kernel.brick_hash_encode_bwd(
        layout, x, g.t().contiguous().t())
    torch.cuda.synchronize()
    assert (tracing.counts["brick_hash_encode.launches"],
            tracing.counts["brick_hash_encode_bwd.launches"]) == (
        counts[0] + 1, counts[1] + 2)
    assert out.shape == (n, 24)
    assert torch.equal(out, hashgrid_kernel.brick_encode_reference(
        layout, table, x))
    ref = hashgrid_kernel.brick_encode_bwd_reference(layout, x, g,
                                                     torch.float64)
    live = hashgrid_kernel.live_entries(layout).to(cuda)
    for d in (dtable, strided):
        a = chip_smoke.brick_bwd_agreement(layout, d, ref, live)
        assert a["ok"], a


@pytest.mark.cuda
def test_brick_training_wrappers_refuse_what_the_kernels_do_not_take(
        cuda, monkeypatch):
    _, net = _ngp(monkeypatch, cuda)
    layout, table = net.xyz_encoder.layout, net.xyz_encoder.table.detach()
    x, _ = _ngp_inputs(net, 8, seed=0, device=cuda)
    g = torch.zeros(8, 24, device=cuda)
    strided = torch.empty(8, 6, device=cuda)[:, :3].copy_(x)
    for bad_x in (x.double(), strided):
        with pytest.raises(ValueError):
            hashgrid_kernel.brick_hash_encode(layout, table, bad_x)
        with pytest.raises(ValueError):
            hashgrid_kernel.brick_hash_encode_bwd(layout, bad_x, g)
    for bad_table in (table.double(), table[:-1], table.cpu()):
        with pytest.raises(ValueError):
            hashgrid_kernel.brick_hash_encode(layout, bad_table, x)
    for bad_g in (g.double(), g[:, :22], g.cpu()):
        with pytest.raises(ValueError):
            hashgrid_kernel.brick_hash_encode_bwd(layout, x, bad_g)


@pytest.mark.cuda
def test_ngp_train_step_on_gpu_matches_cpu(cuda, monkeypatch):
    """One deterministic loss_fn of the NGP train path on 64 rays of hard
    view 0 with the trained hard_ngp_b9 weights: the brick kernels on the
    GPU against the plain versions on the CPU. All f32: the loss to 1e-5,
    every parameter gradient (the table's too) to 1e-3 in relative norm
    (cuBLAS against the CPU's matmul, atomic sums against index_add_)."""
    from nerf_replication_tpu_torch.train.trainers.nerf import NetworkWrapper

    views = synthetic_scene.test_views("hard", 16, 16, [0])
    batch = {k: torch.as_tensor(views[0][k][::4].copy())
             for k in ("rays_o", "rays_d", "colors")}
    res = {}
    for device in (torch.device("cpu"), cuda):
        cfg, net = _ngp(monkeypatch, device)
        counts = (tracing.counts["brick_hash_encode.launches"],
                  tracing.counts["brick_hash_encode_bwd.launches"])
        wrap = NetworkWrapper(net.train(), cfg)
        loss, _ = wrap.loss_fn({k: t.to(device) for k, t in batch.items()},
                               None, train=True)
        loss.backward()
        made = (tracing.counts["brick_hash_encode.launches"] - counts[0],
                tracing.counts["brick_hash_encode_bwd.launches"] - counts[1])
        assert made == ((2, 2) if device.type == "cuda" else (0, 0))
        res[device.type] = (float(loss.detach()),
                            {k: p.grad.cpu() for k, p in
                             net.named_parameters()})
    assert res["cuda"][0] == pytest.approx(res["cpu"][0], rel=1e-5)
    assert "xyz_encoder.table" in res["cpu"][1]
    for name, g_cpu in res["cpu"][1].items():
        g_gpu = res["cuda"][1][name]
        assert float((g_gpu - g_cpu).norm() / g_cpu.norm().clamp_min(1e-30)) \
            < 1e-3, name


@pytest.mark.cuda
def test_gather_probes_on_gpu(cuda):
    """scripts/probe_cuda_gather.py at the TPU probe's sizes: every probe
    agrees with PyTorch indexing and launched its kernel."""
    spec = importlib.util.spec_from_file_location(
        "probe_cuda_gather", os.path.join(ROOT, "scripts",
                                          "probe_cuda_gather.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    readings = probe.run(cuda, reps=3)
    assert len(readings) == 5 and all(r["ok"] for r in readings)
    assert all(tracing.counts[f"{w.__name__}.launches"] > 0
               for w in probe.PROBES)
    with pytest.raises(ValueError):
        probe.row_gather(torch.zeros(4, 256, device=cuda),
                         torch.zeros(2, dtype=torch.int64, device=cuda))
