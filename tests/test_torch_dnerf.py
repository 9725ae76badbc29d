"""The port's D-NeRF (models/nerf/dnerf_network.py) on the CPU at a small
size (width 32, depth 8, skip 4, the canonical MLP at the kernels' 256 on
their path; 256 rays of 8 + 8 samples) against the
plain float32 reference ``reference/dnerf.py``, on seeded weights: raw
outputs, rgb, loss and every leaf's gradient, the canonical frame, one
Adam step; the backward's input gradient (#5's arm) in its plain version;
and the dynamic scene's times through the Blender loader and the device
pipeline. The kernels themselves are held to these plain versions on the
card by tests/test_torch_cuda.py."""

from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nerf_replication_tpu_torch.config import make_cfg, parse_args
from nerf_replication_tpu_torch.datasets import DeviceRayPipeline
from nerf_replication_tpu_torch.datasets.nerf.blender import Dataset
from nerf_replication_tpu_torch.models import make_network
from nerf_replication_tpu_torch.models.encoding.freq import freq_encode
from nerf_replication_tpu_torch.models.nerf.dnerf_network import DNeRFNetwork
from nerf_replication_tpu_torch.models.nerf.network import NeRFMLP
from nerf_replication_tpu_torch.ops import (
    deform_mlp,
    mlp_kernel,
    mlp_train,
    tile_mlp,
)
from nerf_replication_tpu_torch.train import make_trainer
from nerf_replication_tpu_torch.train.trainers.nerf import NetworkWrapper
from nerf_replication_tpu_torch.utils import synthetic_scene, tracing
from reference import dnerf as ref

N_RAYS, WIDTH = 256, 32
MODEL = {"xyz_freqs": 10, "dir_freqs": 4, "time_freqs": 10, "D": 8,
         "skips": (4,), "D_t": 8, "skips_t": (4,)}
RENDER = {"N_samples": 8, "N_importance": 8, "near": 2.0, "far": 6.0}


# the nn.Module network at width 32; the fused path's canonical MLP is the
# kernels' 256 wide
MODULE = ("network.nerf.W", str(WIDTH), "network.use_pallas_mlp_train",
          "False")


def _cfg(*opts):
    return make_cfg(parse_args([
        "--cfg_file", "configs/nerf/hard_dnerf.yaml", "device", "cpu",
        "network.deform.W", str(WIDTH), "task_arg.N_samples", "8",
        "task_arg.N_importance", "8", "seed", "7", *opts]))


@pytest.fixture(scope="module")
def batch():
    """Rays from radius 4 towards the origin, a quarter of them at t = 0."""
    g = torch.Generator().manual_seed(11)
    eye = F.normalize(torch.randn(N_RAYS, 3, generator=g), dim=-1) * 4.0
    d = F.normalize(-eye / 4.0 + 0.15 * torch.randn(N_RAYS, 3, generator=g),
                    dim=-1)
    times = torch.rand(N_RAYS, generator=g)
    times[::4] = 0.0
    return {"rays_o": eye, "rays_d": d, "times": times,
            "colors": torch.rand(N_RAYS, 3, generator=g)}


def _port(opts=(), batch=None):
    """(network, its weights as a dict, loss, gradients) of one
    deterministic training loss."""
    cfg = _cfg(*opts)
    net = make_network(cfg)
    assert isinstance(net, DNeRFNetwork)
    w = {k: v.detach().clone() for k, v in net.state_dict().items()}
    loss, (out, _, _) = NetworkWrapper(net, cfg).loss_fn(batch, None,
                                                         train=False)
    loss.backward()
    return net, w, loss.detach(), out, {k: p.grad for k, p in
                                        net.named_parameters()}


def _reference(w, batch):
    w = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    loss, out = ref.loss_of(w, MODEL, RENDER, batch)
    grads = torch.autograd.grad(loss, list(w.values()))
    return loss.detach(), out, dict(zip(w, grads))


def _leaf_errors(got: dict, want: dict) -> dict:
    return {k: float((got[k] - g).norm() / g.norm().clamp_min(1e-30))
            for k, g in want.items()}


def test_float32_network_matches_the_reference(batch):
    """The nn.Module network in float32 (``network.dtype float32``) is the
    reference up to the float32 summation order: raw outputs, rgb and loss
    to 1e-5, every leaf's gradient, the deformation's included, to 1e-4
    of its norm (read ~1e-6; an inverse-CDF depth is a continuous function
    of the coarse weights, so no sample jumps)."""
    net, w, loss, out, grads = _port(("network.dtype", "float32", *MODULE),
                                     batch)
    r_loss, r_out, r_grads = _reference(w, batch)
    assert float(abs(loss - r_loss) / r_loss) < 1e-5
    torch.testing.assert_close(out["rgb"], r_out["rgb"].detach(),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(out["rgb_coarse"],
                               r_out["rgb_coarse"].detach(), rtol=0,
                               atol=1e-5)
    pts = batch["rays_o"][:, None] + batch["rays_d"][:, None] * \
        torch.linspace(2.0, 6.0, 8)[:, None]
    with torch.no_grad():
        raw = net(pts, batch["rays_d"][:, None], "", batch["times"][:, None])
        r_raw = ref.field(w, MODEL, pts, batch["rays_d"][:, None],
                          batch["times"][:, None])
    torch.testing.assert_close(raw, r_raw, rtol=1e-5, atol=1e-5)
    errs = _leaf_errors(grads, r_grads)
    assert set(errs) == set(w) and any(k.startswith("deform.") for k in errs)
    assert max(errs.values()) < 1e-4, errs


def test_fused_path_follows_the_reference(batch):
    """The training apply the card runs (the canonical MLP through #3/#4/#5,
    here their plain versions in bf16; #5's input gradient the only path
    into the deformation) on 256 rays x 16 points, at the batch's times,
    with the deformation in float32 (``network.dtype float32``) so that
    both sides move the points alike, against the float32 reference's
    field: raw outputs to 1e-2 and every leaf's gradient under a random
    cotangent to 0.25 of its norm (bf16 keeps 8 bits; the deltas of 8
    layers at a random init read up to 0.16 on the first layers' leaves).
    With the input gradient zeroed (#5 as it was) every deformation leaf
    reads 1."""
    net = make_network(_cfg("network.dtype", "float32"))
    w = {k: v.detach().clone().requires_grad_(True)
         for k, v in net.state_dict().items()}
    g = torch.Generator().manual_seed(3)
    d = batch["rays_d"][:, None]
    pts = batch["rays_o"][:, None] + d * torch.linspace(2.5, 5.5, 16)[:, None]
    cot = torch.randn(N_RAYS, 16, 4, generator=g)
    t = batch["times"][:, None]
    want = ref.field(w, MODEL, pts, d, t)
    r_grads = dict(zip(w, torch.autograd.grad((want * cot).sum(),
                                              list(w.values()))))
    apply = mlp_train.make_fused_train_apply(net)
    raw = apply(pts, d, "", t)
    (raw * cot).sum().backward()
    assert float((raw.detach() - want.detach()).abs().max()) < 1e-2
    errs = _leaf_errors({k: p.grad for k, p in net.named_parameters()},
                        r_grads)
    print("fused path, worst leaves:", sorted(errs.items(),
                                              key=lambda kv: -kv[1])[:3])
    assert max(errs.values()) < 0.25, errs
    net.zero_grad()
    zero = mlp_train.FusedNeRFMLPFn.backward

    def no_input_grad(ctx, gr):
        gw, gb, gx, *rest = zero(ctx, gr)
        return (gw, gb, None if gx is None else torch.zeros_like(gx), *rest)

    with mock.patch.object(mlp_train.FusedNeRFMLPFn, "backward",
                           staticmethod(no_input_grad)):
        (apply(pts, d, "", t) * cot).sum().backward()
    errs = _leaf_errors({k: p.grad for k, p in net.named_parameters()},
                        r_grads)
    assert all(errs[k] == 1.0 for k in errs if k.startswith("deform."))


def test_bf16_training_loss_follows_the_reference(batch):
    """The card's configuration as it is (the deformation in bf16 too, at
    its published width 256, so on the route of its kernels, here their
    plain versions): the training loss to 2e-2 of the reference's. Its
    gradients are not compared here: bf16 moves dx by ~1e-3 at this init,
    which the 10th band turns into phase shifts of ~0.5 rad, so the
    deformation's gradients differ by their own size (the benchmark's
    limits, set on the card, hold that path;
    test_fused_bf16_deformation_follows_the_reference holds it at the
    route's own moved points)."""
    _, w, loss, _, _ = _port(("network.deform.W", "256"), batch)
    r_loss, _, _ = _reference(w, batch)
    assert float(abs(loss - r_loss) / r_loss) < 2e-2


def test_canonical_frame_does_not_move(batch):
    """dx is exactly 0 at t = 0, a mask on t: the points come back bit
    for bit, and rays at t = 0 give the deformation no gradient."""
    net = make_network(_cfg(*MODULE))
    pts = batch["rays_o"] * 0.3
    before = tracing.counts["DNeRF.deform_points"]
    moved = net.move(pts, torch.zeros(N_RAYS))
    assert torch.equal(moved, pts)
    assert tracing.counts["DNeRF.deform_points"] == before + N_RAYS
    assert not torch.equal(net.move(pts, torch.full((N_RAYS,), 0.5)), pts)
    zero = {k: v.clone() for k, v in batch.items()}
    zero["times"] = torch.zeros(N_RAYS)
    *_, grads = _port(MODULE, zero)
    assert all(float(g.abs().max()) == 0.0 for k, g in grads.items()
               if k.startswith("deform."))
    with pytest.raises(ValueError, match="time"):
        net(pts[:, None], batch["rays_d"][:, None], "")


def test_one_adam_step_matches_the_reference(batch):
    """One ``Trainer.train_step`` (clip 40, Adam with optax's bias
    corrections, lr 5e-4) from the seed's weights against the reference's
    :func:`reference.dnerf.adam_step` on the reference's gradients: the
    first update is lr * g / (|g| + eps), so the weights agree to 1e-3 of
    lr: an element whose gradient is within a few thousand eps of 0 takes
    an update that follows that element's own relative error (read 1.7e-4
    of lr at worst)."""
    cfg = _cfg("network.dtype", "float32", *MODULE)
    net = make_network(cfg)
    w0 = {k: v.detach().clone() for k, v in net.state_dict().items()}
    trainer = make_trainer(cfg, net)
    trainer.train_step(batch, None)
    _, _, r_grads = _reference(w0, batch)
    want = ref.adam_step(w0, r_grads, {}, lr=5e-4)
    got = dict(net.state_dict())
    moved = max(float((got[k] - w0[k]).abs().max()) for k in w0)
    assert moved == pytest.approx(5e-4, rel=1e-3)
    for k in w0:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=5e-7)


def _mlp(depth=4, skip=1, seed=0):
    """A seeded NeRFMLP and its layout."""
    g = torch.Generator().manual_seed(seed)
    mlp = NeRFMLP(63, 27, depth=depth, skips=(skip,), generator=g)
    return mlp, mlp_kernel.layout(depth, skip, 63, 27)


def test_plain_input_gradient_is_autograds_in_f64():
    """STRUCTURAL: #5's plain input gradient, d_0 . W_0^T + d_{skip+1} .
    W_ix^T from the plain backward's deltas, with every bf16 rounding
    replaced by float64, is autograd's gradient of the plain forward in
    float64 (1e-10): a missing skip term or a wrong transpose fails."""
    mlp, lay = _mlp()
    with torch.no_grad():
        w, b = tile_mlp.gather(lay, tile_mlp.params_of(
            lay, dict(mlp.named_parameters())))
    packed = tile_mlp.Pack(w.double(), b.double(), lay)
    g = torch.Generator().manual_seed(1)
    x = F.pad(torch.randn(130, 63, generator=g, dtype=torch.float64),
              (0, 1)).requires_grad_(True)
    v = F.pad(torch.randn(130, 27, generator=g, dtype=torch.float64),
              (0, 5))
    cot = torch.randn(130, 4, generator=g, dtype=torch.float64)

    def take(flat, at, rows, cols):
        return flat[at:at + rows * cols].view(rows, cols).double(), \
            at + rows * cols

    to64 = lambda t: t.double()  # noqa: E731
    with mock.patch.object(mlp_kernel, "_bf16", to64), \
            mock.patch.object(tile_mlp, "_take", take), \
            mock.patch.object(mlp_train, "_bf16", to64), \
            mock.patch.object(mlp_train, "_round_delta", to64):
        raw = mlp_kernel._mlp_body(packed, x, v)
        (want,) = torch.autograd.grad((raw * cot).sum(), x)
        *_, got = mlp_train.fused_nerf_mlp_bwd_reference(
            packed, x.detach(), v, cot, with_input_grad=True)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


def test_fused_fn_returns_the_input_gradient_when_asked():
    """``FusedNeRFMLPFn`` gives its inputs x their gradient when x needs
    one: the plain backward's f32 input gradient, not zeros; for bf16
    features rounded to bf16, for points (the training route) the points'
    f32 gradient through the encoding exactly, unrounded. v's stays zero
    by contract, and without x needing one no input gradient is formed.
    (test_points_route_keeps_the_encoding_gradient_in_f32 holds the
    points' against the old features route.)"""
    mlp, lay = _mlp(depth=8, skip=4)
    packed, inverse, params = tile_mlp.packer(lay)(
        dict(mlp.named_parameters()))
    g = torch.Generator().manual_seed(2)
    x, v = mlp_kernel.encode_features(torch.randn(200, 3, generator=g),
                                      torch.randn(200, 3, generator=g),
                                      10, 4)
    cot = torch.randn(200, 4, generator=g)
    *_, want = mlp_train.fused_nerf_mlp_bwd_reference(
        packed, x, v, cot, with_input_grad=True)
    xg, vg = x.clone().requires_grad_(True), v.clone().requires_grad_(True)
    raw = mlp_train.FusedNeRFMLPFn.apply(packed, inverse, xg, vg, *params)
    (raw * cot).sum().backward()
    assert float(xg.grad.float().abs().max()) > 0
    assert torch.equal(xg.grad, want.to(torch.bfloat16))
    assert float(vg.grad.abs().max()) == 0.0
    pts, dirs = (torch.randn(200, 3, generator=g) for _ in range(2))
    *_, want32 = mlp_train.fused_nerf_mlp_bwd_reference(
        packed, pts, dirs, cot, with_input_grad=True)
    pg = pts.clone().requires_grad_(True)
    raw32 = mlp_train.FusedNeRFMLPFn.apply(packed, inverse, pg, dirs,
                                           *params)
    torch.testing.assert_close(raw32, mlp_train.FusedNeRFMLPFn.apply(
        packed, inverse, *mlp_kernel.encode_features(pts, dirs, 10, 4),
        *params), rtol=0, atol=0)
    (raw32 * cot).sum().backward()
    assert pg.grad.dtype == torch.float32
    assert torch.equal(pg.grad, want32)
    assert not torch.equal(want32, want32.to(torch.bfloat16).float())
    calls = tracing.counts["fused_nerf_mlp_bwd_reference.calls"]
    mlp.zero_grad(set_to_none=True)
    (mlp_train.FusedNeRFMLPFn.apply(packed, inverse, x, v, *params)
     * cot).sum().backward()
    assert tracing.counts["fused_nerf_mlp_bwd_reference.calls"] == calls + 1
    assert all(q.grad is not None for q in params)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_encoding_gradient_is_autograds(dtype):
    """The encoding-gradient kernel's plain version, dL/dp = g[d] + sum_b
    2^b (cos(2^b p_d) g[sin col] - sin(2^b p_d) g[cos col]), is autograd's
    gradient through ``freq_encode`` in float64, with no bf16 round trip:
    in float64 to 1e-5 (rtol), in float32 to 1e-5 of the terms' absolute
    sum (f32 sines, products and sums of 21 terms; the arguments reach 2^9
    x 6 rad). A wrong sign, band scale or column fails."""
    g = torch.Generator().manual_seed(5)
    # float32 points, so that both sides encode the same arguments
    p = (12.0 * torch.rand(300, 3, generator=g) - 6.0).double()
    gx = torch.randn(300, 64, generator=g, dtype=torch.float64)
    gx[:, 63] = 0.0
    p64 = p.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(freq_encode(p64, 10), p64, gx[:, :63])
    got = mlp_train.encode_grad_reference(p.to(dtype), gx.to(dtype), 10)
    assert got.dtype == dtype and got.shape == (300, 3)
    if dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-12)
        return
    scale = gx[:, :3].abs() + sum(
        2.0 ** b * (gx[:, 3 + 6 * b:6 + 6 * b].abs()
                    + gx[:, 6 + 6 * b:9 + 6 * b].abs()) for b in range(10))
    assert float(((got.double() - want).abs() / scale).max()) <= 1e-5


def test_points_route_keeps_the_encoding_gradient_in_f32():
    """REGRESSION: the training route hands ``FusedNeRFMLPFn`` the moved
    points, and their gradient is the plain input gradient dL/dx (f32)
    taken through the encoding in f32 (``encode_grad_reference``), bit for
    bit. The old route encoded first (``mlp_kernel._encode``, which ends in
    a bf16 round trip), so autograd rounded dL/dx to bf16 at that node
    before the chain rule: its gradient is exactly the chain rule of the
    bf16-rounded dL/dx. The two differ, and the new one is the closer to
    the chain rule of the f32 dL/dx in float64."""
    mlp, lay = _mlp(depth=8, skip=4)
    packed, inverse, params = tile_mlp.packer(lay)(
        dict(mlp.named_parameters()))
    g = torch.Generator().manual_seed(6)
    p = 4.0 * torch.rand(200, 3, generator=g) - 2.0
    d = F.normalize(torch.randn(200, 3, generator=g), dim=-1)
    cot = torch.randn(200, 4, generator=g)
    keep = {}
    *_, want_new = mlp_train.fused_nerf_mlp_bwd_reference(
        packed, p, d, cot, keep, with_input_grad=True)
    gx = keep["grad_x"]

    new = p.clone().requires_grad_(True)
    (mlp_train.FusedNeRFMLPFn.apply(packed, inverse, new, d, *params)
     * cot).sum().backward()
    old = p.clone().requires_grad_(True)
    x = mlp_kernel._encode(old, 10, 64)
    v = mlp_kernel.encode_features(p, d, 10, 4)[1]
    (mlp_train.FusedNeRFMLPFn.apply(packed, inverse, x, v, *params)
     * cot).sum().backward()

    assert torch.equal(new.grad, want_new)
    q = p.clone().requires_grad_(True)
    (want_old,) = torch.autograd.grad(
        freq_encode(q, 10), q, gx[:, :63].to(torch.bfloat16).float())
    assert torch.equal(old.grad, want_old)
    assert not torch.equal(new.grad, old.grad)
    q = p.double().requires_grad_(True)
    (exact,) = torch.autograd.grad(freq_encode(q, 10), q, gx[:, :63].double())
    err_new = float((new.grad.double() - exact).norm())
    err_old = float((old.grad.double() - exact).norm())
    print(f"points' gradient against the f64 chain rule: f32 route "
          f"{err_new:.3e}, bf16 round trip {err_old:.3e}")
    assert err_new * 10 < err_old


@pytest.mark.parametrize("deform", [False, True])
def test_training_step_counts_its_encodes(batch, deform):
    """One CPU training loss and backward on the kernels' route (their
    plain versions here): the canonical MLP's plain versions encode with
    ``freq_encode`` (twice a pass, forward and backward: 8 a step), the
    features-in versions never run, and the encoding gradient's plain
    version runs once a pass for a D-NeRF (the moved points need a
    gradient) and never for a static NeRF. The launch counters of the
    encode arm and the encoding gradient stay 0 off the card."""
    keys = ("freq_encode.calls", "encode_grad_reference.calls",
            "fused_nerf_mlp_enc_reference.calls",
            "fused_nerf_mlp_reference.calls",
            "fused_nerf_mlp_bwd_reference.calls",
            "fused_nerf_mlp_bwd.encode_launches",
            "fused_nerf_mlp_bwd.encode_grad_launches")
    if deform:
        cfg = _cfg("network.deform.W", "256", "network.deform.D", "2",
                   "network.deform.skips", "[0]")
    else:
        cfg = make_cfg(parse_args([
            "--cfg_file", "configs/nerf/hard.yaml", "device", "cpu",
            "task_arg.N_samples", "8", "task_arg.N_importance", "8"]))
    net = make_network(cfg)
    wrapper = NetworkWrapper(net, cfg)
    assert wrapper.renderer.train_apply is not net
    b = batch if deform else {k: v for k, v in batch.items()
                              if k != "times"}
    before = {k: tracing.counts[k] for k in keys}
    with mock.patch.object(deform_mlp, "encode_inputs",
                           wraps=deform_mlp.encode_inputs) as deform_encode:
        loss, _ = wrapper.loss_fn(b, None, train=False)
        loss.backward()
    got = {k: tracing.counts[k] - before[k] for k in keys}
    # Psi_t's plain versions encode its inputs (two freq_encode calls each)
    canonical = got["freq_encode.calls"] - 2 * deform_encode.call_count
    assert canonical == 8, got
    assert got["encode_grad_reference.calls"] == (2 if deform else 0), got
    assert got["fused_nerf_mlp_enc_reference.calls"] == 2
    assert got["fused_nerf_mlp_reference.calls"] == 0
    assert got["fused_nerf_mlp_bwd_reference.calls"] == 2
    assert got["fused_nerf_mlp_bwd.encode_launches"] == 0
    assert got["fused_nerf_mlp_bwd.encode_grad_launches"] == 0
    assert all(q.grad is not None for q in net.parameters())


def test_dynamic_scene_times_reach_every_batch(tmp_path):
    """``generate_scene`` writes the dynamic hard scene in D-NeRF's layout
    (a ``time`` a frame, view i of n at i / (n - 1)); the Blender loader
    gives every ray its frame's time, and the device pipeline each ray its
    image's."""
    import json

    synthetic_scene.generate_scene(str(tmp_path), "hard_dnerf", H=8, W=8,
                                   n_train=3, n_val=0, n_test=2)
    meta = json.loads((tmp_path / "hard_dnerf" / "transforms_train.json")
                      .read_text())
    assert [f["time"] for f in meta["frames"]] == [0.0, 0.5, 1.0]
    cfg = _cfg("task_arg.N_rays", "16")
    train = Dataset(cfg, data_root=str(tmp_path), split="train", H=8, W=8,
                    seed=0)
    test = Dataset(cfg, data_root=str(tmp_path), split="test", H=8, W=8)
    np.testing.assert_array_equal(train.time_arrays(), [0.0, 0.5, 1.0])
    assert np.all(train[1]["times"] == 0.5) and train[1]["times"].shape == (
        16,)
    assert np.all(test[1]["times"] == 1.0) and test[1]["times"].shape == (64,)
    images, poses, K = train.as_arrays()
    # the images differ with time: the primitives moved
    assert float(np.abs(images[0] - images[2]).max()) > 0.1
    pipe = DeviceRayPipeline(images, poses, K, n_rays=16,
                             times=train.time_arrays(),
                             sample_across_images=True)
    b = pipe.sample(torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    img = torch.randint(0, 3, (16,), generator=g)
    torch.testing.assert_close(b["times"], torch.tensor([0.0, 0.5, 1.0])[img])
    one = DeviceRayPipeline(images, poses, K, n_rays=16,
                            times=train.time_arrays())
    assert one.sample(torch.Generator().manual_seed(5))["times"].shape == (16,)


def test_benchmark_counts_and_copies_are_the_ports():
    """The benchmark's D-NeRF pieces against the port at the published
    widths: its weight shapes are the network's state dict; Psi_t is
    497,152 and the canonical MLP 593,408 multiply-adds a point, 6.86
    TFLOP a 4096-ray step with the backward; its reference copy gives
    the top-level reference's raw outputs; its scene copy moves the
    primitives as the port's scene does."""
    from benchmark.harness import dnerf_scene, dnerf_yardstick, specs
    from benchmark.reference import dnerf as bench_ref

    c = specs.config("dnerf-hard")
    net = make_network(_cfg("network.deform.W", "256"))
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert shapes == dnerf_yardstick.weight_shapes(c["model"])
    assert dnerf_yardstick.deform_flops(c["model"]) == 2 * 497_152
    assert dnerf_yardstick.train_step_flops(c) == pytest.approx(6.86e12,
                                                                rel=1e-3)
    w = {k: v.detach() for k, v in net.state_dict().items()}
    g = torch.Generator().manual_seed(4)
    pts = torch.rand(64, 3, generator=g) * 2.0 - 1.0
    dirs = F.normalize(torch.randn(64, 3, generator=g), dim=-1)
    t = torch.rand(64, generator=g)
    t[:8] = 0.0
    torch.testing.assert_close(
        bench_ref.DNeRFField(c["model"])(w, pts, dirs, t),
        ref.field(w, {**MODEL, "skips_t": (4,)}, pts, dirs, t),
        rtol=1e-5, atol=1e-5)
    for time in (0.0, 0.3, 1.0):
        assert dnerf_scene.spheres_at(time) == synthetic_scene.spheres_at(
            synthetic_scene.HARD_SPHERES, synthetic_scene.HARD_MOTION, time)
    np.testing.assert_array_equal(dnerf_scene.frame_times(150),
                                  synthetic_scene.frame_times(150))


def test_benchmark_stand_ins_plant_the_input_gradient_faults():
    """The benchmark reference's stand-ins for #5's input gradient faults
    change Psi_t's gradient alone, as a faulty arm would: the sign flip
    negates it exactly, the skip term left out and the zeroed arm change
    it, and the canonical MLP's gradient and the raw outputs stay the
    reference's. ``angle`` reads them 2, above 0, and 1, and 0 for the
    reference itself and where both gradients are zero."""
    from benchmark.harness import dnerf_yardstick, inputs, specs
    from benchmark.reference import dnerf as bench_ref
    from benchmark.traffic.dnerf_train import angle

    m = specs.config("dnerf-hard")["model"]
    w = inputs.init_weights(dnerf_yardstick.weight_shapes(m), m, 5,
                            torch.device("cpu"))
    g = torch.Generator().manual_seed(6)
    pts = torch.rand(128, 3, generator=g) * 2.0 - 1.0
    dirs = F.normalize(torch.randn(128, 3, generator=g), dim=-1)
    t = torch.rand(128, generator=g)
    cot = torch.randn(128, 4, generator=g)

    def grads(fault=None):
        p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        raw = bench_ref.DNeRFField(m, fault=fault)(p, pts, dirs, t)
        gr = dict(zip(p, torch.autograd.grad(
            (raw * cot).sum(), list(p.values()), allow_unused=True)))
        gr = {k: torch.zeros_like(w[k]) if v is None else v
              for k, v in gr.items()}
        flat = {part: torch.cat([v.reshape(-1) for k, v in gr.items()
                                 if k.startswith(part)])
                for part in ("deform.", "canonical.")}
        return raw.detach(), flat

    raw, want = grads()
    assert angle(want["deform."], want["deform."]) == pytest.approx(0.0,
                                                                    abs=1e-6)
    assert angle(torch.zeros(3), torch.zeros(3)) == 0.0
    for fault, reads in (("flip_input_grad", 2.0), ("no_skip_grad", None),
                         ("no_input_grad", 1.0)):
        raw_f, got = grads(fault)
        torch.testing.assert_close(raw_f, raw, rtol=0, atol=0)
        torch.testing.assert_close(got["canonical."], want["canonical."],
                                   rtol=0, atol=0)
        a = angle(got["deform."], want["deform."])
        if reads is None:
            assert 0.05 < a < 1.95, a
        else:
            assert a == pytest.approx(reads, abs=1e-6), (fault, a)
    torch.testing.assert_close(grads("flip_input_grad")[1]["deform."],
                               -want["deform."], rtol=0, atol=0)


# The deformation MLP at its published widths (W 256), as its kernels take
# it; on the CPU the route runs their plain versions.
DEFORM_256 = ("network.deform.W", "256")


def _deform_batch(n=384, seed=21):
    """Points around the scene, times with every third at t = 0, and a
    cotangent of dx."""
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(n, 3, generator=g) * 4.0 - 2.0
    t = torch.rand(n, generator=g)
    t[::3] = 0.0
    return p, t, torch.randn(n, 3, generator=g)


def _moved_grads(net, p, t, cot, deform=None):
    """(dx, every deform.* leaf's gradient) of the moved points under the
    cotangent ``cot``, through ``move`` with ``deform`` (None: the
    nn.Module)."""
    net.zero_grad(set_to_none=True)
    dx = net.move(p, t, deform) - p
    (dx * cot).sum().backward()
    return dx.detach(), {k: p_.grad.clone() for k, p_ in
                         net.deform.named_parameters(prefix="deform")}


@pytest.mark.parametrize("against", ["module", "reference"])
def test_deformation_kernels_plain_versions_follow(against):
    """The deformation kernels' plain versions (the training route on the
    CPU: ``deform_mlp.make_train_deform``, 384 points, a third at t = 0,
    the seed's init at W 256) against ``DeformMLP`` with autograd in bf16
    (``module``: the same bf16 operands and activations, rounded at other
    points: the biases in bf16, the weight gradients in bf16, other sums'
    orders) and against the f32 ``reference/dnerf.py`` (``reference``): dx
    in relative norm and every ``deform.*`` leaf's gradient under a random
    cotangent on dx. Read: against the module dx 9.1e-5 and leaves up to
    2.6e-3 (the bounds 2e-3 and 2e-2); against f32, bf16's own error, dx
    4.8e-3 and leaves up to 0.13 on the first layers' (the bounds 2e-2
    and test_fused_path_follows_the_reference's 0.25: the deltas of 8
    bf16 layers at a random init)."""
    net = make_network(_cfg(*DEFORM_256))
    p, t, cot = _deform_batch()
    dx, grads = _moved_grads(net, p, t, cot,
                             deform_mlp.make_train_deform(net))
    if against == "module":
        want_dx, want = _moved_grads(net, p, t, cot)
        dx_bound, leaf_bound = 2e-3, 2e-2
    else:
        w = {k: v.detach().clone().requires_grad_(True)
             for k, v in net.state_dict().items() if k.startswith("deform.")}
        want_dx = ref.deform(w, MODEL, p, t)
        want = dict(zip(w, torch.autograd.grad((want_dx * cot).sum(),
                                               list(w.values()))))
        want_dx = want_dx.detach()
        dx_bound, leaf_bound = 2e-2, 0.25
    dx_err = float((dx - want_dx).norm() / want_dx.norm())
    errs = _leaf_errors(grads, want)
    print(f"against the {against}: dx {dx_err:.2e}, worst leaves",
          sorted(errs.items(), key=lambda kv: -kv[1])[:3])
    assert set(errs) == {k for k in net.state_dict()
                         if k.startswith("deform.")}
    assert dx_err < dx_bound
    assert max(errs.values()) < leaf_bound, errs


def test_fused_bf16_deformation_follows_the_reference(batch):
    """The training apply with the deformation in bf16 at W 256, as the
    card runs it (Psi_t through ``FusedDeformMLPFn``, the canonical MLP
    through #3/#4/#5; their plain versions here), against the f32
    reference's field at test_fused_path_follows_the_reference's bounds:
    raw outputs to 1e-2 and every leaf's gradient to 0.25 of its norm.
    bf16 moves dx by ~1e-3, which the 10th band turns into phase shifts of
    ~0.5 rad (read 0.056 on raw and 0.62 on leaves), so the reference's
    canonical field is evaluated at the route's moved points: its
    deformation's value is swapped for the route's dx, its gradients kept
    (straight through). Read: raw 2.7e-3, worst leaf 0.17 (deform.*; the
    f32 path reads 0.14). Counts one plain call of each deformation
    kernel and no launch."""
    net = make_network(_cfg(*DEFORM_256))
    w = {k: v.detach().clone().requires_grad_(True)
         for k, v in net.state_dict().items()}
    g = torch.Generator().manual_seed(3)
    d = batch["rays_d"][:, None]
    pts = batch["rays_o"][:, None] + d * torch.linspace(2.5, 5.5, 16)[:, None]
    cot = torch.randn(N_RAYS, 16, 4, generator=g)
    t = batch["times"][:, None]
    deform = deform_mlp.make_train_deform(net)
    with torch.no_grad():
        dx = net.move(pts, t, deform) - pts.reshape(-1, 3)
    plain = ref.deform

    def at_route_points(w_, m, x, tt):
        r_dx = plain(w_, m, x, tt)
        return r_dx + (dx - r_dx).detach()

    with mock.patch.object(ref, "deform", at_route_points):
        want = ref.field(w, MODEL, pts, d, t)
    r_grads = dict(zip(w, torch.autograd.grad((want * cot).sum(),
                                              list(w.values()))))
    keys = ("fused_deform_mlp_reference.calls",
            "fused_deform_mlp_bwd_reference.calls",
            "fused_deform_mlp.launches", "fused_deform_mlp_bwd.launches")
    before = [tracing.counts[k] for k in keys]
    raw = mlp_train.make_fused_train_apply(net)(pts, d, "", t)
    (raw * cot).sum().backward()
    assert [tracing.counts[k] - b for k, b in zip(keys, before)] == \
        [1, 1, 0, 0]
    assert float((raw.detach() - want.detach()).abs().max()) < 1e-2
    errs = _leaf_errors({k: p.grad for k, p in net.named_parameters()},
                        r_grads)
    print("bf16 deformation route, worst leaves:",
          sorted(errs.items(), key=lambda kv: -kv[1])[:3])
    assert max(errs.values()) < 0.25, errs


def test_fused_deformation_gives_canonical_rows_no_gradient():
    """Rows at t = 0 through the route: their points come back bit for
    bit, the plain backward's deltas are exactly zero on them (the mask's
    zero cotangent), and a batch all at t = 0 gives every deform.* leaf
    an exactly zero gradient."""
    net = make_network(_cfg(*DEFORM_256))
    deform = deform_mlp.make_train_deform(net)
    p, t, cot = _deform_batch(n=200)
    seen = {}
    bwd = deform_mlp.fused_deform_mlp_bwd

    def keep_planes(*args, **kw):
        seen["g"] = args[3]
        return bwd(*args, **kw, keep=seen)

    with mock.patch.object(deform_mlp, "fused_deform_mlp_bwd", keep_planes):
        dx, _ = _moved_grads(net, p, t, cot, deform)
    zero = t == 0.0
    assert bool(zero.any()) and bool((dx[zero] == 0).all())
    assert float(seen["g"][zero].abs().max()) == 0.0
    for d in seen["planes"]["d"]:
        assert float(d[zero].abs().max()) == 0.0
    assert float(seen["planes"]["d"][0][~zero].abs().max()) > 0.0
    dx, grads = _moved_grads(net, p, torch.zeros_like(t), cot, deform)
    assert float(dx.abs().max()) == 0.0
    assert all(float(g.abs().max()) == 0.0 for g in grads.values())


def test_training_step_packs_each_mlp_once_a_version():
    """The training route on a D-NeRF at its published widths (its plain
    versions here) makes two packs a step, whose coarse and fine passes
    share them: Psi_t's, and the one canonical MLP's for both passes;
    after an in-place update (the optimizer's) two new ones, and the new
    parameters reach the kernels' pack."""
    net = make_network(_cfg(*DEFORM_256))
    apply_fn = mlp_train.make_fused_train_apply(net)
    p, t, _ = _deform_batch(n=32)
    made, real = [], tile_mlp.Pack

    def counted(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    def step():
        for model in ("coarse", "fine"):
            raw = apply_fn(p[:, None], F.normalize(p, dim=-1)[:, None],
                           model, t[:, None])
            raw.sum().backward()

    with mock.patch.object(tile_mlp, "Pack", counted):
        step()
        assert len(made) == 2
        with torch.no_grad():
            net.deform.out.bias.add_(1.0)
            net.canonical.rgb.bias.add_(1.0)
        step()
    assert len(made) == 4
    for old, new in zip(made[:2], made[2:]):
        assert new.layout == old.layout
        assert float((new.b - old.b).max()) == 1.0


@pytest.mark.parametrize("case", ["bf16 at W 256", "float32", "bf16 at W 32",
                                  "bf16 at W 32, flag off"])
def test_deformation_route_follows_the_network(case):
    """The training route picks Psi_t's path from what it observes: a bf16
    deformation at the kernels' shape goes through ``FusedDeformMLPFn``
    (its plain versions here: they count a call), a float32 one keeps the
    ``nn.Module`` (nothing counted), and a bf16 one of a width the kernels
    do not cover makes ``network.use_pallas_mlp_train`` raise, naming it,
    as the canonical MLP's does; with the flag off the module trains it."""
    opts = {"bf16 at W 256": DEFORM_256,
            "float32": ("network.dtype", "float32"),
            "bf16 at W 32": (),
            "bf16 at W 32, flag off": ("network.use_pallas_mlp_train",
                                       "False", "network.nerf.W", "32")}[case]
    cfg = _cfg(*opts)
    net = make_network(cfg)
    renderer = NetworkWrapper(net, cfg).renderer
    if case == "bf16 at W 32":
        assert "width 32" in mlp_train.train_unsupported(net)
        assert mlp_train.make_fused_train_apply(net) is None
        with pytest.raises(ValueError, match="width 32"):
            renderer.train_apply
        return
    p, t, cot = _deform_batch(n=64)
    calls = tracing.counts["fused_deform_mlp_reference.calls"]
    fused = case == "bf16 at W 256"
    if case == "bf16 at W 32, flag off":
        assert renderer.train_apply is net
    else:
        assert (deform_mlp.make_train_deform(net) is not None) == fused
    raw = renderer.train_apply(p[:, None], F.normalize(p, dim=-1)[:, None],
                               "", t[:, None])
    (raw * cot.sum(-1, keepdim=True)[:, None]).sum().backward()
    assert tracing.counts["fused_deform_mlp_reference.calls"] == \
        calls + int(fused)
    assert all(q.grad is not None for q in net.deform.parameters())
