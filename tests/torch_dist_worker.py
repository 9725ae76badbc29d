"""One rank of the port's data-parallel CPU checks, launched by
tests/test_torch_parallel.py (not collected: its name does not start with
``test_``). It imports no JAX.

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_dist_worker.py OUTDIR SUITE

makes a gloo group on the CPU (60 s collective timeout), runs the suite's
cases and writes ``rank<r>.json`` and ``rank<r>.pt`` (tensors) to OUTDIR.
Suite ``two`` (2 ranks): the explicit-batch steps held against JAX, the
device sampler's epoch, ``Trainer.train`` over host batches, the brick
encoder's table gradient, sharded eval, both frame renderers, the train
CLI's rank-0 gating and ``dryrun_multichip``. Suite ``three`` (3 ranks):
sharded eval, and a chunk function and both frame renderers with fewer ray
chunks than ranks.
The functions that make each case's inputs are shared with the test, which
runs the one-process references.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from nerf_replication_tpu_torch.config import CN, default_cfg  # noqa: E402
from nerf_replication_tpu_torch.config import load_cfg_tree  # noqa: E402
from nerf_replication_tpu_torch.datasets import DeviceRayPipeline  # noqa: E402
from nerf_replication_tpu_torch.models import make_network  # noqa: E402
from nerf_replication_tpu_torch.models.encoding.hashgrid import (  # noqa: E402
    HashGridEncoder,
)
from nerf_replication_tpu_torch.models.nerf.network import (  # noqa: E402
    make_network as make_nerf_network,
)
from nerf_replication_tpu_torch.models.nerf.renderer import (  # noqa: E402
    ngp_renderer,
)
from nerf_replication_tpu_torch.models.nerf.renderer.volume_renderer import (  # noqa: E402,E501
    Renderer,
    RenderSettings,
)
from nerf_replication_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from nerf_replication_tpu_torch.train import make_trainer  # noqa: E402
from nerf_replication_tpu_torch.train.recorder import Recorder  # noqa: E402

TIMEOUT_S = 60.0


# -- inputs, shared with the test ------------------------------------------

def tiny_cfg(**task):
    """test_parallel.py's tiny NeRF (D 2, W 32, 4/2 frequency bands, f32,
    8 + 8 samples, the nn.Module MLP) on the CPU, with ``task`` on top."""
    cfg = default_cfg()
    cfg.device = "cpu"
    cfg.task_arg.update({"N_rays": 32, "N_samples": 8, "N_importance": 8,
                         "white_bkgd": True, **task})
    cfg.network.nerf = CN({"D": 2, "W": 32, "V_D": 1, "skips": [1]})
    cfg.network.xyz_encoder = CN({"type": "frequency", "input_dim": 3,
                                  "freq": 4})
    cfg.network.dir_encoder = CN({"type": "frequency", "input_dim": 3,
                                  "freq": 2})
    cfg.network.dtype = "float32"
    cfg.network.use_pallas_mlp_train = False
    return cfg


def jax_cfg():
    """The explicit-batch steps held against JAX: no jitter, no noise, and
    the coarse pass alone. With a fine pass the two packages' one-process
    losses already sit 7.5e-6 apart at this init (a float32 cdf that ends
    an ulp off 1.0 moves the last inverse-CDF sample by a bin; the coarse
    outputs agree within 1.8e-7), which would hide what the sharding
    adds."""
    return tiny_cfg(perturb=False, raw_noise_std=0.0, N_importance=0)


def step_batch(step: int, n: int = 32) -> dict:
    """test_multihost.py's global batch of ``step``."""
    rng = np.random.default_rng(100 + step)
    ro = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (n, 1))
    rd = (rng.normal(size=(n, 3)) * 0.1
          + np.array([0.0, 0.0, -1.0])).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    return {"rays_o": ro, "rays_d": rd, "colors": colors}


def sampler_cfg():
    """The device sampler's epoch: jitter, density noise and random
    backgrounds, so every draw site runs."""
    cfg = tiny_cfg(raw_noise_std=1.0, random_bkgd=True)
    cfg.ep_iter = 3
    return cfg


def sampler_pipeline() -> DeviceRayPipeline:
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(3, 8, 8, 3)).astype(np.float32)
    alphas = rng.uniform(size=(3, 8, 8)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 2, 3] = 4.0
    K = np.array([[8.0, 0, 4], [0, 8, 4], [0, 0, 1]], np.float32)
    return DeviceRayPipeline(images, poses, K, n_rays=32, alphas=alphas)


def host_batches() -> list[dict]:
    """Two reference-shaped host batches, (1, 32, 3) and a meta dict."""
    out = []
    for i in range(2):
        b = step_batch(i)
        out.append({**{k: v[None] for k, v in b.items()},
                    "meta": {"H": 8, "W": 8}})
    return out


def brick_encoder() -> HashGridEncoder:
    """test_parallel.py's brick grid: 2 levels 8 -> 16, ``log2_bricks`` 9,
    the table U(-1, 1) from a seeded generator."""
    enc = HashGridEncoder.from_cfg(CN({
        "type": "cuda_hashgrid", "backend": "brick", "input_dim": 3,
        "num_levels": 2, "level_dim": 2, "base_resolution": 8,
        "desired_resolution": 16, "log2_bricks": 9,
        "bounds": [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]}),
        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        enc.table.uniform_(-1.0, 1.0,
                           generator=torch.Generator().manual_seed(1))
    return enc


def brick_points() -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(1).uniform(
        size=(64, 3)).astype(np.float32))


def brick_grad(enc: HashGridEncoder, x: torch.Tensor, mesh=None):
    """The table's gradient of the mean over ``x``'s points of their
    squared features: on a rank, its rows' mean, averaged over the ranks."""
    enc.zero_grad()
    if mesh is not None:
        x = x[mesh.rows(x.shape[0])]
    (enc(x) ** 2).sum(-1).mean().backward()
    if mesh is not None:
        pmesh.all_reduce_mean_grads(enc.parameters(), mesh)
    return enc.table.grad.clone()


def eval_setup(n_rays: int = 100):
    """test_parallel.py's eval case: the tiny network, ``ray_chunk`` 40,
    ``n_rays`` rays (a chunk does not divide them)."""
    cfg = tiny_cfg(ray_chunk=40)
    net = make_network(cfg)
    rng = np.random.default_rng(1)
    ro = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (n_rays, 1))
    rd = (rng.normal(size=(n_rays, 3)) * 0.1 + [0.0, 0.0, -1.0])
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return net, RenderSettings.from_cfg(cfg), ro, rd


def eval_outputs(renderer, ro, rd) -> dict:
    dense = renderer.render_rays_batch(ro, rd)
    fast = renderer.render_image_fast(ro, rd)
    return {"rgb": dense["rgb"], "depth": dense["depth"],
            "fast_rgb": fast["rgb"]}


FRAME_H = FRAME_W = 8
FRAME_FOCAL = 0.5 * FRAME_W / np.tan(0.3)


def frame_pose() -> torch.Tensor:
    c2w = torch.eye(4)
    c2w[2, 3] = 4.0
    return c2w


def frame_occupancy():
    return (np.ones((8, 8, 8), np.uint8), (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
            2)


def freq_frame(mesh=None, segments: int = 1, ray_chunk: int = 32):
    """test_parallel.py's compacted frame (lego at W 32, D 2, f32, 8 + 8
    samples), with ``segments`` ERT segments."""
    cfg = load_cfg_tree(os.path.join(ROOT, "configs/nerf/lego.yaml"),
                        default_cfg())
    cfg.network.dtype = "float32"
    cfg.network.nerf.W, cfg.network.nerf.D = 32, 2
    cfg.network.nerf.skips = [1]
    net = make_network(cfg)
    s = RenderSettings(N_samples=8, N_importance=8, ray_chunk=ray_chunk,
                       ert_segments=segments)
    fn = Renderer(net, settings=s, mesh=mesh).make_frame_renderer(
        FRAME_H, FRAME_W, FRAME_FOCAL, capacity=0.75,
        occupancy=frame_occupancy(), out_dtype=torch.float32)
    return fn(frame_pose())


def ngp_frame(mesh=None, ray_chunk: int = 32):
    """test_parallel.py's NGP frame (3 brick levels, W 16, softplus; the
    unfused route, W 16 being outside the fused kernel)."""
    net = make_nerf_network(CN({
        "task_arg": {"use_viewdirs": True},
        "network": {"dtype": "float32",
                    "nerf": {"W": 16, "D": 2, "V_D": 1, "skips": [1]},
                    "xyz_encoder": {
                        "type": "cuda_hashgrid", "backend": "brick",
                        "input_dim": 3, "num_levels": 3, "level_dim": 2,
                        "base_resolution": 4, "desired_resolution": 16,
                        "log2_bricks": 4,
                        "bounds": [-1.2, -1.2, -1.2, 1.2, 1.2, 1.2]},
                    "dir_encoder": {"type": "sphere_harmonics",
                                    "degree": 2}}})).eval()
    apply_fn = ngp_renderer.make_ngp_eval_apply(net, fused=False)
    s = RenderSettings(ray_chunk=ray_chunk, density_activation="softplus")
    fn = ngp_renderer.make_ngp_frame_renderer(
        apply_fn, FRAME_H, FRAME_W, FRAME_FOCAL, frame_occupancy(), s,
        n_candidates=8, n_coarse=6, n_fine=6, capacity=0.75, probe_sub=1,
        out_dtype=torch.float32, mesh=mesh)
    return fn(frame_pose())


def train_device_run(mesh=None, control: str | None = None):
    """The device sampler's epoch on a fresh tiny network: (per-step
    losses, parameters); ``control`` names a faulty rank of
    ``parallel.dryrun.CONTROLS``."""
    from nerf_replication_tpu_torch.parallel.dryrun import control_mesh

    cfg = sampler_cfg()
    net = make_network(cfg)
    if control is not None:
        mesh = control_mesh(mesh, control)
    trainer = make_trainer(cfg, net, mesh=mesh)
    summary = trainer.train_device(0, sampler_pipeline())
    return summary["loss"].tolist(), net.state_dict()


def host_train_run(mesh=None):
    """``Trainer.train`` over :func:`host_batches`: (losses, parameters)."""
    cfg = tiny_cfg()
    cfg.record_dir = os.devnull
    net = make_network(cfg)
    trainer = make_trainer(cfg, net, mesh=mesh)
    summary = trainer.train(0, host_batches(), Recorder(cfg, process_index=1))
    return summary["loss"].tolist(), net.state_dict()


# -- the ranks' cases -------------------------------------------------------

def jax_steps(mesh, weights: dict) -> tuple[list, dict]:
    """Two data-parallel steps on the explicit global batches from
    ``weights`` (the JAX init, through the bridge)."""
    cfg = jax_cfg()
    net = make_network(cfg)
    net.load_state_dict(weights)
    trainer = make_trainer(cfg, net, mesh=mesh)
    step = pmesh.make_dp_train_step(trainer, mesh)
    losses = []
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in step_batch(i).items()}
        losses.append(float(step(batch)["loss"]))
    return losses, net.state_dict()


def cli_gating(mesh, outdir: str) -> dict:
    """The train CLI under the group on a 16x16 probe scene, each rank with
    its own checkpoint and record directories: which came to exist."""
    from nerf_replication_tpu_torch.train.cli import main as train_main
    from nerf_replication_tpu_torch.utils import synthetic_scene

    scene = os.path.join(outdir, "scene")
    if mesh.is_main:
        synthetic_scene.generate_scene(scene, "probe", H=16, W=16, n_train=2,
                                       n_val=0, n_test=1)
    mesh.barrier()
    mine = os.path.join(outdir, f"r{mesh.rank}")
    os.chdir(ROOT)
    trainer = train_main([
        "--cfg_file", "configs/nerf/probe.yaml", "device", "cpu",
        "network.nerf.D", "4", "network.nerf.skips", "[1]",
        "task_arg.N_samples", "8", "task_arg.N_importance", "8",
        "task_arg.N_rays", "32",
        "train_dataset.data_root", scene, "test_dataset.data_root", scene,
        "train_dataset.H", "16", "train_dataset.W", "16",
        "test_dataset.H", "16", "test_dataset.W", "16",
        "test_dataset.input_ratio", "1.0",
        "trained_model_dir", os.path.join(mine, "model"),
        "record_dir", os.path.join(mine, "record"),
        "result_dir", os.path.join(mine, "result"), "save_result", "False",
        "ep_iter", "2", "save_ep", "1", "save_latest_ep", "1", "eval_ep", "1",
        "train.epoch", "1", "resume", "False"])
    return {"model_dir": os.path.isdir(os.path.join(mine, "model")),
            "record_dir": os.path.isdir(os.path.join(mine, "record")),
            "steps": trainer.step, "evals": trainer.evals,
            "loss": trainer.summaries[-1]["loss"].tolist()}


def suite_two(mesh, outdir: str) -> tuple[dict, dict]:
    from nerf_replication_tpu_torch.parallel.dryrun import dryrun_multichip

    out, tensors = {}, {}
    weights = torch.load(os.path.join(outdir, "jax_init.pt"))
    out["jax_losses"], tensors["jax_params"] = jax_steps(mesh, weights)
    out["device_losses"], tensors["device_params"] = train_device_run(mesh)
    out["own_draws_losses"], _ = train_device_run(mesh, "own draws")
    out["host_losses"], tensors["host_params"] = host_train_run(mesh)
    tensors["brick_grad"] = brick_grad(brick_encoder(), brick_points(), mesh)
    net, s, ro, rd = eval_setup()
    renderer = Renderer(net, settings=s)            # the auto mesh
    out["auto_mesh"] = renderer.mesh is not None \
        and renderer.mesh.size == mesh.size
    tensors["eval"] = eval_outputs(renderer, ro, rd)
    tensors["freq_frame"] = freq_frame(mesh)
    tensors["ert_frame"] = freq_frame(mesh, segments=2)
    tensors["ngp_frame"] = ngp_frame(mesh)
    out["gating"] = cli_gating(mesh, outdir)
    out["dryrun"] = dryrun_multichip(mesh.size, "cpu")
    return out, tensors


def idle_rank_render(mesh) -> tuple[int, dict]:
    """``make_dp_eval_render`` of a dict-valued chunk function over 2
    chunks of 4 rows: (the calls this rank made, the gathered outputs)."""
    calls = []

    def chunk_fn(x):
        calls.append(x.shape[0])
        return {"double": 2.0 * x, "hit": x[:, 0] > 3.0}

    got = pmesh.make_dp_eval_render(chunk_fn, mesh, 4)(
        torch.arange(16.0).reshape(8, 2))
    return len(calls), got


def suite_three(mesh, outdir: str) -> tuple[dict, dict]:
    out, tensors = {}, {}
    out["idle_calls"], tensors["idle_render"] = idle_rank_render(mesh)
    net, s, ro, rd = eval_setup()
    tensors["eval"] = eval_outputs(Renderer(net, settings=s), ro, rd)
    # 64 rays in chunks of 32: two chunks, so rank 2 renders none
    tensors["freq_frame"] = freq_frame(mesh)
    tensors["ngp_frame"] = ngp_frame(mesh)
    return out, tensors


def main(outdir: str, suite: str):
    torch.set_num_threads(1)
    mesh = pmesh.make_mesh(device="cpu", timeout_s=TIMEOUT_S)
    try:
        out, tensors = {"two": suite_two, "three": suite_three}[suite](
            mesh, outdir)
        out["rank"], out["size"] = mesh.rank, mesh.size
        torch.save(tensors, os.path.join(outdir, f"rank{mesh.rank}.pt"))
        with open(os.path.join(outdir, f"rank{mesh.rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
