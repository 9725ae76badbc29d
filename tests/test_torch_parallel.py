"""Port parity for data parallelism (``nerf_replication_tpu_torch.parallel``):
gloo groups of CPU ranks (tests/torch_dist_worker.py), launched once per
module, held against the JAX package's ``make_dp_train_step`` on a 2-device
mesh of the conftest's simulated devices, and against the port's own
one-process runs, with the bounds of tests/test_parallel.py and
tests/test_multihost.py; and single-process cases of the sharding rules.

Each launch has a free port, a 60 s collective timeout in the ranks, a
180 s limit on the whole group and a kill of every rank on failure.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from nerf_replication_tpu import config as jax_config
from nerf_replication_tpu.models import make_network as jax_make_network
from nerf_replication_tpu.models.nerf.network import init_params
from nerf_replication_tpu.parallel import mesh as jax_mesh
from nerf_replication_tpu.train import make_trainer as jax_make_trainer
from nerf_replication_tpu_torch.models.nerf.renderer.volume_renderer import (
    Renderer,
)
from nerf_replication_tpu_torch.parallel import mesh as pmesh
from nerf_replication_tpu_torch.utils.ckpt_utils import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
GROUP_TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(outdir: str, suite: str, n: int) -> dict:
    """Run ``suite`` on ``n`` gloo ranks; every rank is killed if one fails
    or the group outlives GROUP_TIMEOUT_S. Returns {rank: (json, tensors)}."""
    env = {**os.environ, "PYTHONPATH": ROOT, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(n),
           "LOCAL_WORLD_SIZE": str(n), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, outdir, suite],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {n}-rank group outlived {GROUP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} (exit {p.returncode}):\n{log[-3000:]}"
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not failed, "\n".join(failed)
    out = {}
    for r in range(n):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            out[r] = (json.load(f), torch.load(
                os.path.join(outdir, f"rank{r}.pt")))
    out["log"] = logs[0]
    return out


def _jax_init():
    jcfg = jax_config.default_cfg()
    jcfg.task_arg.update({"N_rays": 32, "N_samples": 8, "N_importance": 0,
                          "white_bkgd": True, "perturb": False,
                          "raw_noise_std": 0.0})
    jcfg.network.nerf = {"D": 2, "W": 32, "V_D": 1, "skips": [1]}
    jcfg.network.xyz_encoder = {"type": "frequency", "input_dim": 3,
                                "freq": 4}
    jcfg.network.dir_encoder = {"type": "frequency", "input_dim": 3,
                                "freq": 2}
    jcfg.network.dtype = "float32"
    net = jax_make_network(jcfg)
    return jcfg, net, init_params(net, jax.random.key(0))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("dp2"))
    _, _, params = _jax_init()
    torch.save(params_from_jax(jax.tree.map(np.asarray, params)),
               os.path.join(outdir, "jax_init.pt"))
    return _launch(outdir, "two", 2)


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    return _launch(str(tmp_path_factory.mktemp("dp3")), "three", 3)


def _same_on_every_rank(group, key):
    first = group[0][1][key]
    for r in range(1, len(group) - 1):
        other = group[r][1][key]
        if isinstance(first, dict):
            for k in first:
                assert torch.equal(first[k], other[k]), (key, k, r)
        else:
            assert torch.equal(first, other), (key, r)
    return first


def _assert_params(got: dict, ref: dict, rtol=2e-4, atol=2e-6):
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_dp_steps_match_jax_make_dp_train_step(two_ranks):
    """Two data-parallel steps on explicit global batches, 2 port ranks
    against the JAX package's make_dp_train_step on a 2-device mesh, from
    the same init: losses rtol 1e-5, leaves rtol 2e-4 / atol 2e-6
    (test_parallel.py:271-274). No jitter or noise, and the coarse pass
    alone (torch_dist_worker.jax_cfg says why)."""
    jcfg, net, params = _jax_init()
    trainer = jax_make_trainer(jcfg, net)
    mesh = jax_mesh.make_mesh(n_devices=2)
    step = jax_mesh.make_dp_train_step(trainer._train_step_inner, mesh)
    state = jax_mesh.replicate_tree(trainer.init_state(params), mesh)
    losses = []
    for i in range(2):
        batch = jax_mesh.shard_batch(
            {k: jnp.asarray(v) for k, v in worker.step_batch(i).items()},
            mesh)
        state, stats = step(state, batch, jax.random.key(3 + i))
        losses.append(float(stats["loss"]))
    for r in (0, 1):
        np.testing.assert_allclose(two_ranks[r][0]["jax_losses"], losses,
                                   rtol=1e-5)
    got = _same_on_every_rank(two_ranks, "jax_params")
    _assert_params(got, params_from_jax(jax.tree.map(np.asarray,
                                                     state["params"])))


def test_train_device_draws_the_global_batch(two_ranks):
    """The device sampler's epoch (jitter, density noise, random
    backgrounds) on 2 ranks against one process: per-step losses rtol 1e-5,
    parameters rtol 2e-4 / atol 2e-6. Ranks that draw their own rays (the
    control) train on another batch and miss the losses."""
    ref_losses, ref_params = worker.train_device_run()
    for r in (0, 1):
        np.testing.assert_allclose(two_ranks[r][0]["device_losses"],
                                   ref_losses, rtol=1e-5)
    _assert_params(_same_on_every_rank(two_ranks, "device_params"),
                   ref_params)
    own = np.asarray(two_ranks[0][0]["own_draws_losses"])
    assert np.max(np.abs(own - ref_losses) / np.abs(ref_losses)) > 1e-3


def test_host_loader_train_shards_host_batches(two_ranks):
    """``Trainer.train`` over (1, 32, 3) host batches: each rank takes its
    16 rays (shard_host_batch's ray axis 1); losses rtol 1e-5 and
    parameters rtol 2e-4 / atol 2e-6 against one process."""
    ref_losses, ref_params = worker.host_train_run()
    np.testing.assert_allclose(two_ranks[0][0]["host_losses"], ref_losses,
                               rtol=1e-5)
    _assert_params(_same_on_every_rank(two_ranks, "host_params"), ref_params)


def test_brick_table_gradient_after_all_reduce(two_ranks):
    """The plain brick encoder's table gradient of each rank's 32 points,
    averaged over the ranks, against one process's over all 64: within
    1e-5 of the largest |gradient| (#7's own atomic-order bound)."""
    ref = worker.brick_grad(worker.brick_encoder(), worker.brick_points())
    got = _same_on_every_rank(two_ranks, "brick_grad")
    assert float(ref.abs().max()) > 0
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _assert_same(a, b, atol):
    """test_parallel.py's bound: atol, and > 90% of rays bit-equal."""
    a, b = a.numpy(), b.numpy()
    np.testing.assert_allclose(a, b, atol=atol)
    exact = np.mean(np.all(a.reshape(len(a), -1) == b.reshape(len(b), -1),
                           axis=-1))
    assert exact > 0.9, f"only {exact:.0%} rays bit-equal"


@pytest.mark.parametrize("group", ["two_ranks", "three_ranks"])
def test_sharded_eval_matches_one_process(group, request):
    """render_rays_batch and render_image_fast of 100 rays at ray_chunk 40
    (three chunks, dealt out whole) under the auto mesh against one
    process: JAX's test_renderer_eval_dp_default_and_bitwise_equal bounds
    (atol 5e-4, depth 5e-3, > 90% bit-equal; read: bit-equal)."""
    ranks = request.getfixturevalue(group)
    if group == "two_ranks":
        assert ranks[0][0]["auto_mesh"]
    net, s, ro, rd = worker.eval_setup()
    ref = worker.eval_outputs(Renderer(net, settings=s), ro, rd)
    got = _same_on_every_rank(ranks, "eval")
    _assert_same(got["rgb"], ref["rgb"], 5e-4)
    _assert_same(got["depth"], ref["depth"], 5e-3)
    _assert_same(got["fast_rgb"], ref["fast_rgb"], 5e-4)


@pytest.mark.parametrize("group,key,segments", [
    ("two_ranks", "freq_frame", 1), ("two_ranks", "ert_frame", 2),
    ("three_ranks", "freq_frame", 1)])
def test_frame_renderer_sharded_matches_single(group, key, segments,
                                               request):
    """The compacted frame (and its ERT form) on the group against one
    process: JAX's bounds (< 5% of pixels off by > 1e-3, max < 2e-2; read:
    bit-equal). On 3 ranks the frame's two chunks leave one rank idle."""
    ref = worker.freq_frame(segments=segments)
    diff = (_same_on_every_rank(request.getfixturevalue(group), key)
            - ref).abs()
    assert float((diff > 1e-3).float().mean()) < 0.05
    assert float(diff.max()) < 2e-2


@pytest.mark.parametrize("group", ["two_ranks", "three_ranks"])
def test_ngp_frame_renderer_sharded_matches_single(group, request):
    """The NGP frame-path frame on the group against one process within
    JAX's atol 1e-5 (read: bit-equal); on 3 ranks one holds no chunk."""
    got = _same_on_every_rank(request.getfixturevalue(group), "ngp_frame")
    ref = worker.ngp_frame()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


def test_idle_rank_renders_no_chunk(three_ranks):
    """Two chunks over three ranks: rank 2 calls the chunk function not
    once (it takes the outputs' keys, shapes and dtypes from rank 0), and
    every rank holds the whole dict of outputs, bools cast back."""
    x = torch.arange(16.0).reshape(8, 2)
    assert [three_ranks[r][0]["idle_calls"] for r in range(3)] == [1, 1, 0]
    for r in range(3):
        got = three_ranks[r][1]["idle_render"]
        assert torch.equal(got["double"], 2.0 * x)
        assert got["hit"].dtype == torch.bool
        assert torch.equal(got["hit"], x[:, 0] > 3.0)


def test_rank0_gating_of_records_and_checkpoints(two_ranks):
    """The train CLI under the group, each rank pointed at its own
    directories: only rank 0's checkpoint and record directories come into
    existence (test_multihost.py:104-110), both ranks step together and
    rank 0 alone evaluates the sharded val render."""
    g0, g1 = two_ranks[0][0]["gating"], two_ranks[1][0]["gating"]
    assert g0["model_dir"] and g0["record_dir"]
    assert not g1["model_dir"] and not g1["record_dir"]
    assert g0["steps"] == g1["steps"] == 2 and g0["loss"] == g1["loss"]
    assert set(g0["evals"][0]) == {"mse", "psnr", "ssim"}
    assert g1["evals"] == []


def test_dryrun_multichip_on_two_cpu_ranks(two_ranks):
    """dryrun_multichip(2, "cpu") with the JAX dry run's asserts (it raises
    on a miss) and its line in MULTICHIP_r05.json's format; the bf16 arm's
    faulty ranks fall outside its loss bound and the first-step gradient
    bound."""
    from nerf_replication_tpu_torch.parallel import dryrun

    d = two_ranks[0][0]["dryrun"]
    assert d["n_ranks"] == 2 and np.isfinite(d["loss"])
    assert d["max_param_diff"] < 3e-3 and d["eval_diff"] < 1e-3
    assert d["frame_diff"] < 5e-2 and d["ngp_frame_diff"] < 5e-2
    assert d["bf16_loss_rel"] <= dryrun.BF16_LOSS_RTOL
    assert all(v > dryrun.BF16_LOSS_RTOL
               for v in d["bf16_controls"].values())
    assert d["grad_diff"] <= dryrun.GRAD_TOL
    assert d["bf16_grad_diff"] <= dryrun.GRAD_TOL
    assert all(v > dryrun.GRAD_TOL
               for v in d["bf16_control_grads"].values())
    assert "dryrun_multichip(2): ok, loss=" in two_ranks["log"]


# -- single-process cases ----------------------------------------------------

def _mesh(rank: int, size: int) -> pmesh.Mesh:
    return pmesh.Mesh(rank=rank, size=size, device=torch.device("cpu"),
                      backend="gloo")


@pytest.mark.parametrize("shape,size,rank,axis", [
    ((1, 32), 2, 1, 1), ((4, 8), 2, 1, 0), ((1, 7), 2, 0, None),
    ((3, 8), 2, 1, 1), ((1, 12), 3, 2, 1)])
def test_shard_host_batch_axis_rule(shape, size, rank, axis):
    """The ray axis is the first of the rays' leading axes that divides by
    the group's size; every leaf that starts with those axes is split on
    it, the rest (meta, strings, a batch no axis divides) stays whole; the
    rank's rows in the flattened order are a slice where contiguous."""
    n = int(np.prod(shape))
    batch = {"rays_o": np.arange(n * 3, dtype=np.float32).reshape(
                 *shape, 3),
             "alpha": np.arange(n, dtype=np.float32).reshape(shape),
             "scale": np.ones(5, np.float32), "name": np.array(["a", "b"]),
             "meta": {"H": 8, "W": 8}}
    mesh = _mesh(rank, size)
    out = pmesh.shard_host_batch(batch, mesh)
    index, total = pmesh.host_batch_rows(batch, mesh)
    assert total == n and out["meta"] == batch["meta"]
    assert out["scale"] is batch["scale"] and out["name"] is batch["name"]
    if axis is None:
        assert index is None and out["rays_o"] is batch["rays_o"]
        return
    part = shape[axis] // size
    sl = [slice(None)] * 2
    sl[axis] = slice(rank * part, (rank + 1) * part)
    np.testing.assert_array_equal(out["rays_o"], batch["rays_o"][tuple(sl)])
    np.testing.assert_array_equal(out["alpha"], batch["alpha"][tuple(sl)])
    rows = np.arange(n)[index] if isinstance(index, slice) \
        else index.numpy()
    np.testing.assert_array_equal(rows, out["alpha"].ravel())
    assert isinstance(index, slice) == (int(np.prod(shape[:axis])) == 1)


def test_chunk_rows_deals_whole_chunks():
    """Rank r of N takes chunks r, r + N, ...; none when there are fewer
    chunks than ranks; rows that are not whole chunks raise."""
    x = torch.arange(24).reshape(12, 2)
    got = pmesh.chunk_rows(x, _mesh(1, 2), 3)
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  [6, 8, 10, 18, 20, 22])
    assert pmesh.chunk_rows(x, _mesh(3, 4), 6).shape == (0, 2)
    with pytest.raises(ValueError):
        pmesh.chunk_rows(x, _mesh(0, 2), 5)


def test_mesh_data_against_world_size(monkeypatch):
    """``mesh.data`` -1 or the group's size builds the mesh; any other
    value raises. A one-rank gloo group in this process."""
    from nerf_replication_tpu_torch.config import default_cfg

    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    cfg = default_cfg()
    cfg.device = "cpu"
    assert cfg.mesh.data == -1
    try:
        mesh = pmesh.make_mesh(cfg, timeout_s=60)
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        cfg.mesh.data = 1
        assert pmesh.make_mesh(cfg).size == 1
        cfg.mesh.data = 2
        with pytest.raises(ValueError, match="mesh.data 2"):
            pmesh.make_mesh(cfg)
        assert pmesh.default_mesh(cfg) is None   # one rank: no sharding
    finally:
        torch.distributed.destroy_process_group()
