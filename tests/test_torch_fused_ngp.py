"""Port parity for the fused brick encode + NGP MLP eval: the weight
carry-over (extract_mlp_weights) and the plain version of the kernel (the
CPU path of the wrapper that launches csrc/fused_ngp.cu) against the JAX
package's fused_ngp_eval in interpret mode, at the skip placements of
tests/test_fused_ngp.py. Inputs are made from seeds with numpy."""

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
from nerf_replication_tpu_torch.config import CN
from nerf_replication_tpu_torch.models.nerf.network import make_network
from nerf_replication_tpu_torch.ops import (
    eval_encode,
    fused_ngp,
    hashgrid_kernel,
)
from nerf_replication_tpu_torch.utils import tracing
from nerf_replication_tpu_torch.utils.ckpt_utils import params_from_jax

SKIPS = [(3, [1]), (2, [1]), (2, []), (3, [0, 1])]


def small_cfg(depth, skips, width=16, degree=2):
    """tests/test_fused_ngp.py's network: 3 levels, 16-wide MLP."""
    return {
        "task_arg": {"use_viewdirs": True},
        "network": {
            "dtype": "float32",
            "nerf": {"W": width, "D": depth, "V_D": 1, "skips": skips},
            "xyz_encoder": {
                "type": "cuda_hashgrid", "backend": "brick",
                "input_dim": 3, "num_levels": 3, "level_dim": 2,
                "base_resolution": 4, "desired_resolution": 16,
                "log2_hashmap_size": 10, "log2_bricks": 4,
                "bounds": [-1.2, -1.2, -1.2, 1.2, 1.2, 1.2],
            },
            "dir_encoder": {"type": "sphere_harmonics", "degree": degree},
        },
    }


@functools.cache
def both(depth, skips):
    """(jax net, jax params from seed ``depth``, port net with the same
    weights) of :func:`small_cfg`, made once per placement."""
    cfg_dict = small_cfg(depth, list(skips))
    net = jax_make_network(JaxCN(cfg_dict))
    params = init_params(net, jax.random.key(depth))
    port = make_network(CN(cfg_dict))
    port.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jax.device_get(params))))
    return net, params, port


def rays(n_rays, n_samples, seed):
    g = np.random.default_rng(seed)
    pts = g.uniform(-1.3, 1.3, (n_rays, n_samples, 3)).astype(np.float32)
    dirs = g.normal(size=(n_rays, 1, 3)).astype(np.float32)
    return pts, dirs


@pytest.mark.parametrize("depth,skips", SKIPS)
def test_extract_mlp_weights_matches_jax(depth, skips):
    """The port's operands are JAX's, transposed back from nn.Linear's
    (out, in): equal exactly, in the same order, with the same meta."""
    _, params, port = both(depth, tuple(skips))
    for branch in ("coarse", "fine"):
        mlp = getattr(port, branch)
        ops, meta = fused_ngp.extract_mlp_weights(
            mlp.state_dict(), 6, depth, tuple(skips), 1)
        ref_ops, ref_meta = jax_fused.extract_mlp_weights(
            params["params"][branch], 6, depth, tuple(skips), 1)
        assert meta == ref_meta
        assert len(ops.ops) == len(ref_ops)
        for a, b in zip(ops.ops, ref_ops):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("depth,skips", SKIPS)
def test_plain_fused_matches_jax(depth, skips, monkeypatch):
    """The plain fused_ngp_eval on the port's pack against JAX's
    make_ngp_eval_apply (its fused Pallas kernel in interpret mode, f32
    HIGHEST) on the same weights and points. Both read the same bf16
    table values and multiply in f32; the MLP's sums run in other orders:
    atol 1e-5 + rtol 1e-5 on outputs of order 1."""
    monkeypatch.setenv("NGP_FUSED", "1")
    net, params, port = both(depth, tuple(skips))
    pts, dirs = rays(9, 5, seed=len(skips))
    expect = jax_make_ngp_eval_apply(net, params)(
        params, jnp.asarray(pts), jnp.asarray(dirs), "fine")
    enc = port.xyz_encoder
    x = enc.to_unit(torch.from_numpy(pts).reshape(-1, 3))
    sh = port.dir_encoder(torch.from_numpy(dirs)).expand(9, 5, 4)
    ops, meta = fused_ngp.extract_mlp_weights(
        port.fine.state_dict(), 6, depth, tuple(skips), 1)
    calls = tracing.counts["fused_ngp_eval_reference.calls"]
    out = fused_ngp.fused_ngp_eval(
        enc.layout, meta, eval_encode.pack_eval_table(enc.table.detach()),
        ops, x, sh.reshape(-1, 4))
    assert tracing.counts["fused_ngp_eval_reference.calls"] == calls + 1
    np.testing.assert_allclose(out.reshape(9, 5, 4).numpy(),
                               np.asarray(expect), atol=1e-5, rtol=1e-5)


def test_pack_layout_of_hard_ngp_branch():
    """hard_ngp's branch (D=3, W=64, skip [1], 12 levels, 16 SH): 18,408
    f32 (73.6 KB of shared memory), every segment a multiple of 4 floats
    so the kernel reads rows as float4."""
    cfg = small_cfg(3, [1], width=64, degree=4)
    cfg["network"]["xyz_encoder"].update(
        num_levels=12, base_resolution=16, desired_resolution=512,
        log2_bricks=9)
    port = make_network(CN(cfg))
    ops, meta = fused_ngp.extract_mlp_weights(
        port.fine.state_dict(), 24, 3, (1,), 1)
    assert meta == (("plain", "plain", "split"), False)
    assert ops.flat.numel() == 18_408
    assert all(t.numel() % 4 == 0 or t.shape[0] == 1 for t in ops.ops)
    assert fused_ngp.flops_per_point(port.xyz_encoder.layout, ops) == \
        36_160 + hashgrid_kernel.encode_flops_per_point(
            port.xyz_encoder.layout)


@pytest.mark.parametrize("change,match", [
    ({"nerf": {"W": 200}}, "width 200"),
    ({"dir_encoder": {"degree": 2}}, "4 direction features"),
    ({"nerf": {"V_D": 2}}, "view_depth 2"),
])
def test_kernel_coverage_names_what_differs(change, match):
    from nerf_replication_tpu_torch.models.nerf.renderer import ngp_renderer

    cfg = small_cfg(3, [1], width=64, degree=4)
    for key, value in change.items():
        cfg["network"][key].update(value)
    net = make_network(CN(cfg))
    assert ngp_renderer.unsupported(net) is not None
    with pytest.raises(ValueError, match=match):
        ngp_renderer.make_ngp_eval_apply(net)
    assert ngp_renderer.make_ngp_eval_apply(net, fused=False) is not None
