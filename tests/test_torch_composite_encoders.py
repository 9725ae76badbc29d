"""Port parity for the composite and D-NeRF encoders built on the
vertex-exact hash grid: all 11 config type names of
nerf_replication_tpu/models/encoding/__init__.py at the small configs of
tests/test_hashgrid.py, with the Flax init carried to the port by
``params_from_jax``, against the JAX modules on the same seeded numpy
inputs: the forward, every parameter gradient and the points' gradient
(``jax.grad``), the canonical frames, the Flax tree round trip of the
weight bridge, and ``num_frames`` propagation by ``make_network``.

Tolerances: forward within atol 1e-5 (float32; the deformation MLPs sum
their products in another order); gradients within rtol 1e-4 and atol
1e-5 of the leaf's largest |gradient| (f32 sums in another order,
through the same analytic backward); the weight bridge bit-equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_replication_tpu.config import CN as JaxCN
from nerf_replication_tpu.models.encoding import get_encoder as jax_get_encoder
from nerf_replication_tpu_torch.config import CN, default_cfg
from nerf_replication_tpu_torch.models.encoding import get_encoder
from nerf_replication_tpu_torch.models.nerf.network import make_network
from nerf_replication_tpu_torch.utils.ckpt_utils import (
    params_from_jax,
    params_to_jax,
)

BOUNDS = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
GRID = {"num_levels": 2, "level_dim": 2, "base_resolution": 4,
        "log2_hashmap_size": 10, "per_level_scale": 2.0, "bounds": BOUNDS}
# tests/test_hashgrid.py's encoder zoo and D-NeRF cases
CASES = {
    "triplane": {}, "cuda_triplane": {},
    "cuda_hashgrid_latent": {"num_frames": 3},
    "cuda_hashgrid_4d": {"num_frames": 3},
    "cuda_hashgrid_coef": {"num_frames": 3, "basis_num": 2},
    "cuda_motion2d": {"num_frames": 3},
    **{v: {"freq": 4, "W": 32, "D": 2, "num_frames": 3} for v in (
        "dnerf", "dnerf_mlp_tensorf", "dnerf_ngp_mlp", "dnerf_ngp_tensorf",
        "cuda_dnerf_ngp_tensorf")},
}
TIMED = [t for t in CASES if not t.endswith("triplane")]
N = 64
FWD_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def section(name, **extra):
    return {"type": name, **GRID, **CASES[name], **extra}


def inputs(name, t=None, seed=0):
    """N points inside the bounds, and for the timed encoders frames 0, 1,
    2 and fractional times (HashLatent truncates them)."""
    g = np.random.default_rng(seed)
    xyz = g.uniform(-0.9, 0.9, (N, 3))
    if name not in TIMED:
        return xyz.astype(np.float32)
    if t is None:
        t = g.choice([0.0, 1.0, 2.0, 0.5, 1.7], N)
    return np.concatenate([xyz, np.broadcast_to(t, (N,))[:, None]],
                          -1).astype(np.float32)


@functools.cache
def case(name, d=None):
    """(the JAX module's jitted apply and gradient (params, points) of
    sum(out x cot), its Flax params from seed 1 as numpy, port module with
    those weights) of ``name``'s small config (depth ``d`` for dnerf)."""
    cfg = section(name, **({"D": d} if d else {}))
    jenc = jax_get_encoder(JaxCN(cfg))
    x = jnp.asarray(inputs(name))
    params = jax.tree.map(np.asarray,
                          jax.jit(jenc.init)(jax.random.key(1), x))
    enc = get_encoder(CN(cfg))
    enc.load_state_dict(params_from_jax(params))

    def loss(p, xx, cot):
        return jnp.sum(jenc.apply(p, xx) * cot)

    fns = jax.jit(jenc.apply), jax.jit(jax.grad(loss, argnums=(0, 1)))
    return fns, params, enc


def jax_run(fns, params, x, cot):
    apply, grad = fns
    grads = grad(params, jnp.asarray(x), jnp.asarray(cot))
    return (np.asarray(apply(params, jnp.asarray(x))),
            jax.tree.map(np.asarray, grads))


def port_run(enc, x, cot):
    enc.zero_grad(set_to_none=True)
    xx = torch.from_numpy(x).requires_grad_(True)
    out = enc(xx)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in enc.named_parameters()}
    return out.detach().numpy(), grads, xx.grad


def close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    atol = GRAD_ATOL * max(float(np.abs(b).max()), 1e-30)
    np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=atol)


def check(name, x, d=None, seed=2):
    fns, params, enc = case(name, d)
    cot = np.random.default_rng(seed).normal(
        size=(N, enc.output_dim)).astype(np.float32)
    out, grads, dx = port_run(enc, x, cot)
    jout, (jgrads, jdx) = jax_run(fns, params, x, cot)
    assert out.shape == (N, enc.output_dim) == jout.shape
    np.testing.assert_allclose(out, jout, atol=FWD_ATOL, rtol=0)
    expect = params_from_jax(jgrads)
    assert set(expect) == set(grads)
    for key, g in grads.items():
        close(g.numpy(), expect[key].numpy())
    close(dx.numpy(), jdx)
    return out, grads, dx


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_gradients_match_jax(name):
    out, grads, dx = check(name, inputs(name))
    assert np.isfinite(out).all()
    # every parameter learns, and the points get a gradient through the
    # grids' analytic input gradient
    moved = [k for k, g in grads.items() if g.abs().max() > 0]
    assert moved == list(grads), set(grads) - set(moved)
    assert dx.abs().max() > 0


@pytest.mark.parametrize("name", [n for n in TIMED
                                  if n != "cuda_hashgrid_latent"])
def test_canonical_frame(name):
    """At the canonical frame (t = 0; t = -1 for dnerf) the points are not
    deformed: the parity holds there too, and a deformation's parameters
    get no gradient through the unchosen branch."""
    t = -1.0 if name == "dnerf" else 0.0
    out, grads, _ = check(name, inputs(name, t=t, seed=3), seed=4)
    deform = [k for k in grads if k.startswith(("mlp", "st_feat",
                                                "time_"))]
    for key in deform:
        assert not grads[key].any(), key
    if name == "dnerf":
        from nerf_replication_tpu_torch.models.encoding.freq import freq_encode
        x = torch.from_numpy(inputs(name, t=t, seed=3))
        assert torch.equal(torch.from_numpy(out), freq_encode(x[:, :3], 4))


def test_dnerf_skip_layer():
    """D 6: the encoding re-enters after layer 4 as [enc, h], so layer 5
    takes W + enc_dim inputs (Flax's kernel shape, carried over)."""
    _, params, enc = case("dnerf", 6)
    enc_dim = 4 * (1 + 2 * 4)
    assert params["params"]["time_mlp_5"]["kernel"].shape == (32 + enc_dim,
                                                              32)
    assert tuple(enc.time_mlp[5].weight.shape) == (32, 32 + enc_dim)
    check("dnerf", inputs("dnerf"), d=6, seed=5)


@pytest.mark.parametrize("name", list(CASES))
def test_weight_bridge_round_trip(name):
    """params_to_jax(params_from_jax(tree)) gives the Flax tree back, bit
    for bit, and the port module's state_dict has the same keys."""
    _, params, enc = case(name)
    state = params_from_jax(params)
    assert set(state) == set(enc.state_dict())
    back = params_to_jax(state)
    flat, tree = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree == tree_b
    for a, b in zip(flat, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_nested_names():
    """Flax names at several depths map to the port's state_dict keys."""
    keys = {n: set(params_from_jax(case(n)[1])) for n in (
        "cuda_triplane", "cuda_motion2d", "cuda_hashgrid_coef",
        "cuda_hashgrid_latent", "dnerf_ngp_tensorf", "dnerf")}
    assert "xy_plane.table" in keys["cuda_triplane"]
    assert {"mlp.3.weight", "mlp.3.bias", "mlp_out.weight"} <= \
        keys["cuda_motion2d"]
    assert {"basis.1.table", "coefs.table", "coef_mlp_out.weight"} <= \
        keys["cuda_hashgrid_coef"]
    assert "latent_t" in keys["cuda_hashgrid_latent"]
    assert {"st_feat_1", "grid.table"} <= keys["dnerf_ngp_tensorf"]
    assert {"time_mlp.1.weight", "time_out.bias"} <= keys["dnerf"]
    _, _, coef = case("cuda_hashgrid_coef")
    assert coef.coefs.input_dim == 4 and coef.coefs.log2_hashmap_size == 20


def test_num_frames_propagates():
    """make_network hands a top-level num_frames to the encoder sections
    that do not set their own (tests/test_hashgrid.py's case)."""
    cfg = default_cfg()
    cfg.num_frames = 7
    cfg.network.nerf = {"D": 2, "W": 32, "V_D": 1, "skips": [1]}
    cfg.network.xyz_encoder = CN({
        "type": "cuda_hashgrid_latent", "num_levels": 2, "level_dim": 2,
        "base_resolution": 4, "log2_hashmap_size": 10, "bounds": BOUNDS})
    cfg.network.dir_encoder = {"type": "frequency", "input_dim": 3, "freq": 2}
    net = make_network(cfg)
    assert net.xyz_encoder.num_frames == 7
    assert tuple(net.xyz_encoder.latent_t.shape) == (7, 32)
    assert cfg.network.xyz_encoder.num_frames == 7
    cfg.network.xyz_encoder.num_frames = 2
    assert make_network(cfg).xyz_encoder.num_frames == 2


@pytest.mark.parametrize("frames", [2, 3, 5, 7])
def test_frame_time_is_jitted_jax_division(frames):
    """The encoders' t / frames is jitted XLA's product by the f32
    reciprocal, bit for bit (the CPU's true division rounds a third of
    t / 3 one ulp apart, which the finest cells of a 4-D grid magnify)."""
    from nerf_replication_tpu_torch.models.encoding.hashgrid import (
        frame_time,
    )

    t = np.random.default_rng(frames).uniform(
        0, frames, 100_000).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: v / frames)(t))
    assert np.array_equal(frame_time(torch.from_numpy(t), frames).numpy(),
                          ref)
