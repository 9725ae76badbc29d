"""Port parity for the vertex-exact (``xla``) hash grid: the level layout,
the hashed and dense corner indices and their weights, the forward, the
table gradient (against both ``sorted_bwd`` arms of JAX's, the port's
one ``index_add_`` for either value) and the analytic input gradient
of nerf_replication_tpu_torch/models/encoding/hashgrid.py against the JAX
package's ``_level_layout``, ``_indices_weights``, ``hash_encode`` and
``jax.grad`` through its ``custom_vjp``, in float32 and in the bf16 arm.
Inputs are made from seeds with numpy.

Tolerances: indices bit-equal (a wrong index reads another row of a JAX
checkpoint); weights within 1e-6; the f32 forward within atol 1e-6; the
bf16 forward and table gradient within one bf16 step, 2^-7 of a value's
magnitude (one bf16 rounding of a sum whose f32 terms may be added in
another order); the table gradient within rtol 1e-5, atol 1e-7 (the JAX
test's, tests/test_hashgrid.py);
the input gradient within rtol 1e-4, atol 1e-5 away from cell faces (the
JAX test's); the padding rows' gradient exactly zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_replication_tpu.config import CN as JaxCN
from nerf_replication_tpu.models.encoding import hashgrid as jhg
from nerf_replication_tpu_torch.config import CN
from nerf_replication_tpu_torch.models.encoding import get_encoder
from nerf_replication_tpu_torch.models.encoding import hashgrid as hg

# the xyz encoder sections of the three NGP configs:
# (n_levels, base, finest, log2_hashmap_size)
CONFIGS = {"hard_ngp": (12, 16, 512, 19), "lego_ngp": (16, 16, 1024, 19),
           "probe48_ngp": (12, 16, 256, 17)}
# small grids with dense and hashed levels at each D: (D, levels, base,
# finest, log2 T, F)
SMALL = {2: (2, 4, 4, 64, 10, 2), 3: (3, 4, 4, 32, 12, 2),
         4: (4, 3, 2, 8, 10, 4)}
FWD_ATOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
DX_RTOL, DX_ATOL = 1e-4, 1e-5


def layouts(D, levels, base, finest, log2_t, F, input_grad=True,
            sorted_bwd=True):
    """(port HashLayout, the JAX layout tuple) of one grid."""
    scales, offsets, use_hash, T = hg._level_layout(D, levels, log2_t, base,
                                                    finest, 2.0)
    port = hg.HashLayout(tuple(scales), tuple(offsets), tuple(use_hash), T,
                         D, F, input_grad)
    return port, (*port, sorted_bwd)


def points(n, D, seed, res):
    """n uniform points in [0,1]^D, the faces 0 and 1 on every axis and
    lattice corners k / res of the finest level."""
    g = np.random.default_rng(seed)
    x = [g.uniform(0, 1, size=(n, D)),
         np.zeros((1, D)), np.ones((1, D)),
         np.eye(D), 1.0 - np.eye(D),
         g.integers(0, res + 1, size=(16, D)) / res]
    return np.concatenate(x).astype(np.float32)


def off_faces(n, D, seed, res):
    """Points a cell's inner fractions away from every level's cell faces:
    a product of 1/res_finest with an odd offset stays off coarser faces
    when the resolutions are powers of two (the JAX test's construction)."""
    g = np.random.default_rng(seed)
    cell = g.integers(0, res, size=(n, D))
    frac = np.array([0.3, 0.5, 0.7, 0.45][:D])
    return ((cell + frac) / res).astype(np.float32)


def table_for(layout, seed, scale=0.1):
    g = np.random.default_rng(seed)
    return (g.normal(size=(layout.offsets[-1], layout.n_features))
            * scale).astype(np.float32)


@pytest.mark.parametrize("D", [2, 3, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_level_layout_matches_jax(name, D):
    levels, base, finest, log2_t = CONFIGS[name]
    port = hg._level_layout(D, levels, log2_t, base, finest, 2.0)
    ref = jhg._level_layout(D, levels, log2_t, base, finest, 2.0)
    assert port == ref
    scales, offsets, use_hash, T = port
    assert all(o % 8 == 0 for o in offsets) and T == 2 ** log2_t


@pytest.mark.parametrize("grid", [SMALL[2], SMALL[3], SMALL[4],
                                  (3, 12, 16, 512, 19, 2)],
                         ids=["D2", "D3", "D4", "hard_ngp"])
def test_indices_weights_match_jax(grid):
    """Global rows bit-equal (the uint32 hash in int64, the dense index
    with dimension 0 most significant), weights within 1e-6."""
    port, ref = layouts(*grid)
    assert any(port.use_hash) and not all(port.use_hash)
    x = points(400, grid[0], 0, port.scales[-1])
    idx, w = hg._indices_weights(port, torch.from_numpy(x))
    jidx, jw = jhg._indices_weights(ref, jnp.asarray(x))
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    assert int(idx.max()) < port.offsets[-1]


@pytest.mark.parametrize("D", [2, 3, 4])
def test_forward_matches_hash_encode(D):
    port, ref = layouts(*SMALL[D])
    x = points(300, D, 1, port.scales[-1])
    table = table_for(port, 2)
    out = hg.hash_encode(port, torch.from_numpy(table), torch.from_numpy(x))
    expect = jhg.hash_encode(ref, jnp.asarray(table), jnp.asarray(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                               atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("D", [2, 3, 4])
def test_bf16_forward_matches_hash_encode(D):
    """The bf16 arm: bf16 table and weights, bf16 products, their sum in
    f32 rounded to bf16. Bound: 2^-7 of the feature (the rounding of a
    sum whose terms were added in another order can land one bf16 step
    away) plus 1e-7."""
    port, ref = layouts(*SMALL[D])
    x = points(300, D, 3, port.scales[-1])
    table = table_for(port, 4)
    t16 = torch.from_numpy(table).to(torch.bfloat16)
    out = hg.hash_encode(port, t16, torch.from_numpy(x))
    expect = np.asarray(jhg.hash_encode(
        ref, jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(x)))
    err = np.abs(out.numpy() - expect)
    assert (err <= 2.0 ** -7 * np.abs(expect) + 1e-7).all(), err.max()
    # most features are bit-equal: only reordered f32 sums may differ
    assert (err == 0).mean() > 0.99
    f32 = hg.hash_encode(port, t16.float(), torch.from_numpy(x))
    assert not torch.equal(out, f32)   # the arm rounds


def _jax_grads(ref, table, x, cot, dtype=jnp.float32):
    def loss(t, xx):
        return jnp.sum(jhg.hash_encode(ref, t.astype(dtype), xx) * cot)

    return jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(table),
                                                   jnp.asarray(x))


def _port_grads(port, table, x, cot, dtype=torch.float32):
    t = torch.from_numpy(table).requires_grad_(True)
    xx = torch.from_numpy(x).requires_grad_(True)
    (hg.hash_encode(port, t.to(dtype), xx) * torch.from_numpy(cot)).sum() \
        .backward()
    return t.grad, xx.grad


@pytest.mark.parametrize("sorted_bwd", [True, False])
@pytest.mark.parametrize("D", [2, 3, 4])
def test_table_gradient_matches_jax_grad(D, sorted_bwd):
    """The port's index_add_ against jax.grad through both sorted_bwd arms
    (its sorted segment-sum and its scatter-add), rtol 1e-5 / atol 1e-7;
    the 8-aligned padding rows, which no corner indexes, exactly zero."""
    port, ref = layouts(*SMALL[D], sorted_bwd=sorted_bwd)
    x = points(300, D, 5, port.scales[-1])
    table = table_for(port, 6)
    cot = np.random.default_rng(7).normal(
        size=(x.shape[0], len(port.scales) * port.n_features)).astype(
            np.float32)
    dt, _ = _port_grads(port, table, x, cot)
    jdt, _ = _jax_grads(ref, table, x, cot)
    np.testing.assert_allclose(dt.numpy(), np.asarray(jdt), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    pad = np.ones(port.offsets[-1], bool)
    for level, res in enumerate(port.scales):
        rows = min((res + 1) ** D, port.table_size)
        pad[port.offsets[level]:port.offsets[level] + rows] = False
    assert pad.any() and not dt[torch.from_numpy(pad)].any()


def test_bf16_table_gradient_is_bf16_rounded():
    """The bf16 arm hands the f32 table the f32 sum rounded to bf16, as the
    JAX module's cast does: equal to jax.grad through the cast up to one
    bf16 step of a row's reordered sum."""
    port, ref = layouts(*SMALL[3])
    x = points(300, 3, 11, port.scales[-1])
    table = table_for(port, 12)
    cot = np.random.default_rng(13).normal(size=(x.shape[0], 8)).astype(
        np.float32)
    dt, _ = _port_grads(port, table, x, cot, torch.bfloat16)
    jdt, _ = _jax_grads(ref, table, x, cot, jnp.bfloat16)
    jdt = np.asarray(jdt)
    assert dt.dtype == torch.float32
    assert torch.equal(dt, dt.to(torch.bfloat16).float())
    err = np.abs(dt.numpy() - jdt)
    assert (err <= 2.0 ** -7 * np.abs(jdt) + 1e-30).all(), err.max()
    assert (err == 0).mean() > 0.99


@pytest.mark.parametrize("D", [2, 3, 4])
def test_input_gradient_matches_jax_grad(D):
    """The analytic d(out)/dx against jax.grad of hash_encode (its own
    analytic backward), and against autograd of the port's plain forward,
    away from cell faces: rtol 1e-4, atol 1e-5."""
    port, ref = layouts(*SMALL[D])
    x = off_faces(200, D, 14, port.scales[-1])
    table = table_for(port, 15)
    cot = np.random.default_rng(16).normal(
        size=(x.shape[0], len(port.scales) * port.n_features)).astype(
            np.float32)
    _, dx = _port_grads(port, table, x, cot)
    _, jdx = _jax_grads(ref, table, x, cot)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=DX_RTOL,
                               atol=DX_ATOL)
    xx = torch.from_numpy(x).requires_grad_(True)
    (hg.encode_forward(port, torch.from_numpy(table), xx)
     * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(dx.numpy(), xx.grad.numpy(), rtol=DX_RTOL,
                               atol=DX_ATOL)
    assert np.abs(dx.numpy()).max() > 1e-3


def test_input_gradient_zero_without_input_grad():
    """With input_grad False the points get a zero gradient, as JAX's
    ``zeros_like(x)``, not none."""
    port, ref = layouts(*SMALL[3], input_grad=False)
    x = off_faces(50, 3, 17, port.scales[-1])
    table = table_for(port, 18)
    cot = np.ones((50, 8), np.float32)
    dt, dx = _port_grads(port, table, x, cot)
    jdt, jdx = _jax_grads(ref, table, x, cot)
    assert dx is not None and not dx.any() and not np.asarray(jdx).any()
    np.testing.assert_allclose(dt.numpy(), np.asarray(jdt), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_encoder_module_matches_flax():
    """HashGridEncoder(backend xla) from the probe48_ngp section against the
    Flax module on the same table, world-space points clipped outside the
    bounds, and its gradients: the table's, and the points' with
    ``input_grad`` set (normalised, so the box's 1 / side and the clip's
    zero outside apply)."""
    section = {"type": "cuda_hashgrid", "input_dim": 3, "num_levels": 4,
               "level_dim": 2, "base_resolution": 16,
               "desired_resolution": 128, "log2_hashmap_size": 12,
               "bounds": [-1.2, -1.2, -1.2, 1.2, 1.2, 1.2]}
    enc = get_encoder(CN(section))
    assert (enc.backend, enc.input_grad, enc.sorted_bwd) == ("xla", False,
                                                             True)
    jenc = jhg.HashGridEncoder.from_cfg(JaxCN({**section, "input_grad": True}))
    enc_g = get_encoder(CN({**section, "input_grad": True}))
    table = table_for(enc.layout, 19)
    x = np.random.default_rng(20).uniform(-1.3, 1.3, (4, 25, 3)).astype(
        np.float32)
    cot = np.random.default_rng(21).normal(size=(4, 25, 8)).astype(
        np.float32)

    def jloss(t, xx):
        return jnp.sum(jenc.apply({"params": {"table": t}}, xx) * cot)

    expect = jenc.apply({"params": {"table": jnp.asarray(table)}},
                        jnp.asarray(x))
    jdt, jdx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table),
                                               jnp.asarray(x))
    for e in (enc, enc_g):
        with torch.no_grad():
            e.table.copy_(torch.from_numpy(table))
    xx = torch.from_numpy(x).requires_grad_(True)
    out = enc_g(xx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expect),
                               atol=FWD_ATOL, rtol=0)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(enc_g.table.grad.numpy(), np.asarray(jdt),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # inside the box every point is off a face almost surely; the clip
    # zeroes the points outside it
    np.testing.assert_allclose(xx.grad.numpy(), np.asarray(jdx),
                               rtol=DX_RTOL, atol=DX_ATOL)
    outside = (np.abs(x) > 1.2).any(-1)
    assert outside.any()
    np.testing.assert_array_equal(
        (xx.grad.numpy() == 0).any(-1)[outside],
        np.ones(outside.sum(), bool))
    np.testing.assert_array_equal(
        enc(torch.from_numpy(x)).detach().numpy(), out.detach().numpy())


def test_from_cfg_flags_are_strict():
    section = CN({"type": "hashgrid", "num_levels": 2, "log2_hashmap_size": 8,
                  "sorted_bwd": "false"})
    with pytest.raises(TypeError, match="sorted_bwd"):
        get_encoder(section)
    with pytest.raises(ValueError, match="compute_dtype"):
        get_encoder(CN({"type": "hashgrid", "compute_dtype": "float16"}))
    enc = get_encoder(CN({"type": "hashgrid", "input_dim": 4,
                          "num_levels": 2, "level_dim": 3,
                          "log2_hashmap_size": 8, "compute_dtype": "bfloat16",
                          "sorted_bwd": False}))
    assert (enc.output_dim, enc.layout.input_dim, enc.sorted_bwd,
            enc.compute_dtype) == (6, 4, False, "bfloat16")
    assert enc(torch.rand(5, 4)).dtype == torch.float32
