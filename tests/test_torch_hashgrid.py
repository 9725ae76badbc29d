"""Port parity for the bricked hash grid: layout, brick ids, the packed
eval table and the plain eval encode (the CPU path of the wrapper that
launches csrc/brick_encode_eval.cu) against the JAX package, and the
HashGridEncoder module. Inputs are made from seeds with numpy."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_replication_tpu.models.encoding.hashgrid import (
    normalize_to_unit as jax_normalize,
)
from nerf_replication_tpu.ops.pallas import hashgrid_kernel as jax_hk
from nerf_replication_tpu.ops.pallas.eval_encode import (
    brick_encode_eval as jax_encode_eval,
)
from nerf_replication_tpu.ops.pallas.eval_encode import (
    pack_eval_table as jax_pack,
)
from nerf_replication_tpu_torch.config import CN
from nerf_replication_tpu_torch.models.encoding import get_encoder
from nerf_replication_tpu_torch.models.encoding.hashgrid import (
    HashGridEncoder,
    normalize_to_unit,
)
from nerf_replication_tpu_torch.ops import eval_encode
from nerf_replication_tpu_torch.ops import hashgrid_kernel as hk
from nerf_replication_tpu_torch.utils.ckpt_utils import load_pretrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (levels, base, finest, log2_bricks): hard_ngp with the b9 checkpoint's
# and the yaml's brick caps, lego_ngp, and the JAX tests' small layouts
LAYOUTS = [(12, 16, 512, 9), (12, 16, 512, 12), (16, 16, 1024, 12),
           (4, 4, 32, 5), (3, 4, 16, 4)]
B9 = (12, 16, 512, 9)
SMALL = (4, 4, 32, 5)   # tests/test_eval_encode.py's layout


def layouts(args):
    n, base, finest, bricks = args
    return (hk.make_brick_layout(n, base, finest, log2_bricks=bricks),
            jax_hk.make_brick_layout(n, base, finest, log2_bricks=bricks))


def points(n, seed, layout):
    """n uniform points in [0,1]^3, plus 0, 1 and cell boundaries k/res of
    every level on each axis."""
    g = np.random.default_rng(seed)
    x = [g.uniform(0, 1, size=(n, 3))]
    x.append(np.array([[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]]))
    for res in layout.scales:
        k = g.integers(0, res + 1, size=(8, 3))
        x.append(k / res)
    return np.concatenate(x).astype(np.float32)


@pytest.mark.parametrize("args", LAYOUTS)
def test_make_brick_layout_matches_jax(args):
    port, ref = layouts(args)
    assert tuple(port) == tuple(ref)
    if args == B9:
        assert port.n_rows == 5504   # the checkpoint's table


@pytest.mark.parametrize("args", [B9, (12, 16, 512, 12), SMALL])
def test_compute_brick_ids_bit_equal(args):
    """Dense ids and the uint32 XOR hash (computed in int64 and masked
    here) are integers: equal exactly."""
    port, ref = layouts(args)
    x = points(500, 0, port)
    ids = hk.compute_brick_ids(port, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        ids, np.asarray(jax_hk.compute_brick_ids(ref, jnp.asarray(x))))
    assert any(port.use_hash)   # the hash is exercised


def test_pack_eval_table_bit_equal():
    """The int32 pack holds JAX's uint32 bits, and unpacks to the bf16
    roundings of the two halves of the table, exactly."""
    g = np.random.default_rng(1)
    table = g.normal(scale=0.5, size=(384, 256)).astype(np.float32)
    table[0, :8] = [0.0, -0.0, 1.0, -1.0, 3.0e-39, 65504.0, 1 + 2 ** -8,
                    1 + 3 * 2 ** -8]   # zeros, a denormal, bf16 ties
    packed = eval_encode.pack_eval_table(torch.from_numpy(table))
    assert packed.dtype == torch.int32 and packed.shape == (384, 128)
    np.testing.assert_array_equal(packed.numpy().view(np.uint32),
                                  np.asarray(jax_pack(jnp.asarray(table))))
    f0, f1 = eval_encode.unpack_f0_f1(packed)
    bf = torch.from_numpy(table).to(torch.bfloat16).float()
    assert torch.equal(f0, bf[:, :128]) and torch.equal(f1, bf[:, 128:])


@pytest.mark.parametrize("mxu_max_rows", [0, 10 ** 9])
def test_plain_eval_encode_matches_jax_kernel(mxu_max_rows):
    """The JAX kernel in interpret mode, scalar row copies (mxu_max_rows 0,
    TPU kernel #9) and one-hot fetches (10^9, #8). Both read the same bf16
    values and weight them in f32; they sum the 8 corners in other orders,
    so they agree to f32 rounding of values below 1: atol 1e-6."""
    port, ref = layouts(SMALL)
    table = np.random.default_rng(2).uniform(
        -1, 1, size=(port.n_rows, 256)).astype(np.float32)
    x = points(300, 3, port)
    out = eval_encode.brick_encode_eval(
        port, eval_encode.pack_eval_table(torch.from_numpy(table)),
        torch.from_numpy(x))
    expect = jax_encode_eval(ref, jax_pack(jnp.asarray(table)),
                             jnp.asarray(x), mxu_max_rows=mxu_max_rows,
                             blk=128)
    assert out.shape == (x.shape[0], 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=1e-6,
                               rtol=0)


def test_plain_eval_encode_matches_jax_reference_on_b9_table():
    """The trained hard_ngp_b9 table: the port's plain encode against JAX's
    brick_encode_reference fed the bf16-rounded table (the fast XLA
    oracle of the same function). Features reach ~10; same bf16 values,
    corners summed in order by both: atol 2e-6."""
    port, ref = layouts(B9)
    table = np.asarray(load_pretrain(os.path.join(
        ROOT, "data", "pretrain", "hard_ngp_b9"))["params"]["xyz_encoder"]
        ["table"])
    x = points(4000, 4, port)
    out = eval_encode.brick_encode_eval(
        port, eval_encode.pack_eval_table(torch.from_numpy(table)),
        torch.from_numpy(x))
    rounded = jnp.asarray(table).astype(jnp.bfloat16).astype(jnp.float32)
    expect = np.asarray(jax_hk.brick_encode_reference(ref, rounded,
                                                      jnp.asarray(x)))
    assert out.shape == (x.shape[0], 24)
    np.testing.assert_allclose(out.numpy(), expect, atol=2e-6, rtol=0)


def test_brick_encode_reference_matches_jax_training_forward():
    """The nn.Module route's encode (the plain training forward, bf16 table
    reads on these small levels) against JAX's brick_hash_encode in
    interpret mode: atol 1e-6, summation order only."""
    port, ref = layouts(SMALL)
    table = np.random.default_rng(5).uniform(
        -1, 1, size=(port.n_rows, 256)).astype(np.float32)
    x = points(200, 6, port)
    out = hk.brick_encode_reference(port, torch.from_numpy(table),
                                    torch.from_numpy(x))
    expect = jax_hk.brick_hash_encode(ref, jnp.asarray(table), jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), atol=1e-6,
                               rtol=0)


def test_eval_encode_counts_plain_calls_on_cpu():
    port, _ = layouts(SMALL)
    packed = eval_encode.pack_eval_table(torch.zeros(port.n_rows, 256))
    calls = eval_encode.brick_encode_eval_reference.calls
    launches = eval_encode.brick_encode_eval.launches
    eval_encode.brick_encode_eval(port, packed, torch.rand(5, 3))
    assert eval_encode.brick_encode_eval_reference.calls == calls + 1
    assert eval_encode.brick_encode_eval.launches == launches


def test_normalize_to_unit_matches_jax():
    """float32 clamp and scale by the largest side plus 1e-6: bit equal."""
    x = np.random.default_rng(7).uniform(-1.5, 1.5, (100, 3)).astype(
        np.float32)
    bounds = (-1.2, -1.2, -1.2, 1.2, 1.2, 1.2)
    np.testing.assert_array_equal(
        normalize_to_unit(torch.from_numpy(x), bounds).numpy(),
        np.asarray(jax_normalize(jnp.asarray(x), bounds)))


def test_hashgrid_encoder_from_cfg():
    """The hard_ngp encoder section with the reference YAML names; the xla
    backend is not ported and names its ROADMAP item."""
    section = {"type": "cuda_hashgrid", "backend": "brick", "input_dim": 3,
               "num_levels": 12, "level_dim": 2, "base_resolution": 16,
               "desired_resolution": 512, "log2_hashmap_size": 19,
               "log2_bricks": 9, "bounds": [-1.2, -1.2, -1.2, 1.2, 1.2, 1.2]}
    enc = get_encoder(CN(section))
    assert isinstance(enc, HashGridEncoder) and enc.output_dim == 24
    assert enc.layout == layouts(B9)[0]
    assert tuple(enc.table.shape) == (5504, 256)
    assert float(enc.table.detach().abs().max()) <= 1e-4
    assert list(enc.state_dict()) == ["table"]
    out = enc(torch.rand(2, 5, 3) * 2.4 - 1.2)
    assert out.shape == (2, 5, 24)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item A.10"):
        get_encoder(CN({**section, "backend": "xla"}))
    with pytest.raises(ValueError):
        get_encoder(CN({**section, "level_dim": 4}))


def test_hashgrid_encoder_matches_flax_module():
    """The nn.Module encode against the Flax HashGridEncoder (brick) on the
    same table, world-space points: atol 1e-6."""
    from nerf_replication_tpu.models.encoding.hashgrid import (
        HashGridEncoder as JaxHashGrid,
    )

    bounds = (-1.2, -1.2, -1.2, 1.2, 1.2, 1.2)
    jax_enc = JaxHashGrid(n_levels=4, base_resolution=4, finest_resolution=32,
                          log2_bricks=5, bounds=bounds, backend="brick",
                          input_grad=False)
    enc = HashGridEncoder(n_levels=4, base_resolution=4, finest_resolution=32,
                          log2_bricks=5, bounds=bounds)
    table = np.random.default_rng(8).uniform(-1, 1, tuple(enc.table.shape))
    with torch.no_grad():
        enc.table.copy_(torch.from_numpy(table))
    x = np.random.default_rng(9).uniform(-1.3, 1.3, (6, 7, 3)).astype(
        np.float32)
    expect = jax_enc.apply({"params": {"table": jnp.asarray(table,
                                                            jnp.float32)}},
                           jnp.asarray(x))
    np.testing.assert_allclose(enc(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(expect), atol=1e-6, rtol=0)
    assert jax.tree.leaves(expect)   # the Flax module ran
