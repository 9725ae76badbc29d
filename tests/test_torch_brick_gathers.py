"""The brick gather kernels' Python side on the CPU: the cell-corner table
that the eval encode (TPU kernels #8/#9) reads, its plain encode against
the packed table's oracle and against the JAX package's Pallas kernel in
interpret mode, the model of the two kernels' thread map
(ops/brick_tile.py, csrc/brick_tile.cuh), and the sector count that
chip_smoke.py prints beside their times. Inputs are made from seeds with
numpy; the JAX references are computed once per module."""

import os
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_replication_tpu.ops.pallas import hashgrid_kernel as jax_hk
from nerf_replication_tpu.ops.pallas.eval_encode import (
    brick_encode_eval as jax_encode_eval,
)
from nerf_replication_tpu.ops.pallas.eval_encode import (
    pack_eval_table as jax_pack,
)
from nerf_replication_tpu_torch.ops import brick_tile, eval_encode
from nerf_replication_tpu_torch.ops import hashgrid_kernel as hk
from nerf_replication_tpu_torch.utils import tracing
from nerf_replication_tpu_torch.utils.ckpt_utils import load_pretrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (levels, base, finest, log2_bricks): the trained hard_ngp_b9 table, and
# a 16-level layout with hashed levels drawn from U(-1, 1)
TABLES = {"b9 trained": (12, 16, 512, 9), "16 levels random": (16, 4, 64, 6)}
SIZES = [0, 1, 31, 32, 127, 129, 4097]


def _points(n, seed, layout):
    """n uniform points in [0,1]^3, plus 0, 1 and cell boundaries k/res of
    every level on each axis."""
    g = np.random.default_rng(seed)
    x = [g.uniform(0, 1, size=(n, 3)),
         np.array([[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]])]
    x += [g.integers(0, res + 1, size=(8, 3)) / res for res in layout.scales]
    return np.concatenate(x).astype(np.float32)


@pytest.fixture(scope="module", params=list(TABLES))
def case(request):
    """One table: both packages' layouts, the f32 table, the port's packed
    and cell tables, and points."""
    args = TABLES[request.param]
    layout = hk.make_brick_layout(*args[:3], log2_bricks=args[3])
    if request.param == "b9 trained":
        table = np.asarray(load_pretrain(os.path.join(
            ROOT, "data", "pretrain", "hard_ngp_b9"))["params"]
            ["xyz_encoder"]["table"])
    else:
        table = np.random.default_rng(21).uniform(
            -1, 1, size=(layout.n_rows, hk.ROW)).astype(np.float32)
    packed = eval_encode.pack_eval_table(torch.from_numpy(table))
    return dict(name=request.param, layout=layout,
                jax_layout=jax_hk.make_brick_layout(
                    *args[:3], log2_bricks=args[3]),
                table=table, packed=packed,
                cells=eval_encode.pack_cell_table(packed),
                x=_points(400, 22, layout))


@pytest.fixture(scope="module")
def jax_outputs(case):
    """JAX's brick_encode_eval in interpret mode on the case's table and
    points, by ``mxu_max_rows``: 0 (scalar row copies, TPU kernel #9) and
    10^9 (one-hot fetches, #8)."""
    packed = jax_pack(jnp.asarray(case["table"]))
    return {m: np.asarray(jax_encode_eval(
        case["jax_layout"], packed, jnp.asarray(case["x"]), mxu_max_rows=m,
        blk=128)) for m in (0, 10 ** 9)}


def test_pack_cell_table_copies_the_corner_words(case):
    """Word 8k + c of a row is corner c of cell k = lx*16 + ly*4 + lz: the
    packed word of vertex (lx + dx, ly + dy, lz + dz), copied bit for
    bit."""
    packed, cells = case["packed"], case["cells"]
    assert cells.dtype == torch.int32 and cells.is_contiguous()
    assert tuple(cells.shape) == (case["layout"].n_rows, 512)
    for lx in range(4):
        for ly in range(4):
            for lz in range(4):
                k = lx * 16 + ly * 4 + lz
                for c in range(8):
                    dx, dy, dz = (c >> 2) & 1, (c >> 1) & 1, c & 1
                    v = (lx + dx) * 25 + (ly + dy) * 5 + (lz + dz)
                    assert torch.equal(cells[:, 8 * k + c], packed[:, v])


def test_cell_encode_is_bit_equal_to_the_packed_oracle(case):
    """The kernel's plain version over the cell table, and the wrapper on
    CPU tensors, against brick_encode_eval_reference over the packed
    table: the same words summed in the same order, bit for bit."""
    layout, x = case["layout"], torch.from_numpy(case["x"])
    oracle = eval_encode.brick_encode_eval_reference(layout, case["packed"],
                                                     x)
    calls = tracing.counts["brick_encode_cells_reference.calls"]
    out = eval_encode.brick_encode_eval(layout, case["cells"], x)
    assert tracing.counts["brick_encode_cells_reference.calls"] == calls + 1
    assert out.shape == (x.shape[0], 2 * len(layout.scales))
    assert torch.equal(out, oracle)
    assert torch.equal(eval_encode.brick_encode_cells_reference(
        layout, case["cells"], x), oracle)


@pytest.mark.parametrize("mxu_max_rows", [0, 10 ** 9])
def test_cell_encode_matches_jax_kernel(case, jax_outputs, mxu_max_rows):
    """Against the JAX kernel in interpret mode, both fetch strategies:
    the same bf16 values weighted in f32, the 8 corners summed in another
    order, so they agree to f32 rounding: atol 1e-6."""
    out = eval_encode.brick_encode_eval(case["layout"], case["cells"],
                                        torch.from_numpy(case["x"]))
    np.testing.assert_allclose(out.numpy(), jax_outputs[mxu_max_rows],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("kernel", ["eval", "fwd"])
@pytest.mark.parametrize("n_levels", [12, 16])
@pytest.mark.parametrize("n", SIZES)
def test_tile_map_covers_every_point_and_level_once(n, n_levels, kernel):
    """At each kernel's block shape: each (point, level) with point < n is
    computed once and no lane past n computes anything; the 32 lanes of a
    warp's step are 32 consecutive points of one level whose float2
    stores fall on 16 different 8-byte banks a half-warp; every output
    float is stored once, from the shared word its (point, level) was
    written to."""
    feats, stride = 2 * n_levels, brick_tile.tile_stride(n_levels)
    tile, groups = brick_tile.block_shape(kernel, n_levels)
    assert tile * groups % 32 == 0 and tile * groups <= 512
    written, steps = {}, {}
    for block, warp, lane, step, point, level, word in \
            brick_tile.tile_writes(n, n_levels, kernel):
        assert point < n and (point, level) not in written
        assert block == point // tile
        assert 0 <= word and word + 1 < tile * stride
        written[(point, level)] = (block, word)
        steps.setdefault((block, warp, step), []).append(
            (lane, point, level, word))
    assert len(written) == n * n_levels
    for lanes in steps.values():
        lane0, point0, level0, _ = lanes[0]
        assert all(point - point0 == lane - lane0 and level == level0
                   for lane, point, level, _ in lanes)
        for half in (0, 1):
            banks = [(word // 2) % 16 for lane, _, _, word in lanes
                     if lane // 16 == half]
            assert len(set(banks)) == len(banks)
    stored = set()
    for block, index, word in brick_tile.tile_stores(n, n_levels, kernel):
        assert index not in stored
        stored.add(index)
        point, feature = divmod(index, feats)
        assert written[(point, feature // 2)] == (block, word - feature % 2)
    assert stored == set(range(n * feats))


def test_sectors_per_lookup_on_a_hand_built_case():
    """Three lookups of two words each. Request 0: lookup A reads bytes 0
    and 28 (sector 0), lookup B bytes 28 and 32 (sectors 0 and 1): 2
    sectors. Request 1: lookup C reads bytes 60 and 64 (sectors 1 and 2):
    2 sectors. 4 sectors over 3 lookups."""
    offsets = torch.tensor([[0, 28], [28, 32], [60, 64]])
    assert brick_tile.sectors_per_lookup(offsets, torch.tensor([0, 0, 1])) \
        == pytest.approx(4 / 3)
    # each lookup its own request: 1 + 2 + 2
    assert brick_tile.sectors_per_lookup(offsets, torch.arange(3)) \
        == pytest.approx(5 / 3)


def test_sectors_per_lookup_of_the_three_table_layouts():
    """One point in each of the 64 cells of brick 0 of a one-level layout,
    each lookup its own request (rows aligned): the packed table spends
    113/32 = 3.53 sectors a lookup, the f32 training table 113/16 = 7.06,
    the cell-corner table exactly 1."""
    layout = hk.make_brick_layout(1, 4, 4, log2_bricks=4)
    cell = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1)
    x = torch.from_numpy(((cell.reshape(-1, 3) + 0.5) / 4).astype(
        np.float32))
    units = torch.arange(64)[:, None]
    got = {table: Fraction(brick_tile.sectors_per_lookup(
        brick_tile.corner_bytes(layout, x, table), units)).limit_denominator(
            64) for table in ("packed", "train", "cells")}
    assert got == {"packed": Fraction(113, 32), "train": Fraction(113, 16),
                   "cells": 1}


def test_sector_count_sees_lanes_that_share_a_cell():
    """32 consecutive points in one cell: one warp-wide request of the
    present map reads each sector once (1/32 of a sector a lookup on the
    cell table); the first training forward's map spreads them over 12
    requests a level apart, so it reads each sector 12 times more."""
    layout = hk.make_brick_layout(12, 16, 512, log2_bricks=9)
    x = torch.full((32, 3), 0.3)
    n, levels = 32, len(layout.scales)
    cells = brick_tile.corner_bytes(layout, x, "cells")
    assert brick_tile.sectors_per_lookup(
        cells, brick_tile.warp_level_units(n, levels)) == pytest.approx(1 / 32)
    train = brick_tile.corner_bytes(layout, x, "train")
    now = brick_tile.sectors_per_lookup(
        train, brick_tile.warp_level_units(n, levels))
    first = brick_tile.sectors_per_lookup(
        train, brick_tile.level_fastest_units(n, levels))
    assert first == pytest.approx(12 * now)
