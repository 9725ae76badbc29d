"""Port parity for the bricked hash grid: layout, brick ids, the packed
eval table and the plain eval encode over its cell-corner table (the CPU
path of the wrapper that launches csrc/brick_encode_eval.cu) against the
JAX package, the training
encode's table gradient (the CPU path of the wrappers that launch
csrc/brick_hash_encode.cu) against jax.grad through the Pallas kernel in
interpret mode, the HashGridEncoder module, and the gather probes' script
on the CPU. Inputs are made from seeds with numpy."""

import importlib.util
import os
from unittest import mock

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
from nerf_replication_tpu_torch.utils import tracing
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
        port, eval_encode.pack_cell_table(eval_encode.pack_eval_table(
            torch.from_numpy(table))), torch.from_numpy(x))
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
        port, eval_encode.pack_cell_table(eval_encode.pack_eval_table(
            torch.from_numpy(table))), torch.from_numpy(x))
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
    cells = eval_encode.pack_cell_table(eval_encode.pack_eval_table(
        torch.zeros(port.n_rows, 256)))
    calls = tracing.counts["brick_encode_cells_reference.calls"]
    launches = tracing.counts["brick_encode_eval.launches"]
    eval_encode.brick_encode_eval(port, cells, torch.rand(5, 3))
    assert tracing.counts["brick_encode_cells_reference.calls"] == calls + 1
    assert tracing.counts["brick_encode_eval.launches"] == launches


def test_normalize_to_unit_matches_jax():
    """float32 clamp and scale by the largest side plus 1e-6: bit equal to
    the jitted JAX function, as the JAX package runs it."""
    x = np.random.default_rng(7).uniform(-1.5, 1.5, (100, 3)).astype(
        np.float32)
    bounds = (-1.2, -1.2, -1.2, 1.2, 1.2, 1.2)
    np.testing.assert_array_equal(
        normalize_to_unit(torch.from_numpy(x), bounds).numpy(),
        np.asarray(jax.jit(lambda p: jax_normalize(p, bounds))(
            jnp.asarray(x))))


def test_to_unit_takes_a_gradient_after_inference_mode():
    """The encoder's box corners do not depend on the mode of their first
    use: an eval under inference_mode, then a gradient with respect to the
    points through the same encoder; both bit-equal to normalize_to_unit,
    the gradient the float32 reciprocal of the side inside the box and 0
    outside."""
    bounds = (-1.2, -1.2, -1.2, 1.2, 1.2, 1.2)
    enc = HashGridEncoder(n_levels=3, base_resolution=8, finest_resolution=32,
                          log2_bricks=9, bounds=bounds, backend="brick",
                          input_grad=False)
    x = torch.from_numpy(np.random.default_rng(8).uniform(
        -1.5, 1.5, (100, 3)).astype(np.float32))
    with torch.inference_mode():
        evaluated = enc.to_unit(x)
    xg = x.clone().requires_grad_(True)
    out = enc.to_unit(xg)
    out.sum().backward()
    expect = torch.clamp(normalize_to_unit(x, bounds), 0.0, 1.0)
    assert torch.equal(evaluated, expect) and torch.equal(out.detach(), expect)
    inside = (x.abs() < 1.2).float()
    assert torch.equal(xg.grad, inside * enc.box_inv_side)


def test_hashgrid_encoder_from_cfg():
    """The hard_ngp encoder section with the reference YAML names; with
    ``backend xla`` the same section builds the vertex-exact grid, whose
    table has its own shape."""
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
    xla = get_encoder(CN({**section, "backend": "xla"}))
    assert xla.backend == "xla" and enc.backend == "brick"
    assert tuple(xla.table.shape) == (xla.layout.offsets[-1], 2)
    assert xla(torch.rand(2, 5, 3) * 2.4 - 1.2).shape == (2, 5, 24)
    with pytest.raises(ValueError):
        get_encoder(CN({**section, "level_dim": 4}))


def test_hashgrid_encoder_matches_flax_module():
    """The nn.Module encode against the Flax HashGridEncoder (brick) on the
    same table, world-space points, the Flax module jitted as the JAX
    package runs it: atol 1e-6."""
    from nerf_replication_tpu.models.encoding.hashgrid import (
        HashGridEncoder as JaxHashGrid,
    )

    bounds = (-1.2, -1.2, -1.2, 1.2, 1.2, 1.2)
    jax_enc = JaxHashGrid(n_levels=4, base_resolution=4, finest_resolution=32,
                          log2_bricks=5, bounds=bounds, backend="brick",
                          input_grad=False)
    enc = HashGridEncoder(n_levels=4, base_resolution=4, finest_resolution=32,
                          log2_bricks=5, bounds=bounds, backend="brick",
                          input_grad=False)
    table = np.random.default_rng(8).uniform(-1, 1, tuple(enc.table.shape))
    with torch.no_grad():
        enc.table.copy_(torch.from_numpy(table))
    x = np.random.default_rng(9).uniform(-1.3, 1.3, (6, 7, 3)).astype(
        np.float32)
    expect = jax.jit(jax_enc.apply)(
        {"params": {"table": jnp.asarray(table, jnp.float32)}},
        jnp.asarray(x))
    np.testing.assert_allclose(enc(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(expect), atol=1e-6, rtol=0)
    assert jax.tree.leaves(expect)   # the Flax module ran


# layouts for the table gradient: every level on the bf16 branch (the JAX
# tests' layout, tests/test_hashgrid.py), and one whose last level has
# 8192 rows and takes the f32 branch
GRAD_LAYOUTS = [(3, 8, 32, 9), (3, 16, 128, 13)]
GRAD_IDS = ["bf16 levels only", "with an f32 level"]
# port against jax.grad: the same f32 contributions with the same bf16
# roundings, summed in f32 in another order
GRAD_TOL = 1e-5


def _grad_case(args, n=300, seed=10):
    """(port layout, JAX layout, x with 0.0, 1.0 and cell boundaries,
    cotangent) from a numpy seed."""
    port, ref = layouts(args)
    x = points(n, seed, port)
    cot = np.random.default_rng(seed + 1).normal(
        size=(x.shape[0], 2 * len(port.scales))).astype(np.float32)
    return port, ref, x, cot


def _jax_table_grad(ref, table, x, cot):
    out, vjp = jax.vjp(
        lambda t: jax_hk.brick_hash_encode(ref, t, jnp.asarray(x)),
        jnp.asarray(table))
    dtable, = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(dtable)


def _level_errs(layout, got, want):
    """Per level: max |got - want| over the level's max |want|."""
    errs = []
    for level in range(len(layout.scales)):
        rows = slice(layout.offsets[level], layout.offsets[level + 1])
        errs.append(float(np.abs(got[rows] - want[rows]).max()
                          / np.abs(want[rows]).max()))
    return errs


def _bf16_levels(layout):
    return [hk.level_rows(layout, level) <= hk.MXU_MAX_ROWS
            for level in range(len(layout.scales))]


@pytest.mark.parametrize("args", GRAD_LAYOUTS, ids=GRAD_IDS)
def test_table_gradient_matches_jax_vjp(args):
    """BrickHashEncodeFn on CPU tensors (plain forward and backward)
    against jax.vjp through brick_hash_encode in interpret mode: every
    level within 1e-5 of its max |gradient| (f32 summation order only; the
    JAX package's own test allows 5e-2 against its unrounded reference),
    the padding exactly zero, no gradient to the points."""
    port, ref, x, cot = _grad_case(args)
    assert _bf16_levels(port) == [True, True, args[3] == 9]
    table = np.random.default_rng(12).uniform(
        -1, 1, size=(port.n_rows, 256)).astype(np.float32)
    out_ref, grad_ref = _jax_table_grad(ref, table, x, cot)
    t = torch.from_numpy(table).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = hk.BrickHashEncodeFn.apply(port, t, xt)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), out_ref, atol=1e-6,
                               rtol=0)
    assert xt.grad is None
    grad = t.grad.numpy()
    assert max(_level_errs(port, grad, grad_ref)) <= GRAD_TOL
    live = hk.live_entries(port).numpy()
    assert live.sum() < live.size and not grad[~live].any()
    assert not grad_ref[~live].any() and (grad[live] != 0).any()


@pytest.mark.parametrize("args", GRAD_LAYOUTS, ids=GRAD_IDS)
def test_unrounded_table_gradient_does_not_match_jax(args):
    """The gradient with f32 contributions on every level (what autograd
    through the plain forward gave before the backward was written out)
    misses jax.grad by ~2e-3 of a level's max on the bf16 levels, far
    outside the 1e-5 bound, and meets it on the f32 level."""
    port, ref, x, cot = _grad_case(args)
    table = np.zeros((port.n_rows, 256), np.float32)
    _, grad_ref = _jax_table_grad(ref, table, x, cot)
    with mock.patch.object(hk, "MXU_MAX_ROWS", 0):
        unrounded = hk.brick_encode_bwd_reference(
            port, torch.from_numpy(x), torch.from_numpy(cot)).numpy()
    errs = _level_errs(port, unrounded, grad_ref)
    for err, bf16 in zip(errs, _bf16_levels(port)):
        assert (err > 100 * GRAD_TOL) if bf16 else (err <= GRAD_TOL), errs


def test_table_gradient_at_zero_and_one():
    """x at exactly 0.0 and 1.0: floor(x * res) at 1.0 is clamped to the
    last cell with a fraction of 1.0, so a point at (1, 1, 1) moves one
    entry a level and feature; against jax.grad as above."""
    port, ref, _, _ = _grad_case(GRAD_LAYOUTS[1])
    x = np.array([[0, 0, 0], [1, 1, 1], [0, 1, 0], [1, 0, 1]], np.float32)
    cot = np.random.default_rng(13).normal(size=(4, 6)).astype(np.float32)
    _, grad_ref = _jax_table_grad(ref, np.zeros((port.n_rows, 256),
                                                np.float32), x, cot)
    grad = hk.brick_encode_bwd_reference(port, torch.from_numpy(x),
                                         torch.from_numpy(cot)).numpy()
    assert max(_level_errs(port, grad, grad_ref)) <= GRAD_TOL
    corner = hk.brick_encode_bwd_reference(
        port, torch.from_numpy(x[1:2]), torch.from_numpy(cot[1:2])).numpy()
    for level in range(3):
        rows = slice(port.offsets[level], port.offsets[level + 1])
        assert np.count_nonzero(corner[rows]) == 2   # one entry a feature


@pytest.mark.parametrize("mxu_max_rows", [0, hk.MXU_MAX_ROWS],
                         ids=["f32 levels", "bf16 levels"])
def test_plain_backward_matches_autograd_of_plain_forward(mxu_max_rows):
    """The plain backward is the gradient of the plain forward: against
    autograd through brick_encode_reference within 1e-6 of each level's
    max (f32 summation order), with every level on the f32 branch and with
    the bf16 levels on. On a bf16 level autograd rounds too: the backward
    of ``.to(torch.bfloat16)`` casts the gathered rows' gradient to bf16,
    which is the rounding the plain backward writes out."""
    port, _, x, cot = _grad_case(GRAD_LAYOUTS[0])
    table = torch.from_numpy(np.random.default_rng(14).uniform(
        -1, 1, size=(port.n_rows, 256)).astype(np.float32))
    xt, ct = torch.from_numpy(x), torch.from_numpy(cot)
    with mock.patch.object(hk, "MXU_MAX_ROWS", mxu_max_rows):
        t = table.clone().requires_grad_(True)
        hk.brick_encode_reference(port, t, xt).backward(ct)
        errs = _level_errs(port, hk.brick_encode_bwd_reference(
            port, xt, ct).numpy(), t.grad.numpy())
    assert max(errs) <= 1e-6


def test_hashgrid_encoder_trains_through_the_function():
    """HashGridEncoder.forward on CPU tensors goes through the wrappers to
    the plain versions, once each way, and launches nothing; its table
    gradient is the plain backward's."""
    enc = HashGridEncoder(n_levels=3, base_resolution=8, finest_resolution=32,
                          log2_bricks=9, backend="brick", input_grad=False)
    x = torch.from_numpy(points(50, 15, enc.layout))
    cot = torch.from_numpy(np.random.default_rng(16).normal(
        size=(x.shape[0], 6)).astype(np.float32))
    keys = ("brick_encode_reference.calls", "brick_encode_bwd_reference.calls",
            "brick_hash_encode.launches", "brick_hash_encode_bwd.launches")
    before = tuple(tracing.counts[k] for k in keys)
    enc(x).backward(cot)
    after = tuple(tracing.counts[k] for k in keys)
    assert after == (before[0] + 1, before[1] + 1, before[2], before[3])
    assert torch.equal(enc.table.grad,
                       hk.brick_encode_bwd_reference(enc.layout, x, cot))
    f64 = hk.brick_encode_bwd_reference(enc.layout, x, cot, torch.float64)
    assert f64.dtype == torch.float64
    assert float((f64 - enc.table.grad).abs().max()) < 1e-5


@pytest.mark.parametrize("args", [B9, (12, 16, 512, 12), (12, 16, 512, 13)])
def test_live_and_touched_entries(args):
    """The reachable entries of the committed layouts and of the one with
    f32 levels: 125 lanes a feature, a dense level's bricks or a hashed
    level's power-of-two range; what a batch touches lies inside them."""
    port, _ = layouts(args)
    live = hk.live_entries(port)
    used = [hk.hash_range(port, level) if port.use_hash[level]
            else port.bsides[level] ** 3 for level in range(12)]
    assert int(live.sum()) == 250 * sum(used)
    assert all(u <= hk.level_rows(port, level) for level, u in
               enumerate(used))
    x = torch.from_numpy(points(200, 17, port))
    dtable = hk.brick_encode_bwd_reference(port, x, torch.ones(len(x), 24))
    assert not dtable[~live].any()
    # a corner of weight zero (a point on a cell boundary) is touched too
    assert int((dtable != 0).sum()) < hk.touched_entries(port, x)
    inside = x[:200]     # the uniform points: every weight is positive
    dtable = hk.brick_encode_bwd_reference(port, inside, torch.ones(200, 24))
    assert hk.touched_entries(port, inside) == int((dtable != 0).sum())
    assert hk.encode_flops_per_point(port) == 12 * 57


def test_gather_probes_script_on_cpu():
    """scripts/probe_cuda_gather.py at a small size on the CPU, where each
    wrapper takes its PyTorch call: every probe's check runs and holds,
    nothing is launched, and main() refuses to run without a GPU."""
    spec = importlib.util.spec_from_file_location(
        "probe_cuda_gather", os.path.join(ROOT, "scripts",
                                          "probe_cuda_gather.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    readings = probe.run("cpu", n=512, rows=128, reps=1)
    assert [r["name"] for r in readings] == [
        "probe_row_gather", "probe_elem_gather", "probe_lane_gather",
        "probe_atomic_add", "probe_atomic_add"]
    assert all(r["ok"] and r["bound_by"] == "bytes" and r["bound_ms"] > 0
               for r in readings)
    assert all(tracing.counts[f"{w.__name__}.launches"] == 0
               for w in probe.PROBES)
    if not torch.cuda.is_available():
        assert probe.main() == 1
