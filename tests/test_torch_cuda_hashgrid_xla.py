"""The vertex-exact (``xla``) hash grid and the composite encoders on a GPU,
against the same functions on the CPU: the corner rows and weights bit for
bit, the forward against a float64 sum of the same corner products (within
chip_smoke.XLA_FWD_TOL of max |table|), the table gradient against float64
sums of its float32 contributions (every row within its worst-case
summation bound, untouched rows exactly zero), the input gradient against
the CPU's float32 run (within chip_smoke.XLA_DX_TOL of a column's max),
the bf16 arm against its CPU run (within chip_smoke.xla_bf16_agreement's
bound: one bf16 step of the element beyond the two f32 sums' summation
bound), and four composite encoders in float64 (within
chip_smoke.COMPOSITE_F64_TOL of a leaf's max). Plain PyTorch: no kernel of
the repository runs. Every test is marked ``cuda`` and skips itself where
no GPU is found. Imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_hashgrid_xla.py
"""

import copy

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nerf_replication_tpu_torch.config import CN
from nerf_replication_tpu_torch.models.encoding import get_encoder
from nerf_replication_tpu_torch.models.encoding import hashgrid as hg

# (D, levels, base, finest, log2 T, F): small grids with dense and hashed
# levels, and hard_ngp's
GRIDS = {"D2": (2, 4, 4, 64, 10, 2), "D3": (3, 4, 4, 32, 12, 2),
         "D4 F4": (4, 3, 2, 8, 10, 4), "hard_ngp": (3, 12, 16, 512, 19, 2)}
SIZES = [1, 31, 4097, 114_688]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def layout(D, levels, base, finest, log2_t, F, **kw):
    scales, offsets, use_hash, T = hg._level_layout(D, levels, log2_t, base,
                                                    finest, 2.0)
    lay = hg.HashLayout(tuple(scales), tuple(offsets), tuple(use_hash), T, D,
                        F, False)
    return lay._replace(**kw)


def points(n, D, seed):
    x = np.random.default_rng(seed).uniform(0, 1, (n, D))
    x[: min(n, 2)] = np.array([[0.0] * D, [1.0] * D])[: min(n, 2)]
    return torch.from_numpy(x.astype(np.float32))


def table_for(lay, seed, device):
    return torch.empty(lay.offsets[-1], lay.n_features, device=device) \
        .uniform_(-1, 1, generator=torch.Generator(device=device)
                  .manual_seed(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_forward_and_rows(cuda, grid, n):
    lay = layout(*GRIDS[grid])
    x = points(n, lay.input_dim, n)
    table = table_for(lay, 1, cuda)
    idx, w = hg._indices_weights(lay, x.to(cuda))
    ref, idx_cpu, w_cpu = cs.xla_forward_f64(lay, table, x)
    assert torch.equal(idx.cpu(), idx_cpu)
    assert torch.equal(w.cpu(), w_cpu)
    out = hg.hash_encode(lay, table, x.to(cuda))
    err = float((out.cpu().double() - ref).abs().max())
    assert err <= cs.XLA_FWD_TOL * float(table.abs().max())
    out16 = hg.hash_encode(lay, table.to(torch.bfloat16), x.to(cuda))
    ref16 = hg.encode_forward(lay, table.cpu().to(torch.bfloat16), x)
    assert cs.xla_bf16_agreement(out16, ref16, lay, table)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", list(GRIDS))
def test_table_gradient(cuda, grid):
    lay = layout(*GRIDS[grid])
    x = points(20_000, lay.input_dim, 2)
    table = table_for(lay, 3, cuda)
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=(x.shape[0], len(lay.scales) * lay.n_features)).astype(
            np.float32))
    ref = cs.xla_table_grad_f64(lay, x, g, lay.offsets[-1])
    dtable = hg.encode_backward(lay, table, x.to(cuda), g.to(cuda), True,
                                False)[0]
    a = cs.xla_grad_agreement(dtable, ref)
    assert a["ok"] and a["untouched_zero"], a


@pytest.mark.cuda
@pytest.mark.parametrize("grid", list(GRIDS))
def test_input_gradient(cuda, grid):
    lay = layout(*GRIDS[grid], input_grad=True)
    x = points(20_000, lay.input_dim, 5)
    table = table_for(lay, 6, cuda)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=(x.shape[0], len(lay.scales) * lay.n_features)).astype(
            np.float32))
    dx = hg.encode_backward(lay, table, x.to(cuda), g.to(cuda), False,
                            True)[1]
    dx_cpu = hg.encode_backward(lay, table.cpu(), x, g, False, True)[1]
    rel = ((dx.cpu() - dx_cpu).abs().amax(0) / dx_cpu.abs().amax(0)).max()
    assert float(rel) <= cs.XLA_DX_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cuda_motion2d", "cuda_hashgrid_coef",
                                  "dnerf_ngp_tensorf", "dnerf"])
def test_composite_in_float64(cuda, name):
    """A small config (4 levels, 2^14 rows; dnerf 6 x 64, so the skip
    layer runs) on 4096 points: the card against the CPU in float64."""
    enc = get_encoder(CN({"type": name, "num_frames": 3, "num_levels": 4,
                          "log2_hashmap_size": 14, "W": 64, "D": 6,
                          "bounds": [-1.0] * 3 + [1.0] * 3}),
                      torch.Generator().manual_seed(8)).double()
    x = cs.composite_inputs(name, 9)[:4096]
    cot = torch.from_numpy(np.random.default_rng(10).normal(
        size=(x.shape[0], enc.output_dim)))
    card = cs.run_composite(copy.deepcopy(enc).to(cuda), x.to(cuda),
                            cot.to(cuda))
    cpu = cs.run_composite(enc, x, cot)
    assert set(card) == set(cpu)
    for key, ref in cpu.items():
        err = float((card[key].cpu() - ref).abs().max())
        assert err <= cs.COMPOSITE_F64_TOL * float(ref.abs().max()), key
