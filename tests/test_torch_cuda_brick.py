"""The two brick gather kernels on a GPU: the eval encode (TPU kernels
#8/#9, csrc/brick_encode_eval.cu, from the cell-corner table) and the
training forward (#6, csrc/brick_hash_encode.cu), each bit for bit against
its plain version at ragged point counts around the 32- and 64-point
tiles, at N = 0, and at the main path's sizes, on 12- and 16-level
layouts. Every test is marked ``cuda`` and skips itself where no GPU is
found. Imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_brick.py
"""

import numpy as np
import pytest
import torch

from nerf_replication_tpu_torch.ops import eval_encode
from nerf_replication_tpu_torch.ops import hashgrid_kernel as hk
from nerf_replication_tpu_torch.utils import tracing

# hard_ngp at the b9 checkpoint's and the yaml's brick caps (every level
# bf16 on the training forward), lego_ngp's 16 levels, and a 12-level
# layout with f32 levels (log2_bricks 13)
LAYOUTS = {"b9": (12, 16, 512, 9), "b12": (12, 16, 512, 12),
           "16 levels": (16, 16, 1024, 12), "b13": (12, 16, 512, 13)}
# ragged counts; the eval's coarse / fine chunk and the training batch's
# coarse / fine points
SIZES = [0, 1, 31, 32, 127, 129, 4097]
REAL = [384_000, 896_000, 49_152, 114_688]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def ray_points(n: int, seed: int, device) -> torch.Tensor:
    """n points in [0,1]^3, 64 consecutive samples a ray (so neighbouring
    lanes share cells, as on the render and training paths), with 0 and 1
    among them."""
    g = np.random.default_rng(seed)
    rays = -(-n // 64)
    o = g.uniform(0, 1, (rays, 1, 3))
    d = g.normal(size=(rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(0, 0.5, 64)[None, :, None]
    x = np.clip(o + t * d, 0, 1).reshape(-1, 3)[:n]
    x[:2] = np.array([[0, 0, 0], [1, 1, 1]])[:n]
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def tables(args, seed, device):
    layout = hk.make_brick_layout(*args)
    table = torch.empty(layout.n_rows, hk.ROW, device=device).uniform_(
        -1, 1, generator=torch.Generator(device=device).manual_seed(seed))
    packed = eval_encode.pack_eval_table(table)
    return layout, table, packed, eval_encode.pack_cell_table(packed)


@pytest.mark.cuda
@pytest.mark.parametrize("layout_name", list(LAYOUTS))
def test_brick_gathers_match_plain_versions(cuda, layout_name):
    """Both kernels at every ragged size, bit for bit: the eval encode
    against its plain version over the cell table and against the oracle
    over the packed table, the training forward against its plain
    version; one launch a call, none at N = 0."""
    layout, table, packed, cells = tables(LAYOUTS[layout_name], 0, cuda)
    for n in SIZES:
        x = ray_points(n, n, cuda)
        counts = (tracing.counts["brick_encode_eval.launches"],
                  tracing.counts["brick_hash_encode.launches"])
        feats = eval_encode.brick_encode_eval(layout, cells, x)
        out = hk.brick_hash_encode(layout, table, x)
        torch.cuda.synchronize()
        launched = int(n > 0)
        assert (tracing.counts["brick_encode_eval.launches"],
                tracing.counts["brick_hash_encode.launches"]) == (
                    counts[0] + launched, counts[1] + launched)
        assert feats.shape == out.shape == (n, 2 * len(layout.scales))
        assert torch.equal(feats, eval_encode.brick_encode_cells_reference(
            layout, cells, x))
        assert torch.equal(feats, eval_encode.brick_encode_eval_reference(
            layout, packed, x))
        assert torch.equal(out, hk.brick_encode_reference(layout, table, x))


@pytest.mark.cuda
@pytest.mark.parametrize("n", REAL)
def test_brick_gathers_match_plain_versions_at_path_sizes(cuda, n):
    """The main path's point counts, on the yaml's layout (the training
    forward) and the b9 checkpoint's (the eval encode), at the wrappers'
    own level groups."""
    layout, table, _, _ = tables(LAYOUTS["b12"], n, cuda)
    x = ray_points(n, n, cuda)
    assert torch.equal(hk.brick_hash_encode(layout, table, x),
                       hk.brick_encode_reference(layout, table, x))
    layout, _, packed, cells = tables(LAYOUTS["b9"], n, cuda)
    assert torch.equal(eval_encode.brick_encode_eval(layout, cells, x),
                       eval_encode.brick_encode_eval_reference(
                           layout, packed, x))


@pytest.mark.cuda
def test_eval_wrapper_refuses_a_misaligned_or_strided_cell_table(cuda):
    layout, _, packed, cells = tables(LAYOUTS["b9"], 0, cuda)
    x = ray_points(64, 0, cuda)
    # contiguous, but 4 bytes off the 16-byte alignment of the cell loads
    misaligned = torch.empty(cells.numel() + 1, dtype=torch.int32,
                             device=cuda)[1:].view_as(cells)
    misaligned.copy_(cells)
    strided = torch.empty(layout.n_rows, 1024, dtype=torch.int32,
                          device=cuda)[:, ::2]
    strided.copy_(cells)
    for bad in (misaligned, strided, packed, cells.float(), cells.cpu(),
                cells[:-1]):
        with pytest.raises(ValueError):
            eval_encode.brick_encode_eval(layout, bad, x)
