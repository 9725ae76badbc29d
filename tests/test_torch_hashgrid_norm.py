"""The hash grids' normalisation into their box, against the jitted JAX
package.

The JAX package's ``normalize_to_unit`` divides by the largest side plus
1e-6; inside ``jit`` that divisor is a constant, and XLA computes the
division as a product by its float32 reciprocal. The first test shows that
this is what jitted JAX does (and that eager JAX and a true division differ
from it at the shipped bounds), so the port is held bit for bit to the
jitted function, and its encoders of configs/nerf/hard_ngp.yaml (brick and
xla backends) to the jitted Flax encoders: unit coordinates and the xla
grid's corner rows bit-equal, the encode within atol 1e-6 (the tolerance
of the grids' other parity tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nerf_replication_tpu.config import CN as JaxCN
from nerf_replication_tpu.models.encoding import hashgrid as jhg
from nerf_replication_tpu_torch.config import CN
from nerf_replication_tpu_torch.models.encoding import get_encoder
from nerf_replication_tpu_torch.models.encoding import hashgrid as hg

# the bounds of configs/nerf/hard_ngp.yaml and configs/nerf/lego_ngp.yaml
HALF_SIDES = {"hard_ngp": 1.2, "lego_ngp": 1.5}
ENC_ATOL = 1e-6


def world_points(half: float, n: int = 20000, seed: int = 0) -> np.ndarray:
    """Points inside and up to 10% outside the box, its corners and faces."""
    g = np.random.default_rng(seed)
    x = g.uniform(-1.1 * half, 1.1 * half, (n, 3))
    faces = np.array([[-half] * 3, [half] * 3, [0.0, -half, half]])
    return np.concatenate([x, faces]).astype(np.float32)


def jitted_normalize(x: np.ndarray, bounds) -> np.ndarray:
    return np.asarray(jax.jit(lambda p: jhg.normalize_to_unit(p, bounds))(
        jnp.asarray(x)))


@pytest.mark.parametrize("name", sorted(HALF_SIDES))
def test_jitted_jax_normalises_by_the_reciprocal(name):
    """Jitted JAX equals (x - lo) * f32(1 / side) bit for bit; a true
    division (eager JAX, the port before this repair) lands elsewhere."""
    half = HALF_SIDES[name]
    bounds = [-half] * 3 + [half] * 3
    x = world_points(half)
    lo, hi = np.float32(-half), np.float32(half)
    side = (hi - lo) + np.float32(jhg.EPS)
    clipped = np.clip(x, lo, hi)
    jitted = jitted_normalize(x, bounds)
    np.testing.assert_array_equal(jitted,
                                  (clipped - lo) * (np.float32(1) / side))
    divided = (clipped - lo) / side
    assert (jitted != divided).mean() > 0.05
    eager = np.asarray(jhg.normalize_to_unit(jnp.asarray(x), bounds))
    np.testing.assert_array_equal(eager, divided)


@pytest.mark.parametrize("name", sorted(HALF_SIDES))
def test_normalize_to_unit_is_bit_equal_to_jitted_jax(name):
    half = HALF_SIDES[name]
    bounds = [-half] * 3 + [half] * 3
    x = world_points(half, seed=1)
    np.testing.assert_array_equal(
        hg.normalize_to_unit(torch.from_numpy(x), bounds).numpy(),
        jitted_normalize(x, bounds))


def _encoder_section(backend: str) -> dict:
    with open("configs/nerf/hard_ngp.yaml") as f:
        section = yaml.safe_load(f)["network"]["xyz_encoder"]
    return {**section, "backend": backend}


@pytest.mark.parametrize("backend", ["brick", "xla"])
def test_hard_ngp_encoder_matches_jitted_flax(backend, monkeypatch):
    """hard_ngp.yaml's encoder section (12 levels, bounds +-1.2) on world
    points: the unit coordinates bit-equal to jitted JAX's, the xla grid's
    corner rows bit-equal to JAX's on them, the encode against the jitted
    Flax encoder on the same seeded table within atol 1e-6."""
    import os

    monkeypatch.chdir(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    section = _encoder_section(backend)
    enc = get_encoder(CN(section))
    jenc = jhg.HashGridEncoder.from_cfg(JaxCN(section))
    assert enc.backend == backend
    table = np.random.default_rng(2).uniform(
        -1, 1, tuple(enc.table.shape)).astype(np.float32)
    with torch.no_grad():
        enc.table.copy_(torch.from_numpy(table))
    x = world_points(1.2, n=4000, seed=3)
    unit = enc.to_unit(torch.from_numpy(x))
    np.testing.assert_array_equal(
        unit.numpy(), np.clip(jitted_normalize(x, section["bounds"]), 0, 1))
    if backend == "xla":
        layout = enc.layout
        ref = (*layout, True)
        rows, _ = hg._indices_weights(layout, unit)
        jrows, _ = jax.jit(lambda p: jhg._indices_weights(ref, p))(
            jnp.asarray(unit.numpy()))
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    with torch.no_grad():
        out = enc(torch.from_numpy(x)).numpy()
    expect = jax.jit(jenc.apply)({"params": {"table": jnp.asarray(table)}},
                                 jnp.asarray(x))
    np.testing.assert_allclose(out, np.asarray(expect), atol=ENC_ATOL, rtol=0)
