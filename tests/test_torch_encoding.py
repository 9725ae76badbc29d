"""Port parity: the frequency and spherical-harmonics encoders against the
JAX package, and the encoder dispatch of the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_replication_tpu.models.encoding.freq import freq_encode as jax_freq
from nerf_replication_tpu.models.encoding.sh import SHEncoder as JaxSHEncoder
from nerf_replication_tpu.models.encoding.sh import sh_encode as jax_sh
from nerf_replication_tpu_torch.config import CN
from nerf_replication_tpu_torch.models.encoding import get_encoder
from nerf_replication_tpu_torch.models.encoding.freq import freq_encode
from nerf_replication_tpu_torch.models.encoding.sh import SHEncoder, sh_encode


@pytest.mark.parametrize("n_freqs,include_input",
                         [(10, True), (4, True), (6, False)])
def test_freq_encode_matches_jax(n_freqs, include_input):
    """float32 inputs with |x| up to 6 (render points reach ~6): the top
    band's argument is 2^9 x ~ 3000 rad, where float32 sin/cos of two
    libraries agree to ~1e-4 (the argument's own rounding is 2.4e-4)."""
    x = np.random.default_rng(0).uniform(-6, 6, size=(257, 3)).astype(
        np.float32)
    ref = np.asarray(jax_freq(jnp.asarray(x), n_freqs, include_input))
    out = freq_encode(torch.from_numpy(x), n_freqs, include_input).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode_matches_jax(degree):
    """Unit directions: the same f32 products and sums in the same order;
    XLA may contract a product and a sum into one FMA, so values of order
    1 agree to atol 1e-6."""
    d = np.random.default_rng(degree).normal(size=(500, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    out = sh_encode(torch.from_numpy(d), degree).numpy()
    ref = np.asarray(jax_sh(jnp.asarray(d), degree))
    assert out.shape == ref.shape == (500, degree ** 2)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_sh_encoder_normalises_as_jax_does():
    """Raw ray directions, a tiny and a zero one among them: divided by
    |d| + 1e-8 first (a zero direction gives the constant band alone);
    atol 1e-6 as above. The dispatch builds it from the config names."""
    d = np.random.default_rng(7).normal(scale=3.0, size=(64, 3))
    d[0], d[1] = 0.0, 1e-9
    d = d.astype(np.float32)
    enc = get_encoder(CN({"type": "sphere_harmonics", "degree": 4}))
    assert isinstance(enc, SHEncoder) and enc.output_dim == 16
    out = enc(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(out, np.asarray(JaxSHEncoder(4)(jnp.asarray(d))),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out[0, 1:], 0.0)
    with pytest.raises(ValueError):
        SHEncoder(degree=5)


# every name the JAX dispatch knows besides "frequency" and
# "sphere_harmonics" (the hash-grid names default to the xla backend);
# the first five encode points, the rest points and a time
OTHER_TYPES = [
    "hashgrid", "cuda_hashgrid", "grid_hash",
    "triplane", "cuda_triplane", "cuda_hashgrid_latent", "cuda_hashgrid_4d",
    "cuda_hashgrid_coef", "cuda_motion2d", "dnerf", "dnerf_mlp_tensorf",
    "dnerf_ngp_mlp", "dnerf_ngp_tensorf", "cuda_dnerf_ngp_tensorf",
]


@pytest.mark.parametrize("name", OTHER_TYPES)
def test_unported_encoders_name_their_roadmap_item(name):
    """Every encoder name builds its module and encodes: none is left
    unported (the test's name dates from when these raised). Each builds
    at a small size here and encodes points of its input width; their
    parity with the JAX package is in tests/test_torch_hashgrid_xla.py and
    tests/test_torch_composite_encoders.py."""
    enc = get_encoder(CN({"type": name, "num_levels": 2,
                          "log2_hashmap_size": 8, "W": 16, "D": 2}))
    width = 3 if name in OTHER_TYPES[:5] else 4   # xyz, else xyz + t
    out = enc(torch.rand(5, width))
    assert out.shape == (5, enc.output_dim)
    assert bool(torch.isfinite(out).all())


def test_frequency_encoder_dims_and_unknown_type():
    enc = get_encoder(CN({"type": "frequency", "input_dim": 3, "freq": 10}))
    assert enc.output_dim == 63 and enc.n_freqs == 10
    with pytest.raises(ValueError):
        get_encoder(CN({"type": "no_such_encoder"}))
