"""Port parity for the ESS/ERT parts of the volume renderer: the
``fast_sampling`` masks (``_ess_ert_mask``), the masked ``fine_stage`` with
its ``ess_stats``, the segmented ``fine_stage_ert``, ``render_rays`` with
``fast_sampling`` in eval and training form, against the JAX package's
functions on the CPU. Inputs are made with numpy from a seed; networks are
small (4 layers, 32 wide, float32) with weights from the JAX package's
init carried over by ``params_from_jax``, plus an analytic sphere density
added in both frameworks so that rays hit, miss and saturate."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_replication_tpu import config as jax_config
from nerf_replication_tpu.models import make_network as jax_make_network
from nerf_replication_tpu.models.nerf.network import init_params
from nerf_replication_tpu.models.nerf.renderer import volume_renderer as jv
from nerf_replication_tpu.train.trainers.nerf import (
    NetworkWrapper as JaxWrapper,
)
from nerf_replication_tpu.utils.ckpt_utils import load_pretrain as jax_load
from nerf_replication_tpu_torch import config
from nerf_replication_tpu_torch.models import make_network
from nerf_replication_tpu_torch.models.nerf.renderer import volume_renderer \
    as tv
from nerf_replication_tpu_torch.train.trainers.nerf import NetworkWrapper
from nerf_replication_tpu_torch.utils import tracing
from nerf_replication_tpu_torch.utils.ckpt_utils import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["network.nerf.D", "4", "network.nerf.W", "32", "network.nerf.skips",
         "[2]", "network.dtype", "float32"]


def _cfgs(*opts):
    """(port cfg, JAX cfg) of configs/nerf/hard.yaml with ``opts``."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        argv = ["--cfg_file", "configs/nerf/hard.yaml", *opts]
        return (config.make_cfg(config.parse_args(argv)),
                jax_config.make_cfg(jax_config.parse_args(argv)))
    finally:
        os.chdir(cwd)


def small_network():
    """(JAX apply, port apply): the small network, seed-0 JAX init, with
    30 x (0.8 - |p|) added to the raw density in both frameworks."""
    cfg, jcfg = _cfgs(*SMALL)
    jnet = jax_make_network(jcfg)
    params = init_params(jnet, jax.random.key(0))
    net = make_network(cfg)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    net.eval()

    def jax_apply(p, pts, viewdirs, model=""):
        raw = jnet.apply(params, pts, viewdirs, model=model)
        sphere = 30.0 * (0.8 - jnp.linalg.norm(pts, axis=-1))
        return raw.at[..., 3].add(sphere)

    def port_apply(pts, viewdirs, model=""):
        raw = net(pts, viewdirs, model)
        sphere = 30.0 * (0.8 - torch.linalg.norm(pts, dim=-1))
        return torch.cat([raw[..., :3], raw[..., 3:] + sphere[..., None]], -1)

    return jax_apply, port_apply


@pytest.fixture(scope="module")
def small():
    return small_network()


def rays(n, seed, spread=0.35):
    """``n`` rays from (0, 0, 4) toward the origin, directions spread so
    that some hit the radius-0.8 sphere and some miss; unit directions."""
    g = np.random.default_rng(seed)
    rd = g.normal(size=(n, 3)) * spread + [0.0, 0.0, -1.0]
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.tile([[0.0, 0.0, 4.0]], (n, 1))
    return ro.astype(np.float32), rd.astype(np.float32)


def both(*arrays):
    """Each numpy array as (jnp array, torch tensor)."""
    return [(jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a)))
            for a in arrays]


def settings(**kw):
    return (jv.RenderSettings(**kw),
            tv.RenderSettings(**{k: v for k, v in kw.items()}))


def assert_outputs(out, ref, keys=("rgb", "depth", "acc"), atol=1e-5):
    for k in keys:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), atol=atol, rtol=0,
                                   err_msg=k)


# --- RenderSettings ---------------------------------------------------------

def test_render_settings_defaults_match_jax():
    j, t = jv.RenderSettings(), tv.RenderSettings()
    for field in dataclasses.fields(j):
        assert getattr(t, field.name) == getattr(j, field.name), field.name


# --- _ess_ert_mask ----------------------------------------------------------

def mask_inputs(n, s, seed):
    """Activated coarse densities (n, s) with every kind of ray: empty
    (all ~0), thin (max <= 0.5), and object rays with a bump of random
    height and place; sorted coarse depths; the coarse bin below each of
    16 fine depths (-1 .. s-2, the range searchsorted - 1 gives)."""
    g = np.random.default_rng(seed)
    t = np.sort(g.uniform(2.0, 6.0, size=(n, s)), axis=-1).astype(np.float32)
    kind = g.integers(0, 3, size=(n, 1))
    centre = g.uniform(2.5, 5.5, size=(n, 1))
    height = np.where(kind == 0, 1e-5, np.where(kind == 1, 0.4, 60.0))
    height = height * g.uniform(0.2, 1.0, size=(n, 1))
    dens = height * np.exp(-((t - centre) / 0.3) ** 2)
    below = g.integers(-1, s - 1, size=(n, 16))
    return dens.astype(np.float32), t, below


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thresholds", [(0.25, 0.45), (0.05, 0.9),
                                        (0.5, 0.1)])
def test_ess_ert_mask_bit_equal(seed, thresholds):
    dens, t, below = mask_inputs(96, 24, seed)
    js, ts = settings(weights_threshold=thresholds[0],
                      ert_threshold=thresholds[1])
    ref = np.asarray(jax.jit(lambda *a: jv._ess_ert_mask(*a, js))(
        jnp.asarray(dens), jnp.asarray(t), jnp.asarray(below)))
    out = tv._ess_ert_mask(torch.from_numpy(dens), torch.from_numpy(t),
                           torch.from_numpy(below), ts)
    assert out.dtype == torch.bool
    np.testing.assert_array_equal(out.numpy(), ref)
    assert 0.01 < ref.mean() < 0.99           # both kinds of sample occur


# --- the masked fine_stage --------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_masked_fine_stage_and_ess_stats_match_jax(small, seed):
    """fine_stage with the coarse densities given: rgb, depth, acc within
    1e-5, ess_stats equal (the mask is exact, the fine MLP float32)."""
    jax_apply, port_apply = small
    n, s_c = 64, 16
    ro, rd = rays(n, seed)
    dens, t, _ = mask_inputs(n, s_c, seed + 10)
    w = np.random.default_rng(seed).uniform(size=(n, s_c)).astype(np.float32)
    (jro, tro), (jrd, trd), (jt, tt), (jw, tw), (jd, td) = both(
        ro, rd, t, w, dens)
    js, ts = settings(N_samples=s_c, N_importance=16, ess_verbose=True,
                      density_activation="softplus")
    ref = jax.jit(lambda ro, rd, t, w, d: jv.fine_stage(
        jax_apply, None, ro, rd, rd, t, w, None, None, js,
        density_coarse=d))(jro, jrd, jt, jw, jd)
    out = tv.fine_stage(port_apply, tro, trd, trd, tt, tw, ts,
                        density_coarse=td)
    assert_outputs(out, ref, ("rgb", "acc"))
    assert_outputs(out, ref, ("depth",), atol=5e-5)
    stats = {k: float(v) for k, v in out["ess_stats"].items()}
    assert stats == {k: float(v) for k, v in ref["ess_stats"].items()}
    assert 0 < stats["skipped_points"] < n * (s_c + 16) - n * s_c
    assert stats["empty_rays"] > 0


def test_masked_samples_get_zero_raw_and_no_gradient(small):
    """In the training form (random u from a generator) an invalid fine
    sample's raw output is replaced by 0 before the weights, so its
    gradient is exactly zero; a valid one's is not. The mask is recomputed
    here from the same generator state."""
    _, port_apply = small
    n, s_c, s_f = 32, 16, 16
    ro, rd = (torch.from_numpy(a) for a in rays(n, 3))
    dens, t, _ = (torch.from_numpy(a) for a in mask_inputs(n, s_c, 4))
    w = torch.from_numpy(np.random.default_rng(5).uniform(
        size=(n, s_c)).astype(np.float32))
    s = tv.RenderSettings(N_samples=s_c, N_importance=s_f,
                          density_activation="softplus", raw_noise_std=0.5)
    seen = []

    def capture(pts, viewdirs, model=""):
        raw = port_apply(pts, viewdirs, model)
        raw.retain_grad()
        seen.append(raw)
        return raw

    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    out = tv.fine_stage(capture, ro, rd, rd, t, w, s, generator=gen,
                        train=True, density_coarse=dens)
    (out["rgb"].sum() + out["depth"].sum()).backward()
    gen.set_state(state)
    bins = 0.5 * (t[..., 1:] + t[..., :-1])
    t_fine = tv.sample_pdf(bins, w[..., 1:-1], s_f, generator=gen)
    order = torch.sort(torch.cat([t, t_fine], -1), dim=-1, stable=True)[1]
    below = torch.searchsorted(bins, t_fine, right=True) - 1
    valid = torch.cat([torch.ones(n, s_c, dtype=torch.bool),
                       tv._ess_ert_mask(dens, t, below, s)], -1
                      ).gather(-1, order)
    grad = seen[0].grad
    assert not valid.all() and valid.any()
    assert (grad[~valid] == 0).all()
    assert (grad[valid].abs().sum(-1) > 0).float().mean() > 0.5


# --- fine_stage_ert ---------------------------------------------------------

@pytest.mark.parametrize("n_samples,n_seg,split,expected", [
    (192, 2, 2.0 / 3.0, [0, 128, 192]),
    (192, 3, 2.0 / 3.0, [0, 128, 160, 192]),
    (32, 4, 0.5, [0, 16, 22, 28, 32]),
    (10, 8, 0.9, [0, 3, 4, 5, 6, 7, 8, 9, 10]),
    (20, 3, 0.99, [0, 18, 19, 20]),
])
def test_ert_bounds(n_samples, n_seg, split, expected):
    """The segment bounds of the JAX fine_stage_ert (:264-275), read off
    the sample counts its segments give the MLP."""
    sizes = []

    def record(p, pts, viewdirs, model=""):
        sizes.append(pts.shape[1])
        return jnp.zeros(pts.shape[:-1] + (4,))

    n_c = n_samples // 2
    t = jnp.tile(jnp.linspace(2.0, 6.0, n_c)[None], (2, 1))
    ones = jnp.ones((2, 3))
    s = jv.RenderSettings(N_samples=n_c, N_importance=n_samples - n_c,
                          ert_split=split)
    jax.jit(lambda t, w: jv.fine_stage_ert(record, None, ones, ones, ones, t,
                                           w, s, n_seg=n_seg))(
        t, jnp.ones((2, n_c)))
    assert list(np.cumsum([0] + sizes)) == expected
    assert tv.ert_bounds(n_samples, n_seg, split) == expected


def test_ert_fractions_and_capacity():
    assert tv.ert_fractions(3) == (0.5, 0.4)
    assert tv.ert_fractions(4, (0.6,)) == (0.6, 0.6 * 0.8, 0.6 * 0.8 ** 2)
    assert tv.ert_fractions(2, (0.3, 0.2)) == (0.3, 0.2)
    assert tv.ert_capacity(40000, 0.5) == 20096
    assert tv.ert_capacity(40000, 0.4) == 16000
    assert tv.ert_capacity(100, 0.001) == 100     # 128 rays, capped at n
    assert tv.ert_capacity(1000, 0.0) == 1


def wall_fields():
    """The JAX test's field: rays with y > 0 meet a wall of density 50
    (they saturate early), the others see softplus(-5)."""
    def jax_apply(p, pts, viewdirs, model=""):
        sigma = jnp.where(pts[..., 1:2] > 0, 50.0, -5.0)
        return jnp.concatenate([jnp.ones_like(sigma), jnp.zeros_like(sigma),
                                pts[..., :1], sigma], axis=-1)

    def port_apply(pts, viewdirs, model=""):
        sigma = torch.where(pts[..., 1:2] > 0, 50.0, -5.0)
        return torch.cat([torch.ones_like(sigma), torch.zeros_like(sigma),
                          pts[..., :1], sigma], -1)

    return jax_apply, port_apply


def ert_inputs(n, s_c, seed):
    g = np.random.default_rng(seed)
    rd = g.normal(size=(n, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    t = np.sort(g.uniform(2.0, 6.0, size=(n, s_c)), axis=-1)
    w = g.uniform(size=(n, s_c))
    return both(np.zeros((n, 3), np.float32), rd.astype(np.float32),
                t.astype(np.float32), w.astype(np.float32))


@pytest.mark.parametrize("field", ["small", "wall"])
@pytest.mark.parametrize("finite_tail", [False, True])
def test_fine_stage_ert_at_full_capacity_is_fine_stage(small, field,
                                                       finite_tail):
    """Every ray kept: fine_stage's outputs up to f32 rounding (the
    carried transmittance multiplies in another order)."""
    _, port_apply = small if field == "small" else wall_fields()
    (_, ro), (_, rd), (_, t), (_, w) = ert_inputs(96, 16, 1)
    s = tv.RenderSettings(N_samples=16, N_importance=16, ert_segments=3,
                          density_activation="softplus",
                          finite_tail=finite_tail)
    dense = tv.fine_stage(port_apply, ro, rd, rd, t, w, s)
    seg = tv.fine_stage_ert(port_apply, ro, rd, rd, t, w, s,
                            surv_frac=(1.0, 1.0))
    assert_outputs(seg, {k: v.detach().numpy() for k, v in dense.items()},
                   atol=2e-6)
    assert int(seg["stats"]["ert_overflow"]) == 0


@pytest.mark.parametrize("field", ["small", "wall"])
@pytest.mark.parametrize("n_seg,frac,split", [
    (2, None, 2.0 / 3.0), (2, (0.3,), 2.0 / 3.0), (3, None, 0.5),
    (4, (0.6,), 0.4)])
def test_fine_stage_ert_tight_capacity_matches_jax(small, field, n_seg,
                                                   frac, split):
    """Survivors kept at tight capacity: the same rays dropped (every ray's
    output within 1e-5, so no ray differs by its tail) and the same
    ert_overflow as the JAX function."""
    jax_apply, port_apply = small if field == "small" else wall_fields()
    (jro, tro), (jrd, trd), (jt, tt), (jw, tw) = ert_inputs(256, 16, 2)
    kw = dict(N_samples=16, N_importance=16, ert_segments=n_seg,
              ert_split=split, density_activation="softplus")
    if frac is not None:
        kw["ert_frac"] = frac
    js, ts = settings(**kw)
    ref = jax.jit(lambda ro, rd, t, w: jv.fine_stage_ert(
        jax_apply, None, ro, rd, rd, t, w, js))(jro, jrd, jt, jw)
    out = tv.fine_stage_ert(port_apply, tro, trd, trd, tt, tw, ts)
    assert_outputs(out, ref)
    assert int(out["stats"]["ert_overflow"]) == int(
        ref["stats"]["ert_overflow"])


# --- render_rays --------------------------------------------------------------

@pytest.mark.parametrize("fast_sampling", [False, True])
def test_render_rays_matches_jax(small, fast_sampling):
    """Eval render_rays with and without the masks: ess_stats equal; the
    coarse outputs and the dense fine ones within 1e-5 (depth 2e-5), the
    masked fine ones within 2e-4 (depth 2e-3; read 9.2e-5 / 1.1e-3); a
    coarse-only call returns the coarse weights as well."""
    jax_apply, port_apply = small
    (jro, tro), (jrd, trd) = both(*rays(64, 0))
    js, ts = settings(N_samples=16, N_importance=24,
                      fast_sampling=fast_sampling, ess_verbose=True,
                      density_activation="softplus")
    ref = jax.jit(lambda ro, rd: jv.render_rays(jax_apply, None, ro, rd,
                                                 None, js))(jro, jrd)
    with torch.no_grad():
        out = tv.render_rays(port_apply, tro, trd, ts)
    assert_outputs(out, ref, ("rgb_coarse", "acc_coarse"))
    assert_outputs(out, ref, ("depth_coarse",), atol=2e-5)
    # a fine depth on a coarse bin's edge can move by an ulp and take the
    # neighbouring bin's ESS verdict
    assert_outputs(out, ref, ("rgb", "acc"),
                   atol=2e-4 if fast_sampling else 1e-5)
    assert_outputs(out, ref, ("depth",), atol=2e-3 if fast_sampling else 2e-5)
    assert ("ess_stats" in out) == ("ess_stats" in ref) == fast_sampling
    if fast_sampling:
        assert ({k: float(v) for k, v in out["ess_stats"].items()}
                == {k: float(v) for k, v in ref["ess_stats"].items()})
        plain = tv.render_rays(port_apply, tro, trd,
                               dataclasses.replace(ts, fast_sampling=False))
        assert (out["rgb"] - plain["rgb"]).abs().max() > 1e-4
    js0, ts0 = (dataclasses.replace(x, N_importance=0) for x in (js, ts))
    ref0 = jax.jit(lambda ro, rd: jv.render_rays(jax_apply, None, ro, rd,
                                                  None, js0))(jro, jrd)
    with torch.no_grad():
        out0 = tv.render_rays(port_apply, tro, trd, ts0)
    assert set(out0) == set(ref0) == {"rgb", "depth", "acc", "weights"}
    assert_outputs(out0, ref0, ("rgb", "acc", "weights"))


# --- the training form on the trained checkpoint ----------------------------

HARD = ["pretrain_path", "data/pretrain/hard", "task_arg.N_samples", "32",
        "task_arg.N_importance", "32", "task_arg.fast_sampling", "True"]


def object_batch(n=48, seed=0):
    """``n`` rays of hard test view 0 over the object, with colours."""
    from nerf_replication_tpu_torch.utils import synthetic_scene

    pose = synthetic_scene.test_poses()[0]
    focal = 800 / (2.0 * np.tan(synthetic_scene.CAMERA_ANGLE_X / 2.0))
    ro, rd = synthetic_scene.camera_rays(pose, 800, 800, focal)
    g = np.random.default_rng(seed)
    iy, ix = g.integers(250, 550, size=n), g.integers(250, 550, size=n)
    return {"rays_o": np.ascontiguousarray(ro[iy, ix]),
            "rays_d": np.ascontiguousarray(rd[iy, ix]),
            "colors": g.uniform(size=(n, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def trained_arms():
    """The masked training loss on the trained hard weights, with no
    randomness, and its gradients as port leaves, through each arm: the
    port's nn.Module and fused arms (the fused kernels' plain versions on
    the CPU), the JAX package's XLA and fused (Pallas) arms."""
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        tree = jax_load("data/pretrain/hard")
        batch = object_batch()
        arms = {}
        for fused in (False, True):
            cfg, jcfg = _cfgs(*HARD, "network.use_pallas_mlp_train",
                              str(fused))
            net = make_network(cfg)
            net.load_state_dict(params_from_jax(tree))
            calls = tracing.counts["fused_nerf_mlp_bwd_reference.calls"]
            loss, _ = NetworkWrapper(net, cfg).loss_fn(
                {k: torch.from_numpy(v) for k, v in batch.items()}, None,
                train=True)
            loss.backward()
            assert (tracing.counts["fused_nerf_mlp_bwd_reference.calls"]
                    > calls) == fused
            arms[("port", fused)] = (float(loss.detach()), {
                k: p.grad.clone() for k, p in net.named_parameters()})
            jwrap = JaxWrapper(jax_make_network(jcfg), jcfg)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jwrap.loss_fn(p, jb, None, train=True)[0]))(
                jax.tree.map(jnp.asarray, tree))
            arms[("jax", fused)] = (float(loss), params_from_jax(
                jax.tree.map(np.asarray, grads)))
    finally:
        os.chdir(cwd)
    return arms


def _rel(grads, ref):
    ours = torch.cat([g.ravel() for g in grads.values()])
    theirs = torch.cat([ref[k].ravel() for k in grads])
    return float((ours - theirs).norm() / theirs.norm())


@pytest.mark.parametrize("fused", [False, True])
def test_masked_training_matches_jax(trained_arms, fused):
    """Each port arm against the JAX arm of its kind with fast_sampling
    on. The fused arms round at the same points: the loss within 2e-4
    relative, all leaves together within 1e-2 in relative norm (read
    3.3e-3). The nn.Module arm's bias add rounds once where Flax's bf16
    Dense rounds twice, which on the trained weights' ill-conditioned
    deepest fine leaves moves the gradient as much as the other arm does
    (below): the loss within 2e-3 (read 3.6e-4), the leaves within 5e-2
    (read 2.8e-2)."""
    loss, grads = trained_arms[("port", fused)]
    ref_loss, ref = trained_arms[("jax", fused)]
    assert loss == pytest.approx(ref_loss, rel=2e-4 if fused else 2e-3)
    assert _rel(grads, ref) < (1e-2 if fused else 5e-2)


def test_masked_training_fused_arm_against_module_arm(trained_arms):
    """The fused training path (#3-#5's plain versions here) against the
    nn.Module arm under the masks: the loss within 2e-3 relative, all
    leaves within 5e-2 in relative norm. The two arms round to bf16 at
    other points, and on these 48 rays the deepest fine leaves are
    ill-conditioned: the port's arms read 2.6% apart, the JAX package's
    own two arms 3.1%, which the same bound holds."""
    loss, grads = trained_arms[("port", True)]
    ref_loss, ref = trained_arms[("port", False)]
    assert loss == pytest.approx(ref_loss, rel=2e-3)
    assert _rel(grads, ref) < 5e-2
    assert _rel(trained_arms[("jax", True)][1],
                trained_arms[("jax", False)][1]) < 5e-2
    assert tracing.counts["fused_nerf_mlp.launches"] == 0
