"""Parity of the PyTorch port's render path with the JAX package, on CPU.

Inputs are made with numpy from a seed and go through both packages; each
case states its tolerance. The port runs with device="cpu", where the
composite is the CUDA kernels' plain PyTorch version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manus_tpu.data.synthetic import procedural_skeleton, sample_gaussians_on_bones
from manus_tpu.ops.rasterizer import pallas_backend
from manus_tpu.ops.rasterizer import payload as jpayload
from manus_tpu.ops.rasterizer.api import RasterConfig as JRasterConfig
from manus_tpu.ops.rasterizer.api import calculate_colors_from_sh as j_colors
from manus_tpu.ops.rasterizer.api import render_gaussians as j_render
from manus_tpu.ops.rasterizer.binning import bin_gaussians as j_bin
from manus_tpu.ops.rasterizer.projection import project_gaussians as j_project
from manus_tpu.ops.skinning import bone_deformation_transforms as j_bone_tf
from manus_tpu.ops.skinning import skin_gaussians as j_skin
from manus_tpu.utils.transforms import covariance_from_scaling_rotation as j_cov
from manus_tpu_torch.models.convert import camera_from_numpy
from manus_tpu_torch.ops.rasterizer import composite
from manus_tpu_torch.ops.rasterizer.api import RasterConfig, render_gaussians
from manus_tpu_torch.ops.rasterizer.api import calculate_colors_from_sh
from manus_tpu_torch.ops.rasterizer.binning import bin_gaussians
from manus_tpu_torch.ops.rasterizer.payload import build_payload
from manus_tpu_torch.ops.rasterizer.projection import project_gaussians
from manus_tpu_torch.ops.skinning import bone_deformation_transforms, skin_gaussians
from manus_tpu_torch.utils.camera import TENSOR_FIELDS
from manus_tpu_torch.utils.transforms import covariance_from_scaling_rotation
from tests.utils import make_test_camera, random_scene


def T(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def port_camera(cam):
    d = {f: np.asarray(getattr(cam, f)) for f in TENSOR_FIELDS}
    return camera_from_numpy(dict(d, width=cam.width, height=cam.height), "cpu")


def assert_close(a, b, atol, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a.astype(np.float64) - b.astype(np.float64)).max()
    assert err <= atol, f"{what}: max abs err {err} > {atol}"


def assert_close_normalised(a, b, atol, what=""):
    """max |a - b| / max |a| <= atol, the scale-free form of
    tests/test_pallas.py for gradients whose magnitude depends on the scene."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(a).max() + 1e-12
    assert np.abs(a).max() > 0, f"{what}: reference is all zero"
    err = np.abs(a - b).max() / scale
    assert err <= atol, f"{what}: normalised err {err} > {atol}"


def hand_inputs(n=300, seed=0):
    """Skinned-hand inputs: canonical points, covariances, skin weights and
    bone transforms of procedural_skeleton, as numpy."""
    skel = procedural_skeleton(8)
    j = len(skel["bnames"])
    pts, cols = sample_gaussians_on_bones(
        skel["rest_heads"], skel["rest_tails"], skel["rest_transforms"],
        n // j + 1, seed=seed)
    pts = pts[:n]
    rng = np.random.RandomState(seed)
    scales = rng.uniform(0.005, 0.03, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    skin = rng.dirichlet(np.ones(j) * 0.1, size=n).astype(np.float32)
    feats = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    return dict(pts=pts, scales=scales, quats=quats, skin=skin, feats=feats,
                pose=skel["pose_transforms"][3], rest=skel["rest_transforms"])


# Tolerance 1e-5 max abs: float32 arithmetic of the same formulas in
# another evaluation order; the values are O(1).
def test_covariance_from_scaling_rotation_parity():
    h = hand_inputs()
    want = j_cov(jnp.asarray(h["scales"]), jnp.asarray(h["quats"]))
    got = covariance_from_scaling_rotation(T(h["scales"]), T(h["quats"]))
    assert_close(got, want, 1e-5, "cov6")


def test_skinning_parity():
    h = hand_inputs()
    cov = j_cov(jnp.asarray(h["scales"]), jnp.asarray(h["quats"]))
    jtf = j_bone_tf(jnp.asarray(h["pose"]), jnp.asarray(h["rest"]))
    ttf = bone_deformation_transforms(T(h["pose"]), T(h["rest"]))
    assert_close(ttf, jtf, 1e-5, "bone tf")
    want = j_skin(jnp.asarray(h["pts"]), cov, jnp.asarray(h["skin"]), jtf)
    got = skin_gaussians(T(h["pts"]), T(cov), T(h["skin"]), T(jtf))
    for name in ("posed_xyz", "posed_cov", "tf"):
        assert_close(getattr(got, name), getattr(want, name), 1e-5, name)


def test_sh_colours_with_tf_parity():
    h = hand_inputs()
    cam = make_test_camera(64, 64, dist=1.2)
    cov = j_cov(jnp.asarray(h["scales"]), jnp.asarray(h["quats"]))
    jtf = j_bone_tf(jnp.asarray(h["pose"]), jnp.asarray(h["rest"]))
    sk = j_skin(jnp.asarray(h["pts"]), cov, jnp.asarray(h["skin"]), jtf)
    for tf in (sk.tf, None):
        want = j_colors(sk.posed_xyz, jnp.asarray(h["feats"]),
                        jnp.asarray(h["pts"]), cam, 3, tf)
        got = calculate_colors_from_sh(
            T(sk.posed_xyz), T(h["feats"]), T(h["pts"]), port_camera(cam), 3,
            None if tf is None else T(tf))
        assert_close(got, want, 1e-5, f"colours tf={tf is not None}")


def test_projection_parity():
    cam = make_test_camera(64, 64)
    s = random_scene(300, seed=2, spread=0.8)
    active = np.random.RandomState(0).uniform(size=300) > 0.1
    want = j_project(jnp.asarray(s["means"]), jnp.asarray(s["cov6"]), cam,
                     active=jnp.asarray(active))
    got = project_gaussians(T(s["means"]), T(s["cov6"]), port_camera(cam),
                            active=T(active, torch.bool))
    # means2d are pixel coordinates up to ~64, where one float32 ulp is
    # 7.6e-6: 3e-5 is four ulps. The rest is O(1): 1e-5.
    assert_close(got.means2d, want.means2d, 3e-5, "means2d")
    assert_close(got.conic, want.conic, 1e-5, "conic")
    assert_close(got.depth, want.depth, 1e-5, "depth")
    # integer and boolean outputs steer binning: exact
    for name in ("radius", "tile_rect", "visible"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert int(got.visible.sum()) > 100


# Binning scenes: (name, scene kwargs, bin kwargs, which rule binds).
BIN_CASES = [
    ("no_drop", dict(n=300, seed=5), dict(tg_max=64, pair_budget_factor=8,
                                          max_pairs_per_tile=1024), None),
    ("tg_max", dict(n=300, seed=5, scale_range=(0.08, 0.25)),
     dict(tg_max=3, pair_budget_factor=0, max_pairs_per_tile=0), "trunc"),
    ("pair_budget", dict(n=300, seed=5, scale_range=(0.08, 0.25)),
     dict(tg_max=64, pair_budget_factor=1, max_pairs_per_tile=0), "budget"),
    ("max_pairs_per_tile", dict(n=300, seed=5),
     dict(tg_max=64, pair_budget_factor=0, max_pairs_per_tile=12), "far"),
    ("multi_capacity", dict(n=300, seed=7, scale_range=(0.05, 0.2)),
     dict(tg_max=64, pair_budget_factor=0, max_pairs_per_tile=0,
          multi_frac=0.05, multi_floor=16), "trunc"),
]


@pytest.mark.parametrize("name,scene,kw,rule", BIN_CASES,
                         ids=[c[0] for c in BIN_CASES])
def test_bin_gaussians_equals_jax(name, scene, kw, rule):
    """Exact integer equality of every binning output, including each
    drop rule: sub-rect tg_max truncation and multi-capacity degradation
    ("trunc"), the pair budget ("budget") and the per-tile cap ("far")."""
    cam = make_test_camera(64, 64)
    s = random_scene(**scene)
    proj = j_project(jnp.asarray(s["means"]), jnp.asarray(s["cov6"]), cam)
    want = j_bin(proj, 4, 4, **kw)
    tproj = project_gaussians(T(s["means"]), T(s["cov6"]), port_camera(cam))
    got = bin_gaussians(tproj, 4, 4, **kw)
    for field in want._fields:
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            f"{name}: {field}")
    over, far = int(got.overflow_count), int(got.overflow_far)
    if rule is None:
        assert over == 0
    elif rule == "far":
        assert far > 0 and over == far
    else:
        assert over > 0 and far == 0
    if rule == "budget":
        # the budget (not truncation) binds: the pairs fill the buffer
        assert int((got.pair_src >= 0).sum()) == got.pair_src.shape[0]


def _jax_payload(s, cam, max_pairs=1024):
    proj = j_project(jnp.asarray(s["means"]), jnp.asarray(s["cov6"]), cam)
    bins = j_bin(proj, cam.width // 16, cam.height // 16, 64, 128, 8, max_pairs)
    pay = jpayload.build_payload(proj, jnp.asarray(s["colors"]),
                                 jnp.asarray(s["opacity"]), bins, 64)
    return pay, bins


def test_plain_composite_matches_pallas_interpret():
    """composite_tiles_torch vs composite_tiles_pallas(interpret=True) at
    32x32, chunk 64, forward and VJP. Tolerance: normalised max abs 1e-4,
    as tests/test_pallas.py holds the Pallas kernel to the XLA path (the
    two prefix sums round differently)."""
    cam = make_test_camera(32, 32)
    s = random_scene(160, seed=11)
    pay, bins = _jax_payload(s, cam)
    rng = np.random.RandomState(0)
    d_rgb = rng.normal(size=(4, 3, 256)).astype(np.float32)
    d_tfin = rng.normal(size=(4, 256)).astype(np.float32)

    (rgb_j, tf_j), vjp = jax.vjp(
        lambda p: pallas_backend.composite_tiles_pallas(
            p, bins.tile_offsets, bins.tile_counts, 2, 2, tile=16, chunk=64,
            interpret=True),
        pay)
    (dpay_j,) = vjp((jnp.asarray(d_rgb), jnp.asarray(d_tfin)))

    tpay = T(pay).requires_grad_(True)
    rgb_t, tf_t = composite.composite_tiles(
        tpay, T(bins.tile_offsets, torch.int32), T(bins.tile_counts, torch.int32),
        2, 2, chunk=64)
    (dpay_t,) = torch.autograd.grad(
        [rgb_t, tf_t], [tpay], [T(d_rgb), T(d_tfin)])
    assert float(tf_t.detach().min()) < 0.2  # the scene covers the tiles
    assert_close_normalised(rgb_j, rgb_t.detach(), 1e-4, "rgb")
    assert_close_normalised(1 - np.asarray(tf_j), 1 - tf_t.detach().numpy(),
                            1e-4, "t_final")
    assert_close_normalised(dpay_j, dpay_t, 1e-4, "d_payload")


def test_payload_and_its_gradient_match_jax():
    """build_payload forward (exact gather) and backward: the plain
    index_add_ of the port against the sort/pointer-doubling VJP of JAX,
    1e-5 max abs (sums of a few float32 cotangents in another order)."""
    cam = make_test_camera(32, 32)
    s = random_scene(160, seed=11)
    jproj = j_project(jnp.asarray(s["means"]), jnp.asarray(s["cov6"]), cam)
    jbins = j_bin(jproj, 2, 2, 64, 128, 8, 1024)
    cot = np.random.RandomState(1).normal(size=(16, jbins.pair_src.shape[0]))
    cot = cot.astype(np.float32)

    def jf(m2d, conic, colors, opacity):
        pay = jpayload.build_payload(
            jproj._replace(means2d=m2d, conic=conic), colors, opacity, jbins, 64)
        return jnp.sum(pay * cot), pay

    args = (jproj.means2d, jproj.conic, jnp.asarray(s["colors"]),
            jnp.asarray(s["opacity"]))
    jgrads, jpay = jax.grad(jf, argnums=(0, 1, 2, 3), has_aux=True)(*args)

    tproj = project_gaussians(T(s["means"]), T(s["cov6"]), port_camera(cam))
    targs = [T(a).requires_grad_(True) for a in args]
    tpay = build_payload(
        tproj._replace(means2d=targs[0], conic=targs[1]), targs[2], targs[3],
        bin_gaussians(tproj, 2, 2, 64, 128, 8, 1024))
    np.testing.assert_array_equal(tpay.detach().numpy(), np.asarray(jpay))
    tgrads = torch.autograd.grad((tpay * T(cot)).sum(), targs)
    for name, a, b in zip(("means2d", "conic", "colors", "opacity"),
                          jgrads, tgrads):
        assert_close(b, a, 1e-5, name)


def _render_scene():
    cam = make_test_camera(48, 48)
    s = random_scene(120, seed=5)
    target = np.random.RandomState(1).uniform(0, 1, (48, 48, 3))
    return cam, s, target.astype(np.float32)


BG = np.array([0.3, 0.1, 0.2], np.float32)


def _j_loss(cam, target, backend):
    n = 120

    def loss(means, cov6, colors, opacity, m2d):
        out = j_render(
            means, cov6, means, jnp.zeros((n, 16, 3)), opacity, cam,
            jnp.asarray(BG), colors_precomp=colors, means2d_offset=m2d,
            config=JRasterConfig(backend=backend, tg_max=64,
                                 max_pairs_per_tile=1024, chunk=32,
                                 pallas_chunk=64))
        return jnp.sum(jnp.abs(out.render - target)), out
    return loss


def _t_loss(cam, target, backend):
    n = 120

    def loss(means, cov6, colors, opacity, m2d):
        out = render_gaussians(
            means, cov6, means, torch.zeros(n, 16, 3), opacity, cam,
            torch.tensor(BG), colors_precomp=colors, means2d_offset=m2d,
            config=RasterConfig(backend=backend, tg_max=64,
                                max_pairs_per_tile=1024, chunk=32))
        return (out.render - T(target)).abs().sum(), out
    return loss


@pytest.mark.parametrize("backend", ["torch", "oracle"])
def test_render_forward_matches_jax(backend):
    """The port's image, T_final and overflow against JAX backend="pallas"
    (interpret mode): 2e-5 max abs, as tests/test_pallas.py holds Pallas
    to XLA."""
    cam, s, target = _render_scene()
    args = [s["means"], s["cov6"], s["colors"], s["opacity"],
            np.zeros((120, 2), np.float32)]
    _, jout = _j_loss(cam, target, "pallas")(*map(jnp.asarray, args))
    _, tout = _t_loss(port_camera(cam), target, backend)(*map(T, args))
    assert_close(tout.render.detach(), jout.render, 2e-5, "render")
    assert_close(tout.t_final, jout.t_final, 2e-5, "t_final")
    np.testing.assert_array_equal(tout.radii.numpy(), np.asarray(jout.radii))
    assert int(tout.overflow) == int(jout.overflow)
    assert float(tout.t_final.min()) < 0.5


def test_render_gradients_match_jax_xla():
    """Gradients wrt means, cov, colours, opacity and means2d_offset against
    JAX backend="xla" with a non-zero background: normalised max abs 1e-4,
    the tolerance tests/test_pallas.py uses between two composites."""
    cam, s, target = _render_scene()
    args = [s["means"], s["cov6"], s["colors"], s["opacity"],
            np.zeros((120, 2), np.float32)]
    jf = _j_loss(cam, target, "xla")
    jgrads = jax.grad(lambda *a: jf(*a)[0], argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, args))
    targs = [T(a).requires_grad_(True) for a in args]
    loss, _ = _t_loss(port_camera(cam), target, "torch")(*targs)
    tgrads = torch.autograd.grad(loss, targs)
    for name, a, b in zip(("means", "cov", "colors", "opacity", "m2d"),
                          jgrads, tgrads):
        assert_close_normalised(a, b, 1e-4, name)
