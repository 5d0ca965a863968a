"""The port's composite render in its four contact modes and its
composite fine-tuning step (train/composite.py) against the JAX
package's on the CPU: a voxel-skinned hand and an object blob through its
palm, 64x64, the same numpy inputs; JAX on its plain `xla` raster path,
the port on `torch`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manus_tpu import config as jconfig
from manus_tpu.data.synthetic import (
    gt_object_gaussians,
    hemisphere_cameras,
    procedural_skeleton,
    sample_gaussians_on_bones,
)
from manus_tpu.data.voxel import build_voxel_grid
from manus_tpu.models.gaussians import init_gaussian_model as j_init
from manus_tpu.ops import contacts as jcontacts
from manus_tpu.ops.rasterizer.api import RasterConfig as JRaster
from manus_tpu.ops.skinning import bone_deformation_transforms as j_bone_tf
from manus_tpu.train import composite as jcomp
from manus_tpu.train import workloads as jwork
from manus_tpu_torch import config as tconfig
from manus_tpu_torch.models.convert import (
    camera_from_numpy,
    model_from_numpy,
    voxel_grid_from_numpy,
)
from manus_tpu_torch.ops.rasterizer.api import RasterConfig as TRaster
from manus_tpu_torch.train import composite as tcomp
from manus_tpu_torch.train.optim import group_learning_rates
from manus_tpu_torch.utils.camera import TENSOR_FIELDS
from manus_tpu_torch.utils.colormap import lut
from tests.test_torch_train_step import _port_state

W = H = 64
HAND_CAP, OBJ_CAP = 1024, 768
RASTER = dict(tg_max=64, max_pairs_per_tile=512, chunk=32)
ALPHA = 0.3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scene():
    """780 hand points on procedural_skeleton's bones with a 16-cell
    nearest-keypoint voxel grid, posed at frame 1; an object blob of 600
    points (radius ~6 cm) through the palm, so a few dozen hand points lie
    within the 4 mm threshold; two cameras 0.45 m away."""
    skel = procedural_skeleton(2)
    pts, cols = sample_gaussians_on_bones(
        skel["rest_heads"], skel["rest_tails"], skel["rest_transforms"], 40,
        seed=0)
    center = skel["rest_heads"].mean(0)
    kp = np.concatenate([skel["rest_heads"][:1], skel["rest_tails"]])
    vg = build_voxel_grid(kp, mano=None, res=16, num_bones=len(skel["bnames"]))
    og = gt_object_gaussians(600, seed=3)
    rng = np.random.RandomState(0)
    return dict(
        hand=j_init(pts, cols, HAND_CAP),
        obj=j_init(og["means"] * 0.12 + center, og["colors"], OBJ_CAP),
        vg=vg,
        cams=hemisphere_cameras(4, W, H, dist=0.45, center=center)[:2],
        bone_tf=j_bone_tf(jnp.asarray(skel["pose_transforms"][1]),
                          jnp.asarray(skel["rest_transforms"]),
                          append_identity=True),
        aux=rng.uniform(0, 1, (HAND_CAP, 3)).astype(np.float32),
        acc=rng.uniform(0, 0.6, HAND_CAP).astype(np.float32),
        gt=rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
        mask=(rng.uniform(size=(H, W, 1)) > 0.3).astype(np.float32),
    )


def _cam(c):
    return camera_from_numpy(
        dict({f: np.asarray(getattr(c, f)) for f in TENSOR_FIELDS},
             width=c.width, height=c.height), "cpu")


def _model(m):
    return model_from_numpy(
        dict(jax.tree.map(np.asarray, m.params)._asdict(),
             active=np.asarray(m.active)), "cpu")


def _grid(vg):
    return voxel_grid_from_numpy(dict(
        vg_center=np.asarray(vg.center), vg_scale=np.asarray(vg.scale),
        vg_weights=np.asarray(vg.weights)), "cpu")


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture
def reference_contacts(monkeypatch):
    """The JAX composite's contact_map with its beyond-threshold residue
    set to 0. Under jax.jit, XLA on the CPU computes 1 - clip(d, 0, c) / c
    as 1 - c * (1 / c) ~ 1.4e-8 for every point farther than c, where the
    reference (and the port) give 0 (ROADMAP Queue C;
    test_torch_colormap_contacts.py). Without this, the JAX nocs panels
    colour every active point, not those in contact."""
    orig = jcontacts.contact_map

    def contact_map(*args, **kwargs):
        d01, idx, colors = orig(*args, **kwargs)
        return jnp.where(d01 < 1e-6, 0.0, d01), idx, colors

    monkeypatch.setattr(jcontacts, "contact_map", contact_map)


# The contact panels colour each gaussian by a LUT entry, floor(v * 255) of
# its d01 (or the accumulated map). The two packages' d01 differ by the
# conditioning of the distance expansion (test_torch_colormap_contacts.py),
# so a value within that of a step of the table takes the next entry: that
# gaussian's colour moves by (1 - alpha) times the table's largest step
# (magma: 0.0096). Such flips are rare (one or two gaussians here, each
# over ~30 of the panel's 4,096 pixels): renders are held within 1e-4 at
# 97% of the pixels and within 1e-4 + that move everywhere. The nocs
# panels take a hand point's colour by its nearest-neighbour index, which
# may differ where two neighbours are within rounding of each other: 97%
# of those pixels within 1e-4.
@pytest.mark.parametrize("mode", ["results", "gt_eval", "acc_gt_eval",
                                  "nocs"])
def test_composite_render_matches_jax(mode, scene, reference_contacts):
    sc = scene
    jfn = jcomp.make_composite_render(
        jconfig.composite_config(), JRaster(backend="xla", **RASTER), mode)
    jr, jacc, jd01 = jfn(
        jcomp.CompositeModels(sc["hand"], sc["obj"], sc["vg"]), sc["bone_tf"],
        sc["cams"][0], sc["cams"][1], jnp.zeros(3), jnp.asarray(sc["acc"]),
        jnp.asarray(sc["aux"]))
    tfn = tcomp.make_composite_render(
        tconfig.composite_config(), TRaster(backend="torch", **RASTER), mode)
    stats = {}
    tr, tacc, td01 = tfn(
        tcomp.CompositeModels(_model(sc["hand"]), _model(sc["obj"]),
                              _grid(sc["vg"])),
        torch.tensor(np.asarray(sc["bone_tf"])), _cam(sc["cams"][0]),
        _cam(sc["cams"][1]), torch.zeros(3), torch.tensor(sc["acc"]),
        torch.tensor(sc["aux"]), stats=stats)
    tr, jr = tr.numpy(), np.asarray(jr)
    assert tr.shape == jr.shape == (H, W * tcomp.PANELS[mode], 3)
    assert stats["pair_overflow"].shape == () and stats["pair_overflow"] >= 0

    # d01 and the accumulated map: the distance conditioning of
    # test_torch_colormap_contacts.py at |x| <= 0.4 m (eps = 8 u (0.8)^2,
    # sqrt(2 eps) = 2.5e-4 m), over c = 4 mm: 0.07
    td01, jd01 = td01.numpy(), np.asarray(jd01)
    np.testing.assert_allclose(td01, jd01, atol=0.07, rtol=0)
    assert 10 < (td01 > 0).sum() < 780
    assert np.abs(td01 - jd01).mean() < 1e-5
    want_acc = sc["acc"] if mode == "acc_gt_eval" else sc["acc"] + jd01
    np.testing.assert_allclose(tacc.numpy(), want_acc, atol=0.07, rtol=0)
    np.testing.assert_allclose(np.asarray(jacc), want_acc, atol=1e-7)

    step = (1 - ALPHA) * np.abs(np.diff(lut("magma"), axis=0)).max()
    for k in range(tcomp.PANELS[mode]):
        err = np.abs(tr[:, k * W:(k + 1) * W] - jr[:, k * W:(k + 1) * W])
        assert (err <= 1e-4).mean() >= 0.97, f"panel {k}: {err.max()}"
        if not (mode == "nocs" and k > 0):
            assert err.max() <= 1e-4 + step, f"panel {k}: {err.max()}"


def test_unknown_mode_raises_up_front():
    """The JAX package fails only at the panels' concatenate."""
    with pytest.raises(ValueError, match="contact_render_type"):
        tcomp.make_composite_render(tconfig.composite_config(),
                                    TRaster(backend="torch"), "heatmap")


def _check_finetune_state(start, tstate, jstate, grad_tol=2e-3):
    """The port's state after one step from JAX's `start` against JAX's:
    the Adam moments within grad_tol of each leaf's largest entry (the
    render gradients' normalised tolerance); the parameters held to masked
    Adam in float64 on the port's own moments and the pre-step
    parameters, at group_learning_rates' rate and the float32 bias
    corrections, within 4 float32 ulps plus 1e-6 of the rate (as
    tests/test_torch_train_step_lpips.py holds the training step's);
    inactive slots unchanged."""
    assert tstate.step == int(jstate.step)
    assert tstate.opt.step == int(jstate.opt.step)
    lrs = group_learning_rates(tconfig.composite_config().model,
                               int(start.step))
    t = tstate.opt.step
    bc1, bc2 = (float(1.0 - torch.tensor(beta, dtype=torch.float32) ** t)
                for beta in (0.9, 0.999))
    active = tstate.model.active.numpy()
    for name in jstate.model.params._fields:
        for mom in ("m", "v"):
            want = np.asarray(getattr(getattr(jstate.opt, mom), name))
            got = getattr(getattr(tstate.opt, mom), name).numpy()
            np.testing.assert_allclose(
                got, want, atol=grad_tol * np.abs(want).max() + 1e-30, rtol=0,
                err_msg=f"adam {mom} {name}")
        lr = float(getattr(lrs, name))
        got = getattr(tstate.model.params, name).numpy()
        m = getattr(tstate.opt.m, name).numpy().astype(np.float64)
        v = getattr(tstate.opt.v, name).numpy().astype(np.float64)
        p0 = np.asarray(getattr(start.model.params, name), np.float64)
        adam = p0 - lr * (m / bc1) / (np.sqrt(v / bc2) + 1e-15)
        act = np.broadcast_to(active.reshape((-1,) + (1,) * (m.ndim - 1)),
                              m.shape)
        want = np.where(act, adam, p0)
        tol = 4 * np.spacing(np.abs(want).astype(np.float32)) + 1e-6 * lr
        assert (np.abs(got - want) <= tol).all(), name


@pytest.mark.parametrize("optimize", ["hand", "object"])
def test_composite_finetune_step_matches_jax(optimize, scene):
    """Three steps of each package, each from the same (JAX's) state: the
    loss within 1e-4 of JAX's, psnr within 1e-3 dB, the state as
    _check_finetune_state holds it. The hand is skinned by its voxel grid,
    with the gradient through the grid sample to the positions, as JAX
    takes it."""
    sc = scene
    trainable = sc["hand"] if optimize == "hand" else sc["obj"]
    frozen = sc["obj"] if optimize == "hand" else sc["hand"]
    jstep = jcomp.make_composite_finetune_step(
        jconfig.composite_config(), JRaster(backend="xla", **RASTER),
        optimize, voxel_grid=sc["vg"])
    tstep = tcomp.make_composite_finetune_step(
        tconfig.composite_config(), TRaster(backend="torch", **RASTER),
        optimize, voxel_grid=_grid(sc["vg"]))
    jbatch = dict(rgb=jnp.asarray(sc["gt"]), mask=jnp.asarray(sc["mask"]),
                  camera=sc["cams"][0], bg=jnp.zeros(3),
                  bone_tf=sc["bone_tf"])
    tbatch = dict(rgb=torch.tensor(sc["gt"]), mask=torch.tensor(sc["mask"]),
                  camera=_cam(sc["cams"][0]), bg=torch.zeros(3),
                  bone_tf=torch.tensor(np.asarray(sc["bone_tf"])))
    tfrozen = _model(frozen)
    jstate = jwork.init_train_state(trainable)
    losses = []
    for k in range(3):
        start = jstate
        jstate, jm = jstep(start, frozen, jbatch)
        tstate, tm = tstep(_port_state(start), tfrozen, tbatch)
        assert set(tm) == {"loss", "psnr"}
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-4, rtol=0, err_msg=f"step {k}")
        np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]),
                                   atol=1e-3, rtol=0, err_msg=f"step {k}")
        _check_finetune_state(start, tstate, jstate)
        np.testing.assert_array_equal(tstate.model.active.numpy(),
                                      np.asarray(jstate.model.active))
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0]
