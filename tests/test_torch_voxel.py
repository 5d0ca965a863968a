"""Parity of the port's voxel skinning with the JAX package, on CPU.

The kNN queries, the trilinear grid sampler and the skin weights it
gives, build_voxel_grid (the nearest-keypoint stand-in and the
MANO branch, on a synthetic mesh) and HAND_GAUSSIAN steps in voxel mode
(the skin weights sampled from the grid every step). Inputs are made
with numpy from seeds; each case states its tolerance.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manus_tpu.data import voxel as jvoxel
from manus_tpu.data.synthetic import procedural_skeleton
from manus_tpu.ops import grid_sample as jgrid
from manus_tpu.ops import knn as jknn
from manus_tpu_torch.data import voxel as tvoxel
from manus_tpu_torch.models.convert import voxel_grid_from_numpy, voxel_grid_to_numpy
from manus_tpu_torch.ops import grid_sample as tgrid
from manus_tpu_torch.ops import knn as tknn
from tests.test_torch_train_step import _jax_step, _port_step, _scene, run_steps


def _coords(rng):
    """In range, out of range (zero-padded corners) and edge-exact."""
    return np.concatenate([
        rng.uniform(-1, 1, (500, 3)),
        rng.uniform(-1.6, 1.6, (500, 3)),
        [[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [1.0, -1.0, 0.3]],
    ]).astype(np.float32)


def test_grid_sample_trilinear_matches_jax():
    """Values within 2e-6 and coordinate gradients within 2e-5 of the JAX
    sampler (8-corner sums in another order)."""
    rng = np.random.RandomState(0)
    grid = rng.rand(5, 6, 7, 4).astype(np.float32)
    coords = _coords(rng)
    cot = rng.rand(coords.shape[0], 4).astype(np.float32)
    want = jgrid.grid_sample_trilinear(jnp.asarray(grid), jnp.asarray(coords))
    g_want = jax.grad(lambda x: jnp.vdot(
        jgrid.grid_sample_trilinear(jnp.asarray(grid), x), cot))(
            jnp.asarray(coords))
    x = torch.tensor(coords, requires_grad=True)
    got = tgrid.grid_sample_trilinear(torch.tensor(grid), x)
    (g_got,) = torch.autograd.grad((got * torch.tensor(cot)).sum(), [x])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("brick", [False, True], ids=["corners", "brick"])
def test_skinning_weights_from_voxel_grid_match_jax(brick):
    """The normalised weights, with all-zero rows (points outside the
    grid) routed to the background channel, within 2e-6 of JAX's plain
    sampler and of its brick table."""
    rng = np.random.RandomState(1)
    grid = rng.rand(5, 6, 7, 4).astype(np.float32)
    grid[..., :] *= rng.rand(5, 6, 7, 1) > 0.3  # some all-zero cells
    center = np.float32([0.1, -0.2, 0.05])
    scale = np.float32([0.3, 0.2, 0.25])
    xyz = _coords(rng) * scale + center
    want = jgrid.skinning_weights_from_voxel_grid(
        jnp.asarray(xyz), jnp.asarray(center), jnp.asarray(scale),
        jnp.asarray(grid),
        brick=jnp.asarray(jgrid.build_brick_table(grid)) if brick else None)
    got = tgrid.skinning_weights_from_voxel_grid(
        torch.tensor(xyz), torch.tensor(center), torch.tensor(scale),
        torch.tensor(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)
    assert (got.numpy()[:, -1] == 1.0).sum() > 100  # outside points


def test_knn_matches_jax():
    """knn_indices: equal neighbour lists (random points: no near ties);
    nearest_neighbor with and without pt2_valid: equal indices, distances
    within 1e-5 (|x|^2 + |y|^2 - 2 x.y cancels to ~1e-7 of d^2, which
    the square root of a small d^2 magnifies)."""
    rng = np.random.RandomState(2)
    q = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    ref = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    want = np.asarray(jknn.knn_indices(jnp.asarray(q), jnp.asarray(ref), 7,
                                       block=256))
    got = tknn.knn_indices(torch.tensor(q), torch.tensor(ref), 7, block=256)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    valid = rng.rand(300) > 0.5
    for pv in (None, valid):
        jd, ji = jknn.nearest_neighbor(
            jnp.asarray(q), jnp.asarray(ref), block=256,
            pt2_valid=None if pv is None else jnp.asarray(pv))
        td, ti = tknn.nearest_neighbor(
            torch.tensor(q), torch.tensor(ref), block=256,
            pt2_valid=None if pv is None else torch.tensor(pv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5,
                                   rtol=0)
        if pv is not None:
            assert pv[ti.numpy()].all()


def _mano(seed=3):
    """A synthetic MANO rest mesh: 778 random vertices around the
    skeleton and Dirichlet weights over MANO's 16 joints."""
    rng = np.random.RandomState(seed)
    return dict(
        verts=rng.uniform(-0.05, 0.2, (778, 3)).astype(np.float32)
        * np.float32([1.0, 1.0, 0.2]),
        faces=np.zeros((1, 3), np.int32),
        weights=rng.dirichlet(np.ones(16) * 0.3, 778).astype(np.float32))


# (res, branch): the nearest-keypoint stand-in on the JAX test's random
# keypoints and on procedural_skeleton's, and the MANO branch, each at
# both resolutions
@pytest.mark.parametrize("res,branch", [(16, "random"), (24, "random"),
                                        (16, "skeleton"), (24, "skeleton"),
                                        (16, "mano"), (24, "mano")])
def test_build_voxel_grid_matches_jax(res, branch):
    """Equal geometry (centre, scale, shape), equal background (far)
    masks, weights within 1e-5 (float32 distances and sums in another
    order, under an exp of -d2 / 8e-4)."""
    if branch == "random":
        kp = np.random.RandomState(0).uniform(-0.1, 0.1, (21, 3)).astype(
            np.float32)
        kw = dict(num_bones=20)
    else:
        skel = procedural_skeleton(8)
        kp = np.concatenate([skel["rest_heads"][:1], skel["rest_tails"]])
        kw = dict(num_bones=13)
    mano = _mano() if branch == "mano" else None
    want = jvoxel.build_voxel_grid(kp, mano=mano, res=res, **kw)
    got = tvoxel.build_voxel_grid(kp, mano=mano, res=res, device="cpu", **kw)
    w_want = np.asarray(want.weights)
    w_got = got.weights.numpy()
    assert w_got.shape == w_want.shape
    np.testing.assert_array_equal(got.center.numpy(), np.asarray(want.center))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    far_want = w_want[..., -1] == 1.0
    np.testing.assert_array_equal(w_got[..., -1] == 1.0, far_want)
    assert 0 < far_want.sum() < far_want.size
    np.testing.assert_allclose(w_got, w_want, atol=1e-5, rtol=0)
    back = voxel_grid_from_numpy(voxel_grid_to_numpy(got), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, got))


def test_mano_skin_weights_20_matches_jax():
    mano = _mano()
    np.testing.assert_array_equal(tvoxel.mano_skin_weights_20(mano),
                                  jvoxel.mano_skin_weights_20(mano))


# One step, and three steps of which the first two run the mask prune: the
# skin weights come from a 24-resolution grid over procedural_skeleton,
# the bone transforms carry the background channel's identity.
@pytest.mark.parametrize("steps,remove_seg_end", [(1, 0), (3, 2)],
                         ids=["1_step", "3_steps_mask_prune"])
def test_voxel_train_steps_match_jax(steps, remove_seg_end):
    sc = _scene()
    skel = procedural_skeleton(8)
    kp = np.concatenate([skel["rest_heads"][:1], skel["rest_tails"]])
    jgrid_ = jvoxel.build_voxel_grid(kp, res=24, num_bones=13)
    tgrid_ = voxel_grid_from_numpy(
        dict(vg_center=jgrid_.center, vg_scale=jgrid_.scale,
             vg_weights=jgrid_.weights), "cpu")
    jstep, jstate, jbatch = _jax_step(sc, remove_seg_end, voxel_grid=jgrid_)
    tstep, tstate, tbatch = _port_step(sc, remove_seg_end, jstate, jbatch,
                                       voxel_grid=tgrid_)
    assert tstate.model.skin_weights is None and tbatch["bone_tf"].shape[0] == 14
    *_, pruned = run_steps(jstep, jstate, jbatch, tstep, tstate, tbatch,
                           steps)
    assert pruned > 0


def test_load_mano_rest_round_trip(tmp_path):
    """A pickle in the reference's layout (vert, faces, weights) loads as
    the JAX loader loads it; a missing file raises where the JAX loader
    returns None, so a wrong path cannot fall back to the stand-in grid."""
    mano = _mano()
    path = tmp_path / "mano_rest.pkl"
    with open(path, "wb") as f:
        pickle.dump(dict(vert=mano["verts"].astype(np.float64),
                         faces=mano["faces"], weights=mano["weights"]), f)
    got = tvoxel.load_mano_rest(str(path))
    want = jvoxel.load_mano_rest(str(path))
    assert set(got) == set(want) == {"verts", "faces", "weights"}
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(FileNotFoundError):
        tvoxel.load_mano_rest(str(tmp_path / "missing.pkl"))


@pytest.mark.parametrize("override", [False, True], ids=["defaults", "set"])
def test_make_voxel_grid_reads_the_config(override):
    """make_voxel_grid builds the grid that the JAX CLI builds from the
    same config fields (grid_res, grid_size, grid_offset; the defaults
    and set values), and none in points mode."""
    from manus_tpu.config import hand_config as j_hand_config
    from manus_tpu_torch.config import hand_config

    skel = procedural_skeleton(8)
    kp = np.concatenate([skel["rest_heads"][:1], skel["rest_tails"]])
    jcfg, cfg = j_hand_config(), hand_config()
    assert (cfg.skin_init, cfg.dataset.grid_res, cfg.dataset.grid_size,
            cfg.dataset.grid_offset) == (
        jcfg.skin_init, jcfg.dataset.grid_res, jcfg.dataset.grid_size,
        jcfg.dataset.grid_offset)
    for c in (jcfg, cfg):
        c.dataset.grid_res = 16
        if override:
            c.dataset.grid_size = (1.0, 0.8, 0.7)
            c.dataset.grid_offset = (0.01, -0.02, 0.0)
    d = jcfg.dataset
    want = jvoxel.build_voxel_grid(kp, res=d.grid_res, ratio=d.grid_size,
                                   offset=d.grid_offset, num_bones=13)
    got = tvoxel.make_voxel_grid(cfg, kp, num_bones=13, device="cpu")
    assert got.weights.shape == want.weights.shape
    np.testing.assert_array_equal(got.center.numpy(), np.asarray(want.center))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               atol=1e-5, rtol=0)
    cfg.skin_init = "mano_init_points"
    assert tvoxel.make_voxel_grid(cfg, kp, num_bones=13, device="cpu") is None
    cfg.skin_init = "mesh"
    with pytest.raises(ValueError, match="skin_init"):
        tvoxel.make_voxel_grid(cfg, kp, num_bones=13, device="cpu")


def test_make_train_step_holds_the_grid_to_skin_init():
    """The hand's step takes a grid exactly when skin_init asks for one;
    the object workload has no skin weights and takes either config."""
    from manus_tpu_torch.config import hand_config
    from manus_tpu_torch.train import workloads as twork

    grid = twork.VoxelGrid(torch.zeros(3), torch.ones(3),
                           torch.zeros(4, 4, 4, 14))
    cfg = hand_config()
    assert callable(twork.make_train_step(cfg, 1.0, True, voxel_grid=grid))
    with pytest.raises(ValueError, match="no voxel grid"):
        twork.make_train_step(cfg, 1.0, True)
    assert callable(twork.make_train_step(cfg, 1.0, False))
    cfg.skin_init = "mano_init_points"
    assert callable(twork.make_train_step(cfg, 1.0, True))
    with pytest.raises(ValueError, match="a voxel grid"):
        twork.make_train_step(cfg, 1.0, True, voxel_grid=grid)
