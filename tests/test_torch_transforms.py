"""The port's utils/transforms.py against the JAX package's on the same
numpy inputs from a seed: quaternions, axis-angles, Euler angles in every
convention (extrinsic and intrinsic), homogeneous helpers and forward
kinematics (kintree, FK, keypoints). float32 on the CPU; tolerance 2e-6
absolute on rotation entries and posed coordinates of a unit-sized
skeleton (a few float32 ulps through 4-5 chained 4x4 products)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manus_tpu.utils import transforms as jt
from manus_tpu_torch.utils import transforms as tt

ATOL = 2e-6


def _close(want, got, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


CONVENTIONS = ["".join(p) for p in itertools.permutations("XYZ")] + [
    "XYX", "ZXZ"]


@pytest.mark.parametrize("intrinsic", [False, True],
                         ids=["extrinsic", "intrinsic"])
@pytest.mark.parametrize("convention", CONVENTIONS)
def test_euler_angles_to_matrix_matches_jax(convention, intrinsic):
    e = np.random.RandomState(0).uniform(-np.pi, np.pi, (4, 5, 3)).astype(
        np.float32)
    want = jt.euler_angles_to_matrix(jnp.asarray(e), convention, intrinsic)
    got = tt.euler_angles_to_matrix(torch.tensor(e), convention, intrinsic)
    _close(want, got)


def test_euler_bad_convention_raises():
    for bad in ("XY", "XYW"):
        with pytest.raises(ValueError):
            tt.euler_angles_to_matrix(torch.zeros(3), bad)


def test_quaternion_and_axis_angle_match_jax():
    """Every branch of matrix_to_quaternion (each of w, x, y, z the
    largest), the small-angle series, and the round trips."""
    rng = np.random.RandomState(1)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[:4] = np.eye(4, dtype=np.float32) * 3 + 0.1  # each branch once
    m = np.asarray(jt.quaternion_to_matrix(jnp.asarray(q)))
    _close(m, tt.quaternion_to_matrix(torch.tensor(q)))
    _close(jt.matrix_to_quaternion(jnp.asarray(m)),
           tt.matrix_to_quaternion(torch.tensor(m)))
    best = np.argmax(np.abs(np.asarray(jt.matrix_to_quaternion(
        jnp.asarray(m)))), -1)
    assert set(best[:4].tolist()) == {0, 1, 2, 3}
    aa = rng.normal(size=(32, 3)).astype(np.float32)
    aa[0] = 0.0
    aa[1] = [1e-8, 0.0, 0.0]
    _close(jt.axis_angle_to_quaternion(jnp.asarray(aa)),
           tt.axis_angle_to_quaternion(torch.tensor(aa)))
    _close(jt.axis_angle_to_matrix(jnp.asarray(aa)),
           tt.axis_angle_to_matrix(torch.tensor(aa)))
    _close(jt.matrix_to_axis_angle(jnp.asarray(m)),
           tt.matrix_to_axis_angle(torch.tensor(m)), atol=2e-5)
    qu = q / np.linalg.norm(q, axis=-1, keepdims=True)
    _close(jt.quaternion_to_axis_angle(jnp.asarray(qu)),
           tt.quaternion_to_axis_angle(torch.tensor(qu)), atol=1e-5)
    e = rng.uniform(-3, 3, (8, 3)).astype(np.float32)
    _close(jt.euler_angles_to_quats(jnp.asarray(e)),
           tt.euler_angles_to_quats(torch.tensor(e)))


def test_sqrt_positive_part_has_jax_gradient():
    x = np.asarray([-1.0, 0.0, 0.25, 4.0], np.float32)
    jg = jax.grad(lambda v: jt._sqrt_positive_part(v).sum())(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tt._sqrt_positive_part(xt).sum().backward()
    _close(jg, xt.grad)


def test_homogeneous_helpers_match_jax():
    rng = np.random.RandomState(2)
    m34 = rng.normal(size=(3, 2, 3, 4)).astype(np.float32)
    _close(jt.homogenize_matrix(jnp.asarray(m34)),
           tt.homogenize_matrix(torch.tensor(m34)))
    mat = np.asarray(jt.homogenize_matrix(jnp.asarray(m34)))
    pts = rng.normal(size=(3, 2, 3)).astype(np.float32)
    _close(jt.transform_points(jnp.asarray(mat), jnp.asarray(pts)),
           tt.transform_points(torch.tensor(mat), torch.tensor(pts)),
           atol=1e-5)


def _skeleton(seed=3):
    """A 7-bone tree (two roots, chains of depth 3) with rotated rest
    frames."""
    rng = np.random.RandomState(seed)
    parents = ["None", "b0", "b1", "None", "b3", "b4", "b1"]
    names = [f"b{i}" for i in range(7)]
    rest = np.tile(np.eye(4, dtype=np.float32), (7, 1, 1))
    rest[:, :3, :3] = np.asarray(jt.euler_angles_to_matrix(
        jnp.asarray(rng.uniform(-1, 1, (7, 3)).astype(np.float32)), "XYZ",
        True))
    rest[:, :3, 3] = rng.uniform(-0.5, 0.5, (7, 3))
    return names, parents, rest, rng


def test_kintree_matches_jax():
    names, parents, _, _ = _skeleton()
    kt = tt.build_kintree(names, parents)
    assert kt == jt.build_kintree(names, parents)
    np.testing.assert_array_equal(tt.kintree_to_parent_array(kt),
                                  jt.kintree_to_parent_array(kt))


def test_forward_kinematics_matches_jax():
    names, parents, rest, rng = _skeleton()
    kt = jt.build_kintree(names, parents)
    b = 4
    pose = np.asarray(jt.euler_angles_to_matrix(jnp.asarray(
        rng.uniform(-1, 1, (b, 7, 3)).astype(np.float32)), "XYZ", True))
    gpose = np.asarray(jt.euler_angles_to_matrix(jnp.asarray(
        rng.uniform(-1, 1, (b, 3)).astype(np.float32)), "XYZ", True))
    gt = rng.uniform(-1, 1, (b, 3)).astype(np.float32)
    joints = rng.uniform(-0.5, 0.5, (7, 3)).astype(np.float32)
    want = jt.get_pose_wrt_root(jnp.asarray(rest), jnp.asarray(pose),
                                jnp.asarray(gpose), jnp.asarray(gt), kt)
    got = tt.get_pose_wrt_root(torch.tensor(rest), torch.tensor(pose),
                               torch.tensor(gpose), torch.tensor(gt), kt)
    _close(want, got)
    kp_want = jt.get_keypoints(want, jnp.asarray(rest), jnp.asarray(joints))
    _close(kp_want, tt.get_keypoints(got, torch.tensor(rest),
                                     torch.tensor(joints)))
