"""Parity of the port's synthetic datasets with the JAX package's.

Both build the same scene from the same seed (numpy draws); the gt images
come from each package's renderer, the JAX one with backend="xla" off the
TPU, the port's on the CPU with the composite's plain version. Numpy
draws, cameras, extents and bones are equal (cameras and covariances to
float32 rounding); images within the render tolerance of
test_torch_raster.py (2e-5), and the masks (final transmittance < 0.5)
equal: no pixel of these scenes has a transmittance within that
tolerance of 0.5.
"""
import numpy as np
import pytest
import torch

from manus_tpu.data import synthetic as jsyn
from manus_tpu_torch.data import synthetic as tsyn
from manus_tpu_torch.utils.camera import TENSOR_FIELDS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tensors here are small, and test workers
    side by side, each with a full OpenMP team, oversubscribe the CPU
    (the new port test files took 115 s under -n 5 so, 26 s with one)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

RENDER_TOL = 2e-5


def _cams_equal(tcams, jcams):
    for f in TENSOR_FIELDS:
        np.testing.assert_allclose(getattr(tcams, f).numpy(),
                                   np.asarray(getattr(jcams, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert (tcams.width, tcams.height) == (jcams.width, jcams.height)


def _images_close(t, j):
    np.testing.assert_allclose(t.images, j.images, atol=RENDER_TOL, rtol=0)
    assert t.masks.dtype == j.masks.dtype == bool
    np.testing.assert_array_equal(t.masks, j.masks)


def _gt_equal(t, j):
    assert set(t.gt) == set(j.gt)
    for k in t.gt:
        if k == "cov6":  # computed by each package's float32 math
            np.testing.assert_allclose(t.gt[k], j.gt[k], rtol=1e-5,
                                       atol=1e-9, err_msg=k)
        else:
            np.testing.assert_array_equal(t.gt[k], j.gt[k], err_msg=k)


@pytest.fixture(scope="module")
def static_pair():
    kw = dict(width=32, height=32, num_cameras=3)
    return (tsyn.build_synthetic_static(**kw, device="cpu"),
            jsyn.build_synthetic_static(**kw))


@pytest.fixture(scope="module")
def dynamic_pair():
    kw = dict(width=32, height=32, num_cameras=3, num_frames=2)
    return (tsyn.build_synthetic_dynamic(**kw, device="cpu"),
            jsyn.build_synthetic_dynamic(**kw))


def test_static_dataset_matches_jax(static_pair):
    t, j = static_pair
    _cams_equal(t.cameras, j.cameras)
    _gt_equal(t, j)
    assert t.extent == pytest.approx(j.extent, rel=1e-6)
    assert (t.width, t.height, t.bg_color) == (j.width, j.height, j.bg_color)
    _images_close(t, j)
    assert t.images.max() > 0.1  # the object is in view
    for a, b in zip(t.sample_gaussians(50), j.sample_gaussians(50)):
        np.testing.assert_array_equal(a, b)


def test_dynamic_dataset_matches_jax(dynamic_pair):
    t, j = dynamic_pair
    _cams_equal(t.cameras, j.cameras)
    _gt_equal(t, j)
    assert t.extent == pytest.approx(j.extent, rel=1e-6)
    assert (t.num_frames, t.num_views) == (j.num_frames, j.num_views) == (2, 3)
    for name in ("heads", "tails", "transforms"):
        np.testing.assert_array_equal(
            getattr(t.bones_rest, name).numpy(),
            np.asarray(getattr(j.bones_rest, name)), err_msg=name)
        for tb, jb in zip(t.bones_posed, j.bones_posed):
            np.testing.assert_array_equal(
                getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                err_msg=name)
    np.testing.assert_array_equal(t.bones_rest.keypoints().numpy(),
                                  np.asarray(j.bones_rest.keypoints()))
    _images_close(t, j)
    assert t.images.max() > 0.1
    for a, b in zip(t.sample_gaussians_on_bones(5),
                    j.sample_gaussians_on_bones(5)):
        np.testing.assert_array_equal(a, b)


def test_splits_match_jax(static_pair, dynamic_pair):
    t, j = static_pair
    for ts, js in zip(tsyn.split_synthetic_static(t),
                      jsyn.split_synthetic_static(j)):
        assert ts.num_views == js.num_views
        _cams_equal(ts.cameras, js.cameras)
        np.testing.assert_array_equal(ts.masks, js.masks)
        np.testing.assert_allclose(ts.images, js.images, atol=RENDER_TOL)
    t, j = dynamic_pair
    for ratio in (0.1, 0.5):
        for ts, js in zip(tsyn.split_synthetic_dynamic(t, ratio),
                          jsyn.split_synthetic_dynamic(j, ratio)):
            assert ts.num_frames == js.num_frames
            assert len(ts.bones_posed) == len(js.bones_posed)
            np.testing.assert_allclose(ts.images, js.images, atol=RENDER_TOL)
            for tb, jb in zip(ts.bones_posed, js.bones_posed):
                np.testing.assert_array_equal(tb.transforms.numpy(),
                                              np.asarray(jb.transforms))


def test_load_skeleton_missing_file_is_none(tmp_path):
    assert tsyn.load_skeleton(str(tmp_path / "none.pkl")) is None
    assert jsyn.load_skeleton(str(tmp_path / "none.pkl")) is None
    assert (tsyn.load_reference_skeleton() is None) == (
        jsyn.load_reference_skeleton() is None)
