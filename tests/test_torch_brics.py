"""The port's BRICS loaders (data/brics.py), calibration and undistortion
(data/params.py) and batch assembly (data/prefetch.py, csrc/image_ops.cpp)
against OpenCV and the JAX package's loaders on the CPU, on small captures
written here: 64x64, 3-9 cameras, 3 frames an action, non-zero lens
distortion; dynamic captures by h5py (its default libver, and libver
"latest" with creation order, dense groups and lzf crops) and by the
port's own writer.

Tolerances: the undistortion's bytes equal OpenCV's but on at most
UNDIST_SHARE of the pixels, each off by at most 1 (a source position
within double rounding of a 1/32 px step; none measured on these inputs);
every float the loaders make from the same bytes within 1e-6 (float32
against float64 arithmetic, the area resize's sums in another order)."""
import os

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from chip_smoke import hand20_skeleton
from manus_tpu.data import brics as jbrics
from manus_tpu.data.prefetch import assemble_batch_native as jassemble
from manus_tpu_torch.data import brics as tbrics
from manus_tpu_torch.data import hdf5
from manus_tpu_torch.data import params as tparams
from manus_tpu_torch.data import prefetch
from manus_tpu_torch.data.synthetic import hemisphere_cameras
from manus_tpu_torch.preprocess.novel_pose import generate_flexion_sequence
from manus_tpu_torch.utils import cuda_build
from manus_tpu_torch.utils.io import dump_points
from scripts import torch_hdf5_fixtures as fixtures

cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")

W = H = 64
DIST = (-0.12, 0.05, 0.002, -0.001)
UNDIST_MAX, UNDIST_SHARE, ATOL = 1, 1e-3, 1e-6
CAMERA_FIELDS = ("K", "extr", "world_view_transform", "full_proj_transform",
                 "camera_center", "fovx", "fovy")


def _rgba(rng, h, w):
    """Random colours; alpha 0, 255 or in between, in blocks."""
    img = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
    img[..., 3] = np.choose(rng.randint(0, 3, (h, w)),
                            [0, 255, rng.randint(1, 255)]).astype(np.uint8)
    return img


def write_static_capture(root, n_cams=5, names=None, dist=DIST, seed=0,
                         no_alpha=(1,), width=W, height=H):
    """images/refined_seg/<cam>/0001.png (BGRA through OpenCV, BGR for
    the cameras in no_alpha) and calib/optim_params.txt."""
    rng = np.random.RandomState(seed)
    cams = hemisphere_cameras(n_cams, width, height, device="cpu")
    names = names or [f"cam{i:03d}" for i in range(n_cams)]
    rows = []
    for i, (cam, name) in enumerate(zip(cams, names)):
        K = cam.K.double().numpy().tolist()
        extr = cam.extr.double().numpy()
        q = Rotation.from_matrix(extr[:3, :3]).as_quat().tolist()  # xyzw
        t = extr[:3, 3].tolist()
        rows.append(
            f"{i} {width} {height} {K[0][0]!r} {K[1][1]!r} {K[0][2]!r} "
            f"{K[1][2]!r} {dist[0]} {dist[1]} {dist[2]} {dist[3]} {name} "
            f"{q[3]!r} {q[0]!r} {q[1]!r} {q[2]!r} {t[0]!r} {t[1]!r} {t[2]!r}")
        d = os.path.join(root, "images", "refined_seg", name)
        os.makedirs(d)
        rgba = _rgba(rng, height, width)
        bgra = rgba[..., [2, 1, 0, 3]]
        cv2.imwrite(os.path.join(d, "0001.png"),
                    bgra[..., :3] if i in no_alpha else bgra)
    os.makedirs(os.path.join(root, "calib"))
    with open(os.path.join(root, "calib", "optim_params.txt"), "w") as f:
        f.write("\n".join(rows))
    return root


def capture_tree(frames, n_cams=3, seed=0, width=W, height=H):
    """One action's HDF5 contents: K/, extr/, frames/<fno>/{images, bbox,
    metadata} (a 20-bone hand flexing, RGBA bbox crops inside the frame)
    and mano_rest."""
    rng = np.random.RandomState(seed)
    cams = hemisphere_cameras(n_cams, width, height, device="cpu")
    names = [f"cam{i:03d}" for i in range(n_cams)]
    skel = hand20_skeleton()
    seq = generate_flexion_sequence(skel, num_frames=len(frames),
                                    device="cpu")
    nb = len(skel["bnames"])
    tree = {"K": {}, "extr": {}, "frames": {}, "mano_rest": {
        "verts": rng.rand(10, 3).astype(np.float32),
        "faces": rng.randint(0, 10, (6, 3)).astype(np.int32)}}
    for name, cam in zip(names, cams):
        tree["K"][name] = cam.K.double().numpy()
        tree["extr"][name] = cam.extr.double().numpy()[:3]
    for fi, fno in enumerate(frames):
        images, bbox = {}, {}
        for name in names:
            x0, y0 = rng.randint(0, width // 2), rng.randint(0, height // 2)
            x1 = rng.randint(x0 + 8, width + 1)
            y1 = rng.randint(y0 + 8, height + 1)
            images[name] = _rgba(rng, y1 - y0, x1 - x0)
            bbox[name] = np.asarray([x0, y0, x1, y1], np.int64)
        md = {
            "bnames": np.asarray(
                [n.encode() for n in skel["bnames"]])[:, None],
            "bnames_parent": np.asarray(
                [p.encode() for p in skel["bnames_parent"]])[:, None],
            "rest_heads": seq["rest_heads"], "rest_tails": seq["rest_tails"],
            "rest_matrixs": seq["rest_matrixs"],
            "pose_heads": seq["pose_heads"][fi],
            "pose_tails": seq["pose_tails"][fi],
            "pose_matrixs": seq["pose_matrixs"][fi],
            "eulers": rng.normal(0, 0.1, (nb, 3)).astype(np.float32),
            "root_translation": rng.rand(3).astype(np.float32),
            "root_rotation": rng.rand(3).astype(np.float32),
        }
        tree["frames"][fno] = {"images": images, "bbox": bbox,
                               "metadata": md}
    return tree


def _h5py_write(group, tree):
    for name, value in tree.items():
        if isinstance(value, dict):
            _h5py_write(group.create_group(name), value)
        else:
            group.create_dataset(name, data=value)


# "h5py_latest" writes at least this many cameras, so that every
# per-camera group holds more than 8 links (dense storage)
LATEST_CAMS = 9


def camera_order(writer, n_cams=3):
    """The cameras' names in the order the writer creates them, which is
    the order h5py lists K/ and extr/ in: by name but for "h5py_latest"
    (track_order=True), which creates the odd ones first."""
    names = [f"cam{i:03d}" for i in range(
        max(n_cams, LATEST_CAMS) if writer == "h5py_latest" else n_cams)]
    return names[1::2] + names[0::2] if writer == "h5py_latest" else names


def write_dynamic_capture(root, actions=(("grasp_a", ("0", "1", "2")),
                                         ("grasp_b", ("0", "5", "10"))),
                          writer="h5py", n_cams=3):
    """One .hdf5 file an action, written by h5py (its default libver), by
    hdf5.write_tree, or by h5py as "h5py_latest": libver="latest",
    track_order=True, lzf-compressed chunked crops and camera_order's
    cameras (dense link storage in every per-camera group)."""
    os.makedirs(root, exist_ok=True)
    order = camera_order(writer, n_cams)
    for seed, (action, frames) in enumerate(actions):
        tree = capture_tree(frames, n_cams=len(order), seed=seed)
        path = os.path.join(root, f"{action}.hdf5")
        if writer == "h5py":
            with h5py.File(path, "w") as f:
                _h5py_write(f, tree)
        elif writer == "h5py_latest":
            for group in ("K", "extr"):
                tree[group] = {m: tree[group][m] for m in order}
            for frame in tree["frames"].values():
                for group in ("images", "bbox"):
                    frame[group] = {m: frame[group][m] for m in order}
            with h5py.File(path, "w", libver="latest",
                           track_order=True) as f:
                fixtures.write_h5py_tree(f, tree, lambda c: dict(
                    chunks=True, compression="lzf"))
        else:
            hdf5.write_tree(path, tree)
    return root


@pytest.fixture(scope="module")
def static_capture(tmp_path_factory):
    return write_static_capture(str(tmp_path_factory.mktemp("static")))


@pytest.fixture(scope="module", params=["h5py", "write_tree", "h5py_latest"])
def dynamic_capture(tmp_path_factory, request):
    """(root, the cameras in h5py's order) of a capture by each writer."""
    root = write_dynamic_capture(str(tmp_path_factory.mktemp("dynamic")),
                                 writer=request.param)
    return root, camera_order(request.param)


def _same_cameras(t, j):
    assert (t.width, t.height) == (j.width, j.height)
    for field in CAMERA_FIELDS:
        np.testing.assert_allclose(getattr(t, field).numpy(),
                                   np.asarray(getattr(j, field)),
                                   rtol=ATOL, atol=ATOL, err_msg=field)


def _same_images(got, want):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= UNDIST_MAX / 255 + ATOL
    assert (d > ATOL).mean() <= UNDIST_SHARE


# ---------------------------------------------------------------------------
# calibration, undistortion and resize against OpenCV


@pytest.mark.parametrize("size", [(64, 64), (97, 53), (320, 180)])
@pytest.mark.parametrize("dist", [(0, 0, 0, 0), DIST, (0.2, -0.08, -0.003,
                                                       0.002)])
def test_undistort_params_and_image_match_opencv(size, dist):
    w, h = size
    K = np.array([[0.9 * w, 0, w / 2 + 3.3], [0, 0.95 * w, h / 2 - 2.1],
                  [0, 0, 1.0]])
    dist = np.asarray(dist, np.float64)
    want_K, want_roi = cv2.getOptimalNewCameraMatrix(
        K, dist, (w, h), alpha=0, centerPrincipalPoint=True)
    got_K, got_roi = tparams.get_undistort_params(K, dist, (w, h))
    np.testing.assert_allclose(got_K, want_K, rtol=1e-6)
    assert tuple(got_roi) == tuple(want_roi)
    rng = np.random.RandomState(w + h)
    for channels in (3, 4):
        img = rng.randint(0, 256, (h, w, channels)).astype(np.uint8)
        want = cv2.undistort(img, K, dist, None, want_K)
        got = tparams.undistort_image(K, want_K, dist, img)
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.max() <= UNDIST_MAX
        assert (d.max(-1) > 0).mean() <= UNDIST_SHARE


@pytest.mark.parametrize("shift", [0.0, 1.0, 0.5])
def test_undistort_without_distortion_matches_opencv(shift):
    """No distortion about the centre: the identity map (shift 0), whole
    pixel shifts and half ones."""
    w, h = 80, 48
    K = np.array([[70.0, 0, (w - 1) / 2 + shift], [0, 70.0, (h - 1) / 2],
                  [0, 0, 1.0]])
    dist = np.zeros(4)
    new_K, _ = tparams.get_undistort_params(K, dist, (w, h))
    img = np.random.RandomState(9).randint(0, 256, (h, w, 4)).astype(np.uint8)
    want = cv2.undistort(img, K, dist, None, new_K)
    np.testing.assert_array_equal(
        tparams.undistort_image(K, new_K, dist, img), want)


@pytest.mark.parametrize("factor", [0.5, 0.37])
def test_resize_area_matches_opencv(factor):
    rng = np.random.RandomState(3)
    for shape in ((72, 128, 3), (72, 128, 1), (61, 50)):
        img = rng.rand(*shape).astype(np.float32)
        size = (int(shape[1] * factor + 0.5), int(shape[0] * factor + 0.5))
        want = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
        got = tparams.resize_area(img, size)
        np.testing.assert_allclose(got.reshape(want.shape), want, atol=ATOL)


def test_calibration_rows_parse_as_jax(static_capture):
    from manus_tpu.data import params as jparams

    path = os.path.join(static_capture, "calib", "optim_params.txt")
    got, want = tparams.read_params(path), jparams.read_params(path)
    assert got.tolist() == want.tolist()
    for row_t, row_j in zip(got, want):
        for a, b in zip(tparams.get_intr(row_t), jparams.get_intr(row_j)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tparams.get_extr(row_t),
                                      jparams.get_extr(row_j))
    assert tparams.STATIC_SKIP_CAMERAS == jparams.STATIC_SKIP_CAMERAS


# ---------------------------------------------------------------------------
# the datasets against the JAX package's


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("resize", [1.0, 0.5])
def test_static_dataset_matches_jax(static_capture, split, resize):
    kw = dict(root_dir=static_capture,
              params_dir=os.path.join(static_capture, "calib"), width=W,
              height=H, split=split, skip_cameras=(), resize_factor=resize)
    want = jbrics.BricsStaticDataset(**kw)
    got = tbrics.BricsStaticDataset(**kw, device="cpu")
    assert got.num_views == want.num_views == (3 if split == "train" else 2)
    _same_cameras(got.cameras, want.cameras)
    _same_images(got.images, want.images)
    _same_images(got.masks, want.masks)
    assert got.images.dtype == np.float32 and got.images.shape == \
        want.images.shape
    assert abs(got.extent - want.extent) <= ATOL * want.extent
    views = np.asarray([0, 1])
    for key in ("rgb", "mask"):
        _same_images(got.get_batch(0, views)[key],
                     want.get_batch(0, views)[key])
    for a, b in zip(got.sample_gaussians(64), want.sample_gaussians(64)):
        np.testing.assert_array_equal(a, b)


def test_static_skip_list_and_brics_names(tmp_path):
    """Cameras named as BRICS names them: the skip list drops its 12."""
    names = [f"brics-sbc-{i // 2 + 1:03d}_cam{i % 2}" for i in range(18)]
    root = write_static_capture(str(tmp_path), n_cams=18, names=names,
                                no_alpha=())
    kw = dict(root_dir=root, params_dir=os.path.join(root, "calib"),
              width=W, height=H)
    got = tbrics.BricsStaticDataset(**kw, device="cpu")
    want = jbrics.BricsStaticDataset(**kw)
    kept = [n for n in names if n not in tparams.STATIC_SKIP_CAMERAS]
    assert got.num_views == want.num_views == len(kept) - 2
    _same_cameras(got.cameras, want.cameras)
    _same_images(got.images, want.images)


def test_ply_vertices_and_mesh_init_match_jax(static_capture, tmp_path):
    rng = np.random.RandomState(4)
    pts = rng.rand(50, 3).astype(np.float32)
    binary = str(tmp_path / "binary.ply")
    dump_points(pts, binary, colors=rng.rand(50, 3))
    ascii_ply = str(tmp_path / "ascii.ply")
    with open(ascii_ply, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 50\nproperty float x\n"
                "property float y\nproperty float z\nend_header\n")
        f.write("\n".join(" ".join(map(repr, p.tolist())) for p in pts))
    for path in (binary, ascii_ply):
        got = tbrics._load_ply_vertices(path)
        np.testing.assert_array_equal(got, jbrics._load_ply_vertices(path))
        np.testing.assert_allclose(got, pts, atol=1e-6)
    kw = dict(root_dir=static_capture,
              params_dir=os.path.join(static_capture, "calib"), width=W,
              height=H, skip_cameras=())
    got = tbrics.BricsStaticDataset(**kw, device="cpu").sample_gaussians(
        40, seed=3, mesh_path=binary)
    want = jbrics.BricsStaticDataset(**kw).sample_gaussians(
        40, seed=3, mesh_path=binary)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _same_bones(got, want):
    for field in ("heads", "tails", "transforms", "eulers",
                  "root_translation", "root_rotation"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       err_msg=field)
    assert got.kintree == want.kintree and got.bnames == want.bnames


@pytest.mark.parametrize("split,resize,steps", [
    ("train", 1.0, -1), ("val", 1.0, -1), ("test", 0.5, -1),
    ("train", 0.5, 1)])
def test_dynamic_dataset_matches_jax(dynamic_capture, split, resize, steps):
    """Two actions (frames 0, 5, 10 in the second: sorted by int), the
    frame split, num_time_steps' stride, resize_factor 0.5 (downscale 2),
    bones, samplers and every batch."""
    root, cam_names = dynamic_capture
    kw = dict(root_dir=root, width=W, height=H, split=split,
              resize_factor=resize, num_time_steps=steps)
    want = jbrics.BricsDynamicDataset(**kw)
    got = tbrics.BricsDynamicDataset(**kw, device="cpu")
    assert got._frame_index == want._frame_index
    assert got.num_frames == want.num_frames and got.actions == want.actions
    assert got.cam_names == want.cam_names == cam_names
    _same_cameras(got.cameras, want.cameras)
    assert abs(got.extent - want.extent) <= ATOL * want.extent
    _same_bones(got.bones_rest, want.bones_rest)
    assert len(got.bones_posed) == len(want.bones_posed)
    for g, w in zip(got.bones_posed, want.bones_posed):
        _same_bones(g, w)
    assert got.mano_data.keys() == want.mano_data.keys()
    for k in want.mano_data:
        np.testing.assert_array_equal(got.mano_data[k], want.mano_data[k])
    for f in range(got.num_frames):
        views = np.asarray([0, 2])
        g, w = got.get_batch(f, views), want.get_batch(f, views)
        for key in ("rgb", "mask"):
            assert g[key].shape == w[key].shape == (
                2, int(H * resize), int(W * resize), 3 if key == "rgb" else 1)
            np.testing.assert_allclose(g[key], w[key], atol=ATOL)
    for a, b in zip(got.sample_gaussians_on_bones(10),
                    want.sample_gaussians_on_bones(10)):
        np.testing.assert_allclose(a, b, atol=ATOL)
    got.close()


def test_dynamic_frame_index_and_split(dynamic_capture):
    """6 frames at split_ratio 0.1: 5 train, 1 val; a split of 0 keeps
    every frame in both."""
    dynamic_capture, _ = dynamic_capture
    ds = tbrics.BricsDynamicDataset(dynamic_capture, W, H, device="cpu")
    assert ds._frame_index == [("grasp_a", "0"), ("grasp_a", "1"),
                               ("grasp_a", "2"), ("grasp_b", "0"),
                               ("grasp_b", "5")]
    val = tbrics.BricsDynamicDataset(dynamic_capture, W, H, split="val",
                                     device="cpu")
    assert val._frame_index == [("grasp_b", "10")]
    every = tbrics.BricsDynamicDataset(dynamic_capture, W, H, split="val",
                                       split_ratio=0, device="cpu")
    assert every.num_frames == 6
    one = tbrics.BricsDynamicDataset(dynamic_capture, W, H,
                                     sequences=["grasp_b"], device="cpu")
    assert one.actions == ["grasp_b"]
    with pytest.raises(FileNotFoundError):
        tbrics.BricsDynamicDataset(dynamic_capture, W, H,
                                   sequences=["none"], device="cpu")


def test_dynamic_cameras_in_creation_order_match_jax(tmp_path):
    """K/ and extr/ written with track_order=True and the cameras created
    out of name order: both loaders take h5py's (creation) order, so the
    same view index is the same camera."""
    tree = capture_tree(("0", "1"), n_cams=3)
    order = ["cam002", "cam000", "cam001"]
    order_of = ("K", "extr")
    for group in order_of:
        tree[group] = {name: tree[group][name] for name in order}
    with h5py.File(tmp_path / "a.hdf5", "w") as f:
        for name, value in tree.items():
            _h5py_write(f.create_group(name, track_order=name in order_of),
                        value)
    want = jbrics.BricsDynamicDataset(str(tmp_path), W, H, split_ratio=0)
    got = tbrics.BricsDynamicDataset(str(tmp_path), W, H, split_ratio=0,
                                     device="cpu")
    assert got.cam_names == want.cam_names == order
    _same_cameras(got.cameras, want.cameras)
    g, w = got.get_batch(1, [0, 2]), want.get_batch(1, [0, 2])
    np.testing.assert_allclose(g["rgb"], w["rgb"], atol=ATOL)
    got.close()


# ---------------------------------------------------------------------------
# batch assembly: C++ against numpy against the JAX package's


def _crops(rng, bboxes):
    return [_rgba(rng, b[3] - b[1], b[2] - b[0]) for b in bboxes]


@pytest.mark.parametrize("downscale", [1, 2])
def test_assembly_cpp_numpy_and_jax_agree(downscale):
    rng = np.random.RandomState(5)
    bboxes = np.asarray([[5, 8, 35, 28], [0, 0, 64, 64], [10, 20, 40, 50],
                         [62, 60, 64, 64]], np.int32)
    crops = _crops(rng, bboxes)
    bg = np.asarray([0.2, 0.4, 0.6], np.float32)
    calls = prefetch.assemble_batch_native.calls
    got = prefetch.assemble_batch_native(crops, bboxes, 64, 64, bg,
                                         downscale=downscale)
    assert prefetch.assemble_batch_native.calls == calls + 1
    plain = prefetch.assemble_batch_numpy(crops, bboxes, 64, 64, bg,
                                          downscale=downscale)
    want = jassemble(crops, bboxes, 64, 64, bg, downscale=downscale)
    for g, p, w in zip(got, plain, want):
        assert g.shape == p.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, p, atol=ATOL)
        np.testing.assert_allclose(g, w, atol=ATOL)


@pytest.mark.parametrize("downscale", [1, 2])
def test_assembly_clips_a_bbox_that_leaves_the_frame(downscale):
    rng = np.random.RandomState(6)
    bboxes = np.asarray([[-5, -3, 20, 30], [50, 40, 80, 70],
                         [-10, 10, -2, 20], [70, 70, 90, 90]], np.int32)
    crops = _crops(rng, bboxes)
    bg = np.asarray([1.0, 1.0, 1.0], np.float32)
    got = prefetch.assemble_batch_native(crops, bboxes, 64, 64, bg,
                                         downscale=downscale)
    plain = prefetch.assemble_batch_numpy(crops, bboxes, 64, 64, bg,
                                          downscale=downscale)
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g, p, atol=ATOL)
    # the crop's pixel (5, 3) lands on the frame's (0, 0)
    a = crops[0][3, 5, 3] / 255.0
    if downscale == 1:
        np.testing.assert_allclose(got[1][0, 0, 0, 0], a, atol=ATOL)
    np.testing.assert_array_equal(got[1][2:], 0.0)  # wholly outside


def test_assembly_checks_its_inputs():
    rng = np.random.RandomState(7)
    bboxes = np.asarray([[0, 0, 10, 10]], np.int32)
    with pytest.raises(ValueError, match="want"):
        prefetch.assemble_batch_native([_rgba(rng, 9, 10)], bboxes, 64, 64,
                                       np.zeros(3))
    with pytest.raises(ValueError, match="does not divide"):
        prefetch.assemble_batch_native(_crops(rng, bboxes), bboxes, 64, 63,
                                       np.zeros(3), downscale=2)


def test_failed_image_ops_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises; nothing falls back."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "image_ops.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    rng = np.random.RandomState(8)
    bboxes = np.asarray([[0, 0, 4, 4]], np.int32)
    with pytest.raises(RuntimeError, match="build failed"):
        prefetch.assemble_batch_native(_crops(rng, bboxes), bboxes, 8, 8,
                                       np.zeros(3))


def test_datasets_default_to_the_card(static_capture, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbrics.BricsStaticDataset(
            static_capture, os.path.join(static_capture, "calib"), W, H,
            skip_cameras=())
