"""The render, test and pose entry points of the port's CLI against the
JAX CLI on the CPU (trainer.mode=make_path, render_path, test in its
three forms, make_pose, and COMPOSITE's camera-path sweep), and the
modules under them: camera paths, the animated-PNG video writer, line
sets and frustums, the numpy overlays against OpenCV's drawing, and the
HSV paint keying against OpenCV's conversion and morphology.

The JAX CLI's frames are captured by monkeypatching its
manus_tpu.utils.io.dump_video (its mp4 holds lossy frames). Frames agree
within one 8-bit level at 99% of pixels and 3 everywhere (the renders
agree to ~1e-4: a value at a level's edge rounds either way); PSNRs
within 1e-3 dB, with the same ranking."""
import json
import os
import pickle
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

import main as jmain
from manus_tpu.train import evaluate as jeval
from manus_tpu.utils import io as jio
from manus_tpu.utils import vis as jvis
from manus_tpu_torch import main as tmain
from manus_tpu_torch.train import evaluate as teval
from manus_tpu_torch.utils import io as tio
from manus_tpu_torch.utils import vis as tvis
from manus_tpu_torch.utils.camera import make_camera
from tests.test_torch_cli import COMMON, HAND, OBJ


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A hand and an object trained by the port's CLI (their checkpoints
    load in either package) and a 3-camera path."""
    out = str(tmp_path_factory.mktemp("render"))
    tmain.main(["--device", "cpu", "--config-name", "HAND_GAUSSIAN", *COMMON,
                *HAND, "trainer.exp_name=hand", f"trainer.output_dir={out}"])
    tmain.main(["--device", "cpu", "--config-name", "OBJ_GAUSSIAN", *COMMON,
                *OBJ, "trainer.exp_name=obj", f"trainer.output_dir={out}"])
    path = os.path.join(out, "path.pkl")
    tmain.main(["--device", "cpu", "--config-name", "HAND_GAUSSIAN", *COMMON,
                "trainer.mode=make_path", f"camera_path={path}",
                "render_frames=3", f"trainer.output_dir={out}"])
    return out, path


def _run(cli, runs, exp, *overrides, config="HAND_GAUSSIAN", capture=None,
         monkeypatch=None):
    """One package's CLI in exp; with capture (a list), the JAX CLI's
    dump_video frames and path are appended to it instead of an mp4."""
    out, path = runs
    argv = ["--config-name", config, *COMMON, "dataset.num_frames=2",
            f"trainer.output_dir={out}", f"trainer.exp_name={exp}",
            f"camera_path={path}", "render_frames=3",
            f"render_ckpt_dir={out}/manus_tpu/synthetic/hand/checkpoints",
            *overrides]
    if cli is tmain:
        return tmain.main(["--device", "cpu", *argv])
    monkeypatch.setattr(jio, "dump_video",
                        lambda frames, p, fps=10: capture.append((frames, p)))
    return jmain.main(argv)


def _u8(frames):
    return [(np.clip(np.asarray(f), 0, 1) * 255).astype(np.uint8)
            for f in frames]


def _check(got, want, share=0.99):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = np.abs(g.astype(np.int64) - w.astype(np.int64))
        assert (err <= 1).mean() >= share and err.max() <= 3, err.max()


def _video_is(path, frames):
    assert path.endswith(".apng")
    back = tio.read_video(path)
    assert len(back) == len(frames)
    for a, b in zip(back, frames):
        np.testing.assert_array_equal(a, b)


def test_make_path_pkl_matches_jax(runs, tmp_path):
    _, path = runs
    want = jio.generate_camera_path(str(tmp_path / "j.pkl"), 3,
                                    width=64, height=64)
    with open(path, "rb") as f, open(want, "rb") as g:
        got, exp = pickle.load(f), pickle.load(g)
    assert got.keys() == exp.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(exp[k]))
    spiral = tio.generate_camera_path(str(tmp_path / "s.pkl"), 5, dist=1.5,
                                      spiral=20.0, width=32, height=48)
    jspiral = jio.generate_camera_path(str(tmp_path / "js.pkl"), 5, dist=1.5,
                                       spiral=20.0, width=32, height=48)
    for cj, ct in zip(jio.load_camera_path(jspiral, 32, 48),
                      tio.load_camera_path(spiral, 32, 48, device="cpu")):
        for f in ("K", "world_view_transform", "full_proj_transform",
                  "camera_center", "fovx", "fovy"):
            np.testing.assert_allclose(getattr(ct, f).numpy(),
                                       np.asarray(getattr(cj, f)),
                                       rtol=1e-6, atol=1e-6)


def test_load_camera_path_refuses_joblib(tmp_path):
    """A joblib-compressed path raises with the fix named; a [4, 4] extr
    and a 3x3 K load as the JAX loader reads them."""
    import joblib

    data = {"intrs": [np.diag([50.0, 50.0, 1.0])],
            "extrs": [np.eye(4)[[0, 1, 2, 3]] + np.eye(4) * 0]}
    data["extrs"][0][2, 3] = 3.0
    bad = str(tmp_path / "c.pkl")
    joblib.dump(data, bad, compress=3)
    with pytest.raises(ValueError, match="joblib"):
        tio.load_camera_path(bad, 32, 32, device="cpu")
    good = str(tmp_path / "p.pkl")
    with open(good, "wb") as f:
        pickle.dump(data, f)
    cam = tio.load_camera_path(good, 32, 32, device="cpu")[0]
    jcam = jio.load_camera_path(good, 32, 32)[0]
    np.testing.assert_allclose(cam.full_proj_transform.numpy(),
                               np.asarray(jcam.full_proj_transform),
                               rtol=1e-6)


def test_render_path_matches_jax(runs, monkeypatch):
    got = _run(tmain, runs, "t_path", "trainer.mode=render_path")
    cap = []
    _run(jmain, runs, "j_path", "trainer.mode=render_path", capture=cap,
         monkeypatch=monkeypatch)
    (frames, jpath), = cap
    assert got.video == os.path.splitext(jpath)[0].replace(
        "j_path", "t_path") + ".apng"
    _check(got.frames, _u8(frames))
    _video_is(got.video, got.frames)
    assert len(got.frame_s) == 3 and got.frames[0].mean() > 0


def test_test_epoch_worst_cases_matches_jax(runs, monkeypatch):
    """One render a frame: the PSNRs within 1e-3 dB of JAX's, the same
    ranking in worst_cases.json, the pred | gt | diff^2 strips, the posed
    PLY; the caller's config keeps its split_ratio."""
    got = _run(tmain, runs, "t_test", "trainer.mode=test",
               "dataset.worst_cases=true")
    cap = []
    _run(jmain, runs, "j_test", "trainer.mode=test",
         "dataset.worst_cases=true", capture=cap, monkeypatch=monkeypatch)
    (frames, _), = cap
    _check(got.frames, _u8(frames))
    _video_is(got.video, got.frames)
    out = runs[0]
    with open(os.path.join(out, "manus_tpu", "synthetic", "j_test",
                           "results", "eval_results",
                           "worst_cases.json")) as f:
        want = json.load(f)
    with open(got.worst_cases) as f:
        ranked = json.load(f)
    assert [(r["frame"], r["view"]) for r in ranked] == \
        [(r["frame"], r["view"]) for r in want]
    for r, w in zip(ranked, want):
        assert abs(r["psnr"] - w["psnr"]) < 1e-3
    assert [r["psnr"] for r in ranked] == sorted(r["psnr"] for r in ranked)
    assert sorted(r["frame"] for r in got.records) == [0, 1]
    ply = os.path.join(got.out_dir, "results", "eval_results", "gaussians",
                       "test_0_posed.ply")
    assert os.path.exists(ply)


def test_test_epoch_split_ratio_on_a_copy(runs):
    from manus_tpu_torch.config import CONFIGS

    cfg = CONFIGS["HAND_GAUSSIAN"]()
    cfg.dataset.width = cfg.dataset.height = 64
    cfg.dataset.num_cameras, cfg.dataset.num_frames = 3, 2
    cfg.raster.backend, cfg.raster.max_pairs_per_tile = "xla", 512
    cfg.dataset.test_on_train_dataset = True
    cfg.render_ckpt_dir = os.path.join(runs[0], "manus_tpu", "synthetic",
                                       "hand", "checkpoints")
    before = cfg.dataset.split_ratio
    run = tmain.run_test(cfg, os.path.join(runs[0], "t_copy"), device="cpu")
    assert cfg.dataset.split_ratio == before > 0
    assert len(run.records) == 2 and run.worst_cases is None


@pytest.mark.parametrize("canonical", [True, False], ids=["cano", "novel"])
def test_test_epoch_path_sweeps_match_jax(runs, monkeypatch, canonical):
    extra = ["dataset.test_on_canonical_pose=true"] if canonical else []
    got = _run(tmain, runs, "t_sweep", "trainer.mode=test", *extra)
    cap = []
    _run(jmain, runs, "j_sweep", "trainer.mode=test", *extra, capture=cap,
         monkeypatch=monkeypatch)
    (frames, jpath), = cap
    name = "test_cano" if canonical else "test_novel"
    assert os.path.basename(jpath) == name + ".mp4"
    assert os.path.basename(got.video) == name + ".apng"
    _check(got.frames, _u8(frames))


def test_make_pose_matches_jax(runs):
    out = runs[0]
    got = _run(tmain, runs, "t_pose", "trainer.mode=make_pose",
               "render_frames=4")
    want = jmain.main(["--config-name", "HAND_GAUSSIAN", "trainer.mode=make_pose",
                       "render_frames=4", f"trainer.output_dir={out}",
                       "trainer.exp_name=j_pose"])
    assert want is None
    jpath = os.path.join(out, "manus_tpu", "synthetic", "j_pose",
                         "novel_pose.pkl")
    with open(got, "rb") as f, open(jpath, "rb") as g:
        a, b = pickle.load(f), pickle.load(g)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k], float) if
                                   np.asarray(a[k]).dtype.kind == "f"
                                   else a[k], b[k], atol=2e-6) \
            if np.asarray(b[k]).dtype.kind == "f" else \
            np.testing.assert_array_equal(a[k], b[k])


def test_composite_camera_path_matches_jax(runs):
    """COMPOSITE results with a camera_path: each frame from path camera
    f % 3, as the JAX CLI sweeps it; the video's frames are the PNGs."""
    out, path = runs
    base = os.path.join(out, "manus_tpu", "synthetic")
    argv = ["--config-name", "COMPOSITE", *COMMON, "dataset.num_frames=2",
            f"trainer.output_dir={out}", f"camera_path={path}",
            f"hand_ckpt_dir={base}/hand/checkpoints",
            f"object_ckpt_dir={base}/obj/checkpoints"]
    got = tmain.main(["--device", "cpu", *argv, "trainer.exp_name=t_comp"])
    jmain.main([*argv, "trainer.exp_name=j_comp"])
    frames = {}
    for exp in ("t_comp", "j_comp"):
        ours = os.path.join(base, exp, "results", "eval_results", "ours")
        names = sorted(f for f in os.listdir(ours) if f.endswith(".png"))
        assert names == ["0000.png", "0001.png"]
        frames[exp] = [tio.read_png(os.path.join(ours, n)) for n in names]
    _check(frames["t_comp"], frames["j_comp"])
    _video_is(got.video, frames["t_comp"])
    # the sweep is seen from the path, not from the dataset's cameras
    plain = tmain.main(["--device", "cpu", *argv[:-3], argv[-2], argv[-1],
                        "trainer.exp_name=t_plain"])
    ours = os.path.join(plain.out_dir, "results", "eval_results", "ours")
    assert not np.array_equal(tio.read_png(os.path.join(ours, "0000.png")),
                              frames["t_comp"][0])


def test_video_writer_round_trip_and_chunks(tmp_path):
    """Frames back bit for bit, through read_video and through OpenCV's own
    APNG decoder; the chunks are acTL, fcTL / IDAT, then fcTL / fdAT with
    one sequence, each CRC valid; a float frame is clipped and scaled."""
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (21, 34, 3)).astype(np.uint8)
              for _ in range(4)]
    path = tio.dump_video(frames, str(tmp_path / "v.mp4"), fps=12)
    assert path == str(tmp_path / "v.apng")
    _video_is(path, frames)
    ok, anim = cv2.imreadanimation(path)
    assert ok and len(anim.frames) == 4
    for a, b in zip(anim.frames, frames):
        np.testing.assert_array_equal(a[..., :3][..., ::-1], b)
    data = open(path, "rb").read()
    pos, kinds, seqs = 8, [], []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        kinds.append(kind.decode())
        if kind in (b"fcTL", b"fdAT"):
            seqs.append(struct.unpack(">I", body[:4])[0])
        if kind == b"fcTL":
            assert struct.unpack(">HH", body[20:24]) == (1, 12)
        if kind == b"acTL":
            assert struct.unpack(">II", body) == (4, 0)
        pos += 12 + n
    assert kinds == ["IHDR", "acTL", "fcTL", "IDAT"] + [
        "fcTL", "fdAT"] * 3 + ["IEND"]
    assert seqs == list(range(7))
    floats = [f / 255.0 + 0.3 for f in frames[:2]]
    back = tio.read_video(tio.dump_video(floats, str(tmp_path / "f.mp4")))
    for a, b in zip(back, floats):
        np.testing.assert_array_equal(a, (np.clip(b, 0, 1) * 255).astype(
            np.uint8))
    assert tio.dump_video([], str(tmp_path / "e.mp4")) is None
    with pytest.raises(ValueError):
        tio.dump_video([frames[0], frames[0][:5]], str(tmp_path / "x.mp4"))


def test_lineset_and_camera_rig_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    pts = rng.normal(size=(7, 3)).astype(np.float32)
    edges = rng.randint(0, 7, (5, 2))
    cols = rng.rand(5, 3)
    for c in (None, cols):
        tio.dump_lineset(str(tmp_path / "t.ply"), pts, edges, c)
        jio.dump_lineset(str(tmp_path / "j.ply"), pts, edges, c)
        assert open(tmp_path / "t.ply", "rb").read() == \
            open(tmp_path / "j.ply", "rb").read()
        got, want = tio.load_lineset(str(tmp_path / "t.ply")), \
            jio.load_lineset(str(tmp_path / "j.ply"))
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)
    K = [[60.0, 0, 31.5], [0, 60.0, 31.5], [0, 0, 1]]
    extr = np.eye(4)[:3]
    extr[2, 3] = 2.0
    cams = [make_camera(K, extr, 64, 64, device="cpu"),
            make_camera(K, extr @ np.diag([1, -1, -1, 1]), 64, 64,
                        device="cpu")]
    got = tvis.visualize_camera_rig(cams, str(tmp_path / "rig.ply"))
    from manus_tpu.utils.camera import make_camera as jmake_camera

    jcams = [jmake_camera(np.asarray(K), e, 64, 64)
             for e in (extr, extr @ np.diag([1, -1, -1, 1]))]
    want = jvis.visualize_camera_rig(jcams, str(tmp_path / "jrig.ply"))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6)


def test_overlays_match_opencv():
    """The skeleton overlay of the numpy rasteriser against the JAX
    package's (OpenCV's). Up to 599 px the circles are filled and the
    bones 1 px: every pixel equal, the keypoint centres too. At 900 px
    the bones are 2 px wide, drawn as the pixels within 1 px of the
    segment, which OpenCV's polygon fill does not give exactly: 99% of
    the pixels equal."""
    rng = np.random.RandomState(3)
    kintree = {str(i): (-1 if i % 4 == 0 else i - 1) for i in range(20)}
    for size in (64, 256, 599, 900):
        c = size / 2  # K [R | t], t = (0, 0, 2)
        P = np.asarray([[size * 1.2, 0, c, 2 * c], [0, size * 1.2, c, 2 * c],
                        [0, 0, 1, 2.0]])
        joints = rng.uniform(-0.35, 0.35, (21, 3))
        joints[[3, 11], 0] = [-3.0, 4.0]  # two off the image
        img = rng.randint(0, 256, (size, size, 3)).astype(np.uint8)
        want = jvis.plot_keypoints_2d(joints, img, P, kintree)
        got = tvis.plot_keypoints_2d(joints, img, P, kintree)
        share = (got == want).all(-1).mean()
        if size >= 600:
            assert share >= 0.99, (size, share)
            continue
        assert share == 1.0, (size, share)
        kp = tvis.project_points(joints, P[None])[0].astype(int)
        on = (kp >= 0).all(1) & (kp < size).all(1)
        assert on.sum() > 10
        np.testing.assert_array_equal(got[kp[on, 1], kp[on, 0]],
                                      want[kp[on, 1], kp[on, 0]])
    imgs = rng.randint(0, 256, (3, 48, 64, 3)).astype(np.uint8)
    Ps = np.stack([P * [[48 / 900], [48 / 900], [1]]] * 3)
    np.testing.assert_array_equal(
        tvis.visualize_ik_overlay(imgs, joints, Ps, kintree, max_views=2),
        jvis.visualize_ik_overlay(imgs, joints, Ps, kintree, max_views=2))
    pts = rng.uniform(-5, 70, (30, 2))
    for r in (1, 2, 5):
        np.testing.assert_array_equal(
            tvis.plot_points_in_image(pts, imgs[0], radius=r),
            jvis.plot_points_in_image(pts, imgs[0], radius=r))


def test_hsv_conversion_is_opencv_bit_for_bit():
    rng = np.random.RandomState(4)
    edge = np.asarray([0, 1, 2, 85, 127, 128, 170, 254, 255], np.uint8)
    grid = np.stack(np.meshgrid(edge, edge, edge), -1).reshape(-1, 3)
    px = np.concatenate([grid, rng.randint(0, 256, (1 << 18, 3))]).astype(
        np.uint8).reshape(-1, 1, 3)
    np.testing.assert_array_equal(teval.rgb_to_hsv_u8(px),
                                  cv2.cvtColor(px, cv2.COLOR_RGB2HSV))


def test_paint_keying_matches_jax_bit_for_bit():
    """skin_mask_from_color (HSV range and 5x5 closing) and
    calibrate_hsv_range equal to the JAX package's OpenCV ones, on a
    painted patch with noise and holes: a green paint, a blue one and a
    red one at the hue wrap. The JAX package's circular mean is not
    wrapped to [0, 1): a paint whose hue is above 0.5 (the blue) gets an
    empty hue range, which the port keeps (ROADMAP Queue C)."""
    rng = np.random.RandomState(5)
    for paint in ([0.2, 0.8, 0.3], [0.1, 0.5, 0.9], [0.9, 0.1, 0.12]):
        img = rng.rand(72, 90, 3).astype(np.float32)
        img[10:50, 15:70] = np.clip(
            np.asarray(paint) + rng.normal(0, 0.05, (40, 55, 3)), 0, 1)
        img[20:23, 30:32] = rng.rand(3, 2, 3)  # holes to close
        masks = [np.zeros((72, 90), bool)]
        masks[0][12:48, 17:68] = True
        low, high = teval.calibrate_hsv_range([img], masks)
        assert (low, high) == jeval.calibrate_hsv_range([img], masks)
        for kw in ({}, {"hsv_low": low, "hsv_high": high},
                   {"hsv_low": low, "hsv_high": high, "fill_holes": False}):
            got = teval.skin_mask_from_color(img, **kw)
            np.testing.assert_array_equal(got,
                                          jeval.skin_mask_from_color(img, **kw))
            if paint[1] > 0.5:  # green: calibrated and keyed
                assert got.sum() > 1000
        if paint[2] > 0.5:  # blue: the empty hue range
            assert high[0] < low[0] and not got.any()
    m = rng.rand(33, 41) > 0.5
    np.testing.assert_array_equal(
        teval.morph_close(m), cv2.morphologyEx(
            m.astype(np.uint8), cv2.MORPH_CLOSE,
            np.ones((5, 5), np.uint8)).astype(bool))
    with pytest.raises(ValueError, match="no paint"):
        teval.calibrate_hsv_range([img], [np.zeros((72, 90), bool)])
