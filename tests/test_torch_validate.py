"""The port's capture validator (data/validate.py) and video reader
(data/reader.py) against the JAX package's on the CPU: the findings on
the clean and corrupted captures of tests/test_brics_loaders.py, equal
string for string but for the text a reader's exception adds after
"unreadable HDF5:"; the frames a video gives, equal."""
import os
import shutil

import numpy as np
import pytest

from manus_tpu.data import validate as jval
from manus_tpu_torch.config import CONFIGS, apply_overrides
from manus_tpu_torch.data import validate as tval
from tests.test_brics_loaders import (  # noqa: F401 (fixtures)
    H,
    W,
    fake_dynamic_h5,
    fake_static_dir,
    fake_synced_dir,
)
from tests.test_torch_brics import write_dynamic_capture

h5py = pytest.importorskip("h5py")
cv2 = pytest.importorskip("cv2")
UNREADABLE = "unreadable HDF5:"


def _masked(findings):
    """The findings with the exception text after UNREADABLE dropped."""
    return [s[:s.index(UNREADABLE) + len(UNREADABLE)] if UNREADABLE in s
            else s for s in findings]


def _corrupt_static(root, bad):
    """tests/test_brics_loaders.py's corruption: a non-unit quaternion, an
    empty camera directory, a missing one."""
    shutil.copytree(root, bad)
    ptxt = os.path.join(bad, "calib", "optim_params.txt")
    with open(ptxt) as f:
        rows = f.read().splitlines()
    parts = rows[0].split()
    parts[12] = "9.0"
    rows[0] = " ".join(parts)
    with open(ptxt, "w") as f:
        f.write("\n".join(rows))
    cam1 = os.path.join(bad, "images", "refined_seg", "cam001")
    for name in os.listdir(cam1):
        os.unlink(os.path.join(cam1, name))
    shutil.rmtree(os.path.join(bad, "images", "refined_seg", "cam002"))
    return ptxt


def test_static_findings_match_jax(fake_static_dir, tmp_path):
    root, _ = fake_static_dir
    clean = tval.validate_static_capture(root, skip_cameras=())
    assert clean == jval.validate_static_capture(root, skip_cameras=())
    assert not [s for s in clean if s.startswith("[error]")]
    assert any("ngp_mesh" in s for s in clean)
    bad = str(tmp_path / "bad_static")
    ptxt = _corrupt_static(root, bad)
    got = tval.validate_static_capture(bad, skip_cameras=())
    assert got == jval.validate_static_capture(bad, skip_cameras=())
    errs = "\n".join(s for s in got if s.startswith("[error]"))
    assert "quaternion" in errs and "empty" in errs
    assert "no image directory" in errs
    with open(ptxt, "w") as f:
        f.write("not a calibration file\nat all")
    got = tval.validate_static_capture(bad, skip_cameras=())
    assert got == jval.validate_static_capture(bad, skip_cameras=())
    assert any("do not parse" in s for s in got)


def test_static_image_checks_match_jax(fake_static_dir, tmp_path):
    """A 3-channel image (warning), a greyscale one, one that does not
    decode, sizes that differ, an image dir without calibration and a
    mesh whose header lacks its vertices."""
    root, _ = fake_static_dir
    bad = str(tmp_path / "images")
    shutil.copytree(root, bad)
    seg = os.path.join(bad, "images", "refined_seg")
    img = cv2.imread(os.path.join(seg, "cam000", "0001.png"),
                     cv2.IMREAD_UNCHANGED)
    cv2.imwrite(os.path.join(seg, "cam000", "0001.png"), img[..., :3])
    cv2.imwrite(os.path.join(seg, "cam001", "0001.png"), img[..., 0])
    with open(os.path.join(seg, "cam002", "0001.png"), "wb") as f:
        f.write(b"\x89PNG broken")
    cv2.imwrite(os.path.join(seg, "cam003", "0001.png"), img[:32])
    os.makedirs(os.path.join(seg, "cam_extra"))
    os.makedirs(os.path.join(bad, "mesh", "ngp_mesh"))
    with open(os.path.join(bad, "mesh", "ngp_mesh", "m.ply"), "w") as f:
        f.write("ply\nformat ascii 1.0\nend_header\n")
    got = tval.validate_static_capture(bad, skip_cameras=())
    assert got == jval.validate_static_capture(bad, skip_cameras=())
    assert sum(s.startswith("[error]") for s in got) >= 4


def test_dynamic_findings_match_jax(fake_dynamic_h5, tmp_path):
    root, ref_ds = fake_dynamic_h5
    nb = ref_ds.bones_rest.num_bones
    kw = dict(width=W, height=H, n_bones=nb, frames_per_action=-1)
    clean = tval.validate_dynamic_capture(root, **kw)
    assert clean == jval.validate_dynamic_capture(root, **kw)
    assert not [s for s in clean if s.startswith("[error]")]

    bad = tmp_path / "bad_dyn"
    os.makedirs(bad)
    shutil.copy(os.path.join(root, "grasp_action.hdf5"),
                bad / "grasp_action.hdf5")
    with h5py.File(bad / "grasp_action.hdf5", "r+") as f:
        del f["frames"]["0"]["metadata"]["rest_heads"]
        del f["frames"]["1"]["bbox"]["cam000"]
        f["frames"]["1"]["bbox"].create_dataset(
            "cam000", data=np.asarray([10, 0, 5, H]))
        del f["K"]["cam002"]
        del f["frames"]["2"]["images"]
    got = tval.validate_dynamic_capture(str(bad), **kw)
    assert got == jval.validate_dynamic_capture(str(bad), **kw)
    errs = "\n".join(s for s in got if s.startswith("[error]"))
    assert "missing keys" in errs and "rest_heads" in errs
    assert "outside the" in errs and "K/extr camera sets differ" in errs
    assert "missing 'images'" in errs

    (bad / "junk.hdf5").write_bytes(b"this is not hdf5")
    got = tval.validate_dynamic_capture(str(bad), width=W, height=H,
                                        n_bones=nb)
    want = jval.validate_dynamic_capture(str(bad), width=W, height=H,
                                         n_bones=nb)
    assert _masked(got) == _masked(want)
    assert any(UNREADABLE in s for s in got)


@pytest.mark.parametrize("writer", ["h5py", "write_tree", "h5py_latest"])
def test_dynamic_findings_on_bad_crops_match_jax(writer, tmp_path):
    """A crop of the wrong size, a float crop, a bad bbox shape, frames
    sampled from a longer action, a second action with another rig; by
    each writer (h5py_latest: libver "latest", dense groups in creation
    order, lzf crops)."""
    root = write_dynamic_capture(
        str(tmp_path / "cap"), writer=writer, actions=(
            ("a", tuple(str(i) for i in range(7))), ("b", ("0", "x"))))
    kw = dict(width=64, height=64, n_bones=20, frames_per_action=-1)
    assert tval.validate_dynamic_capture(root, **kw) == \
        jval.validate_dynamic_capture(root, **kw)
    with h5py.File(os.path.join(root, "a.hdf5"), "r+") as f:
        img = f["frames/0/images"]
        crop = img["cam001"][:]
        del img["cam001"]
        img["cam001"] = crop[1:]
        del img["cam002"]
        img["cam002"] = crop.astype(np.float32)
        del f["frames/3/bbox/cam000"]
        f["frames/3/bbox/cam000"] = np.zeros(5)
    with h5py.File(os.path.join(root, "b.hdf5"), "r+") as f:
        del f["K/cam001"], f["extr/cam001"], f["mano_rest"]
    for fpa in (4, -1):
        kw = dict(width=64, height=64, n_bones=20, frames_per_action=fpa)
        got = tval.validate_dynamic_capture(root, **kw)
        assert got == jval.validate_dynamic_capture(root, **kw)
        assert sum(s.startswith("[error]") for s in got) >= 2


def test_unsupported_hdf5_form_is_an_error(tmp_path):
    """A form the reader does not read (here a crop that is an array of
    object references) is reported as an error of its file; the walk goes
    on to the next file."""
    root = write_dynamic_capture(str(tmp_path / "cap"), writer="h5py")
    with h5py.File(os.path.join(root, "grasp_a.hdf5"), "r+") as f:
        images = f["frames/1/images"]
        del images["cam000"]
        images.create_dataset("cam000", data=[images["cam001"].ref],
                              dtype=h5py.ref_dtype)
    got = tval.validate_dynamic_capture(root, 64, 64, frames_per_action=-1)
    errs = [s for s in got if s.startswith("[error]")]
    assert len(errs) == 1 and "unsupported HDF5 form" in errs[0]
    assert "references" in errs[0] and "grasp_a.hdf5" in errs[0]


def test_validate_capture_and_report(fake_static_dir):
    root, _ = fake_static_dir
    for kind in ("brics_static", "brics_dynamic", "synthetic"):
        cfg = CONFIGS["OBJ_GAUSSIAN"]()
        apply_overrides(cfg, [f"dataset.kind={kind}", f"dataset.root={root}"])
        got = tval.validate_capture(cfg)
        assert got == jval.validate_capture(cfg)
        lines_t, lines_j = [], []
        assert tval.report(got, log=lines_t.append) == jval.report(
            got, log=lines_j.append)
        assert lines_t == lines_j


def test_video_reader_matches_jax(fake_synced_dir, tmp_path):
    from manus_tpu.data.reader import VideoReader as JReader
    from manus_tpu.data.reader import extract_frames as jextract
    from manus_tpu_torch.data.reader import VideoReader, extract_frames
    from manus_tpu_torch.utils.io import read_png

    got, want = VideoReader(fake_synced_dir), JReader(fake_synced_dir)
    assert len(got) == len(want) == 2 and got.frame_count == 5
    for idx in (3, 0, 4):
        g, w = got.get_frames(idx), want.get_frames(idx)
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    assert [n for _, n in got([4, 0, 99])] == [n for _, n in want([4, 0,
                                                                   99])]
    got.release()
    want.release()
    one = VideoReader(fake_synced_dir, selected_cams=("cam001",))
    assert set(one.streams) == {"cam001"}
    one.release()
    n = extract_frames(fake_synced_dir, str(tmp_path / "t"), [1, 2])
    assert n == jextract(fake_synced_dir, str(tmp_path / "j"), [1, 2]) == 4
    for cam in ("cam000", "cam001"):
        for fno in (1, 2):
            name = os.path.join(cam, f"{fno:06d}.png")
            np.testing.assert_array_equal(
                read_png(str(tmp_path / "t" / name)),
                cv2.imread(str(tmp_path / "j" / name))[..., ::-1])


def test_video_reader_undistorts_as_jax(fake_synced_dir, tmp_path):
    from manus_tpu.data.reader import VideoReader as JReader
    from manus_tpu_torch.data.reader import VideoReader

    calib = tmp_path / "optim_params.txt"
    rows = [f"{i} {W} {H} 60.0 61.0 31.7 32.2 -0.1 0.04 0.001 -0.002 "
            f"cam00{i} 1 0 0 0 0 0 3" for i in range(2)]
    calib.write_text("\n".join(rows))
    got = VideoReader(fake_synced_dir, undistort=True, cam_path=str(calib))
    want = JReader(fake_synced_dir, undistort=True, cam_path=str(calib))
    g, w = got.get_frames(2), want.get_frames(2)
    for k in g:
        d = np.abs(g[k].astype(int) - w[k].astype(int))
        assert d.max() <= 1 and (d.max(-1) > 0).mean() <= 1e-3
    got.release()
    want.release()
    with pytest.raises(ValueError, match="cam_path"):
        VideoReader(fake_synced_dir, undistort=True)


def test_video_reader_without_opencv_raises(fake_synced_dir, monkeypatch):
    import builtins

    from manus_tpu_torch.data import reader

    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="decoding video needs OpenCV"):
        reader.VideoReader(fake_synced_dir)
    with pytest.raises(ImportError, match="decoding video needs OpenCV"):
        reader.extract_frames(fake_synced_dir, "/nonexistent", [0])
