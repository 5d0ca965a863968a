"""The port's contact evaluation and baselines (train/evaluate.py,
train/baselines.py, utils/io.py's PNG reader and mesh writer,
data/voxel.py's MANO posing) against the JAX package and OpenCV on the
CPU, on the same numpy inputs from fixed seeds."""
import csv
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manus_tpu.data import voxel as jvoxel
from manus_tpu.ops.rasterizer.api import RasterConfig as JRaster
from manus_tpu.train import baselines as jbase
from manus_tpu.train import evaluate as jeval
from manus_tpu.utils import io as jio
from manus_tpu_torch.data import voxel as tvoxel
from manus_tpu_torch.ops.rasterizer.api import RasterConfig as TRaster
from manus_tpu_torch.train import baselines as tbase
from manus_tpu_torch.train import evaluate as teval
from manus_tpu_torch.utils import io as tio
from tests.test_torch_composite import _cam
from utils import make_test_camera

cv2 = pytest.importorskip("cv2")

CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> channels


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_png(path, img, ctype, filters):
    """An independent PNG encoder: row r uses filter filters[r % len]
    (0 none, 1 sub, 2 up, 3 average, 4 paeth), computed on the whole
    image at once from the raw bytes."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int64)
    up = np.concatenate([np.zeros((1, w * c), np.int64), raw[:-1]])
    left = np.concatenate([np.zeros((h, c), np.int64), raw[:, :-c]], axis=1)
    upleft = np.concatenate([np.zeros((h, c), np.int64), up[:, :-c]], axis=1)
    preds = {0: 0 * raw, 1: left, 2: up, 3: (left + up) // 2,
             4: _paeth(left, up, upleft)}
    rows = b""
    for r in range(h):
        k = filters[r % len(filters)]
        rows += bytes([k]) + ((raw[r] - preds[k][r]) % 256).astype(
            np.uint8).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _image(h, w, c, seed):
    """Noise with smooth and flat rows, so every filter sees both."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
    img[: h // 3] = (np.arange(w)[None, :, None] * 3 + 7).astype(np.uint8)
    img[h // 3: h // 2] = 200
    return img


@pytest.mark.parametrize("ctype", [0, 4, 2, 6],
                         ids=["grey", "grey_alpha", "rgb", "rgba"])
def test_read_png_every_filter(ctype, tmp_path):
    """Each colour type under each row filter and a mix of all five, read
    back exactly; the greyscale read of a colour file is OpenCV's
    (IMREAD_GRAYSCALE), for the files it can read."""
    c = CHANNELS[ctype]
    img = _image(23, 37, c, ctype)
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        path = str(tmp_path / f"f{''.join(map(str, filters))}.png")
        _write_png(path, img, ctype, filters)
        rgba = tio.read_png(path, "rgba")
        color = img[..., :3] if c >= 3 else np.repeat(img[..., :1], 3, -1)
        np.testing.assert_array_equal(rgba[..., :3], color)
        np.testing.assert_array_equal(
            rgba[..., 3], img[..., -1] if c in (2, 4) else 255)
        np.testing.assert_array_equal(tio.read_png(path), color)
        gray = tio.read_png(path, "gray")
        assert gray.shape == img.shape[:2] and gray.dtype == np.uint8
        if c == 1:
            np.testing.assert_array_equal(gray, img[..., 0])
        if c != 2:  # OpenCV reads the others
            np.testing.assert_array_equal(
                gray, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
            want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            if c >= 3:
                want = want[..., [2, 1, 0, 3][:c]]
            np.testing.assert_array_equal(
                img if c > 1 else img[..., 0], want)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_read_png_of_cv2_and_dump_image(c, tmp_path):
    """Files written by OpenCV (its own filter choice) and by the port's
    dump_image read back to the same pixels, and the greyscale read of
    an RGB or RGBA file gives OpenCV's IMREAD_GRAYSCALE values: OpenCV's
    PNG decoder converts as (9797 R + 19234 G + 3737 B) >> 15, truncated,
    not cvtColor's rounded BT.601 (4899, 9617, 1868; 14 bits), which
    differs on ~half of random pixels."""
    img = _image(64, 96, c, 10 + c)
    bgr = img[..., [2, 1, 0, 3][:c]] if c >= 3 else img[..., 0]
    cv2.imwrite(str(tmp_path / "cv.png"), bgr)
    tio.dump_image(img if c > 1 else img[..., 0], str(tmp_path / "port.png"))
    for name in ("cv.png", "port.png"):
        path = str(tmp_path / name)
        got = tio.read_png(path, "rgba" if c == 4 else "rgb")
        np.testing.assert_array_equal(
            got, img if c >= 3 else np.repeat(img, 3, -1))
        np.testing.assert_array_equal(
            tio.read_png(path, "gray"), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                      bgr)
    if c == 3:
        r, g, b = (img[..., i].astype(np.int64) for i in range(3))
        bt601 = (4899 * r + 9617 * g + 1868 * b + 8192) >> 14
        assert (bt601 != tio.read_png(str(tmp_path / "cv.png"),
                                      "gray")).mean() > 0.2


def test_read_png_refuses_other_files(tmp_path):
    """16-bit, palette and interlaced files raise; so does a non-PNG."""
    img = _image(8, 8, 3, 0)
    cv2.imwrite(str(tmp_path / "d16.png"), (img.astype(np.uint16) * 257))
    with pytest.raises(ValueError, match="bit depth 16"):
        tio.read_png(str(tmp_path / "d16.png"))
    for ctype, interlace, what in [(3, 0, "colour type 3"),
                                   (2, 1, "interlace 1")]:
        path = str(tmp_path / f"{ctype}{interlace}.png")
        _write_png(path, img, 2, [0])
        data = bytearray(open(path, "rb").read())
        data[25], data[28] = ctype, interlace  # IHDR's fields
        open(path, "wb").write(bytes(data))
        with pytest.raises(ValueError, match=what):
            tio.read_png(path)
    (tmp_path / "x.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        tio.read_png(str(tmp_path / "x.png"))


def _skin_image(seed):
    """A 64x64 skin render: bone-coloured blocks with jittered colours
    (inside and outside the +-10 key), speckle, a hole and blocks on the
    image's edge; the silhouette a little larger than the paint."""
    rng = np.random.RandomState(seed)
    h = w = 64
    img = np.zeros((h, w, 3), np.float32)
    gt = np.zeros((h, w), bool)
    for k, (y, x, s) in enumerate([(0, 0, 20), (0, 30, 18), (22, 5, 25),
                                   (30, 36, 28), (50, 0, 14), (44, 20, 20)]):
        c = teval.BONE_COLORS[(3 * k + seed) % 16]
        img[y:y + s, x:x + s] = c + rng.randint(-12, 13, (min(s, h - y),
                                                          min(s, w - x), 3))
        gt[max(0, y - 2):y + s + 2, max(0, x - 2):x + s + 2] = True
    speck = rng.uniform(size=(h, w)) < 0.04
    img[speck] = teval.BONE_COLORS[rng.randint(0, 16, speck.sum())]
    img[30:36, 40:46] = 0  # a hole inside the silhouette
    return np.clip(img, 0, 255).astype(np.uint8), gt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skin_bone_masks_match_jax(seed):
    """Labels equal to the JAX package's (cv2 keying and morphology, the
    kNN hole vote): the port reproduces cv2.inRange, the 3x3 ellipse's
    erode and dilate with OpenCV's border, the first-bone argmax and the
    first-index nearest neighbour exactly."""
    img, gt = _skin_image(seed)
    got = teval.skin_bone_masks(img, gt, device="cpu")
    want = jeval.skin_bone_masks(img, gt)
    assert set(np.unique(want)) - {0}  # several bones labelled
    np.testing.assert_array_equal(got, want)
    # also from a float image
    np.testing.assert_array_equal(
        teval.skin_bone_masks(img / 255.0, gt, device="cpu"),
        jeval.skin_bone_masks(img / 255.0, gt))


def test_per_bone_and_dir_metrics_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    labels = rng.randint(0, 17, (48, 48))
    gt = rng.uniform(size=(48, 48)) > 0.6
    pred = rng.uniform(size=(48, 48)) > 0.5
    for a, b in zip(teval.per_bone_iou_f1(labels, gt, pred),
                    jeval.per_bone_iou_f1(labels, gt, pred)):
        np.testing.assert_array_equal(a, b)
    got, want = (m.evaluate_metric(labels, gt, pred) for m in (teval, jeval))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # evaluate_contact_dir over PNG pairs, and aggregate_subject_csvs
    pred_dir, gt_dir = tmp_path / "pred", tmp_path / "gt"
    os.makedirs(pred_dir)
    os.makedirs(gt_dir)
    for i in range(3):
        cv2.imwrite(str(pred_dir / f"{i}.png"),
                    (rng.uniform(size=(32, 32, 3)) * 255).astype(np.uint8))
        cv2.imwrite(str(gt_dir / f"{i}.png"),
                    ((rng.uniform(size=(32, 32)) > 0.5) * 255).astype(
                        np.uint8))
    outs = []
    for m, tag in ((teval, "t"), (jeval, "j")):
        s = m.evaluate_contact_dir(str(pred_dir), str(gt_dir),
                                   str(tmp_path / f"{tag}.csv"), 0.4)
        agg = m.aggregate_subject_csvs([str(tmp_path / f"{tag}.csv")] * 2,
                                       str(tmp_path / f"{tag}_agg.csv"))
        outs.append((s, agg, (tmp_path / f"{tag}.csv").read_text(),
                     (tmp_path / f"{tag}_agg.csv").read_text()))
    assert outs[0] == outs[1]


def test_subdivide_mesh_bit_equal():
    rng = np.random.RandomState(2)
    verts = rng.normal(size=(30, 3)).astype(np.float32)
    faces = np.stack([rng.permutation(30)[:3] for _ in range(40)]).astype(
        np.int32)
    v, f = verts, faces
    for _ in range(3):
        tv, tf = tbase.subdivide_mesh(v, f)
        jv, jf = jbase.subdivide_mesh(v, f)
        assert tv.dtype == jv.dtype and tf.dtype == jf.dtype
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
        v, f = tv, tf


def test_dump_mesh_bytes_equal_jax(tmp_path):
    rng = np.random.RandomState(3)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    f = rng.randint(0, 50, (70, 3)).astype(np.int32)
    for colors in (None, rng.uniform(size=(50, 3)),
                   rng.randint(0, 256, (50, 4))):
        tio.dump_mesh(str(tmp_path / "t.ply"), v, f, colors=colors)
        jio.dump_mesh(str(tmp_path / "j.ply"), v, f, colors=colors)
        assert (tmp_path / "t.ply").read_bytes() == \
            (tmp_path / "j.ply").read_bytes()


def _plate(n=9):
    """A square plate facing the test camera, triangulated."""
    gx, gy = np.meshgrid(np.linspace(-0.5, 0.5, n), np.linspace(-0.5, 0.5, n))
    verts = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3)
    faces = []
    for r in range(n - 1):
        for c in range(n - 1):
            a = r * n + c
            faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def test_mano_baseline_contacts_match_jax(tmp_path):
    """Two frames of a plate against an object touching its left half:
    the accumulated map within the contact distance tolerance of
    test_torch_colormap_contacts.py (|x| <= 1 m: sqrt(2 eps) = 5.5e-4 m,
    0.14 of d01, and 2 eps / (d_a + d_b) where d is not small; here every
    point is > 1 mm from the object or beyond c), the PLYs byte for byte
    where the colours agree, and the rendered acc_eval PNG within one
    8-bit level at 99% of pixels (the plain composite of each package;
    a LUT step flipped by the distance tolerance moves a splat by 1/255)."""
    verts, faces = _plate()
    obj = verts[verts[:, 0] < 0.0] + np.asarray([0, 0, 0.001], np.float32)
    posed = [verts, verts + np.asarray([0.0, 0.0, 0.0015], np.float32)]
    cam = make_test_camera(64, 64, dist=2.0)
    jacc = jbase.mano_baseline_contacts(
        verts, faces, posed, obj, str(tmp_path / "j"), subdiv_iters=2,
        cameras=[cam], camera_names=["0000"],
        raster_config=JRaster(backend="xla", max_pairs_per_tile=512,
                              chunk=32))
    tacc = tbase.mano_baseline_contacts(
        verts, faces, posed, obj, str(tmp_path / "t"), subdiv_iters=2,
        cameras=[_cam(cam)], camera_names=["0000"],
        raster_config=TRaster(max_pairs_per_tile=512, chunk=32),
        device="cpu")
    assert tacc.dtype == np.float32 and tacc.shape == jacc.shape
    assert 0 < (tacc > 0).sum() < len(tacc) and tacc.max() <= 2.0
    np.testing.assert_allclose(tacc, jacc, atol=1e-4, rtol=0)
    for sub in ("gt_eval/0.ply", "gt_eval/1.ply", "acc_eval/0.ply",
                "acc_eval/1.ply"):
        assert (tmp_path / "t" / sub).read_bytes() == \
            (tmp_path / "j" / sub).read_bytes(), sub
    got = tio.read_png(str(tmp_path / "t" / "acc_eval_rendered" / "0000.png"))
    want = cv2.imread(str(tmp_path / "j" / "acc_eval_rendered" / "0000.png"))
    err = np.abs(got.astype(int) - want[..., ::-1].astype(int))
    assert (err <= 1).mean() > 0.99 and (got > 127).sum() > 50


def test_pose_mano_verts_and_sequence_match_jax():
    """LBS posing of a MANO-like mesh: float32 blends of the same
    transforms, 1e-6."""
    from manus_tpu.utils.structures import Bones as JBones
    from manus_tpu_torch.utils.structures import Bones as TBones

    rng = np.random.RandomState(0)
    nv = 40
    mano = dict(verts=rng.uniform(-0.1, 0.1, (nv, 3)).astype(np.float32),
                faces=np.zeros((1, 3), np.int32),
                weights=rng.dirichlet(np.ones(16) * 0.3, size=nv).astype(
                    np.float32))
    rest = np.tile(np.eye(4, dtype=np.float32), (20, 1, 1))
    rest[:, :3, 3] = rng.normal(0, 0.05, (20, 3))
    poses = []
    for k in range(3):
        p = np.tile(np.eye(4, dtype=np.float32), (20, 1, 1))
        a = rng.normal(0, 0.3, (20, 3))
        for b in range(20):
            p[b, :3, :3] = cv2.Rodrigues(a[b])[0]
        p[:, :3, 3] = rest[:, :3, 3] + rng.normal(0, 0.01, (20, 3))
        poses.append(p)
    got = tvoxel.pose_mano_verts(mano, poses[0], rest, device="cpu")
    want = jvoxel.pose_mano_verts(mano, poses[0], rest)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    zeros = np.zeros((20, 3), np.float32)
    tseq = tvoxel.pose_mano_sequence(
        mano, [TBones(zeros, zeros, torch.tensor(p)) for p in poses],
        TBones(zeros, zeros, torch.tensor(rest)), device="cpu")
    jseq = jvoxel.pose_mano_sequence(
        mano, [JBones(zeros, zeros, jnp.asarray(p)) for p in poses],
        JBones(zeros, zeros, jnp.asarray(rest)))
    assert len(tseq) == len(jseq) == 3
    for a, b in zip(tseq, jseq):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def _eval_fixture(root, seed):
    """A run directory and ground truth for evaluate_composite: ours
    acc_gt_eval frames [skin | contact] over two bones, a mano baseline
    covering part of the contact, gt masks and RGBA photos; speckled
    skin, so the labels need the hole vote."""
    rng = np.random.RandomState(seed)
    h = w = 48
    res = root / "exp" / "results" / "eval_results"
    dirs = [res / "ours", res / "mano" / "acc_eval_rendered",
            root / "gt" / "gt_contacts_seg", root / "gt" / "gt_contacts"]
    for d in dirs:
        os.makedirs(d)
    for i in range(3):
        skin, sil = _skin_image(seed + i)
        skin, sil = skin[:h, :w], sil[:h, :w]
        gt_c = np.zeros((h, w), np.uint8)
        gt_c[8 + i:28, 6:40 - i] = 255
        ours = (rng.uniform(size=(h, w)) < 0.9) * gt_c
        mano = np.zeros((h, w), np.uint8)
        mano[8:28, 6:24] = 200
        name = f"{i:04d}.png"
        cv2.imwrite(str(dirs[0] / name), cv2.cvtColor(np.concatenate(
            [skin, np.repeat(ours[..., None], 3, -1)], axis=1),
            cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(dirs[1] / name), mano)
        cv2.imwrite(str(dirs[2] / name), gt_c)
        alpha = (sil * 255).astype(np.uint8)
        cv2.imwrite(str(dirs[3] / name),
                    np.dstack([skin[..., 2], skin[..., 1], skin[..., 0],
                               alpha]))
    return root / "exp", dirs[2], dirs[3], res


def test_evaluate_composite_matches_jax(tmp_path):
    """eval_metric.csv identical and the collage identical pixel for
    pixel, on the same triples with a mano baseline present; the scores
    equal; aggregate_eval_tables equal."""
    outs = {}
    for m, tag in ((teval, "t"), (jeval, "j")):
        exp, seg, img, res = _eval_fixture(tmp_path / tag, 7)
        kw = dict(device="cpu") if m is teval else {}
        scores = m.evaluate_composite(str(exp), str(seg), str(img), **kw)
        avg = m.aggregate_eval_tables([str(res / "eval_metric.csv")] * 2,
                                      str(tmp_path / f"{tag}_avg.csv"))
        with open(res / "eval_metric.csv") as f:
            table = list(csv.reader(f))
        outs[tag] = (scores, table,
                     cv2.imread(str(res / "eval_collage.png")),
                     (tmp_path / f"{tag}_avg.csv").read_text(), avg)
    t, j = outs["t"], outs["j"]
    assert set(t[0]) == {"ours", "mano"}
    assert t[0] == j[0]
    assert t[1] == j[1]
    assert [r[0] for r in t[1]] == ["", "ours", "mano", "ours_f1", "mano_f1"]
    assert 0.5 < t[0]["ours"]["iou"] < 1 and 0 < t[0]["mano"]["iou"] < 1
    np.testing.assert_array_equal(t[2], j[2])
    assert t[2].shape == (3 * 48, 4 * 48, 3)
    assert t[3] == j[3]
    assert t[4].keys() == j[4].keys()
    for k in t[4]:
        np.testing.assert_array_equal(t[4][k], j[4][k])
