"""Parity of the port's Trainer with the JAX package's.

Both packages build the same synthetic scene and init model from the
same numpy seeds and fit for a few steps on the CPU (JAX with
raster.backend=xla, the port with the composite's plain version), with
the same batch draws (np.random.RandomState(trainer.seed), drawn ahead by
each prefetch thread in the same order). Their run directories are then
compared file for file: train_metrics.csv per step (loss and psnr within
1e-4 relative, num_active equal), val_results.csv (the same header, psnr
within 1e-3 relative), the same files, and the densify events.
"""
import csv
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jmain
from manus_tpu import config as jcfg
from manus_tpu.data import synthetic as jsyn
from manus_tpu.models.gaussians import init_gaussian_model as j_init
from manus_tpu.train import lpips as jlpips
from manus_tpu.train.trainer import Trainer as JTrainer
from manus_tpu_torch import config as tcfg
from manus_tpu_torch import main as tmain
from manus_tpu_torch.data import synthetic as tsyn
from manus_tpu_torch.models.convert import lpips_params_from_numpy
from manus_tpu_torch.models.gaussians import init_gaussian_model as t_init
from manus_tpu_torch.train import lpips as tlpips
from manus_tpu_torch.train.trainer import Trainer as TTrainer
from manus_tpu_torch.utils.io import dump_image


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tensors here are small, and test workers
    side by side, each with a full OpenMP team, oversubscribe the CPU
    (the new port test files took 115 s under -n 5 so, 26 s with one)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

W = H = 64


def _overrides(steps, extra=()):
    return [
        f"dataset.width={W}", f"dataset.height={H}", "dataset.num_cameras=4",
        "capacity=512", "raster.max_pairs_per_tile=512",
        "model.remove_seg_end=0", f"trainer.max_steps={steps}",
        "trainer.log_every=1", f"trainer.val_every={steps}",
        "trainer.checkpoint_every=0", "raster.backend=xla", *extra,
    ]


def _cfgs(name, steps, extra=()):
    ov = _overrides(steps, extra)
    return (tcfg.apply_overrides(tcfg.CONFIGS[name](), ov),
            jcfg.apply_overrides(jcfg.CONFIGS[name](), ov))


def _object_pair(tc, jc):
    d = tc.dataset
    kw = dict(width=d.width, height=d.height, num_cameras=d.num_cameras)
    tds, tval = tsyn.split_synthetic_static(
        tsyn.build_synthetic_static(**kw, device="cpu"))
    jds, jval = jsyn.split_synthetic_static(jsyn.build_synthetic_static(**kw))
    pts, cols = jds.sample_gaussians(200)
    tmodel = t_init(pts, cols, tc.capacity, opts=tc.model, device="cpu")
    jmodel = j_init(pts, cols, jc.capacity, opts=jc.model)
    return (tds, tval, tmodel, None), (jds, jval, jmodel, None)


def _hand_pair(tc, jc):
    d = tc.dataset
    kw = dict(width=d.width, height=d.height, num_cameras=d.num_cameras,
              num_frames=2)
    tds, tval = tsyn.split_synthetic_dynamic(
        tsyn.build_synthetic_dynamic(**kw, device="cpu"), 0.5)
    jds, jval = jsyn.split_synthetic_dynamic(
        jsyn.build_synthetic_dynamic(**kw), 0.5)
    tmodel, tgrid = tmain.build_hand_pieces(tc, tds, device="cpu")
    jmodel, jgrid = jmain.build_hand_pieces(jc, jds)
    np.testing.assert_allclose(tgrid.weights.numpy(), np.asarray(jgrid.weights),
                               atol=1e-6)
    return (tds, tval, tmodel, tgrid), (jds, jval, jmodel, jgrid)


def _fit_both(tmp_path, tc, jc, pieces, articulated, wrap=None):
    """Fit both trainers; returns (port trainer, JAX trainer, port log
    lines, JAX log lines)."""
    (tds, tval, tmodel, tgrid), (jds, jval, jmodel, jgrid) = pieces
    tlog, jlog = [], []
    tt = TTrainer(tc, tds, tmodel, articulated, tgrid,
                  out_dir=str(tmp_path / "port"), val_dataset=tval,
                  log=tlog.append)
    jt = JTrainer(jc, jds, jmodel, articulated, jgrid,
                  out_dir=str(tmp_path / "jax"), val_dataset=jval)
    if wrap is not None:
        wrap(tt, jt)
    tt.fit()
    jt.fit(log=jlog.append)
    return tt, jt, tlog, jlog


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _files(root):
    """A run directory's files, a checkpoint's name cut to its step (the
    name's loss and val PSNR are compared with the CSVs)."""
    out = []
    for d, _, fs in os.walk(root):
        for f in fs:
            if f.endswith(".npz"):
                f = f.split("-")[0]
            out.append(os.path.relpath(os.path.join(d, f), root))
    return sorted(out)


def _compare_runs(tmp_path, steps_equal, val_close=True):
    """The two run directories: the same files, train rows at
    steps_equal within 1e-4 relative (num_active equal), and with
    val_close the val rows within 1e-3."""
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    tr, jr = (_rows(tmp_path / s / "logs" / "train_metrics.csv")
              for s in ("port", "jax"))
    assert tr[0] == jr[0] == ["step", "loss", "psnr", "num_active",
                              "iters_per_s"]
    assert [r[0] for r in tr] == [r[0] for r in jr]
    for t, j in zip(tr[1:], jr[1:]):
        if int(t[0]) in steps_equal:
            assert t[3] == j[3], (t, j)  # num_active
            np.testing.assert_allclose(float(t[1]), float(j[1]), rtol=1e-4)
            np.testing.assert_allclose(float(t[2]), float(j[2]), rtol=1e-4)
    tv, jv = (_rows(tmp_path / s / "results" / "val_results.csv")
              for s in ("port", "jax"))
    assert tv[0] == jv[0]
    assert len(tv) == len(jv) > 1
    for t, j in zip(tv[1:], jv[1:]) if val_close else ():
        assert t[0:2] == j[0:2] and t[6:] == j[6:]  # name, step, ovf, mode
        np.testing.assert_allclose(float(t[2]), float(j[2]), rtol=1e-3)
        np.testing.assert_allclose(float(t[3]), float(j[3]), rtol=1e-3)
        np.testing.assert_allclose(float(t[4]), float(j[4]), rtol=1e-3,
                                   atol=1e-7)
    return tr, tv


def test_object_trainer_matches_jax(tmp_path):
    tc, jc = _cfgs("OBJ_GAUSSIAN", 5, ["model.densify_from_step=100"])
    pieces = _object_pair(tc, jc)
    _fit_both(tmp_path, tc, jc, pieces, False)
    _compare_runs(tmp_path, range(5))


def test_voxel_hand_trainer_matches_jax(tmp_path):
    """Voxel skinning (grid_res 24); the config's lpips_loss is left out of
    the training loss (random-feature weights only), in both, without the
    caller's config changing; the AlexNet val metric stays live."""
    tc, jc = _cfgs("HAND_GAUSSIAN", 5, [
        "dataset.grid_res=24", "dataset.sample_size=20",
        "trainer.loggers=[csv,jsonl]"])
    assert tc.skin_init == "mano_init_voxel"
    pieces = _hand_pair(tc, jc)
    tt, jt, _, _ = _fit_both(tmp_path, tc, jc, pieces, True)
    assert "lpips_loss" in tc.loss.losses  # the caller's config is as given
    assert "lpips_loss" not in tt.cfg.loss.losses
    assert tt.lpips_eval_mode == jt.lpips_eval_mode == "alex:random-feature"
    _, tv = _compare_runs(tmp_path, range(5))
    assert float(tv[1][4]) > 0  # the AlexNet metric
    events = [[json.loads(line) for line in open(
        tmp_path / s / "logs" / "events.jsonl")] for s in ("port", "jax")]
    assert [sorted(e) for e in events[0]] == [sorted(e) for e in events[1]]
    assert not any("loss/lpips_loss" in e for e in events[0])
    gdir = tmp_path / "port" / "results" / "val_results" / "gaussians"
    assert sorted(os.listdir(gdir)) == ["5_0_cano.ply", "5_0_posed.ply"]
    for s in ("port", "jax"):
        with open(tmp_path / s / "results" / "val_results" / "gaussians"
                  / "5_0_posed.ply", "rb") as f:
            head = f.read(200)
        assert b"property uchar red" in head


def test_densify_event_matches_jax(tmp_path):
    """An object run across a densify event at step 3. The event fires at
    the same step in both with the same counts; the split children's
    noise differs, so losses are compared up to the event. A slot that one
    package selects and the other does not must have a mean gradient
    within float32 rounding (1e-5 relative) of densify_grad_threshold in
    both."""
    tc, jc = _cfgs("OBJ_GAUSSIAN", 5, [
        "model.densify_from_step=2", "model.densification_interval=3"])
    pieces = _object_pair(tc, jc)
    grads = {}

    def wrap(tt, jt):
        for key, tr in (("port", tt), ("jax", jt)):
            inner = tr.densify_step

            def spy(state, inner=inner, key=key):
                s = state.stats
                acc, den = (np.array(x.numpy() if torch.is_tensor(x) else x)
                            for x in (s.grad_accum, s.denom))
                grads[key] = np.where(den > 0, acc / np.maximum(den, 1), 0)
                return inner(state)

            tr.densify_step = spy

    tt, jt, tlog, jlog = _fit_both(tmp_path, tc, jc, pieces, False, wrap)
    tev = [line for line in tlog if line.startswith("[densify]")]
    jev = [line for line in jlog if line.startswith("[densify]")]
    assert len(tev) == len(jev) == 1
    assert tev[0].split(":")[0] == jev[0].split(":")[0] == "[densify] step 3"
    thr = tc.model.densify_grad_threshold
    sel_t, sel_j = grads["port"] >= thr, grads["jax"] >= thr
    assert sel_t.any()
    differ = sel_t != sel_j
    for g in (grads["port"], grads["jax"]):
        assert (np.abs(g[differ] - thr) <= 1e-5 * thr).all()
    if not differ.any():
        # the same active count, clones, splits, prunes and drops
        assert tev[0] == jev[0]
    # the children's noise differs: the steps after the event and the
    # validation at its end are not compared
    _compare_runs(tmp_path, range(4), val_close=False)


def test_lpips_in_loss_with_the_gt_feature_cache(tmp_path):
    """loss.lpips_random_in_loss=true keeps lpips_loss: the trainer builds
    the gt feature cache from its image cache, the batch gathers from it,
    and the cached features are lpips_features of the gt image."""
    tc, _ = _cfgs("HAND_GAUSSIAN", 1, [
        "dataset.grid_res=24", "dataset.sample_size=10",
        "loss.lpips_random_in_loss=true", "model.start_lpips_iter=0",
        "dataset.width=32", "dataset.height=32"])
    ds = tsyn.build_synthetic_dynamic(width=32, height=32, num_cameras=2,
                                      num_frames=2, device="cpu")
    model, grid = tmain.build_hand_pieces(tc, ds, device="cpu")
    logs = []
    tr = TTrainer(tc, ds, model, True, grid, out_dir=str(tmp_path / "a"),
                  log=logs.append)
    assert "lpips_loss" in tr.cfg.loss.losses
    cache = tr._lpips_feat_cache
    assert cache is not None and len(cache) == 5
    assert cache[0].shape[:2] == (2, 2) and cache[0].dtype == torch.bfloat16
    assert sum(a.numel() * a.element_size() for a in cache) > 0
    assert any("gt-feature cache: 4 images" in line for line in logs)
    want = tlpips.lpips_features(tr.lpips_params, torch.as_tensor(
        ds.images[1, 1]))
    for c, w in zip(cache, want):
        assert torch.equal(c[1, 1], w)
    batch = tr.sample_batch()
    assert len(batch["lpips_gt_feats"]) == 5
    _, metrics = tr.train_step(tr.state, batch)
    assert metrics["loss/lpips_loss"].item() > 0
    # over budget: skipped, and said so
    tc.loss.lpips_gt_cache_mb = 1
    tr = TTrainer(tc, ds, model, True, grid, out_dir=str(tmp_path / "b"),
                  log=logs.append)
    assert tr._lpips_feat_cache is None
    assert any("cache skipped" in line for line in logs)


def test_alexnet_lpips_distance_matches_jax():
    """The val metric: AlexNet LPIPS, fp32 on both sides, 64^2, the
    random-feature params carried over as numpy; 1e-4 relative."""
    rng = np.random.RandomState(0)
    params = jlpips.random_lpips_params(5, "alex")
    tparams = lpips_params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, "cpu")
    assert tlpips.infer_arch(tparams) == "alex"
    for k, v in tlpips.random_lpips_params(5, "alex", device="cpu").items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(params[k]))
    for _ in range(2):
        a = rng.uniform(0, 1, (W, H, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
        want = float(jlpips.lpips_distance(params, jnp.asarray(a),
                                           jnp.asarray(b)))
        got = tlpips.lpips_distance(tparams, torch.tensor(a), torch.tensor(b))
        np.testing.assert_allclose(got.item(), want, rtol=1e-4)
    p, mode = tlpips.resolve_lpips_params_mode("", True, seed=5, log=str,
                                               arch="alex", device="cpu")
    assert mode == "alex:random-feature"
    assert tlpips.resolve_lpips_params_mode("", False, log=str,
                                            device="cpu") == (None, "off")


def test_dump_image_round_trips_through_pil(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(1)
    img = rng.uniform(-0.1, 1.1, (13, 7, 3)).astype(np.float32)
    dump_image(img, str(tmp_path / "a" / "x.png"))
    got = np.asarray(Image.open(tmp_path / "a" / "x.png").convert("RGB"))
    np.testing.assert_array_equal(got, (np.clip(img, 0, 1) * 255).astype(
        np.uint8))
    u8 = rng.randint(0, 256, (5, 9, 3)).astype(np.uint8)
    dump_image(u8, str(tmp_path / "y.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "y.png")),
                                  u8)
    # greyscale and RGBA too (the contact evaluation's masks and photos)
    dump_image(u8[..., 0], str(tmp_path / "g.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "g.png")),
                                  u8[..., 0])
    rgba = rng.randint(0, 256, (5, 9, 4)).astype(np.uint8)
    dump_image(rgba, str(tmp_path / "r.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "r.png")),
                                  rgba)
    with pytest.raises(ValueError):
        dump_image(np.zeros((4, 4, 2)), str(tmp_path / "z.png"))


def test_prefetch_loader_keeps_order_reraises_and_joins():
    """Batches arrive in the order drawn; the thread's exception is raised
    by the next __next__ once the batches before it are taken; close()
    joins the thread, also one blocked on a full queue."""
    from manus_tpu_torch.data.prefetch import PrefetchLoader

    draws = iter(range(3))

    def sample():
        n = next(draws, None)
        if n is None:
            raise ValueError("no more")
        return n

    loader = PrefetchLoader(sample, depth=2, device="cpu")
    assert [next(loader) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="no more"):
        next(loader)
    loader.close()
    assert not loader._thread.is_alive()

    full = PrefetchLoader(lambda: 1, depth=1)
    assert next(full) == 1
    full.close()
    assert not full._thread.is_alive()
