"""The port's CLI, `python -m manus_tpu_torch.main`, on the CPU (--device
cpu): the counterparts of tests/test_cli.py's test_cli_training_artifacts,
test_cli_resume_from_run_dir, test_cli_composite and
test_cli_composite_finetune against the JAX CLI, a JAX run directory
resumed by the port, eval_contacts against the JAX CLI's, the modes
that are not ported, and validate_data and training on BRICS captures
against the JAX CLI."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import main as jmain
from manus_tpu_torch import main as tmain
from manus_tpu_torch.ops.rasterizer.api import resolve_raster_backend
from manus_tpu_torch.train import checkpoint as tck
from manus_tpu_torch.utils.io import dump_image, read_png, read_video
from tests.test_torch_brics import write_dynamic_capture, write_static_capture


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tensors here are small, and test workers
    side by side, each with a full OpenMP team, oversubscribe the CPU
    (the new port test files took 115 s under -n 5 so, 26 s with one)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

COMMON = [
    "dataset.width=64", "dataset.height=64", "dataset.num_cameras=3",
    "capacity=1024", "raster.backend=xla", "raster.max_pairs_per_tile=512",
    "model.remove_seg_end=0", "trainer.val_every=0",
]
OBJ = ["trainer.max_steps=8", "trainer.checkpoint_every=5",
       "dataset.sample_size=150"]
HAND = ["dataset.num_frames=2", "dataset.sample_size=20",
        "dataset.grid_res=24", "trainer.max_steps=8",
        "trainer.checkpoint_every=5",
        "loss.losses=[rgb_loss,ssim_loss,isotropic_reg]",
        "loss.loss_weight=[0.8,0.2,0.1]"]


@pytest.fixture(scope="module")
def cli_out(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cli"))
    tmain.main(["--device", "cpu", "--config-name", "OBJ_GAUSSIAN", *COMMON,
                *OBJ, "trainer.exp_name=obj", f"trainer.output_dir={out}"])
    tmain.main(["--device", "cpu", "--config-name", "HAND_GAUSSIAN", *COMMON,
                *HAND, "trainer.exp_name=hand", f"trainer.output_dir={out}"])
    return out


def test_cli_training_artifacts(cli_out):
    base = os.path.join(cli_out, "manus_tpu", "synthetic")
    for exp in ("obj", "hand"):
        run = os.path.join(base, exp)
        assert os.path.exists(os.path.join(run, "config.json"))
        ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
        assert [c.split("-")[0] for c in ckpts] == ["step000005",
                                                     "step000008"]
        assert os.path.exists(os.path.join(run, "logs", "train_metrics.csv"))
        assert os.path.exists(os.path.join(run, "results", "val_results.csv"))
        with open(os.path.join(run, "config.json")) as f:
            snap = json.load(f)
        assert snap["raster"]["backend"] == "xla"  # as given
        assert snap["trainer"]["project"] == "manus_tpu"
    # the final validation on held-out views: images and PLYs
    res = os.path.join(base, "hand", "results", "val_results")
    assert sorted(os.listdir(os.path.join(res, "gaussians"))) == [
        "8_0_cano.ply", "8_0_posed.ply"]
    assert len(os.listdir(os.path.join(res, "images"))) == 2


def test_cli_resume_from_run_dir(cli_out):
    """--config-name <run dir>: the snapshot supplies every override,
    checkpoint=best resolves in its checkpoints, training continues."""
    run_dir = os.path.join(cli_out, "manus_tpu", "synthetic", "obj")
    n_ckpt = len(os.listdir(os.path.join(run_dir, "checkpoints")))
    tr = tmain.main(["--device", "cpu", "--config-name", run_dir,
                     "trainer.max_steps=2", "trainer.checkpoint_every=0",
                     "checkpoint=best"])
    with open(os.path.join(run_dir, "config.json")) as f:
        snap = json.load(f)
    assert snap["dataset"]["width"] == 64
    assert snap["capacity"] == 1024
    assert snap["raster"]["backend"] == "xla"
    assert snap["trainer"]["max_steps"] == 2
    assert len(os.listdir(os.path.join(run_dir, "checkpoints"))) > n_ckpt
    # resumed: the state's step counts on from the best checkpoint's
    assert tr.state.step == 8 + 2


def test_a_jax_run_directory_resumes_in_the_port(tmp_path):
    """The JAX CLI trains (raster.backend=xla, mapped to the plain version
    on the CPU); the port's CLI resumes from its run directory and its
    best checkpoint, and the JAX CLI resumes from the port's."""
    out = str(tmp_path)
    jmain.main(["--config-name", "OBJ_GAUSSIAN", *COMMON, *OBJ,
                "trainer.exp_name=obj", f"trainer.output_dir={out}"])
    run_dir = os.path.join(out, "manus_tpu", "synthetic", "obj")
    best = tck.find_best_checkpoint(os.path.join(run_dir, "checkpoints"))
    want, _ = tck.load_raw(best)
    tr = tmain.main(["--device", "cpu", "--config-name", run_dir,
                     "trainer.max_steps=1", "checkpoint=best"])
    assert tr.cfg.raster.backend == "xla"
    assert resolve_raster_backend(tr.cfg.raster.backend, tr.device) == "torch"
    assert tr.state.step == int(want[".step"]) + 1
    ckpts = os.listdir(os.path.join(run_dir, "checkpoints"))
    assert len(ckpts) == 3
    port_ckpt = tck.find_best_checkpoint(os.path.join(run_dir, "checkpoints"))
    got, extra = tck.load_raw(port_ckpt)
    assert set(got) == set(want) and tck.GEN_STATE in extra
    np.testing.assert_array_equal(got[".model/.active"],
                                  want[".model/.active"])
    jmain.main(["--config-name", run_dir, "trainer.max_steps=1",
                f"checkpoint={port_ckpt}"])


@pytest.mark.parametrize("overrides,what", [
    (["trainer.mode=test", "dataset.worst_cases=true"], None),
    (["trainer.mode=render_path"], None),
    (["trainer.mode=make_path"], None),
    (["trainer.mode=make_pose"], None),
    (["trainer.mode=validate_data"], "data"),
    (["dataset.kind=brics_dynamic"], "data"),
    (["trainer.distributed=true"], "sharded"),
    (["trainer.data_axis=2", "trainer.batch_views=2"], "sharded"),
], ids=["test", "render_path", "make_path", "make_pose", "validate_data",
        "brics", "distributed", "mesh"])
def test_modes_not_ported_raise(overrides, what, tmp_path, request):
    """What is not ported raises NotImplementedError naming its ROADMAP
    item. The four modes of the evaluation slice (what None) raised so
    until they were ported; now each runs on cli_out's hand and returns
    what it made. The data modes (what "data") raised until the BRICS
    readers were ported; now each matches the JAX CLI on a capture. The
    multi-device runs (what "sharded") raised until parallel/ was
    ported: trainer.distributed=true outside a launcher trains alone, as
    JAX's does, and trainer.data_axis=2 starts two ranks, of which only
    the first writes the run directory."""
    argv = ["--device", "cpu", "--config-name", "HAND_GAUSSIAN", *COMMON,
            *HAND, *overrides, f"trainer.output_dir={tmp_path}"]
    if what == "sharded":
        monkeypatch = request.getfixturevalue("monkeypatch")
        monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' threads
        out = tmain.main(argv)
        if "trainer.distributed=true" in overrides:
            assert out.mesh is None and out.state.step == 8
            return
        assert out == 0
        run = os.path.join(str(tmp_path), "manus_tpu", "synthetic", "test")
        with open(os.path.join(run, "logs", "train_metrics.csv")) as f:
            steps = [row.split(",")[0] for row in f.read().splitlines()[1:]]
        assert steps == ["0", "7"]  # log_every's rows, written once
        assert len(os.listdir(os.path.join(run, "checkpoints"))) == 2
        return
    if what == "data":
        if "trainer.mode=validate_data" in overrides:
            _validate_data_matches_jax(tmp_path)
        else:
            _brics_training_matches_jax(tmp_path)
        return
    if what is not None:
        with pytest.raises(NotImplementedError, match=what):
            tmain.main(argv)
        return
    from manus_tpu_torch.utils.io import generate_camera_path

    cli_out = request.getfixturevalue("cli_out")
    ckpts = os.path.join(cli_out, "manus_tpu", "synthetic", "hand",
                         "checkpoints")
    path = generate_camera_path(str(tmp_path / "given.pkl"), 2,
                                width=64, height=64)
    camera_path = str(tmp_path / "made.pkl") if "make_path" in \
        overrides[0] else path
    out = tmain.main(argv + [f"render_ckpt_dir={ckpts}", "render_frames=2",
                             f"camera_path={camera_path}"])
    if isinstance(out, str):  # make_path, make_pose: the pkl written
        assert os.path.exists(out)
    else:
        assert len(out.frames) == 2 and os.path.exists(out.video)


def _validate_data_matches_jax(tmp_path):
    """trainer.mode=validate_data exits with JAX's error count on a clean
    static capture (0) and on one with a broken quaternion and a missing
    camera directory."""
    root = write_static_capture(str(tmp_path / "static"))
    bad = str(tmp_path / "bad")
    shutil.copytree(root, bad)
    ptxt = os.path.join(bad, "calib", "optim_params.txt")
    with open(ptxt) as f:
        rows = f.read().splitlines()
    rows[0] = " ".join(rows[0].split()[:12] + ["9.0"]
                       + rows[0].split()[13:])
    with open(ptxt, "w") as f:
        f.write("\n".join(rows))
    shutil.rmtree(os.path.join(bad, "images", "refined_seg", "cam002"))
    for capture, errors in ((root, 0), (bad, 2)):
        argv = ["--config-name", "OBJ_GAUSSIAN", "dataset.kind=brics_static",
                f"dataset.root={capture}", "trainer.mode=validate_data",
                f"trainer.output_dir={tmp_path / 'out'}"]
        rc = tmain.main(argv)
        assert rc == jmain.main(argv) == errors


def _brics_training_matches_jax(tmp_path, writer="h5py", static=True):
    """3 steps of HAND_GAUSSIAN on a dynamic capture by `writer` (two
    actions, 20 bones, 64x64 crops) and, where `static`, of OBJ_GAUSSIAN
    on a static one (lens distortion, 3 train cameras) through both CLIs:
    every step's loss within 1e-4 of JAX's."""
    dyn = write_dynamic_capture(str(tmp_path / "dynamic"), writer=writer)
    steps = ["trainer.max_steps=3", "trainer.log_every=1",
             "trainer.checkpoint_every=0", "trainer.val_every=0"]
    runs = {
        "hand": ["--config-name", "HAND_GAUSSIAN", *COMMON, *HAND, *steps,
                 "dataset.kind=brics_dynamic", f"dataset.root={dyn}"],
    }
    if static:
        root = write_static_capture(str(tmp_path / "static"))
        runs["obj"] = ["--config-name", "OBJ_GAUSSIAN", *COMMON, *OBJ,
                       *steps, "dataset.kind=brics_static",
                       f"dataset.root={root}"]
    for exp, argv in runs.items():
        losses = []
        for cli, out in ((jmain, "jax"), (tmain, "torch")):
            args = argv + [f"trainer.exp_name={exp}",
                           f"trainer.output_dir={tmp_path / out}"]
            cli.main(["--device", "cpu", *args] if cli is tmain else args)
            csv_path = os.path.join(tmp_path, out, "manus_tpu", "synthetic",
                                    exp, "logs", "train_metrics.csv")
            with open(csv_path) as f:
                rows = [line.split(",") for line in f.read().splitlines()]
            assert rows[0][:2] == ["step", "loss"]
            losses.append([float(r[1]) for r in rows[1:]])
        assert len(losses[0]) == 3
        np.testing.assert_allclose(losses[1], losses[0], atol=1e-4,
                                   err_msg=exp)


def test_brics_h5py_latest_training_matches_jax(tmp_path):
    """The hand run of the brics case on a capture in the forms of h5py's
    libver "latest": 9 cameras in creation order (dense groups), lzf
    crops."""
    _brics_training_matches_jax(tmp_path, writer="h5py_latest",
                                static=False)


@pytest.fixture(scope="module")
def touching_obj(cli_out):
    """An object checkpoint that touches the hand: the trained hand's
    gaussians, each moved by N(0, 2 mm) per axis, without its voxel grid.
    The trained object of cli_out (150 points on a 0.5 m sphere) lies
    centimetres from every hand point, so its contacts would all be 0.
    The hand is posed per frame and this copy stays at the rest pose, so
    only part of the hand is within the 4 mm threshold."""
    base = os.path.join(cli_out, "manus_tpu", "synthetic")
    src = tck.find_best_checkpoint(os.path.join(base, "hand", "checkpoints"))
    with np.load(src) as d:
        arrays = {k: d[k] for k in d.files if "/vg_" not in k}
    rng = np.random.RandomState(0)
    xyz = arrays[".model/.params/.xyz"]
    arrays[".model/.params/.xyz"] = (
        xyz + rng.normal(0, 0.002, xyz.shape)).astype(np.float32)
    out = os.path.join(base, "objc", "checkpoints")
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, "step000001-loss0.100000.npz"), **arrays)
    return out


def _composite(cli, out, exp, *overrides):
    """COMPOSITE through one package's CLI on cli_out's hand and the
    touching object. Returns the run's ours/ directory and what main
    returned (the port's CompositeRun, None from JAX's)."""
    base = os.path.join(out, "manus_tpu", "synthetic")
    argv = ["--config-name", "COMPOSITE", *COMMON, "dataset.num_frames=2",
            f"trainer.exp_name={exp}", f"trainer.output_dir={out}",
            f"hand_ckpt_dir={base}/hand/checkpoints",
            f"object_ckpt_dir={base}/objc/checkpoints", *overrides]
    if cli is tmain:
        argv = ["--device", "cpu", *argv]
    run = cli.main(argv)
    return os.path.join(base, exp, "results", "eval_results", "ours"), run


def _frames(ours):
    names = sorted(f for f in os.listdir(ours) if f.endswith(".png"))
    return names, [read_png(os.path.join(ours, n)).astype(np.int64)
                   for n in names]


def _check_frames(got_dir, want_dir, share=0.99):
    """The PNG frames of two runs: the same names, pixels within one 8-bit
    level at `share` of them (the renders agree to ~1e-4, so a value at a
    level's edge rounds either way), and within 3 levels everywhere: a
    contact colour whose LUT entry the distance conditioning flips moves
    by 0.7 x magma's largest step, 0.0067 (test_torch_composite.py)."""
    names, got = _frames(got_dir)
    want_names, want = _frames(want_dir)
    assert names == want_names and names
    for g, w in zip(got, want):
        err = np.abs(g - w)
        assert (err <= 1).mean() >= share and err.max() <= 3, err.max()


# The accumulated contacts of two frames: each frame's d01 within the
# contact tolerance of test_torch_composite.py (0.07 at the conditioning's
# worst, near d = 0; here the largest is ~2e-3, at d ~ 2 mm, where the
# bound is 2 eps / (2 d) ~ 2e-3), and on average within 1e-4.
@pytest.mark.parametrize("mode", ["results", "gt_eval", "acc_gt_eval"])
def test_composite_cli_matches_jax(mode, cli_out, touching_obj):
    """The JAX CLI and the port's composite the same pair of checkpoints
    (the npz files are interchangeable) in the same mode: the accumulated
    contacts and every frame agree. The JAX CLI's {mode}.mp4 is the
    port's {mode}.apng, whose frames are the PNGs, bit for bit."""
    want, _ = _composite(jmain, cli_out, f"jcomp_{mode}",
                         f"contact_render_type={mode}")
    got, _ = _composite(tmain, cli_out, f"tcomp_{mode}",
                        f"contact_render_type={mode}")
    acc_t = np.load(os.path.join(got, "acc_contacts.npy"))
    acc_j = np.load(os.path.join(want, "acc_contacts.npy"))
    assert acc_t.dtype == np.float32 and acc_t.shape == acc_j.shape == (1024,)
    assert np.isfinite(acc_t).all() and (acc_t >= 0).all()
    np.testing.assert_allclose(acc_t, acc_j, atol=2 * 0.07, rtol=0)
    assert np.abs(acc_t - acc_j).mean() < 1e-4
    # the same points in contact, but within rounding of the threshold
    # (JAX's beyond-threshold residue, ~1.4e-8 a frame, is not contact)
    diff = (acc_t > 0) != (acc_j > 1e-6)
    assert (np.maximum(acc_t, acc_j)[diff] < 1e-2).all()
    if mode != "acc_gt_eval":  # the clouds touch, in part
        assert 0 < (acc_t > 0).sum() < 390
    _check_frames(got, want)
    assert os.path.exists(os.path.join(want, f"{mode}.mp4"))
    pngs = sorted(f for f in os.listdir(got) if f.endswith(".png"))
    video = read_video(os.path.join(got, f"{mode}.apng"))
    assert len(video) == len(pngs)
    for name, frame in zip(pngs, video):
        np.testing.assert_array_equal(frame, read_png(os.path.join(got, name)))


def test_composite_finetune_cli_matches_jax(cli_out, touching_obj):
    """optimize_hand=true, 6 fine-tune steps on frames and views drawn in
    the JAX CLI's order, then the results frames: the fine-tuned hand's
    renders and contacts as the JAX CLI's (its Adam steps agree to
    rounding, test_torch_composite.py; six of them move a slot by at most
    a few of them, so the frames are held at 97%)."""
    args = ["optimize_hand=true", "finetune_steps=6"]
    want, _ = _composite(jmain, cli_out, "jcompft", *args)
    got, _ = _composite(tmain, cli_out, "tcompft", *args)
    acc_t = np.load(os.path.join(got, "acc_contacts.npy"))
    acc_j = np.load(os.path.join(want, "acc_contacts.npy"))
    np.testing.assert_allclose(acc_t, acc_j, atol=2 * 0.07, rtol=0)
    assert np.abs(acc_t - acc_j).mean() < 1e-3
    _check_frames(got, want, share=0.97)


def test_finetune_object_cli_run(cli_out, touching_obj):
    """optimize_object=true through the port's CLI, which returns its
    CompositeRun: 12 fine-tune losses, the nocs frames, and a fine-tuned
    object whose composite loss over every (frame, view) of the scene is
    below the loaded object's (each loss from a step on a fresh state,
    taken before its update)."""
    from manus_tpu_torch.config import composite_config
    from manus_tpu_torch.train.composite import make_composite_finetune_step
    from manus_tpu_torch.train.workloads import (
        init_train_state,
        make_raster_config,
    )
    from manus_tpu_torch.utils.camera import index_camera

    ours, run = _composite(tmain, cli_out, "tcompft_obj",
                           "optimize_object=true", "finetune_steps=12",
                           "contact_render_type=nocs")
    assert len(run.finetune_loss) == 12
    assert all(np.isfinite(run.finetune_loss))
    assert run.frames == [0, 1] and len(run.frame_s) == 2
    names, frames = _frames(ours)
    assert names == ["0000.png", "0001.png"]
    assert frames[0].shape == (64, 3 * 64, 3)

    cfg = composite_config()
    tmain.apply_overrides(cfg, [*COMMON, "dataset.num_frames=2"])
    ds = tmain.build_dataset(cfg, "test", "cpu")
    raster = make_raster_config(cfg)._replace(backend="torch")
    step = make_composite_finetune_step(cfg, raster, "object",
                                        voxel_grid=run.models.voxel_grid)
    loaded, _ = tmain._load_model(touching_obj, "cpu")

    def loss(obj):
        out = []
        for f in range(ds.num_frames):
            for v in range(ds.num_views):
                raw = ds.get_batch(f, np.asarray([v]))
                batch = dict(
                    rgb=torch.as_tensor(raw["rgb"][0]),
                    mask=torch.as_tensor(raw["mask"][0], dtype=torch.float32),
                    camera=index_camera(ds.cameras, v), bg=torch.zeros(3),
                    bone_tf=tmain._bone_tf(ds, f, run.models.voxel_grid))
                _, m = step(init_train_state(obj), run.models.hand, batch)
                out.append(float(m["loss"]))
        return np.mean(out)

    assert loss(run.models.obj) < loss(loaded)


def test_acc_gt_eval_renders_the_saved_contacts(cli_out, touching_obj,
                                                capsys):
    """acc_gt_eval after a gt_eval run of the same experiment renders that
    run's accumulated contacts, as the reference does; the JAX CLI renders
    zeros there (ROADMAP Queue C), as the port does without a saved map,
    saying so on stdout."""
    ours, _ = _composite(tmain, cli_out, "tacc",
                         "contact_render_type=gt_eval")
    saved = np.load(os.path.join(ours, "acc_contacts.npy"))
    capsys.readouterr()
    _composite(tmain, cli_out, "tacc", "contact_render_type=acc_gt_eval")
    assert "WARNING" not in capsys.readouterr().out
    np.testing.assert_array_equal(
        np.load(os.path.join(ours, "acc_contacts.npy")), saved)
    _, frames = _frames(ours)
    assert frames[0].shape == (64, 128, 3)
    assert frames[0][:, 64:].max() > 0  # the contact panel is not black
    _, zero = _frames(_composite(tmain, cli_out, "tacc0",
                                 "contact_render_type=acc_gt_eval")[0])
    assert "acc_gt_eval found no" in capsys.readouterr().out
    assert zero[0][:, 64:].max() == 0


def test_acc_gt_eval_saved_contacts_match_jax(cli_out, touching_obj,
                                              monkeypatch):
    """The port's acc_gt_eval rendering a gt_eval run's saved contacts
    against the JAX CLI's acc_gt_eval whose composite render is given the
    same map in place of its zeros: the same frames (_check_frames) and
    the map saved back unchanged by both."""
    from manus_tpu.train import composite as jcomp

    got, _ = _composite(tmain, cli_out, "taccj",
                        "contact_render_type=gt_eval")
    saved = np.load(os.path.join(got, "acc_contacts.npy"))
    assert (saved > 0).any()
    _composite(tmain, cli_out, "taccj", "contact_render_type=acc_gt_eval")
    assert _frames(got)[1][0][:, 64:].max() > 0  # the contact panel is lit
    make = jcomp.make_composite_render

    def given_saved(*args, **kwargs):
        render = make(*args, **kwargs)
        return lambda models, bone_tf, cam, cano, bg, acc, aux: render(
            models, bone_tf, cam, cano, bg, saved, aux)

    monkeypatch.setattr(jcomp, "make_composite_render", given_saved)
    want, _ = _composite(jmain, cli_out, "jaccj",
                         "contact_render_type=acc_gt_eval")
    for d in (got, want):
        np.testing.assert_array_equal(
            np.load(os.path.join(d, "acc_contacts.npy")), saved)
    _check_frames(got, want)


def _gt_from_acc_gt_eval(ours, gt_dir):
    """Ground truth from an acc_gt_eval run's own frames: the contact
    panel above 0.5 as the mask, the skin panel as the photo with the
    hand's silhouette (any lit pixel) as alpha."""
    for d in ("gt_contacts_seg", "gt_contacts"):
        os.makedirs(os.path.join(gt_dir, d), exist_ok=True)
    names, frames = _frames(ours)
    for name, fr in zip(names, frames):
        w = fr.shape[1] // 2
        skin, contact = fr[:, :w].astype(np.uint8), fr[:, w:]
        seg = (contact.mean(-1) > 127.5).astype(np.uint8) * 255
        alpha = (skin.max(-1) > 0).astype(np.uint8) * 255
        dump_image(seg, os.path.join(gt_dir, "gt_contacts_seg", name))
        dump_image(np.dstack([skin, alpha]),
                   os.path.join(gt_dir, "gt_contacts", name))


def test_eval_contacts_cli_matches_jax(cli_out, touching_obj):
    """trainer.mode=eval_contacts through both CLIs on copies of one
    acc_gt_eval run (after a gt_eval run, so the contact panel is lit)
    with a mano baseline beside it: the same eval_metric.csv and collage;
    "ours" scores 1 against ground truth made from its own frames."""
    base = os.path.join(cli_out, "manus_tpu", "synthetic")
    _composite(tmain, cli_out, "teval", "contact_render_type=gt_eval")
    ours, _ = _composite(tmain, cli_out, "teval",
                      "contact_render_type=acc_gt_eval")
    gt_dir = os.path.join(cli_out, "gt")
    _gt_from_acc_gt_eval(ours, gt_dir)
    res = os.path.dirname(ours)
    mano = os.path.join(res, "mano", "acc_eval_rendered")
    os.makedirs(mano)
    for name in os.listdir(os.path.join(gt_dir, "gt_contacts_seg")):
        seg = read_png(os.path.join(gt_dir, "gt_contacts_seg", name), "gray")
        dump_image(np.where(np.arange(seg.shape[1]) < seg.shape[1] // 2,
                            seg, 0).astype(np.uint8),
                   os.path.join(mano, name))
    shutil.copytree(os.path.join(base, "teval"), os.path.join(base, "jeval"))
    outs = {}
    for cli, exp in ((tmain, "teval"), (jmain, "jeval")):
        argv = ["--config-name", "COMPOSITE", "trainer.mode=eval_contacts",
                f"trainer.exp_name={exp}", f"trainer.output_dir={cli_out}",
                f"gt_contact_dir={gt_dir}"]
        got = cli.main(["--device", "cpu", *argv] if cli is tmain else argv)
        rdir = os.path.join(base, exp, "results", "eval_results")
        with open(os.path.join(rdir, "eval_metric.csv")) as f:
            table = f.read()
        outs[exp] = (got, table,
                     read_png(os.path.join(rdir, "eval_collage.png")))
    scores, table, collage = outs["teval"]
    assert scores == {"ours": {"iou": 1.0, "f1": 1.0},
                      "mano": scores["mano"]}
    assert 0 < scores["mano"]["iou"] < 1
    assert table == outs["jeval"][1]
    np.testing.assert_array_equal(collage, outs["jeval"][2])


def test_cli_runs_on_cuda_by_default(monkeypatch, tmp_path):
    """No --device: the card, and a RuntimeError where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["--config-name", "OBJ_GAUSSIAN",
                    f"trainer.output_dir={tmp_path}"])
    assert not any(tmp_path.iterdir())


def test_debug_mode_runs_one_step(tmp_path):
    """trainer.mode=debug (the reference's fast_dev_run): one step, no
    validation or checkpoint cadence, the final checkpoint at step 1."""
    tr = tmain.main(["--device", "cpu", "--config-name", "OBJ_GAUSSIAN",
                     *COMMON, *OBJ, "trainer.mode=debug",
                     "trainer.exp_name=dbg", f"trainer.output_dir={tmp_path}"])
    assert tr.state.step == 1
    ckpts = os.listdir(os.path.join(tr.out_dir, "checkpoints"))
    assert [c.split("-")[0] for c in ckpts] == ["step000001"]


def test_wandb_logger_without_the_package(monkeypatch, tmp_path):
    """loggers=[wandb, jsonl] where wandb cannot be imported: said once,
    and the jsonl stream is written (the JAX package's behaviour)."""
    import sys

    from manus_tpu_torch.train.trainer import ScalarLoggers

    monkeypatch.setitem(sys.modules, "wandb", None)
    said = []
    loggers = ScalarLoggers(("csv", "wandb", "jsonl"), str(tmp_path), "run",
                            {}, log=said.append)
    loggers.log_scalars(3, {"loss": 0.5})
    loggers.close()
    assert loggers.wandb is None and len(said) == 1
    assert "wandb unavailable" in said[0]
    with open(tmp_path / "logs" / "events.jsonl") as f:
        assert json.loads(f.read()) == {"step": 3, "loss": 0.5}
