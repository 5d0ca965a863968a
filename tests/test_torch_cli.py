"""The port's training CLI, `python -m manus_tpu_torch.main`, on the CPU
(--device cpu): the counterparts of tests/test_cli.py's
test_cli_training_artifacts and test_cli_resume_from_run_dir, a JAX run
directory resumed by the port, and the modes that are not ported."""
import json
import os

import numpy as np
import pytest
import torch

import main as jmain
from manus_tpu_torch import main as tmain
from manus_tpu_torch.train import checkpoint as tck


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
    assert tr.cfg.raster.backend == "torch"
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
    (["trainer.mode=test"], "A6"),
    (["trainer.mode=render_path"], "A6"),
    (["trainer.mode=make_path"], "A6"),
    (["trainer.mode=eval_contacts"], "A5"),
    (["trainer.mode=make_pose"], "A7"),
    (["trainer.mode=validate_data"], "A7"),
    (["dataset.kind=brics_dynamic"], "A7"),
    (["trainer.distributed=true"], "A8"),
    (["trainer.data_axis=2", "trainer.batch_views=2"], "item 8"),
], ids=["test", "render_path", "make_path", "eval_contacts", "make_pose",
        "validate_data", "brics", "distributed", "mesh"])
def test_modes_not_ported_raise(overrides, what, tmp_path):
    with pytest.raises(NotImplementedError, match=what):
        tmain.main(["--device", "cpu", "--config-name", "HAND_GAUSSIAN",
                    *COMMON, *HAND, *overrides,
                    f"trainer.output_dir={tmp_path}"])


def test_composite_workload_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="A5"):
        tmain.main(["--device", "cpu", "--config-name", "COMPOSITE",
                    f"trainer.output_dir={tmp_path}"])
    assert not any(tmp_path.iterdir())


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
