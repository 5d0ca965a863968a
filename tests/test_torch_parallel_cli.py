"""The port's training CLI as two processes (trainer.distributed=true,
gloo, --device cpu): each joins the process group as one rank of a
data_axis=2 mesh. Both ranks must log the same losses, load disjoint
views that cover each batch, and leave the run directory as one process
would (only rank 0 writes); the losses must equal a single-process run's
on the same batches (the data axis splits the views of one function)."""
import os
import re
import socket
import subprocess
import sys

import numpy as np

from manus_tpu_torch import main as tmain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2
ARGS = [
    "--device", "cpu", "--config-name", "HAND_GAUSSIAN",
    "dataset.width=64", "dataset.height=64", "dataset.num_cameras=3",
    "capacity=1024", "raster.backend=xla", "raster.max_pairs_per_tile=512",
    "model.remove_seg_end=0", "trainer.val_every=0", "dataset.num_frames=2",
    "dataset.sample_size=20", "dataset.grid_res=24",
    f"trainer.max_steps={STEPS}", "trainer.checkpoint_every=0",
    "trainer.log_every=1", "trainer.batch_views=4",
    "loss.losses=[rgb_loss,ssim_loss,isotropic_reg]",
    "loss.loss_weight=[0.8,0.2,0.1]",
]
LOSS = re.compile(r"step (\d+): loss=([0-9.]+)")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_cli(tmp_path):
    port = _free_port()
    out = str(tmp_path / "two")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "manus_tpu_torch.main", *ARGS,
         "trainer.data_axis=2", "trainer.distributed=true",
         f"trainer.coordinator=localhost:{port}", "trainer.num_processes=2",
         f"trainer.process_id={r}", f"trainer.output_dir={out}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env=env) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)

    losses = [dict(LOSS.findall(log)) for log in logs]
    assert len(losses[0]) == STEPS and losses[0] == losses[1]
    views = [re.search(r"loads views \[([0-9, ]+)\] of each batch of 4",
                       log).group(1) for log in logs]
    views = [[int(v) for v in vs.split(",")] for vs in views]
    assert views == [[0, 1], [2, 3]]
    assert "backend gloo" in logs[0] and "rank 1/2" in logs[1]

    run = os.path.join(out, "manus_tpu", "synthetic", "test")
    with open(os.path.join(run, "logs", "train_metrics.csv")) as f:
        rows = f.read().splitlines()[1:]
    assert [r.split(",")[0] for r in rows] == [str(s) for s in range(STEPS)]
    assert len(os.listdir(os.path.join(run, "checkpoints"))) == 1
    assert sorted(os.listdir(os.path.join(run, "results", "val_results",
                                          "gaussians"))) == [
        f"{STEPS}_0_cano.ply", f"{STEPS}_0_posed.ply"]

    one = tmain.main([*ARGS, f"trainer.output_dir={tmp_path / 'one'}"])
    with open(os.path.join(one.out_dir, "logs", "train_metrics.csv")) as f:
        want = [float(r.split(",")[1]) for r in f.read().splitlines()[1:]]
    got = [float(r.split(",")[1]) for r in rows]
    np.testing.assert_allclose(got, want, rtol=1e-5)
