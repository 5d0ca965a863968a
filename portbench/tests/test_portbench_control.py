"""The control: the reference in the program's place at the next
precision below the configuration's (TF32 in its float32 matmuls and
convolutions) comes out as not correct. On the card only: TF32 is an
NVIDIA tensor-core format. At a size a test run can hold; the readings
at the cells' own size come from `python3 portbench/check_limits.py
--control`."""
import numpy as np
import pytest

from portbench import run as run_mod
from portbench.registry import Registry

SMALL = {"dataset.width": 320, "dataset.height": 192,
         "dataset.num_cameras": 8, "dataset.num_frames": 2,
         "dataset.sample_size": 600, "capacity": 32768,
         "dataset.grid_res": 64}


def _batches(common, cfg, inputs, seed, n):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = rng.randint(0, cfg["dataset"]["num_frames"])
        v = int(rng.randint(0, cfg["dataset"]["num_cameras"]))
        out.append((f, v, *common.decode(inputs["images"][f, v])))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["hand_lpips"])
def test_the_hand_control_is_not_correct(card, workload):
    from portbench.drivers import common
    from portbench.reference import hand_step as ref

    reg = Registry()
    w = reg.workload(workload)
    cfg = common.config_as_run(reg.config(w["config"]),
                               reg.traffic(w["traffic"]), SMALL)
    lpips = "lpips_loss" in cfg["loss"]["losses"]
    scene = reg.config(w["config"])["scene"]
    limits = run_mod.limits_for(workload)
    for seed in (1, 2, 3):
        inputs = common.build_inputs(cfg, scene, seed, card, images=True,
                                     vgg=lpips)
        batches = _batches(common, cfg, inputs, seed, 3)
        want = ref.run_steps(cfg, inputs, batches, inputs["vgg"], card)
        got = ref.run_steps(cfg, inputs, batches, inputs["vgg"], card,
                            tf32=True)
        gaps = common.compare(got, want, inputs["init"])
        assert any(gaps[k] > limits[k] for k in gaps), gaps


@pytest.mark.cuda
def test_the_contact_control_is_not_correct(card):
    from portbench import check_limits

    limits = run_mod.limits_for("composite_gt_eval")
    for seed in (1, 2, 3):
        got = check_limits.composite_control_reading(
            Registry(), "composite_gt_eval", seed)
        assert got["contact"] > limits["contact"], got
