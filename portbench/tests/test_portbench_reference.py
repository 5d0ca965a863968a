"""The plain references agree with the port's own plain path (its
`torch` backend, which the port runs on the CPU) on a tiny scene, and
the faults of portbench/faults.py make `correct` false."""
import pytest

from portbench import faults
from portbench import run as run_mod
from portbench.registry import Registry
from portbench.tests.conftest import tiny

SEED = 2**31 + 11


def _compared(workload, seed=SEED, seconds=0.3):
    line = run_mod.run_cell(Registry(), workload, seed, seconds, False,
                            device="cpu", scale=tiny(workload))
    return line, {k: c["value"] for k, c in line["compared"].items()}


@pytest.mark.parametrize("seed", [SEED, 5])
def test_the_training_reference_follows_the_port_step_for_step(seed):
    line, got = _compared("hand_lpips", seed)
    assert line["correct"]
    # the same float32 arithmetic: equal but for the bf16 LPIPS chain's
    # rounding in another order
    assert got["loss"] < 1e-5 and got["grad"] < 1e-4 and got["change"] < 1e-4
    # the densify event: the same slots, and the same rows to rounding
    assert got["densify_slots"] == 0 and got["densify_state"] < 1e-6


def test_the_contact_reference_agrees_with_the_port():
    line, got = _compared("composite_gt_eval")
    assert line["correct"]
    # float32 nearest distances against float64: ~1e-9 m^2 on d^2
    assert got["contact"] < 0.02 and got["acc"] < 0.02
    assert got["panels"] < 0.005


def test_a_window_longer_than_a_pass_goes_on_in_a_second_pass(monkeypatch):
    traffic = Registry.traffic

    def short(self, name):
        return dict(traffic(self, name), frames=5)

    monkeypatch.setattr(Registry, "traffic", short)
    line, got = _compared("composite_gt_eval", seconds=3.0)
    assert line["attempted"] > 5
    assert line["correct"], got


@pytest.mark.parametrize("workload,fault", [
    ("hand_lpips", "unchanged"), ("hand_lpips", "half_batch"),
    ("hand_lpips", "altered"), ("hand_lpips", "densify_skipped"),
    ("composite_gt_eval", "altered"),
    ("composite_gt_eval", "search_half"),
    ("composite_gt_eval", "contact_altered"),
    ("composite_gt_eval", "acc_unchanged")])
def test_a_fault_under_the_measured_path_is_not_correct(workload, fault):
    with faults.FAULTS[fault]():
        line, _ = _compared(workload)
    assert not line["correct"]
