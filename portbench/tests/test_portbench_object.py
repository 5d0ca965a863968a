"""The object cell on the CPU at a tiny size: a sound run is correct, the
faults are not, a program without the trace counters ends the run at
once, and the new readers read nothing where there is nothing to read."""
import pytest

from portbench import object_limits
from portbench import run as run_mod
from portbench.drivers import object_train
from portbench.registry import Registry

SCALE = {"dataset.width": 96, "dataset.height": 64,
         "dataset.num_cameras": 3, "dataset.sample_size": 1000,
         "capacity": 4096}
SEED = 2**31 + 31


def _line(trace=False):
    return run_mod.run_cell(Registry(), "object_growth", SEED, 0.3, trace,
                            device="cpu", scale=SCALE)


def test_a_sound_run_is_correct_and_reads_no_drop():
    line = _line(trace=True)
    assert line["correct"], line["compared"]
    assert "init" in line["compared"]
    assert line["metrics"]["raster.pair_drop_share"]["value"] == 0.0
    # the CPU has no device trace: the device readings read nothing
    assert "raster.bin_share" not in line["metrics"]


@pytest.mark.parametrize("fault", ["half_batch", "altered",
                                   "densify_skipped", "init_neighbours"])
def test_a_fault_is_not_correct(fault):
    with object_limits.FAULTS[fault]():
        assert not _line()["correct"]


def test_a_program_without_counters_ends_the_run(monkeypatch):
    from manus_tpu_torch.utils import trace

    monkeypatch.delattr(trace, "count")
    with pytest.raises(RuntimeError, match="trace counters"):
        object_train.run(None)


def test_the_new_readers_read_nothing_without_their_inputs():
    reg = Registry()
    for name in ("raster.bin_share", "raster.pair_drop_share",
                 "densify.event_ms"):
        assert reg.metric_reader(name).read({}) is None
    read = reg.metric_reader("raster.pair_drop_share").read
    assert read({"stretch_counts": {"raster.pairs_emitted": 400.0,
                                    "raster.pairs_dropped": 3.0}}) == 0.75
