"""Shared pieces of the benchmark's own tests: the repository on the
path, the cells shrunk to a size the CPU runs in seconds, and the card
fixture of the tests marked `cuda`."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every cell at 64x48, 4 cameras, 2 frames, 4,096 slots: the same code
# paths as the measured size, small enough for the CPU
TINY = {"dataset.width": 64, "dataset.height": 48, "dataset.num_cameras": 4,
        "dataset.num_frames": 2, "dataset.sample_size": 60, "capacity": 4096,
        "dataset.grid_res": 24}
# the hand cells read every view through get_batch: keep the image cache
# off at this size too
TINY_HAND = dict(TINY, **{"trainer.device_cache_mb": 0})


def tiny(workload: str) -> dict:
    return TINY if workload.startswith("composite") else TINY_HAND


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return "cuda"
