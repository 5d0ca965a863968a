"""The contact search kernel's host side (manus_tpu_torch.ops.knn):
its plan of reference slices, and the dispatch of nearest_neighbor.

The plan is pure Python, so these run without a card: one slice where the
query blocks alone fill the card (the voxel grid's ~2M cells against 20
keypoints or MANO's 778 vertices) or the references are few, several at
the composite's 131,072 x 131,072, and in every case a grid that stays
within the CTAs an H100 holds at once and that one more slice would
overflow, with slices that cover each reference once. The kernel itself
runs only on a card (tests/test_torch_cuda.py).
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from manus_tpu_torch.ops import knn

ROOT = pathlib.Path(__file__).resolve().parents[1]
H100_SMS = 132
SLOTS = H100_SMS * knn.KNN_CTAS_PER_SM

# (n, m): the composite's search both ways, the voxel grid's cells
# against keypoints and against MANO's vertices at grid_res 128 and 96,
# tests/test_torch_cuda.py's shapes, and a few ragged ones.
PLAN_CASES = [(131072, 131072), (2097152, 20), (2097152, 778), (884736, 20),
              (1, 1), (31, 31), (1000, 1000), (4097, 4097), (131072, 4000),
              (65536, 131072), (3000, 4000), (5, 200000), (262145, 7)]


@pytest.mark.parametrize("n,m", PLAN_CASES,
                         ids=[f"{n}x{m}" for n, m in PLAN_CASES])
def test_plan_fills_the_card_and_covers_every_reference(n, m):
    plan = knn.knn_plan(n, m, H100_SMS)
    assert plan.query_blocks == -(-n // knn.KNN_BLOCK_QUERIES)
    assert plan.query_blocks * knn.KNN_BLOCK_QUERIES >= n
    # the slices: each non-empty, together every reference
    assert plan.slices >= 1
    assert (plan.slices - 1) * plan.slice_len < m <= plan.slices * plan.slice_len
    assert plan.slices == 1 or plan.slice_len >= knn.KNN_MIN_SLICE
    # the grid: within the CTAs the card holds at once when sliced, and
    # one slice more would pass them or leave a slice under
    # KNN_MIN_SLICE references
    if plan.slices > 1:
        assert plan.ctas <= SLOTS
    assert plan.query_blocks * (plan.slices + 1) > SLOTS \
        or (plan.slices + 1) * knn.KNN_MIN_SLICE > m


def test_plan_at_the_composite_and_the_voxel_grid():
    comp = knn.knn_plan(131072, 131072, H100_SMS)
    assert comp.slices > 1 and comp.query_blocks == 64
    assert SLOTS - comp.query_blocks < comp.ctas <= SLOTS
    # the voxel grid at grid_res 128: its 2,097,152 cells are 1,024 query
    # blocks, past the CTAs the card holds at once
    for m in (20, 778):
        vox = knn.knn_plan(128 ** 3, m, H100_SMS)
        assert vox.slices == 1 and vox.ctas == 1024
    # few references: one slice whatever the queries
    assert knn.knn_plan(1000, 20, H100_SMS).slices == 1


def test_plan_follows_the_sm_count():
    """The plan reads the SM count it is given and nothing else."""
    small = knn.knn_plan(131072, 131072, 66)
    large = knn.knn_plan(131072, 131072, 264)
    assert small.slices < knn.knn_plan(131072, 131072, H100_SMS).slices \
        < large.slices
    assert knn.knn_plan(131072, 131072) == knn.knn_plan(131072, 131072,
                                                        H100_SMS)


@pytest.mark.parametrize("n,m", [(0, 5), (5, 0)])
def test_plan_refuses_empty_sides(n, m):
    with pytest.raises(ValueError, match="points on both sides"):
        knn.knn_plan(n, m)


def test_importing_knn_builds_nothing():
    """Importing ops/knn.py and ops/contacts.py, and a search on CPU
    tensors, neither builds nor loads a library."""
    code = (
        "import manus_tpu_torch.utils.cuda_build as cb\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a library was built or loaded')\n"
        "cb.build = cb.load = refuse\n"
        "import torch\n"
        "import manus_tpu_torch.ops.knn as knn\n"
        "import manus_tpu_torch.ops.contacts as contacts\n"
        "x = torch.rand(50, 3)\n"
        "d, i = contacts.nearest_neighbor(x, x[:20])\n"
        "assert i.dtype == torch.int32 and knn.nearest_neighbor_cuda.launches == 0\n"
        "assert not cb._loaded\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_cpu_tensors_take_the_plain_path():
    """nearest_neighbor on CPU tensors is nearest_neighbor_torch, bit for
    bit, with and without a mask, and launches no kernel."""
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.uniform(-0.2, 0.3, (3000, 3)).astype(np.float32))
    y = torch.tensor(rng.uniform(-0.2, 0.3, (1500, 3)).astype(np.float32))
    valid = torch.tensor(rng.rand(1500) > 0.3)
    before = knn.nearest_neighbor_cuda.launches
    for pv in (None, valid):
        d, i = knn.nearest_neighbor(x, y, pt2_valid=pv)
        d_t, i_t = knn.nearest_neighbor_torch(x, y, pt2_valid=pv)
        assert torch.equal(d, d_t) and torch.equal(i, i_t)
        assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert knn.nearest_neighbor_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        knn.nearest_neighbor_cuda(x, x)
