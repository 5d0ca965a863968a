"""The conv kernel's plan per layer (manus_tpu_torch.ops.conv.conv_plan).

The plan is pure Python, so these run without a card: for the five stage
layouts of the VGG16 at 512x512 (the conv and, with the channels
swapped, its dx, for each stage's layers) and for the conv shapes of tests/test_torch_cuda.py, the
working row tiles cover every pixel row exactly once, the split divides
the K-chunks with none lost, the workspace and the grid match, the small
stages fill the card without passing one wave, and 16 channels take the
narrow path. On small shapes the conv, computed in plain PyTorch in the
order the kernel schedules it under the plan, equals the plain version.
"""
import numpy as np
import pytest
import torch

from manus_tpu_torch.ops import conv
from manus_tpu_torch.train import lpips

# (stage, ci, co) of the VGG16's distinct layer shapes, padded channels.
VGG_LAYERS = [(0, 16, 64), (0, 64, 64), (1, 64, 128), (1, 128, 128),
              (2, 128, 256), (2, 256, 256), (3, 256, 512), (3, 512, 512),
              (4, 512, 512)]
# tests/test_torch_cuda.py CONV_CASES, and its new shapes.
CONV_CASES = [(13, 9, 3, 64), (16, 16, 64, 128), (45, 45, 16, 8),
              (7, 4, 4, 4), (64, 64, 256, 512), (32, 32, 512, 512),
              (20, 12, 16, 32), (40, 40, 128, 256)]


def _pad16(c):
    return -(-c // 16) * 16


def _check_plan(L, ci, co):
    plan = conv.conv_plan(L, ci, co)
    # tiles: disjoint, inside the layout, covering each pixel row once
    covered = np.zeros(L.rows, np.int64)
    for r0, r1 in conv.plan_row_tiles(L, plan):
        assert 0 <= r0 < r1 <= L.rows and r1 - r0 <= plan.bm
        covered[r0:r1] += 1
    valid = conv.valid_rows(L, "cpu").numpy()
    assert (covered[valid] == 1).all() and covered.max() == 1
    assert len(conv.plan_row_tiles(L, plan)) == plan.m_tiles
    # channels and K
    assert co % plan.bn == 0 and plan.n_tiles * plan.bn == co
    assert ci % plan.kc == 0 and plan.chunks * plan.kc == 3 * ci
    assert plan.chunks % plan.split_k == 0
    assert plan.split_k * (plan.chunks // plan.split_k) == plan.chunks
    assert plan.split_k == 1 \
        or plan.chunks // plan.split_k >= conv.MIN_CHUNKS_PER_SPLIT
    # grid and workspace
    assert plan.grid == plan.m_tiles * plan.n_tiles * plan.split_k
    want_ws = plan.split_k * plan.m_tiles * plan.bm * co \
        if plan.split_k > 1 else 0
    assert plan.workspace == want_ws
    # the narrow path
    assert plan.kc == (64 if ci % 64 == 0 else 16)
    if ci == 16:
        assert plan.kc == 16
    if co % 64:
        assert plan.bn == 16
    return plan


@pytest.mark.parametrize("dx", [False, True], ids=["conv", "dx"])
@pytest.mark.parametrize("si,ci,co", VGG_LAYERS,
                         ids=[f"s{s}_{a}_{b}" for s, a, b in VGG_LAYERS])
def test_plan_of_vgg_layers_at_512(si, ci, co, dx):
    L = lpips._vgg_stage_layouts(512, 512)[si]
    k_in, n_out = (co, ci) if dx else (ci, co)
    plan = _check_plan(L, k_in, n_out)
    if si >= 3:
        # Measured on an H100 (scripts/torch_conv_tune.py): one CTA an SM
        # beats two waves of shorter split-K CTAs, so the small stages
        # fill three quarters of the SMs or more and stay within one wave.
        assert 0.75 * conv.SM_COUNT <= plan.grid <= conv.SM_COUNT
    if si == 4:
        assert plan.split_k > 1
    if si <= 1:
        assert plan.split_k == 1


@pytest.mark.parametrize("h,w,ci,co", CONV_CASES)
def test_plan_of_test_shapes(h, w, ci, co):
    cip, cop = _pad16(ci), _pad16(co)
    L = conv.StageLayout(h, w, max(ci, co, 128))
    _check_plan(L, cip, cop)
    _check_plan(L, cop, cip)


def test_plan_rejects_unpadded_channels():
    L = conv.StageLayout(8, 8, 128)
    with pytest.raises(ValueError, match="multiples of 16"):
        conv.conv_plan(L, 8, 64)
    with pytest.raises(ValueError, match="multiples of 16"):
        conv.conv_plan(L, 64, 24)


# Shapes small enough for the CPU whose plans split K (few tiles), use the
# narrow path, several channel tiles, or a ragged last row tile.
SCHEDULE_CASES = [(13, 9, 3, 64), (16, 16, 64, 128), (7, 4, 4, 4),
                  (20, 12, 16, 32), (12, 10, 128, 512)]


@pytest.mark.parametrize("h,w,ci,co", SCHEDULE_CASES)
def test_planned_schedule_computes_the_conv(h, w, ci, co):
    """The conv and the dx in the kernel's order under the plan against
    the plain version: the same bf16 values but for one-ulp roundings of
    an fp32 sum taken in another order (2^-7 relative, 1e-3 of the
    largest value for a ReLU output within rounding of 0)."""
    rng = np.random.RandomState(h * 100 + co)
    L = conv.StageLayout(h, w, max(ci, co, 128))
    x = torch.tensor(rng.normal(size=(h, w, ci)).astype(np.float32))
    wk = torch.tensor((rng.normal(size=(3, 3, ci, co))
                       * (2.0 / (9 * ci)) ** 0.5).astype(np.float32))
    b = torch.tensor(rng.normal(size=(co,)).astype(np.float32) * 0.1)
    p = conv.pack_conv3x3(wk, b)
    xl = conv.build_layout(x, L)

    def close(got, want):
        got, want = got.float(), want.float()
        limit = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) \
            + 1e-3 * want.abs().max()
        assert bool(((got - want).abs() <= limit).all())
        assert ((got - want).abs() > 0).float().mean().item() <= 0.01

    plan = conv.conv_plan(L, p.ci, p.co)
    y = conv.conv3x3_layout_torch(xl, p.w, p.b, True, L)
    close(conv.conv3x3_layout_plan_torch(xl, p.w, p.b, True, L, plan), y)
    g = torch.tensor(rng.normal(size=(L.rows, p.co)).astype(np.float32)
                     ).to(torch.bfloat16)
    plan_dx = conv.conv_plan(L, p.co, p.ci)
    want = conv.conv3x3_layout_torch(g, p.w_t, None, False, L, mask_by=y)
    close(conv.conv3x3_layout_plan_torch(g, p.w_t, None, False, L, plan_dx,
                                         mask_by=y), want)
    if (ci, co) == (128, 512):
        assert plan.split_k > 1 and plan_dx.split_k > 1
