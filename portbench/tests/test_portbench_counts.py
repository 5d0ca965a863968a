"""The counts the shares divide by."""
import math

import pytest
import torch

from portbench.counts import composite as ccount
from portbench.counts import peaks, vgg16


def test_vgg16_is_305856_multiply_adds_a_pixel():
    assert vgg16.NUM_CONVS == 13
    assert vgg16.macs_per_pixel() == 305856


@pytest.mark.parametrize("h,w", [(720, 1280), (512, 512), (64, 48)])
def test_vgg16_chain_scales_each_stage_by_its_pooled_size(h, w):
    per_stage = [sum(9 * ci * co for ci, co in st) for st in vgg16.STAGES]
    want = sum(2 * m * (h >> s) * (w >> s) for s, m in enumerate(per_stage))
    assert vgg16.chain_flops(h, w) == want
    if h % 16 == 0 and w % 16 == 0:
        assert vgg16.chain_flops(h, w) == 2 * 305856 * h * w


def test_a_1280x720_lpips_step_is_about_1_13_tflop():
    assert 2 * vgg16.chain_flops(720, 1280) == pytest.approx(1.128e12,
                                                             rel=1e-3)


def test_least_time_is_the_larger_bound():
    assert peaks.least_s(flops=67e12) == pytest.approx(1.0)
    assert peaks.least_s(nbytes=3.35e12) == pytest.approx(1.0)
    assert peaks.least_s(flops=1.0, nbytes=3.35e12) == pytest.approx(1.0)


def _walk_one_pixel(payload, off, cnt, x, y):
    """Evaluations of one pixel, pair by pair."""
    log_t, n = 0.0, 0
    for j in range(off, off + cnt):
        if log_t < math.log(ccount.T_EPS):
            break
        n += 1
        mx, my, a, b, c, op = payload[:6, j].tolist()
        dx, dy = x - mx, y - my
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = min(op * math.exp(power), ccount.ALPHA_MAX)
        if power <= 0 and alpha >= ccount.ALPHA_EPS:
            log_t += math.log1p(-alpha)
    return n


def test_walk_counts_match_a_pixel_by_pixel_walk():
    g = torch.Generator().manual_seed(0)
    ntx, nty, per_tile = 2, 2, 40
    t = ntx * nty
    p = t * per_tile
    payload = torch.zeros(16, p)
    tiles = torch.arange(p) // per_tile
    payload[0] = (tiles % ntx) * 16 + torch.rand(p, generator=g) * 16
    payload[1] = (tiles // ntx) * 16 + torch.rand(p, generator=g) * 16
    payload[2] = payload[4] = 0.02 + 0.05 * torch.rand(p, generator=g)
    payload[5] = 0.3 + 0.69 * torch.rand(p, generator=g)
    offsets = torch.arange(t, dtype=torch.int32) * per_tile
    counts = torch.tensor([40, 0, 17, 33], dtype=torch.int32)
    n = ccount.walk_counts(payload, offsets, counts, ntx, chunk=8)
    for ti in range(t):
        for i in range(0, 256, 37):
            x = (ti % ntx) * 16 + i % 16
            y = (ti // ntx) * 16 + i // 16
            assert int(n[ti, i]) == _walk_one_pixel(
                payload, int(offsets[ti]), int(counts[ti]), x, y)
    fwd, bwd = ccount.least_times(n)
    assert 0 < fwd < bwd
