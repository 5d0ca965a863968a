"""The SSIM kernels' math (manus_tpu_torch/csrc/ssim.cu), on the CPU.

The kernels cannot run here. `losses.ssim_partials` (the three partial
maps the forward keeps) and `losses.ssim_grad` (the backward's closed
form) write their math in plain torch over the banded blur; this file
holds them to the plain `ssim` and autograd's gradient of it, on odd
shapes, on images whose borders carry the content (every window there is
cut by the zero padding) and on identical inputs (SSIM 1, a zero
gradient up to rounding). tests/test_torch_cuda.py holds the kernels
themselves to the plain version on a card.
"""
import numpy as np
import pytest
import torch

from manus_tpu_torch.utils import losses

SHAPES = [(5, 7), (11, 11), (37, 53), (64, 96)]
KINDS = ["noisy", "border", "identical"]
GRAD_IN = 0.7  # the incoming gradient of the mean
# The closed form against autograd: each entry of g / N [G*p1 + 2 x G*p2 +
# y G*p3] is a sum of three terms, each a blur of 121 taps, rounded in
# another order than autograd's chain; both sit within a few float32 ulps
# (2^-23 = 1.2e-7) of the largest term, whatever the terms cancel to
# (1.8e-7 at most measured). 1e-6 is about 8 ulps.
GRAD_RTOL = 1e-6


def _images(h, w, kind, seed):
    """(pred, gt) [h, w, 3] float32 in [0, 1]: gt uniform noise (or, for
    "border", a dark frame's interior with bright 3-pixel borders), pred gt
    plus noise (or gt itself, for "identical")."""
    rng = np.random.RandomState(seed)
    gt = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    if kind == "border":
        gt = rng.uniform(0, 0.05, (h, w, 3)).astype(np.float32)
        gt[:3] += 0.9
        gt[-3:] += 0.7
        gt[:, :3] += 0.5
        gt[:, -3:] += 0.8
        gt = np.clip(gt, 0, 1)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(np.float32)
    if kind == "identical":
        pred = gt.copy()
    return torch.tensor(pred), torch.tensor(gt)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,w", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_partials_value_is_the_plain_ssim(h, w, kind):
    """The forward's mean is the plain SSIM's, bit for bit: the same ops."""
    pred, gt = _images(h, w, kind, h * w)
    value, part = losses.ssim_partials(pred, gt)
    assert torch.equal(value, losses.ssim_torch(pred, gt))
    assert part.shape == (3, h, w, 3) and part.dtype == torch.float32
    assert torch.isfinite(part).all()
    if kind == "identical":
        assert value.item() == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,w", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_closed_form_gradient_is_autograds(h, w, kind):
    pred, gt = _images(h, w, kind, h * w + 1)
    leaf = pred.clone().requires_grad_(True)
    want, = torch.autograd.grad(GRAD_IN * losses.ssim_torch(leaf, gt), leaf)
    _, part = losses.ssim_partials(pred, gt)
    got = losses.ssim_grad(part, pred, gt, torch.tensor(GRAD_IN))
    blurred = [losses._depthwise_blur(p, 11, 1.5) for p in part]
    terms = (blurred[0].abs() + (2 * pred * blurred[1]).abs()
             + (gt * blurred[2]).abs()).max() * GRAD_IN / pred.numel()
    gap = (got - want).abs().max()
    assert gap <= GRAD_RTOL * terms, (gap, terms)
    if kind == "identical":
        # SSIM's maximum: nothing but rounding on either side
        assert want.abs().max() <= GRAD_RTOL * terms


@pytest.mark.parametrize("h,w", [(5, 7), (37, 53)])
def test_cpu_tensors_take_the_plain_path(h, w):
    """ssim on CPU tensors is the banded ssim_torch, launches nothing and
    takes a gradient to either image."""
    pred, gt = _images(h, w, "noisy", 3)
    before = (losses.ssim_fwd_cuda.launches, losses.ssim_bwd_cuda.launches)
    a = pred.clone().requires_grad_(True)
    b = gt.clone().requires_grad_(True)
    value = losses.ssim(a, b)
    assert torch.equal(value, losses.ssim_torch(pred, gt))
    ga, gb = torch.autograd.grad(value, (a, b))
    assert ga.abs().sum() > 0 and gb.abs().sum() > 0
    assert (losses.ssim_fwd_cuda.launches,
            losses.ssim_bwd_cuda.launches) == before


def test_kernel_taps_are_the_banded_matrices():
    """The taps the kernels get are the float32 numbers of the banded
    matrix's band, and its interior row sums to one."""
    taps = np.frombuffer(losses._kernel_taps(1.5), dtype=np.float32)
    m = losses._banded_blur_matrix(40, 11, 1.5)
    assert np.array_equal(taps, m[20, 15:26])
    assert taps.sum() == pytest.approx(1.0, abs=1e-6)
    assert np.array_equal(taps, taps[::-1])


@pytest.mark.parametrize("window", [11, 7])
def test_cuda_path_refuses_cpu_tensors_and_other_windows(window):
    pred, gt = _images(5, 7, "noisy", 0)
    with pytest.raises(ValueError, match="CUDA SSIM"):
        losses.ssim_cuda(pred, gt, window_size=window)
