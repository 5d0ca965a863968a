"""The CUDA composite kernels against their plain PyTorch version, on a card.

Marked `cuda`: they skip where torch.cuda.is_available() is false, and
run on an NVIDIA card with `python -m pytest -m cuda tests/test_torch_cuda.py`.
Small scenes that exercise the edges the bench scene may not: tiles with
no pairs, counts clamped by the per-tile cap while the offsets are not,
pair counts that are not a multiple of the kernels' batches, a non-zero
background (the d T_final path), and both early-exit paths.
"""
import numpy as np
import pytest
import torch

from manus_tpu_torch.ops.rasterizer import composite
from manus_tpu_torch.ops.rasterizer.api import RasterConfig, render_gaussians
from manus_tpu_torch.utils.camera import make_camera
from manus_tpu_torch.utils.transforms import covariance_from_scaling_rotation

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scene(n, seed, dev, size, opacity=(0.2, 0.95), spread=0.5):
    rng = np.random.RandomState(seed)
    means = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    t = lambda x: torch.tensor(x, device=dev)
    cov = covariance_from_scaling_rotation(t(scales), t(quats))
    f = size / (2 * np.tan(np.radians(25.0)))
    cam = make_camera([[f, 0, (size - 1) / 2], [0, f, (size - 1) / 2], [0, 0, 1]],
                      [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 3.0]],
                      size, size, device=dev)
    return dict(means=t(means), cov=cov, colors=t(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
                opacity=t(rng.uniform(*opacity, n).astype(np.float32)), cam=cam)


def _render_grads(s, backend, max_pairs, bg):
    args = [s["means"].clone().requires_grad_(True), s["cov"].clone().requires_grad_(True),
            s["colors"].clone().requires_grad_(True),
            s["opacity"].clone().requires_grad_(True)]
    n = args[0].shape[0]
    m2d = torch.zeros(n, 2, device=args[0].device, requires_grad=True)
    out = render_gaussians(
        args[0], args[1], args[0], torch.zeros(n, 16, 3, device=args[0].device),
        args[3], s["cam"], bg, colors_precomp=args[2], means2d_offset=m2d,
        config=RasterConfig(backend=backend, max_pairs_per_tile=max_pairs))
    w = torch.linspace(-1, 1, out.render.numel(), device=args[0].device)
    loss = (out.render.reshape(-1) * w).sum()
    return out, torch.autograd.grad(loss, args + [m2d])


# (gaussians, seed, image size, per-tile cap, opacity range): a sparse
# scene with empty tiles, a dense one whose per-tile cap binds (counts
# clamped, offsets not) with counts past both batch sizes, and an opaque
# one where every pixel saturates early.
CASES = [
    (60, 1, 96, 4096, (0.2, 0.95)),
    (3000, 2, 64, 300, (0.2, 0.95)),
    (2000, 3, 64, 4096, (0.9, 0.99)),
]


@pytest.mark.parametrize("n,seed,size,max_pairs,opacity", CASES,
                         ids=["sparse", "capped", "opaque"])
def test_cuda_composite_matches_plain(dev, n, seed, size, max_pairs, opacity):
    """Forward 1e-4 max abs on image and T_final; gradients of means, cov,
    colours, opacity and means2d_offset within normalised 1e-3 (sums of
    up to thousands of pairs in another order)."""
    s = _scene(n, seed, dev, size, opacity)
    bg = torch.tensor([0.3, 0.2, 0.1], device=dev)
    out_k, g_k = _render_grads(s, "cuda", max_pairs, bg)
    out_p, g_p = _render_grads(s, "torch", max_pairs, bg)
    torch.cuda.synchronize()
    assert (out_k.render - out_p.render).abs().max().item() <= 1e-4
    assert (out_k.t_final - out_p.t_final).abs().max().item() <= 1e-4
    assert int(out_k.overflow_far) == int(out_p.overflow_far)
    if max_pairs < 4096:
        assert int(out_k.overflow_far) > 0
    for name, a, b in zip(("means", "cov", "colors", "opacity", "m2d"), g_p, g_k):
        scale = a.abs().max().item()
        assert scale > 0, name
        err = (a - b).abs().max().item() / scale
        assert err <= 1e-3, f"{name}: normalised err {err}"


def test_cuda_wrappers_count_launches_and_check_inputs(dev):
    s = _scene(200, 4, dev, 64)
    fwd, bwd = composite.composite_fwd_cuda, composite.composite_bwd_cuda
    f0, b0 = fwd.launches, bwd.launches
    _render_grads(s, "cuda", 4096, torch.zeros(3, device=dev))
    assert (fwd.launches - f0, bwd.launches - b0) == (1, 1)
    pay = torch.zeros(16, 256, device=dev)
    cnt = torch.zeros(16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        fwd(pay, cnt.long(), cnt, 4, 4)
    with pytest.raises(ValueError, match="float32"):
        fwd(pay.double(), cnt, cnt, 4, 4)
    rgb, tf, _, n_walk = fwd(pay, cnt, cnt, 4, 4)
    assert rgb.abs().max().item() == 0 and tf.min().item() == 1.0
    assert n_walk.max().item() == 0
