"""The projection kernels (csrc/project.cu) against the plain chain, on a card.

Marked `cuda`: they skip where torch.cuda.is_available() is false, and
run on an NVIDIA card with `python -m pytest -m cuda
tests/test_torch_project_cuda.py`. `project_gaussians_cuda` (forward and
backward) is held to `calculate_colors_from_sh` + `project_gaussians` and
autograd's gradients of the pair, run on the same card, at 131,072 and
1,048,576 rows, over the edges of tests/test_torch_project_vjp.py's scene
(near plane, the tanfov clamp, det == 0, inactive slots, rgb + 0.5 < 0,
singular blends), SH degrees 0-4 and precomputed colours, tf absent,
fixed and trained.

Tolerances, each with its reason:
  * the projected fields (means2d, conic, depth, radius, tile_rect,
    visible): equal bits. The forward rounds every operation as the
    plain chain's torch operations do, so a difference is a fault;
  * colours: 1e-5 of the largest colour. The kernel sums the SH terms
    with FMAs and normalises the direction with its own norm, where the
    chain's einsum and norm reduce in theirs: float32 rounding of a sum
    of up to 25 terms of order 1;
  * gradients: 1e-4 of the largest entry of autograd's, and no more than
    1 in 10,000 entries off by over 1e-3 of their own size (with a floor
    of 1e-4 of the largest). The kernel evaluates the closed form in
    another order than autograd's chain, in float32, through 1 / det and
    1 / z^2 factors that amplify rounding; a wrong term reads 1e-2 or
    more (tests/test_torch_project_vjp.py checks the closed form itself
    in float64 to 1e-10).
"""
import dataclasses

import numpy as np
import pytest
import torch

from manus_tpu_torch.ops.rasterizer import projection as proj_mod
from manus_tpu_torch.ops.rasterizer.api import (
    RasterConfig,
    calculate_colors_from_sh,
    render_gaussians,
)
from manus_tpu_torch.ops.rasterizer.projection import (
    project_gaussians,
    project_gaussians_cuda,
)
from manus_tpu_torch.utils.camera import make_camera
from test_torch_project_vjp import edge_camera, edge_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def camera_720p(dev):
    """A 1280x720 camera at the origin looking down +z, as the cells'
    views (fx = fy = 1,000)."""
    return make_camera([[1000.0, 0, 639.5], [0, 1000.0, 359.5], [0, 0, 1]],
                       np.eye(4)[:3], 1280, 720, device=dev)


def _leaves(s, tf_mode):
    leaves = {k: s[k].clone().requires_grad_(True)
              for k in ("means", "cov", "feat", "cano") if k in s}
    if tf_mode != "none":
        leaves["tf"] = s["tf"].clone().requires_grad_(tf_mode == "grad")
    return leaves


def _plain(cam, s, leaves, deg):
    colors = None
    if deg >= 0:
        colors = calculate_colors_from_sh(
            leaves["means"], leaves["feat"], leaves.get("cano"), cam, deg,
            leaves.get("tf"))
    return project_gaussians(leaves["means"], leaves["cov"], cam,
                             active=s["active"]), colors


def _kernel(cam, s, leaves, deg):
    return project_gaussians_cuda(
        leaves["means"], leaves["cov"], cam, active=s["active"],
        cano_means=leaves.get("cano"),
        features=leaves["feat"] if deg >= 0 else None, sh_degree=deg,
        tf=leaves.get("tf"))


def _assert_grad_close(got, want, what):
    scale = want.abs().max().item()
    err = (got - want).abs()
    assert err.max().item() <= 1e-4 * max(scale, 1e-30), \
        f"{what}: largest gap {err.max().item():.3e} over {scale:.3e}"
    rel = err / (want.abs() + 1e-4 * scale)
    off = (rel > 1e-3).double().mean().item()
    assert off <= 1e-4, f"{what}: {off:.2e} of the entries off by over 1e-3"


# (rows, camera, SH degree (-1: precomputed colours), tf, coefficients)
CASES = [
    (131072, "edge", 3, "none", 16),
    (131072, "edge", 3, "fixed", 16),
    (131072, "edge", 3, "grad", 16),
    (131072, "edge", 0, "none", 16),
    (131072, "edge", 1, "grad", 16),
    (131072, "edge", 2, "none", 9),
    (131072, "edge", 4, "grad", 25),
    (131072, "edge", -1, "none", 16),
    (1048576, "720p", 3, "none", 16),
    (1048576, "720p", 3, "grad", 16),
]
IDS = [f"{n}-{c}-deg{d}-tf_{t}-k{k}" for n, c, d, t, k in CASES]


@pytest.mark.parametrize("n,camera,deg,tf_mode,k", CASES, ids=IDS)
def test_cuda_project_matches_plain(dev, n, camera, deg, tf_mode, k):
    cam = edge_camera(dev) if camera == "edge" else camera_720p(dev)
    s = edge_scene(n, n + deg, torch.float32, dev, tf_mode=tf_mode, k=k)
    leaves = _leaves(s, tf_mode)
    want, want_colors = _plain(cam, s, leaves, deg)
    got, colors = _kernel(cam, s, leaves, deg)
    for g, w_, name in zip(got, want, want._fields):
        assert g.dtype == w_.dtype and torch.equal(g, w_), \
            f"{name}: {int((g != w_).sum())} of {g.numel()} entries differ"
    assert not got.depth.requires_grad and not got.radius.requires_grad
    if camera == "edge":
        e = s["edges"]
        assert not got.visible[e["near"]].any() and not got.visible[5]
        assert got.visible[e["clamp"]].any() and got.visible.sum() > n // 2
    gen = torch.Generator(dev).manual_seed(1)
    gm = torch.randn(n, 2, device=dev, generator=gen)
    gc = torch.randn(n, 3, device=dev, generator=gen)
    gcol = torch.randn(n, 3, device=dev, generator=gen)
    if deg < 0:
        assert colors is None
    else:
        scale = want_colors.abs().max().item()
        assert (colors - want_colors).abs().max().item() <= 1e-5 * scale
    names = [k_ for k_ in ("means", "cov", "cano", "feat", "tf")
             if k_ in leaves and leaves[k_].requires_grad
             and (deg >= 0 or k_ in ("means", "cov"))]

    def grads(p, col):
        loss = (p.means2d * gm).sum() + (p.conic * gc).sum()
        if col is not None:
            loss = loss + (col * gcol).sum()
        return torch.autograd.grad(loss, [leaves[k_] for k_ in names],
                                   allow_unused=True)

    launches = proj_mod.project_bwd_cuda.launches
    g_got = grads(got, colors)
    assert proj_mod.project_bwd_cuda.launches == launches + 1
    g_want = grads(want, want_colors)
    for name, g, w_ in zip(names, g_got, g_want):
        if w_ is None:  # degree 0: the direction has no gradient
            w_ = torch.zeros_like(leaves[name])
        assert g is not None and torch.isfinite(g).all(), name
        _assert_grad_close(g, w_, name)
    masked = ~got.visible
    d = dict(zip(names, g_got))
    assert torch.count_nonzero(d["cov"][masked]) == 0
    if tf_mode != "none":
        assert torch.count_nonzero(d["means"][masked]) == 0
    if tf_mode == "grad" and camera == "edge" and deg >= 1:
        assert torch.count_nonzero(d["tf"][s["edges"]["singular"]]) == 0


def test_cuda_project_counts_launches_only_where_it_ran(dev):
    """The wrappers' counters move once a forward and once a backward; a
    no_grad call launches the forward alone; backend "torch" and an empty
    cloud launch nothing; a render_gaussians view under backend "cuda"
    launches each kernel once."""
    cam = edge_camera(dev)
    s = edge_scene(1000, 0, torch.float32, dev)
    fwd, bwd = proj_mod.project_fwd_cuda, proj_mod.project_bwd_cuda
    f0, b0 = fwd.launches, bwd.launches
    with torch.no_grad():
        p, colors = project_gaussians_cuda(s["means"], s["cov"], cam,
                                           active=s["active"],
                                           features=s["feat"], sh_degree=3)
    assert (fwd.launches, bwd.launches) == (f0 + 1, b0)
    assert not p.means2d.requires_grad and not colors.requires_grad
    empty = s["means"][:0]
    p, colors = project_gaussians_cuda(empty, s["cov"][:0], cam,
                                       features=s["feat"][:0], sh_degree=3)
    assert p.means2d.shape == (0, 2) and colors.shape == (0, 3)
    assert (fwd.launches, bwd.launches) == (f0 + 1, b0)

    means = s["means"].clone().requires_grad_(True)
    bg = torch.zeros(3, device=dev)
    opac = torch.full((1000, 1), 0.5, device=dev)
    for backend, calls in (("torch", 0), ("cuda", 1)):
        out = render_gaussians(means, s["cov"], means, s["feat"], opac, cam,
                               bg, sh_degree=3, active=s["active"],
                               config=RasterConfig(backend=backend))
        out.render.sum().backward()
        assert (fwd.launches, bwd.launches) == (f0 + 1 + calls, b0 + calls)


def test_cuda_project_checks_inputs(dev):
    """A call the kernels cannot take raises; there is no fallback."""
    cam = edge_camera(dev)
    s = edge_scene(64, 0, torch.float32, dev, tf_mode="grad", k=16)
    ok = dict(active=s["active"], features=s["feat"], sh_degree=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        project_gaussians_cuda(s["means"].cpu(), s["cov"].cpu(),
                               edge_camera("cpu"), sh_degree=-1)
    with pytest.raises(ValueError, match="float32"):
        project_gaussians_cuda(s["means"].double(), s["cov"], cam, **ok)
    with pytest.raises(ValueError, match="SH coefficients"):
        project_gaussians_cuda(s["means"], s["cov"], cam, active=s["active"],
                               features=s["feat"][:, :9], sh_degree=3)
    wide = torch.zeros(64, 26, 3, device=dev)
    with pytest.raises(ValueError, match="at most 25"):
        project_gaussians_cuda(s["means"], s["cov"], cam, features=wide,
                               sh_degree=4)
    with pytest.raises(ValueError, match="SH degree"):
        project_gaussians_cuda(s["means"], s["cov"], cam, features=s["feat"],
                               sh_degree=5)
    with pytest.raises(ValueError, match="active"):
        project_gaussians_cuda(s["means"], s["cov"], cam,
                               active=s["active"].float(), features=s["feat"],
                               sh_degree=3)
    with pytest.raises(ValueError, match="camera"):
        project_gaussians_cuda(s["means"], s["cov"], dataclasses.replace(
            cam, fovx=cam.fovx.double()), **ok)
    # strided inputs are made contiguous, not refused
    means = torch.cat([s["means"], s["means"]], 1)[:, :3]
    p, _ = project_gaussians_cuda(means, s["cov"], cam, **ok)
    q, _ = project_gaussians_cuda(s["means"], s["cov"], cam, **ok)
    assert torch.equal(p.means2d, q.means2d)
