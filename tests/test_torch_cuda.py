"""The CUDA composite kernels against their plain PyTorch version, on a card.

Marked `cuda`: they skip where torch.cuda.is_available() is false, and
run on an NVIDIA card with `python -m pytest -m cuda tests/test_torch_cuda.py`.
Small scenes that exercise the edges the bench scene may not: tiles with
no pairs, counts clamped by the per-tile cap while the offsets are not,
pair counts that are not a multiple of the kernels' chunks and batches, a
non-zero background (the d T_final path), both early-exit paths, a tile
at the 4,096-pair cap beside shallow ones (many depth chunks, pixels that
stop in different chunks), and a second walk that does not stop.
"""
import math

import numpy as np
import pytest
import torch

from manus_tpu_torch.ops.grid_sample import (
    skinning_weights_from_voxel_grid_torch,
)
from manus_tpu_torch.ops.rasterizer import composite
from manus_tpu_torch.ops.rasterizer.api import RasterConfig, render_gaussians
from manus_tpu_torch.utils.camera import make_camera
from manus_tpu_torch.utils.transforms import (
    covariance_from_scaling_rotation,
    covariance_from_scaling_rotation_torch,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scene(n, seed, dev, size, opacity=(0.2, 0.95), spread=0.5,
           scale=(0.02, 0.12), clusters=()):
    """n gaussians uniform in a cube of half-width `spread`, and for each
    (count, centre x, centre y, half-width) of `clusters` that many more
    around that centre."""
    rng = np.random.RandomState(seed)
    means = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    for m, cx, cy, half in clusters:
        extra = rng.uniform(-half, half, (m, 3)).astype(np.float32)
        means = np.concatenate([means, extra + np.float32([cx, cy, 0.0])])
    n = means.shape[0]
    scales = rng.uniform(*scale, (n, 3)).astype(np.float32)
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
# one where every pixel saturates early. Then, with small faint gaussians:
# a deep scene (a cluster that fills one tile to the 4,096 cap, two that
# leave tiles between 1 and 3 chunks deep, most tiles empty) and a spread
# one (every tile tens of pairs).
CASES = [
    (60, 1, 96, 4096, (0.2, 0.95), {}),
    (3000, 2, 64, 300, (0.2, 0.95), {}),
    (2000, 3, 64, 4096, (0.9, 0.99), {}),
    (20, 4, 128, 4096, (0.02, 0.3), dict(
        scale=(0.004, 0.02),
        clusters=((7000, -0.52, -0.52, 0.1), (500, 0.6, 0.3, 0.15),
                  (900, 0.2, -0.7, 0.15)))),
    (6000, 6, 256, 4096, (0.05, 0.6), dict(scale=(0.004, 0.03), spread=1.3)),
]


@pytest.mark.parametrize("n,seed,size,max_pairs,opacity,kw", CASES,
                         ids=["sparse", "capped", "opaque", "deep", "spread"])
def test_cuda_composite_matches_plain(dev, n, seed, size, max_pairs, opacity,
                                      kw):
    """Forward 1e-4 max abs on image and T_final; gradients of means, cov,
    colours, opacity and means2d_offset within normalised 1e-3 (sums of
    up to thousands of pairs in another order)."""
    s = _scene(n, seed, dev, size, opacity, **kw)
    bg = torch.tensor([0.3, 0.2, 0.1], device=dev)
    out_k, g_k = _render_grads(s, "cuda", max_pairs, bg)
    out_p, g_p = _render_grads(s, "torch", max_pairs, bg)
    torch.cuda.synchronize()
    assert (out_k.render - out_p.render).abs().max().item() <= 1e-4
    assert (out_k.t_final - out_p.t_final).abs().max().item() <= 1e-4
    assert int(out_k.overflow_far) == int(out_p.overflow_far)
    if max_pairs < 4096 or kw.get("clusters"):
        assert int(out_k.overflow_far) > 0  # the per-tile cap cuts a segment
    for name, a, b in zip(("means", "cov", "colors", "opacity", "m2d"), g_p, g_k):
        scale = a.abs().max().item()
        assert scale > 0, name
        err = (a - b).abs().max().item() / scale
        assert err <= 1e-3, f"{name}: normalised err {err}"


def _payload(dev, raw_counts, seed, ntx, opacity=(0.02, 0.3), sigma=(1.0, 4.0)):
    """A [16, P] payload made with numpy whose tile t owns raw_counts[t]
    pair columns of small random gaussians around it."""
    rng = np.random.RandomState(seed)
    raw = np.asarray(raw_counts, np.int64)
    offsets = np.concatenate([[0], np.cumsum(raw)[:-1]])
    pay = np.zeros((16, int(raw.sum()) + 7), np.float32)
    for t, (o, n) in enumerate(zip(offsets, raw)):
        sl = slice(o, o + n)
        pay[0, sl] = rng.uniform((t % ntx) * 16 - 2, (t % ntx) * 16 + 18, n)
        pay[1, sl] = rng.uniform((t // ntx) * 16 - 2, (t // ntx) * 16 + 18, n)
        s1, s2 = rng.uniform(*sigma, (2, n))
        th = rng.uniform(0, np.pi, n)
        pay[2, sl] = np.cos(th) ** 2 / s1 ** 2 + np.sin(th) ** 2 / s2 ** 2
        pay[4, sl] = np.sin(th) ** 2 / s1 ** 2 + np.cos(th) ** 2 / s2 ** 2
        pay[3, sl] = np.sin(th) * np.cos(th) * (1 / s1 ** 2 - 1 / s2 ** 2)
        pay[5, sl] = rng.uniform(*opacity, n)
        pay[6:9, sl] = rng.uniform(0, 1, (3, n))
    t = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    return torch.tensor(pay, device=dev), t(offsets), t(raw)


# Tiles of 2x2 (x 1): at the cap, inside one chunk, empty, a few chunks.
DEEP_COUNTS = [4096, 300, 0, 700]


def _cotangents(dev, t, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(t, 3, 256, generator=g).to(dev),
            torch.randn(t, 256, generator=g).to(dev))


def test_cuda_composite_gives_equal_bits(dev):
    """Two launches of the forward and of the backward give the same bits:
    every output has one writer and every sum a fixed order, no atomics."""
    pay, offs, cnts = _payload(dev, DEEP_COUNTS, 0, 2)
    fwd = composite.composite_fwd_cuda(pay, offs, cnts, 2, 2)
    again = composite.composite_fwd_cuda(pay, offs, cnts, 2, 2)
    for a, b in zip(fwd[:4], again[:4]):
        assert torch.equal(a, b)
    assert int(fwd[3].max()) > 3 * composite.chunk_size()
    d_rgb, d_tfin = _cotangents(dev, 4)
    d1, d2 = (composite.composite_bwd_cuda(pay, offs, cnts, 2, 2, d_rgb, d_tfin,
                                           *fwd[1:]) for _ in range(2))
    assert torch.equal(d1, d2) and d1.abs().max().item() > 0


@pytest.mark.parametrize("margin", [0.0, 2.5], ids=["rule", "second_walk_goes_on"])
def test_cuda_composite_matches_split_model(dev, monkeypatch, margin):
    """The kernels against their plain model of the same split, chunk for
    chunk: n_walk equal but where log T lands within rounding of log(1e-4)
    (at most 0.1% of the pixels), log T after the last included pair and
    the colours within 1e-4 elsewhere, d_payload per field within 1e-3 of
    the field's largest value. With a margin on the rule that sends a
    chunk to its second walk, most second walks end without a stop and
    the thread goes on through the later chunks: same results."""
    pay, offs, cnts = _payload(dev, DEEP_COUNTS, 1, 2, opacity=(0.02, 0.15))
    want = composite.composite_tiles_split_torch(pay, offs, cnts, 2, 2,
                                                 composite.chunk_size())
    monkeypatch.setattr(composite, "STOP_MARGIN", margin)
    rgb, tfin, log_t, n_walk, state = composite.composite_fwd_cuda(
        pay, offs, cnts, 2, 2)
    same = n_walk == want[3]
    assert same.float().mean().item() >= 0.999
    assert torch.equal(state.item_start, want[4].item_start)
    assert ((rgb - want[0]).abs().amax(1)[same]).max().item() <= 1e-4
    assert ((log_t - want[2]).abs()[same]).max().item() <= 1e-4
    assert (tfin - torch.exp(log_t)).abs().max().item() <= 1e-6
    stop_chunks = torch.unique((n_walk[0].long() - 1) // composite.chunk_size())
    assert len(stop_chunks) >= 3  # pixels of the deep tile stop in several chunks
    d_rgb, d_tfin = _cotangents(dev, 4)
    got = composite.composite_bwd_cuda(pay, offs, cnts, 2, 2, d_rgb, d_tfin,
                                       tfin, log_t, n_walk, state)
    ref = composite.composite_split_backward_torch(
        pay, offs, cnts, 2, 2, composite.chunk_size(), d_rgb, d_tfin, *want[1:])
    for f in range(9):
        scale = ref[f].abs().max().item()
        assert scale > 0
        assert (got[f] - ref[f]).abs().max().item() <= 1e-3 * scale, f
    assert not got[9:].any()


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
    rgb, tf, _, n_walk, _ = fwd(pay, cnt, cnt, 4, 4)
    assert rgb.abs().max().item() == 0 and tf.min().item() == 1.0
    assert n_walk.max().item() == 0


# --- LPIPS kernels: the conv, dx and head kernels against their plain
# versions on the card. bf16 outputs with fp32 sums in another order: a
# value may round one ulp (at most 2^-7 of it) the other way, and a ReLU
# output may be 0 on one side where the pre-activation is within fp32
# rounding of 0 (1e-3 of the output's largest value).

def _assert_bf16_close(got, want, what):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) \
        + 1e-3 * want.abs().max()
    assert bool((err <= limit).all()), f"{what}: max abs err {err.max().item()}"
    assert (err > 0).float().mean().item() <= 0.01, what


# (h, w, ci, co): Ci = 3 (padded to 16) and odd W+2, even W+2 in a
# one-block layout, the 45x45 odd width, several row blocks, and a wide
# layer with several CTAs along both rows and channels; the VGG16's 32x32
# stage, whose plan splits K in both forms; 16 input channels with a K of
# three chunks, no longer than the kernel's ring; and a row count that is
# no multiple of the 128-row tile under 256-channel tiles.
CONV_CASES = [(13, 9, 3, 64), (16, 16, 64, 128), (45, 45, 16, 8),
              (7, 4, 4, 4), (64, 64, 256, 512), (32, 32, 512, 512),
              (20, 12, 16, 32), (40, 40, 128, 256)]
CONV_IDS = ["ci3_odd_w2", "one_block", "45x45", "multi_block", "wide",
            "stage4_split_k", "short_k", "ragged_rows"]


def _conv_layer(dev, h, w, ci, co, seed):
    from manus_tpu_torch.ops import conv

    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(h, w, ci, generator=g)
    wk = torch.randn(3, 3, ci, co, generator=g) * (2.0 / (9 * ci)) ** 0.5
    b = torch.randn(co, generator=g) * 0.1
    L = conv.StageLayout(h, w, max(ci, co, 128))
    p = conv.pack_conv3x3(wk.to(dev), b.to(dev))
    return conv, L, p, conv.build_layout(x.to(dev), L), g


@pytest.mark.parametrize("h,w,ci,co", CONV_CASES, ids=CONV_IDS)
def test_cuda_conv_and_dx_match_plain(dev, h, w, ci, co):
    conv, L, p, xl, g = _conv_layer(dev, h, w, ci, co, h * 31 + w)
    for relu in (False, True):
        y = conv.conv3x3_layout_cuda(xl, p.w, p.b, relu, L)
        _assert_bf16_close(y, conv.conv3x3_layout_torch(xl, p.w, p.b, relu, L),
                           f"conv relu={relu}")
        assert not y[~conv.valid_rows(L, dev)].any()
        assert not y[:, co:].any()
    # the dx of the ReLU'd layer (Co = 3 on the dx when ci == 3: its
    # output has the layout's 16 channels, 13 of them zero)
    gl = torch.randn(L.rows, p.co, generator=g).to(dev, torch.bfloat16)
    dx = conv.conv3x3_layout_dx_cuda(gl, y, p.w_t, L)
    want = conv.conv3x3_layout_torch(gl, p.w_t, None, False, L, mask_by=y)
    assert dx.shape == (L.rows, p.ci)
    _assert_bf16_close(dx, want, "dx")
    assert not dx[:, ci:].any()


def test_cuda_split_k_gives_equal_bits(dev):
    """Two launches of a split-K plan give the same bits: the slices are
    summed in index order, with no atomics."""
    conv, L, p, xl, g = _conv_layer(dev, 32, 32, 512, 512, 7)
    assert conv.conv_plan(L, p.ci, p.co).split_k > 1
    assert conv.conv_plan(L, p.co, p.ci).split_k > 1
    y = conv.conv3x3_layout_cuda(xl, p.w, p.b, True, L)
    assert torch.equal(y, conv.conv3x3_layout_cuda(xl, p.w, p.b, True, L))
    gl = torch.randn(L.rows, p.co, generator=g).to(dev, torch.bfloat16)
    dx = conv.conv3x3_layout_dx_cuda(gl, y, p.w_t, L)
    assert torch.equal(dx, conv.conv3x3_layout_dx_cuda(gl, y, p.w_t, L))
    assert dx.abs().max().item() > 0


def test_cuda_conv_autograd_and_image_conv(dev):
    """The image conv (kernel 7) launches the conv kernel under its own
    count, its backward is the dx kernel (the conv kernel with relu off),
    and both match the CPU path."""
    conv, L, p, xl, _ = _conv_layer(dev, 13, 9, 3, 16, 5)
    x = torch.randn(13, 9, 3)
    p_cpu = conv.ConvWeights(*(t.cpu() if torch.is_tensor(t) else t for t in p))
    fns = (conv.conv3x3_image_cuda, conv.conv3x3_layout_cuda,
           conv.conv3x3_layout_dx_cuda)
    for relu, dx_launches in ((True, [1, 0, 1]), (False, [1, 1, 0])):
        before = [f.launches for f in fns]
        xg = x.to(dev).requires_grad_(True)
        got = conv.conv3x3(xg, p, relu)
        (gx,) = torch.autograd.grad(got.float().sum(), [xg])
        assert [f.launches - n for f, n in zip(fns, before)] == dx_launches
        xc = x.clone().requires_grad_(True)
        want = conv.conv3x3(xc, p_cpu, relu)
        (gc,) = torch.autograd.grad(want.float().sum(), [xc])
        _assert_bf16_close(got.detach().cpu(), want.detach(), "image conv")
        _assert_bf16_close(gx.cpu(), gc, "image conv dx")


# (rows, c): row counts that are no multiple of a CTA's step of rows
# (C / 8 lanes a row, 4 rows a lane group; 2 at C = 512), a C whose
# lane group has an idle lane (24), and grids of more steps than CTAs, so
# that a CTA walks several (70001 x 64, 9000 x 512).
HEAD_CASES = [(4112 * 3, 64), (528, 512), (40, 16), (1000, 128), (777, 256),
              (100, 24), (70001, 64), (9000, 512)]


@pytest.mark.parametrize("rows,c", HEAD_CASES)
def test_cuda_head_matches_plain(dev, rows, c):
    """The head kernels over every row, with all-zero rows (the zero-norm
    guard): the forward within 1e-5 relative (fp32 sums in another
    order), the gradients by the bf16 rule; two launches give equal bits,
    and the da-only form's da equals the two-output form's."""
    from manus_tpu_torch.ops import conv

    g = torch.Generator(device="cpu").manual_seed(rows + c)
    a = torch.randn(rows, c, generator=g)
    b = torch.randn(rows, c, generator=g)
    a[::7] = 0
    b[::7] = 0
    a, b = a.to(dev, torch.bfloat16), b.to(dev, torch.bfloat16)
    lin = (torch.rand(c, generator=g) / c / rows).to(dev)
    got = conv.head_fwd_cuda(a, b, lin).item()
    want = conv.head_fwd_torch(a, b, lin).item()
    assert abs(got - want) <= 1e-5 * abs(want)
    assert conv.head_fwd_cuda(a, b, lin).item() == got  # no atomics
    ct = torch.tensor(1.3, device=dev)
    da, db = conv.head_bwd_cuda(a, b, lin, ct)
    da_ref, db_ref = conv.head_bwd_torch(a, b, lin * ct)
    _assert_bf16_close(da, da_ref, "da")
    _assert_bf16_close(db, db_ref, "db")
    assert not da[::7].any() and not db[::7].any()
    da2, db2 = conv.head_bwd_cuda(a, b, lin, ct)
    assert torch.equal(da, da2) and torch.equal(db, db2)
    da_only, none = conv.head_bwd_cuda(a, b, lin, ct, need_db=False)
    assert none is None and torch.equal(da_only, da)


# (h, w, c): one layout per C the kernels are built for (16, and the
# VGG16 stages' 64 to 512), whose pixel span [m_blk, m_blk + n_valid)
# starts past row 0 and ends inside a CTA's step of rows.
HEAD_SPAN_CASES = [(13, 9, 16), (45, 45, 64), (20, 12, 128), (15, 16, 256),
                   (7, 4, 512)]


@pytest.mark.parametrize("h,w,c", HEAD_SPAN_CASES)
def test_cuda_head_reads_only_the_pixel_span(dev, h, w, c):
    """With the stage's layout the kernels read only its pixel span: the
    rows outside it hold NaN here, yet the forward is finite and the
    backward writes zeros there. Pixel rows that are zero in both (the
    guard) stay zero. Against the plain version over the span; the
    da-only form's da equals the two-output form's; two launches, and two
    replays of a CUDA graph of the forward (the ticket's reset), give
    equal bits."""
    from manus_tpu_torch.ops import conv

    L = conv.StageLayout(h, w, max(c, 128))
    lo, hi = L.m_blk, L.m_blk + L.n_valid
    g = torch.Generator(device="cpu").manual_seed(h * w + c)
    valid = conv.valid_rows(L, "cpu")
    a = torch.randn(L.rows, c, generator=g) * valid[:, None]
    b = torch.randn(L.rows, c, generator=g) * valid[:, None]
    a[lo: lo + 3 * (w + 2)] = 0
    b[lo: lo + 3 * (w + 2)] = 0
    for x in (a, b):
        x[:lo] = x[hi:] = float("nan")
    a, b = a.to(dev, torch.bfloat16), b.to(dev, torch.bfloat16)
    lin = (torch.rand(c, generator=g) / c / (h * w)).to(dev)
    got = conv.head_fwd_cuda(a, b, lin, L)
    want = conv.head_fwd_torch(a, b, lin, L).item()
    assert abs(got.item() - want) <= 1e-5 * abs(want) and want > 0
    assert torch.equal(conv.head_fwd_cuda(a, b, lin, L), got)

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = conv.head_fwd_cuda(a, b, lin, L)
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append(out.clone())
    assert torch.equal(replays[0], got) and torch.equal(replays[1], got)

    ct = torch.tensor(0.7, device=dev)
    da, db = conv.head_bwd_cuda(a, b, lin, ct, L)
    da_ref, db_ref = conv.head_bwd_torch(a, b, lin * ct, L)
    _assert_bf16_close(da, da_ref, "da")
    _assert_bf16_close(db, db_ref, "db")
    outside = torch.ones(L.rows, dtype=torch.bool)
    outside[lo:hi] = False
    for x in (da, db):
        assert not x[outside.to(dev)].any()
        assert not x[lo: lo + 3 * (w + 2)].any()
        assert x.isfinite().all()
    da2, db2 = conv.head_bwd_cuda(a, b, lin, ct, L)
    assert torch.equal(da, da2) and torch.equal(db, db2)
    da_only, none = conv.head_bwd_cuda(a, b, lin, ct, L, need_db=False)
    assert none is None and torch.equal(da_only, da)


def test_cuda_lpips_distance_matches_cpu(dev):
    """lpips_distance and its image gradient at 64x64 through the kernels
    against the plain chain on the CPU, and the launch counts of one
    forward and backward."""
    from manus_tpu_torch.ops import conv
    from manus_tpu_torch.train import lpips

    params = lpips.random_lpips_params(0, device="cpu")
    g = torch.Generator(device="cpu").manual_seed(0)
    a, b = torch.rand(64, 64, 3, generator=g), torch.rand(64, 64, 3, generator=g)

    def run(p, img, ref):
        x = img.clone().requires_grad_(True)
        d = lpips.lpips_distance(p, x, ref)
        return d.item(), torch.autograd.grad(d, [x])[0].cpu().reshape(-1)

    fns = (conv.conv3x3_layout_cuda, conv.conv3x3_layout_dx_cuda,
           conv.head_fwd_cuda, conv.head_bwd_cuda)
    before = [f.launches for f in fns]
    d_k, g_k = run({k: v.to(dev) for k, v in params.items()}, a.to(dev),
                   b.to(dev))
    assert [f.launches - n for f, n in zip(fns, before)] == [26, 13, 5, 5]
    d_p, g_p = run(params, a, b)
    assert abs(d_k - d_p) <= 1e-3 * d_p
    assert (g_k @ g_p / (g_k.norm() * g_p.norm())).item() >= 0.999


def test_lpips_wrappers_check_inputs(dev):
    from manus_tpu_torch.ops import conv

    _, L, p, xl, _ = _conv_layer(dev, 16, 16, 16, 32, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        conv.conv3x3_layout_cuda(xl.float(), p.w, p.b, True, L)
    with pytest.raises(ValueError, match="CUDA"):
        conv.conv3x3_layout_cuda(xl.cpu(), p.w, p.b, True, L)
    with pytest.raises(ValueError, match="do not fit"):
        conv.conv3x3_layout_cuda(xl, p.w_t, p.b, True, L)
    a = torch.zeros(8, 600, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="512"):
        conv.head_fwd_cuda(a, a, torch.zeros(600, device=dev))
    a = torch.zeros(8, 20, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        conv.head_fwd_cuda(a, a, torch.zeros(20, device=dev))
    buf = torch.zeros(8 * 64 + 1, dtype=torch.bfloat16, device=dev)
    a, lin = buf[1:].view(8, 64), torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        conv.head_fwd_cuda(a, a, lin)
    with pytest.raises(ValueError, match="aligned"):
        conv.head_bwd_cuda(a, a, lin, torch.ones((), device=dev))
    a = torch.zeros(L.rows - 1, 64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="rows"):
        conv.head_fwd_cuda(a, a, lin, L)


def _tree_to(x, device):
    """Every tensor of a tree of named tuples on `device`."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree_to(v, device) for v in x))
    return x


def _densify_state(dev, cap=4096, n0=3000, seed=0):
    """A model of n0 live slots in cap, random moments and statistics of
    which about a tenth pass the gradient threshold, on `dev`; every third
    slot's scales are half of percent_dense, so that it clones where the
    others split."""
    from manus_tpu_torch.models import densify
    from manus_tpu_torch.models.gaussians import GaussianOpts, init_gaussian_model
    from manus_tpu_torch.train import workloads

    rng = np.random.RandomState(seed)
    model = init_gaussian_model(rng.uniform(-1, 1, (n0, 3)),
                                rng.uniform(0, 1, (n0, 3)), cap,
                                skin_weights=rng.dirichlet(np.ones(5), n0),
                                device=dev)
    p = model.params
    rot = torch.tensor(rng.normal(size=(cap, 4)).astype(np.float32), device=dev)
    op = torch.tensor(rng.normal(-1, 3, (cap, 1)).astype(np.float32), device=dev)
    small = torch.arange(cap, device=dev)[:, None] % 3 == 0
    scaling = torch.where(small, math.log(GaussianOpts().percent_dense * 0.5),
                          p.scaling)
    model = model._replace(params=p._replace(rotation=rot, opacity=op,
                                             scaling=scaling))
    state = workloads.init_train_state(model)
    t = lambda x: torch.tensor(x.astype(np.float32), device=dev)  # noqa: E731
    stats = densify.DensifyStats(
        grad_accum=t(rng.exponential(1e-4, cap)), denom=t(rng.randint(0, 3, cap)),
        max_radii2d=t(rng.uniform(0, 30, cap)))
    opt = state.opt._replace(m=type(p)(*(torch.randn_like(x) for x in p)))
    return state._replace(opt=opt, stats=stats, step=3001)


def test_cuda_densify_event_matches_cpu_without_sync(dev):
    """make_densify_step on the card under set_sync_debug_mode("error")
    (no host sync), then the same event on the CPU from the same state and
    the same noise: equal masks and counters, values within 1e-6. Then
    the mask prune and the opacity reset, also without a sync."""
    from manus_tpu_torch.config import hand_config
    from manus_tpu_torch.models import densify
    from manus_tpu_torch.train import workloads

    cfg = hand_config()
    state = _densify_state(dev)
    gen = torch.Generator(device=dev)
    gen.set_state(state.gen.get_state())
    noise = torch.randn((2, state.model.capacity, 3), generator=gen, device=dev)
    densify_step, reset_step = workloads.make_densify_step(cfg, extent=1.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, info = densify_step(state)
        kill = torch.arange(state.model.capacity, device=dev) % 4 == 0
        pruned, _, n_kill = densify.prune_by_mask(new.model, new.opt, kill)
        reset = reset_step(new)
    finally:
        torch.cuda.set_sync_debug_mode(0)

    cstate = _tree_to(state, "cpu")
    want, wopt, _, winfo = densify.densify_and_prune(
        cstate.model, cstate.opt, cstate.stats, cfg.model, 1.0, noise.cpu(),
        use_size_threshold=True)
    assert int(info["clones"]) > 0 and int(info["splits"]) > 0
    assert int(info["pruned"]) > 0
    for k in winfo:
        assert int(info[k]) == int(winfo[k]), k
    assert torch.equal(new.model.active.cpu(), want.active)
    for a, b in zip((*new.model.params, new.model.skin_weights, *new.opt.m),
                    (*want.params, want.skin_weights, *wopt.m)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-6, rtol=0,
                                   equal_nan=True)
    assert int(n_kill) == int((want.active & kill.cpu()).sum())
    assert not (pruned.active & kill).any()
    assert float(torch.sigmoid(reset.model.params.opacity).max()) <= 0.0101


def test_cuda_grid_sample_matches_cpu(dev):
    """grid_sample_trilinear on the card against the CPU: values within
    1e-6, coordinate gradients within 1e-5."""
    from manus_tpu_torch.ops.grid_sample import grid_sample_trilinear

    rng = np.random.RandomState(0)
    grid = torch.tensor(rng.rand(9, 11, 7, 14).astype(np.float32))
    coords = torch.tensor(np.concatenate([
        rng.uniform(-1.3, 1.3, (5000, 3)),
        [[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0]]]).astype(np.float32))
    cot = torch.tensor(rng.rand(coords.shape[0], 14).astype(np.float32))

    def run(d):
        x = coords.to(d).requires_grad_(True)
        y = grid_sample_trilinear(grid.to(d), x)
        (g,) = torch.autograd.grad((y * cot.to(d)).sum(), [x])
        return y.detach().cpu(), g.cpu()

    y_k, g_k = run(dev)
    y_p, g_p = run("cpu")
    torch.testing.assert_close(y_k, y_p, atol=1e-6, rtol=0)
    torch.testing.assert_close(g_k, g_p, atol=1e-5, rtol=0)


def test_cuda_outliers_match_cpu(dev):
    """LoOP on the card against the CPU on a dense cloud (where a matmul's
    rounding would reorder near-equal neighbours): probabilities within
    1e-5 (sums of the k distances and of plof^2 in another order), equal
    masks."""
    from manus_tpu_torch.ops.outliers import outlier_mask, outlier_probability

    rng = np.random.RandomState(0)
    pts = torch.tensor(np.concatenate([
        rng.normal(0.1, 0.02, (6000, 3)), rng.uniform(-1, 1, (40, 3))]
    ).astype(np.float32))
    valid = torch.tensor(rng.rand(pts.shape[0]) > 0.1)
    got = outlier_probability(pts.to(dev), valid.to(dev), k=32).cpu()
    want = outlier_probability(pts, valid, k=32)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    mask = outlier_mask(pts.to(dev), valid.to(dev)).cpu()
    assert torch.equal(mask, want > 0.8) and 0 < int(mask.sum()) < 100


def _contact_clouds(seed, n=3000, m=4000):
    """Two clouds at the hand's scale, a third of the second within a few
    mm of the first (tests/test_torch_colormap_contacts.py's)."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(-0.15, 0.15, (n, 3)) + np.array([0.1, 0.2, 0.05])
    b = rng.uniform(-0.15, 0.15, (m, 3)) + np.array([0.1, 0.2, 0.05])
    b[:m // 3] = a[rng.randint(0, n, m // 3)] + rng.normal(0, 0.002,
                                                           (m // 3, 3))
    return a.astype(np.float32), b.astype(np.float32)


def test_cuda_contact_map_matches_cpu(dev):
    """contact_map on the card (the search kernel of csrc/knn.cu, float32
    FMAs) against the CPU's (the plain blockwise path): the distance
    expansion's conditioning bound of
    tests/test_torch_colormap_contacts.py (|d_a - d_b| <= min(sqrt(2 eps),
    2 eps / (d_a + d_b)), eps = 8 u (|x| + |y|)^2), indices equal where
    the float64 neighbour wins by more than 4 eps in d^2; and so whatever
    the caller's TF32 setting."""
    from manus_tpu_torch.ops.contacts import CONTACT_THRESHOLD as c
    from manus_tpu_torch.ops.contacts import contact_map

    x, y = _contact_clouds(0)
    yv = np.random.RandomState(1).uniform(size=len(y)) > 0.1
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        d_g, i_g, _ = contact_map(torch.tensor(x, device=dev),
                                  torch.tensor(y, device=dev),
                                  pt2_valid=torch.tensor(yv, device=dev))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    d_c, i_c, _ = contact_map(torch.tensor(x), torch.tensor(y),
                              pt2_valid=torch.tensor(yv))
    d_g, d_c = d_g.cpu().numpy(), d_c.numpy()
    assert 100 < (d_c > 0).sum() < len(x)
    eps = 8 * 2.0 ** -24 * (np.linalg.norm(x, axis=1)
                            + np.linalg.norm(y[yv], axis=1).max()) ** 2
    da, db = c * (1.0 - d_g.astype(np.float64)), c * (1.0 - d_c)
    bound = np.minimum(np.sqrt(2 * eps), 2 * eps / np.maximum(da + db, 1e-30))
    assert (np.abs(da - db) <= bound + 1e-9).all()
    d2 = ((x[:, None].astype(np.float64) - y[None]) ** 2).sum(-1)
    d2[:, ~yv] = np.inf
    part = np.partition(d2, 1, axis=1)
    unique = part[:, 1] - part[:, 0] > 4 * eps
    np.testing.assert_array_equal(i_g.cpu().numpy()[unique],
                                  i_c.numpy()[unique])


# --- The contact search kernel (csrc/knn.cu) against float64 on the card.

def _nn_float64(x, y, valid):
    """The exact nearest of each row of x among the valid rows of y, in
    float64 on the card: (d^2, its index, the second d^2), the index the
    lowest among equal d^2."""
    xd, yd = x.double(), y.double()
    best, arg, second = [], [], []
    for i in range(0, len(x), 1024):
        d2 = ((xd[i:i + 1024, None] - yd[None]) ** 2).sum(-1)
        if valid is not None:
            d2[:, ~valid] = math.inf
        top = torch.topk(d2, min(2, len(y)), dim=1, largest=False,
                         sorted=True).values
        b = top[:, 0]
        best.append(b)
        second.append(top[:, 1] if len(y) > 1 else torch.full_like(
            b, math.inf))
        # the lowest index reaching the minimum (topk's order is not)
        hit = d2 == b[:, None]
        arg.append(torch.where(hit.any(1), hit.int().argmax(1), 0))
    return torch.cat(best), torch.cat(arg), torch.cat(second)


def _assert_nn_close(x, y, valid, dist, idx):
    """dist within the expansion's bound of the exact distance, |d - d_e|
    <= min(sqrt(eps), eps / (d + d_e)) with eps = 8 u (|x| + max |y|)^2
    (tests/test_torch_colormap_contacts.py), and idx the exact nearest
    wherever it beats the second by more than 2 eps in d^2."""
    best, arg, second = _nn_float64(x, y, valid)
    ys = y if valid is None else y[valid]
    eps = 8 * 2.0 ** -24 * (x.double().norm(dim=1)
                            + ys.double().norm(dim=1).max()) ** 2
    d_e, d = best.sqrt(), dist.double()
    bound = torch.minimum(eps.sqrt(), eps / (d + d_e).clamp(min=1e-30))
    assert ((d - d_e).abs() <= bound + 1e-12).all()
    unique = second - best > 2 * eps
    # (a lone query has a third of the references within a few mm)
    assert unique.double().mean() > 0.5 or len(x) < 100
    assert torch.equal(idx.long()[unique], arg[unique])
    if valid is not None:
        assert valid[idx.long()].all()


def _knn_clouds(n, m, seed):
    """A query and a reference cloud at the hand's scale, a third of the
    references within a few mm of a query (_contact_clouds' shape)."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(-0.15, 0.15, (n, 3)) + np.array([0.1, 0.2, 0.05])
    b = rng.uniform(-0.15, 0.15, (m, 3)) + np.array([0.1, 0.2, 0.05])
    k = m // 3
    b[:k] = a[rng.randint(0, n, k)] + rng.normal(0, 0.002, (k, 3))
    return a.astype(np.float32), b.astype(np.float32)


# (n, m): ragged against the kernel's 2,048-query blocks, 256-reference
# tiles and 32-reference runs, one and several slices, and the voxel
# grid's keypoint form
KNN_CASES = [(1, 1), (31, 31), (1000, 1000), (4097, 4097), (131072, 4000),
             (1, 4097), (4097, 31), (70001, 20)]


@pytest.mark.parametrize("n,m", KNN_CASES,
                         ids=[f"{n}x{m}" for n, m in KNN_CASES])
def test_cuda_nearest_neighbor_matches_float64(dev, n, m):
    from manus_tpu_torch.ops import knn

    x, y = _knn_clouds(n, m, n + m)
    x, y = torch.tensor(x, device=dev), torch.tensor(y, device=dev)
    valid = torch.tensor(np.random.RandomState(m).rand(m) > 0.1, device=dev)
    valid[0] = True
    for pv in (None, valid):
        dist, idx = knn.nearest_neighbor(x, y, pt2_valid=pv)
        assert dist.dtype == torch.float32 and idx.dtype == torch.int32
        assert dist.shape == idx.shape == (n,)
        _assert_nn_close(x, y, pv, dist, idx)


def test_cuda_nearest_neighbor_without_valid_references(dev):
    """Rows with no valid reference get (inf, 0), as the plain path
    gives; with a single valid one, that one at its distance."""
    from manus_tpu_torch.ops import knn

    x, y = _knn_clouds(3000, 5000, 7)
    x, y = torch.tensor(x, device=dev), torch.tensor(y, device=dev)
    none = torch.zeros(5000, dtype=torch.bool, device=dev)
    dist, idx = knn.nearest_neighbor(x, y, pt2_valid=none)
    assert torch.isinf(dist).all() and (idx == 0).all()
    d_c, i_c = knn.nearest_neighbor(x.cpu(), y.cpu(), pt2_valid=none.cpu())
    assert torch.isinf(d_c).all() and (i_c == 0).all()
    one = none.clone()
    one[4321] = True
    dist, idx = knn.nearest_neighbor(x, y, pt2_valid=one)
    assert (idx == 4321).all()
    _assert_nn_close(x, y, one, dist, idx)


def test_cuda_nearest_neighbor_ties_go_to_the_lowest_index(dev):
    """Integer coordinates (every value exact in float32) and each
    reference repeated at several places, across runs, tiles and slices:
    the lowest index among the exactly nearest, under every plan."""
    from manus_tpu_torch.ops import knn

    rng = np.random.RandomState(3)
    base = rng.randint(-40, 40, (700, 3))
    y = np.concatenate([base, base[rng.permutation(700)], base[:300],
                        base[::-1]]).astype(np.float32)
    x = rng.randint(-45, 45, (5000, 3)).astype(np.float32)
    x[:700] = base  # distance 0, several copies each
    xt, yt = torch.tensor(x, device=dev), torch.tensor(y, device=dev)
    d2 = ((x[:, None].astype(np.int64) - y[None].astype(np.int64)) ** 2
          ).sum(-1)
    want_idx = d2.argmin(1)  # numpy: the first of equal minima
    want_d = np.sqrt(d2.min(1)).astype(np.float32)
    m = len(y)
    plans = [knn.knn_plan(len(x), m)] + [
        knn.KnnPlan(3, s, -(-m // s)) for s in (1, 2, 5, 7)]
    for plan in plans:
        dist, idx = knn.nearest_neighbor_cuda(xt, yt, plan=plan)
        np.testing.assert_array_equal(idx.cpu().numpy(), want_idx)
        np.testing.assert_array_equal(dist.cpu().numpy(), want_d)


def test_cuda_nearest_neighbor_same_bits_across_slices_and_tf32(dev):
    """One search under plans of 1 to 9 slices, and with TF32 allowed
    and not: the same bits (the kernel's float32 FMAs read no flag)."""
    from manus_tpu_torch.ops import knn

    x, y = _knn_clouds(4097, 20000, 11)
    x, y = torch.tensor(x, device=dev), torch.tensor(y, device=dev)
    valid = torch.tensor(np.random.RandomState(2).rand(20000) > 0.1,
                         device=dev)
    n, m = x.shape[0], y.shape[0]
    ref_d, ref_i = knn.nearest_neighbor_cuda(
        x, y, valid, plan=knn.KnnPlan(3, 1, m))
    for s in (2, 3, 6, 9):
        d, i = knn.nearest_neighbor_cuda(x, y, valid,
                                         plan=knn.KnnPlan(3, s, -(-m // s)))
        assert torch.equal(d, ref_d) and torch.equal(i, ref_i), s
    prev = torch.backends.cuda.matmul.allow_tf32
    for tf32 in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision("high" if tf32 else "highest")
        try:
            d, i = knn.nearest_neighbor(x, y, pt2_valid=valid)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
            torch.set_float32_matmul_precision("highest")
        assert torch.equal(d, ref_d) and torch.equal(i, ref_i), tf32
    _assert_nn_close(x, y, valid, ref_d, ref_i)


def test_cuda_nearest_neighbor_counts_launches_and_checks_inputs(dev):
    """One launch a call, whatever the plan; the library's shape is the
    plan's; the wrapper refuses what the kernel does not take."""
    import ctypes

    from manus_tpu_torch.ops import knn

    lib = knn.LIBRARY.get()
    cfg = (ctypes.c_int * 5)()
    lib.knn_config(cfg)
    assert list(cfg) == [knn.KNN_THREADS, knn.KNN_QUERIES, knn.KNN_TILE,
                         32, knn.KNN_CTAS_PER_SM]
    ctas = ctypes.c_int(0)
    assert lib.knn_occupancy(ctypes.byref(ctas)) == 0
    assert ctas.value >= knn.KNN_CTAS_PER_SM
    x = torch.rand(5000, 3, device=dev)
    y = torch.rand(3000, 3, device=dev)
    before = knn.nearest_neighbor_cuda.launches
    knn.nearest_neighbor(x, y)
    assert knn.nearest_neighbor_cuda.launches == before + 1
    knn.nearest_neighbor_cuda(x, y, plan=knn.KnnPlan(3, 2, 1500))
    assert knn.nearest_neighbor_cuda.launches == before + 2
    with pytest.raises(ValueError, match="float32"):
        knn.nearest_neighbor_cuda(x.double(), y)
    with pytest.raises(ValueError, match="contiguous"):
        knn.nearest_neighbor_cuda(x.t().contiguous().t(), y)
    with pytest.raises(ValueError, match="pt2_valid"):
        knn.nearest_neighbor_cuda(x, y, torch.ones(3000, device=dev))
    with pytest.raises(ValueError, match="does not cover"):
        knn.nearest_neighbor_cuda(x, y, plan=knn.KnnPlan(3, 2, 1000))
    with pytest.raises(ValueError, match="pt2"):
        knn.nearest_neighbor_cuda(x, y.cpu())
    # a transposed view through nearest_neighbor is made contiguous
    d, i = knn.nearest_neighbor(x.t().contiguous().t(), y)
    d0, i0 = knn.nearest_neighbor(x, y)
    assert torch.equal(d, d0) and torch.equal(i, i0)
    assert knn.nearest_neighbor_cuda.launches == before + 4


def test_cuda_composite_results_panels_match_plain(dev):
    """One `results` frame of a voxel-skinned hand and an object through
    its palm (2,800 + 3,000 gaussians, 128x128): the composite forward
    kernel (four launches, one a panel) against the plain composite on the
    same card, within chip_smoke.py's composite tolerance (1e-4, but at
    most 0.1% of pixels, each within 0.0101, where a walk stops one pair
    apart); the contacts equal (the same ops on the same inputs)."""
    from manus_tpu_torch.config import composite_config
    from manus_tpu_torch.data.synthetic import (
        gt_object_gaussians,
        hemisphere_cameras,
        procedural_skeleton,
        sample_gaussians_on_bones,
    )
    from manus_tpu_torch.data.voxel import build_voxel_grid
    from manus_tpu_torch.models.gaussians import init_gaussian_model
    from manus_tpu_torch.ops.skinning import bone_deformation_transforms
    from manus_tpu_torch.train.composite import (
        CompositeModels,
        make_composite_render,
    )

    skel = procedural_skeleton(2)
    pts, cols = sample_gaussians_on_bones(
        skel["rest_heads"], skel["rest_tails"], skel["rest_transforms"], 150,
        seed=0)
    kp = np.concatenate([skel["rest_heads"][:1], skel["rest_tails"]])
    center = skel["rest_heads"].mean(0)
    og = gt_object_gaussians(3000, seed=3)
    models = CompositeModels(
        hand=init_gaussian_model(pts, cols, 4096, device=dev),
        obj=init_gaussian_model(og["means"] * 0.12 + center, og["colors"],
                                3072, device=dev),
        voxel_grid=build_voxel_grid(kp, res=24, num_bones=len(skel["bnames"]),
                                    device=dev))
    cams = hemisphere_cameras(2, 128, 128, dist=0.45, center=center,
                              device=dev)
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    bone_tf = bone_deformation_transforms(
        t(skel["pose_transforms"][1]), t(skel["rest_transforms"]),
        append_identity=True)
    acc = torch.zeros(4096, device=dev)
    aux = torch.rand(4096, 3, device=dev)
    out = {}
    for backend in ("cuda", "torch"):
        fn = make_composite_render(composite_config(),
                                   RasterConfig(backend=backend), "results")
        calls = composite.composite_fwd_cuda.launches
        out[backend] = fn(models, bone_tf, cams[0], cams[1],
                          torch.zeros(3, device=dev), acc, aux)
        launched = composite.composite_fwd_cuda.launches - calls
        assert launched == (4 if backend == "cuda" else 0)
    (rk, ak, dk), (rp, ap, dp) = out["cuda"], out["torch"]
    assert rk.shape == (128, 512, 3)
    assert torch.equal(dk, dp) and torch.equal(ak, ap)
    assert (dk > 0).sum() > 0
    err = (rk - rp).abs().amax(-1)
    assert err.max() <= 0.0101 and (err > 1e-4).float().mean() <= 1e-3
    assert rk[:, :128].amax() > 0  # the rgb panel shows the scene


@pytest.mark.parametrize("rows,c", [(528, 512), (100, 24), (70001, 64),
                                    (4096, 256)])
def test_cuda_head_fp32_matches_plain(dev, rows, c):
    """The head kernels' fp32 form (the xla_dx LPIPS engine's rows): the
    forward within 1e-5 relative, the gradients within 1e-5 of their
    largest entry (fp32 in and out), equal bits over two launches, zero
    rows guarded, da alone equal to the two-output form's; mixed types
    raise."""
    from manus_tpu_torch.ops import conv

    g = torch.Generator(device="cpu").manual_seed(rows * c)
    a = torch.randn(rows, c, generator=g)
    b = torch.randn(rows, c, generator=g)
    a[::7] = 0
    b[::7] = 0
    a, b = a.to(dev), b.to(dev)
    lin = (torch.rand(c, generator=g) / c / rows).to(dev)
    got = conv.head_fwd_cuda(a, b, lin).item()
    want = conv.head_fwd_torch(a, b, lin).item()
    assert abs(got - want) <= 1e-5 * abs(want)
    assert conv.head_fwd_cuda(a, b, lin).item() == got
    ct = torch.tensor(0.7, device=dev)
    da, db = conv.head_bwd_cuda(a, b, lin, ct)
    da_ref, db_ref = conv.head_bwd_torch(a, b, lin * ct)
    assert da.dtype == db.dtype == torch.float32
    for x, ref in ((da, da_ref), (db, db_ref)):
        assert (x - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert not da[::7].any() and not db[::7].any()
    da_only, _ = conv.head_bwd_cuda(a, b, lin, ct, need_db=False)
    assert torch.equal(da_only, da)
    with pytest.raises(ValueError, match="bfloat16"):
        conv.head_fwd_cuda(a, b.to(torch.bfloat16), lin)


def test_cuda_ik_loop_matches_cpu_without_sync(dev, monkeypatch):
    """solve_ik on the 20-bone hand on the card: its AdaBelief iterations
    run under set_sync_debug_mode("error") (no host sync), and 30 of
    them agree with the CPU's to 1e-5 (the solve is chaotic after ~50)."""
    from chip_smoke import hand20_skeleton
    from manus_tpu_torch.preprocess import ik

    loop = ik.adabelief_loop

    def guarded(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(ik, "adabelief_loop", guarded)
    h = hand20_skeleton()
    chain = ik.make_chain(h["bnames"], h["parents"], h["rest_transforms"],
                          h["rest_heads"], h["rest_tails"])
    rng = np.random.RandomState(0)
    ang = np.where(chain.dof, rng.uniform(-0.3, 0.3, (21, 3)), 0)
    target = ik.chain_forward(chain, torch.tensor([0.01, 0.02, 0.0]),
                              torch.tensor(ang, dtype=torch.float32))[0]
    use = torch.ones(21, dtype=torch.bool)
    out = {}
    for d in ("cpu", dev):
        out[str(d)] = ik.solve_ik(chain, target.to(d), use.to(d), max_iter=30,
                                  tensors=ik.chain_tensors(chain, d))
    (tc, ac, lc), (tg, ag, lg) = out["cpu"], out[str(dev)]
    assert abs(lg - lc) <= 1e-4 * lc
    torch.testing.assert_close(ag.cpu(), ac, rtol=0, atol=1e-5)
    torch.testing.assert_close(tg.cpu(), tc, rtol=0, atol=1e-5)


def test_cuda_brics_capture_loads_on_the_card(dev, tmp_path):
    """A dynamic capture written by hdf5.write_tree (no h5py on the card's
    machine) loads with its cameras and bones on the card, and its
    batches assembled by the C++ library equal the numpy assembly."""
    from chip_smoke import hand20_skeleton
    from manus_tpu_torch.data import hdf5, prefetch
    from manus_tpu_torch.data.brics import BricsDynamicDataset
    from manus_tpu_torch.data.synthetic import hemisphere_cameras
    from manus_tpu_torch.preprocess.novel_pose import (
        generate_flexion_sequence)

    rng = np.random.RandomState(0)
    w, h = 96, 64
    cams = hemisphere_cameras(3, w, h, device="cpu")
    skel = hand20_skeleton()
    seq = generate_flexion_sequence(skel, num_frames=2, device="cpu")
    names = [f"cam{i:03d}" for i in range(3)]
    tree = {"K": {n: c.K.double().numpy() for n, c in zip(names, cams)},
            "extr": {n: c.extr.double().numpy()[:3]
                     for n, c in zip(names, cams)}, "frames": {}}
    for f in range(2):
        boxes = {n: np.asarray([5 + i, 3, 60 + i, 50]) for i, n in
                 enumerate(names)}
        md = {k: seq[k][f] if k.startswith("pose_") else seq[k]
              for k in ("rest_heads", "rest_tails", "rest_matrixs",
                        "pose_heads", "pose_tails", "pose_matrixs")}
        md.update(
            bnames=np.asarray([b.encode() for b in skel["bnames"]])[:, None],
            bnames_parent=np.asarray(
                [b.encode() for b in skel["bnames_parent"]])[:, None],
            eulers=np.zeros((20, 3), np.float32),
            root_translation=np.zeros(3, np.float32),
            root_rotation=np.zeros(3, np.float32))
        tree["frames"][str(f)] = {
            "images": {n: rng.randint(0, 256, (47, 55, 4)).astype(np.uint8)
                       for n in names},
            "bbox": boxes, "metadata": md}
    hdf5.write_tree(tmp_path / "act.hdf5", tree)
    ds = BricsDynamicDataset(str(tmp_path), w, h, split_ratio=0)
    assert ds.cameras.K.device.type == "cuda"
    assert ds.bones_rest.transforms.device.type == "cuda"
    assert ds.bones_posed[1].transforms.device.type == "cuda"
    np.testing.assert_allclose(ds.bones_posed[1].transforms.cpu().numpy(),
                               seq["pose_matrixs"][1], atol=1e-6)
    crops, bboxes = ds.read_crops(1, np.arange(3))
    got = ds.get_batch(1, np.arange(3))
    want = prefetch.assemble_batch_numpy(crops, bboxes, h, w,
                                         np.zeros(3, np.float32))
    np.testing.assert_allclose(got["rgb"], want[0], atol=1e-6)
    np.testing.assert_allclose(got["mask"], want[1], atol=1e-6)
    ds.close()


# The SSIM kernels (csrc/ssim.cu) against the plain banded version on the
# card: the training view's 720x1280 (rows whose 3 W floats take 16-byte
# loads) and the CPU test's odd shapes (rows that do not), plus 720x1280
# at a pointer off 16-byte alignment.
SSIM_SHAPES = [(720, 1280, 0), (5, 7, 0), (11, 11, 0), (37, 53, 0),
               (64, 96, 0), (720, 1280, 1)]
# Both sides are float32, their blurs summed in other orders (11 + 11 taps
# against cuBLAS's k-loop over the band). A map value moves by the
# rounding of the statistics, u E[x x] against B2 >= C2 where a window is
# flat, and the mean averages those roundings of either sign: 2e-6 on the
# value. The gradient's entries are sums of three blurred terms (the
# closed form, against autograd's chain), each within a few ulps of its
# partial maps' rounding: 1e-5 of the largest term, as
# tests/test_torch_ssim.py scales it.
SSIM_VALUE_ATOL, SSIM_GRAD_RTOL = 2e-6, 1e-5


def _ssim_images(h, w, seed, dev, offset=0):
    """(pred, gt) [h, w, 3] float32 in [0, 1] on the card, as a render and
    its view: a smooth field with fine noise, a black quarter (the
    background) in both, pred gt plus noise; `offset` floats into their
    buffers."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    yy, xx = torch.meshgrid(torch.linspace(0, 6, h, device=dev),
                            torch.linspace(0, 9, w, device=dev),
                            indexing="ij")
    base = 0.5 + 0.3 * torch.sin(yy)[..., None] * torch.cos(
        xx)[..., None] * torch.tensor([1.0, 0.7, 0.4], device=dev)
    gt = (base + 0.05 * torch.randn(h, w, 3, device=dev, generator=gen))
    pred = gt + 0.1 * torch.randn(h, w, 3, device=dev, generator=gen)
    out = []
    for img in (pred, gt):
        img = img.clamp(0, 1)
        img[: h // 2, : w // 2] = 0.0
        buf = torch.empty(offset + h * w * 3, device=dev)
        buf[offset:] = img.reshape(-1)
        out.append(buf[offset:].view(h, w, 3))
    return out


@pytest.mark.parametrize("h,w,offset", SSIM_SHAPES,
                         ids=[f"{h}x{w}" + ("_off" if o else "")
                              for h, w, o in SSIM_SHAPES])
def test_cuda_ssim_matches_plain(dev, h, w, offset):
    from manus_tpu_torch.utils import losses

    pred, gt = _ssim_images(h, w, h + w, dev, offset)
    leaf = pred.clone().requires_grad_(True)
    want = losses.ssim_torch(leaf, gt)
    want_g, = torch.autograd.grad(0.7 * want, leaf)
    # the kernels' input: a view `offset` floats into a buffer that takes
    # the gradient
    buf = torch.zeros(offset + pred.numel(), device=dev)
    buf[offset:] = pred.reshape(-1)
    buf.requires_grad_(True)
    got = losses.ssim_cuda(buf[offset:].view(h, w, 3), gt)
    got_g = torch.autograd.grad(0.7 * got, buf)[0][offset:].view(h, w, 3)
    assert abs(got.item() - want.item()) <= SSIM_VALUE_ATOL, (
        got.item(), want.item())
    _, part = losses.ssim_partials(pred.detach(), gt)
    blurred = [losses._depthwise_blur(p, 11, 1.5) for p in part]
    terms = (blurred[0].abs() + (2 * pred.detach() * blurred[1]).abs()
             + (gt * blurred[2]).abs()).max() * 0.7 / pred.numel()
    gap = (got_g - want_g).abs().max().item()
    assert gap <= SSIM_GRAD_RTOL * terms.item(), (gap, terms.item())


def test_cuda_ssim_counts_launches_and_repeats_its_bits(dev):
    """One forward and one backward launch a differentiated call, the
    forward alone under no_grad (no partial maps); two launches give the
    same bits, with or without the maps."""
    from manus_tpu_torch.utils import losses

    pred, gt = _ssim_images(72, 128, 5, dev)
    f0, b0 = losses.ssim_fwd_cuda.launches, losses.ssim_bwd_cuda.launches
    leaf = pred.clone().requires_grad_(True)
    value = losses.ssim(leaf, gt)
    g1, = torch.autograd.grad(value, leaf)
    assert (losses.ssim_fwd_cuda.launches - f0,
            losses.ssim_bwd_cuda.launches - b0) == (1, 1)
    with torch.no_grad():
        again = losses.ssim(leaf, gt)
    assert (losses.ssim_fwd_cuda.launches - f0,
            losses.ssim_bwd_cuda.launches - b0) == (2, 1)
    assert torch.equal(again, value.detach())
    value2, part = losses.ssim_fwd_cuda(pred, gt)
    _, none = losses.ssim_fwd_cuda(pred, gt, partials=False)
    assert none is None and torch.equal(value2, value.detach())
    g2 = losses.ssim_bwd_cuda(part, pred, gt, torch.ones((), device=dev))
    assert torch.equal(g1, g2)
    # a training step's form: the gt a slice of the batch, the loss 1 - s
    batch = torch.stack([gt, pred.detach()])
    leaf = pred.clone().requires_grad_(True)
    g3, = torch.autograd.grad(1.0 - losses.ssim(leaf, batch[0]), leaf)
    assert torch.equal(g3, -g1)


def test_cuda_ssim_checks_inputs(dev):
    from manus_tpu_torch.utils import losses

    pred, gt = _ssim_images(16, 24, 1, dev)
    with pytest.raises(ValueError, match="contiguous"):
        losses.ssim_cuda(pred.transpose(0, 1), gt.transpose(0, 1))
    with pytest.raises(ValueError, match="float32"):
        losses.ssim_cuda(pred.double(), gt.double())
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        losses.ssim_cuda(torch.rand(16, 24, 4, device=dev),
                         torch.rand(16, 24, 4, device=dev))
    with pytest.raises(ValueError, match="img2"):
        losses.ssim_cuda(pred, gt.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="img2"):
        losses.ssim_cuda(pred, gt[:8].contiguous())
    with pytest.raises(ValueError, match="11-tap"):
        losses.ssim_cuda(pred, gt, window_size=7)
    part = torch.empty(3, 16, 24, 3, device=dev)
    with pytest.raises(ValueError, match="grad"):
        losses.ssim_bwd_cuda(part, pred, gt, torch.ones(1, device=dev))


# ---------------------------------------------------------------------------
# The deformation kernels (csrc/deform.cu): covariance, skinning and the
# voxel grid's skin weights against the plain chain they replace.

DEFORM_ROWS = (131_072, 1_048_576)
# The forward's largest gap from the plain chain, in ulps of float32: the
# kernels round every operation as the chain does and add in the order
# ATen's reductions and cuBLAS's GEMM take on the card (0 read at both
# sizes). At 1,048,576 rows cuBLAS blends ~2e-5 of the transforms' entries
# in another order (read: 1.5e-5 to 1.8e-5 of each output, gaps of 2.4e-7
# in tf and 3e-8 in the posed mean): there the test takes the share of
# entries that differ and their largest gap over the output's largest
# entry.
DEFORM_FWD_ULPS = {"covariance": 0, "skin": 0, "skin_sample": 0}
DEFORM_1M_SKIN_SHARE, DEFORM_1M_SKIN_GAP = 1e-4, 1e-6
# The backward against autograd of the plain chain in float64, the largest
# gap over the leaf's largest entry: at most twice the float32 chain's own
# gap, or DEFORM_GRAD_RTOL where that is smaller. The closed forms gather
# terms that autograd adds one op at a time, and where the grid's weights
# nearly vanish the normalisation's gradient cancels in both orders.
DEFORM_GRAD_RTOL = 1e-6


def _ulps(x):
    """float32 bits on a line where neighbouring floats are 1 apart."""
    i = x.contiguous().view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def deform_forward_ulps(got, want) -> int:
    return int((_ulps(got) - _ulps(want)).abs().max())


def deform_inputs(n, dev):
    """chip_smoke.py's hand rows at the cells' widths (its DEFORM_BONES
    bones and DEFORM_GRID^3 grid, 2% of the positions outside it)."""
    from chip_smoke import deform_inputs as make
    return make(n, dev)


def _deform_case(kind, x, plain: bool, dtype=torch.float32):
    """(outputs, leaves' gradients) of one kernel or its plain chain (in
    `dtype`), from fresh leaves; the cotangents fixed by the seed."""
    from manus_tpu_torch.ops import deform
    from manus_tpu_torch.ops.skinning import skin_gaussians_torch

    dev = x["xyz"].device
    x = {k: v.to(dtype) for k, v in x.items()}
    if kind == "covariance":
        leaves = [x["scaling"].clone().requires_grad_(True),
                  x["rotation"].clone().requires_grad_(True)]
        fn = covariance_from_scaling_rotation_torch if plain \
            else deform.covariance_cuda
        outs = (fn(*leaves),)
    elif kind == "skin_sample":
        leaves = [x["xyz"].clone().requires_grad_(True)]
        fn = skinning_weights_from_voxel_grid_torch if plain \
            else deform.skin_sample_cuda
        outs = (fn(leaves[0], x["center"], x["scale"], x["grid"]),)
    else:
        leaves = [x["xyz"].clone().requires_grad_(True),
                  x["cov"].clone().requires_grad_(True),
                  x["weights"].clone().requires_grad_(True)]
        outs = tuple(skin_gaussians_torch(*leaves, x["transforms"])) if plain \
            else deform.skin_cuda(*leaves, x["transforms"])
    gen = torch.Generator(device=dev).manual_seed(7)
    loss = sum((o * torch.randn(o.shape, generator=gen, device=dev).to(
        dtype)).sum() for o in outs)
    return [o.detach() for o in outs], torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("n", DEFORM_ROWS)
@pytest.mark.parametrize("kind", ["covariance", "skin", "skin_sample"])
def test_cuda_deform_matches_plain(dev, kind, n):
    x = deform_inputs(n, dev)
    got, got_g = _deform_case(kind, x, plain=False)
    want, want_g = _deform_case(kind, x, plain=True)
    _, exact_g = _deform_case(kind, x, plain=True, dtype=torch.float64)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        if (kind, n) == ("skin", 1_048_576):
            share = (g != w).float().mean().item()
            gap = ((g - w).abs().max() / w.abs().max()).item()
            assert share <= DEFORM_1M_SKIN_SHARE, (g.shape, share)
            assert gap <= DEFORM_1M_SKIN_GAP, (g.shape, gap)
        else:
            ulps = deform_forward_ulps(g, w)
            assert ulps <= DEFORM_FWD_ULPS[kind], (kind, n, g.shape, ulps)
    for g, w, e in zip(got_g, want_g, exact_g):
        scale = e.abs().max()
        gap = ((g.double() - e).abs().max() / scale).item()
        plain_gap = ((w.double() - e).abs().max() / scale).item()
        assert gap <= max(2 * plain_gap, DEFORM_GRAD_RTOL), (
            kind, n, gap, plain_gap)


def test_cuda_deform_counts_launches(dev):
    """One launch a call each way, through the dispatching functions the
    callers use; the forward alone where nothing takes a gradient."""
    from manus_tpu_torch.ops import deform
    from manus_tpu_torch.ops.grid_sample import (
        skinning_weights_from_voxel_grid)
    from manus_tpu_torch.ops.skinning import skin_gaussians
    from manus_tpu_torch.utils.transforms import (
        covariance_from_scaling_rotation)

    fns = (deform.covariance_fwd_cuda, deform.covariance_bwd_cuda,
           deform.skin_fwd_cuda, deform.skin_bwd_cuda,
           deform.skin_sample_fwd_cuda, deform.skin_sample_bwd_cuda)
    x = deform_inputs(4096, dev)
    before = [f.launches for f in fns]

    def counts():
        return tuple(f.launches - b for f, b in zip(fns, before))

    xyz = x["xyz"].clone().requires_grad_(True)
    s = x["scaling"].clone().requires_grad_(True)
    r = x["rotation"].clone().requires_grad_(True)
    w = skinning_weights_from_voxel_grid(xyz, x["center"], x["scale"],
                                         x["grid"])
    cov = covariance_from_scaling_rotation(s, r)
    sk = skin_gaussians(xyz, cov, w, x["transforms"])
    assert counts() == (1, 0, 1, 0, 1, 0)
    loss = sk.posed_xyz.sum() + sk.posed_cov.sum() + sk.tf.sum()
    torch.autograd.grad(loss, [xyz, s, r])
    assert counts() == (1, 1, 1, 1, 1, 1)
    with torch.no_grad():
        w = skinning_weights_from_voxel_grid(xyz, x["center"], x["scale"],
                                             x["grid"])
        skin_gaussians(xyz, covariance_from_scaling_rotation(s, r), w,
                       x["transforms"])
    assert counts() == (2, 1, 2, 1, 2, 1)
    # the detached sample of a training step: tf takes no gradient
    w = skinning_weights_from_voxel_grid(xyz.detach(), x["center"],
                                         x["scale"], x["grid"])
    sk = skin_gaussians(xyz, covariance_from_scaling_rotation(s, r), w,
                        x["transforms"])
    assert not sk.tf.requires_grad
    torch.autograd.grad(sk.posed_xyz.sum() + sk.posed_cov.sum(), [xyz, s, r])
    assert counts() == (3, 2, 3, 2, 3, 1)
    # an isotropic model's expanded scale, as get_scaling hands it over
    s1 = x["scaling"][:, :1].clone().requires_grad_(True)
    iso = covariance_from_scaling_rotation(s1.expand(-1, 3), r)
    want = covariance_from_scaling_rotation(
        s1.detach().expand(-1, 3).contiguous(), r.detach())
    assert torch.equal(iso.detach(), want)
    g, = torch.autograd.grad(iso.sum(), s1)
    assert g.shape == s1.shape and counts() == (5, 3, 3, 2, 3, 1)


def test_cuda_deform_checks_inputs(dev):
    from manus_tpu_torch.ops import deform

    x = deform_inputs(256, dev)
    cov = deform.covariance_cuda(x["scaling"], x["rotation"])
    w = deform.skin_sample_cuda(x["xyz"], x["center"], x["scale"],
                                x["grid"])
    T = x["transforms"]
    with pytest.raises(ValueError, match="float32"):
        deform.covariance_cuda(x["scaling"].double(), x["rotation"].double())
    with pytest.raises(ValueError, match="scaling"):
        deform.covariance_cuda(x["scaling"][:, :2], x["rotation"])
    with pytest.raises(ValueError, match="float32"):
        deform.skin_cuda(x["xyz"].double(), cov.double(), w.double(),
                         T.double())
    with pytest.raises(ValueError, match="skin_weights"):
        deform.skin_cuda(x["xyz"], cov, w[:, :-1], T)
    with pytest.raises(ValueError, match=r"\[B, 4, 4\]"):
        deform.skin_cuda(x["xyz"], cov, w, T.reshape(-1, 16))
    many = deform.DEFORM_MAX_CHANNELS + 1
    with pytest.raises(ValueError, match="bones"):
        deform.skin_cuda(x["xyz"], cov, torch.rand(256, many, device=dev),
                         torch.eye(4, device=dev).repeat(many, 1, 1))
    with pytest.raises(ValueError, match="transforms"):
        deform.skin_cuda(x["xyz"], cov, w, T.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="float32"):
        deform.skin_sample_cuda(x["xyz"].double(), x["center"], x["scale"],
                                x["grid"])
    with pytest.raises(ValueError, match="channels"):
        deform.skin_sample_cuda(x["xyz"], x["center"], x["scale"],
                                torch.rand(4, 4, 4, many, device=dev))
    with pytest.raises(ValueError, match="grid"):
        deform.skin_sample_cuda(x["xyz"], x["center"], x["scale"],
                                x["grid"].clone().requires_grad_(True))
