"""Parity of the PyTorch port's LPIPS stack with the JAX package.

The port runs on the CPU, where every kernel wrapper runs its plain
PyTorch version; the JAX package runs its Pallas kernels in interpret
mode, as tests/test_conv_pallas.py does. Inputs are made with numpy and
handed to both.

bf16 tolerances: both sides round the same values to bf16 at the same
places (the layout input, every conv output, the dx outputs, the head
gradients) and accumulate in fp32, but in another order. So a bf16
output agrees exactly or differs by one bf16 ulp where the fp32 sums
straddle a rounding boundary; a ReLU output can also differ from 0 where
the pre-activation is within rounding of 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manus_tpu.ops import conv_pallas as jconv
from manus_tpu.train import lpips as jlpips
from manus_tpu.utils import losses as jlosses
from manus_tpu_torch.models.convert import (
    lpips_params_from_numpy,
    lpips_params_to_numpy,
)
from manus_tpu_torch.ops import conv as tconv
from manus_tpu_torch.train import lpips as tlpips
from manus_tpu_torch.utils import losses as tlosses

# (h, w, ci, co): the JAX package's layout-conv test shapes: odd W+2
# (tile_h granule 16), even W+2, the 720p stage-4 odd width scaled down,
# and several row blocks.
SHAPES = [(13, 9, 3, 8), (16, 16, 8, 16), (45, 45, 16, 8), (7, 4, 4, 4)]
SHAPE_IDS = ["odd_w2", "even_w2", "45x45", "multi_block"]
# A bf16 output may differ by one ulp on at most this share of its values
# (sums in another order), and by more only where a ReLU'd value is within
# rounding of 0 on one side.
ULP_SHARE = 0.01


def _np(t):
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _bf16_order(x):
    """float values that are bf16 -> ints ordered like the values, one
    step per bf16 ulp."""
    bits = torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16).view(
        torch.int16).numpy().astype(np.int32)
    mag = bits & 0x7FFF
    return np.where(bits < 0, -mag, mag)


def _assert_bf16_close(got, want, what, share=ULP_SHARE, exact=None):
    """got (the port) and want (JAX) agree exactly or by one bf16 ulp, on
    all but `share` of the values by none, and by more only near a ReLU's
    0. With `exact` (a float64 value of the same formula on the same
    inputs), a value where they differ by more than one ulp passes when
    the port is no farther from it than JAX is, plus one ulp: where the
    formula cancels (the head's d_normed), two fp32 orders of summation
    can land two ulps apart, and the exact value decides which is off."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    ulps = np.abs(_bf16_order(got) - _bf16_order(want))
    near_zero = (np.minimum(np.abs(got), np.abs(want)) == 0) & (
        np.maximum(np.abs(got), np.abs(want)) <= 1e-2 * np.abs(want).max())
    beyond = (ulps > 1) & ~near_zero
    if exact is not None:
        assert exact.shape == got.shape, what
        ulp = np.spacing(np.abs(exact).astype(np.float32)) * 2.0 ** 16
        port_nearer = (np.abs(got - exact)
                       <= np.abs(want.astype(np.float64) - exact) + ulp)
        assert port_nearer[beyond].all(), (
            f"{what}: {int((beyond & ~port_nearer).sum())} values beyond one "
            f"ulp of JAX's and farther than JAX's from the float64 value")
        beyond &= ~port_nearer
    assert not beyond.any(), (
        f"{what}: {int(beyond.sum())} values beyond one ulp, "
        f"max {ulps.max()}")
    frac = float((ulps > 0).mean())
    assert frac <= share, f"{what}: {frac:.4f} of the values differ"


def _head_f64(a, b, lin, ct):
    """The head and its VJP in float64 from the same (bf16-valued) rows:
    _head_bwd_kernel's formula (manus_tpu/ops/conv_pallas.py), with
    d_normed(x, r, g) = g/(r+eps) - x (x.g) / (r (r+eps)^2) and
    g = 2 lin (na - nb). Returns (value, da, db)."""
    a, b = (np.asarray(_np(x), np.float64) for x in (a, b))
    lin = np.asarray(lin, np.float64).reshape(1, -1)
    ra = np.sqrt((a * a).sum(1, keepdims=True))
    rb = np.sqrt((b * b).sum(1, keepdims=True))
    na, nb = a / (ra + 1e-10), b / (rb + 1e-10)
    g = 2.0 * lin * (na - nb)

    def d_normed(x, r):
        dot = (x * g).sum(1, keepdims=True)
        safe_r = np.where(r > 0, r, 1.0)
        return g / (r + 1e-10) - x * (dot / (safe_r * (r + 1e-10) ** 2))

    value = float((lin * (na - nb) ** 2).sum())
    return value, ct * d_normed(a, ra), -ct * d_normed(b, rb)


def _conv_case(h, w, ci, co, seed):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (h, w, ci)).astype(np.float32)
    wk = rng.normal(0, 0.3, (3, 3, ci, co)).astype(np.float32)
    b = rng.normal(0, 0.2, (co,)).astype(np.float32)
    return rng, x, wk, b


def _jax_layout(h, w, ci, co):
    return jconv.StageLayout(h, w, max(ci, co, 128))


def _port_layout(h, w, ci, co):
    return tconv.StageLayout(h, w, max(ci, co, 128))


@pytest.mark.parametrize("h,w,c_max", [
    (512, 512, 128), (256, 256, 128), (128, 128, 256), (64, 64, 512),
    (32, 32, 512), (13, 9, 128), (16, 16, 128), (45, 45, 128), (7, 4, 128),
    (80, 45, 512)])
def test_stage_layout_matches_jax(h, w, c_max):
    """The geometry at the 512^2 VGG stages and the test shapes."""
    want, got = jconv.StageLayout(h, w, c_max), tconv.StageLayout(h, w, c_max)
    for k in ("h", "w", "tile_h", "m_blk", "n_blocks", "rows", "lead",
              "shift"):
        assert getattr(got, k) == getattr(want, k), k


@pytest.mark.parametrize("h,w,c", [(9, 5, 3), (16, 32, 64), (45, 45, 8)])
def test_build_layout_and_unlayout_match_jax(h, w, c):
    """Row for row, real channels exact (the same bf16 cast); the port's
    padding channels (up to 16) and its non-pixel rows are zero."""
    x = np.random.RandomState(h * 7 + w).normal(0, 1, (h, w, c)).astype(
        np.float32)
    jl, tl = jconv.StageLayout(h, w, 128), tconv.StageLayout(h, w, 128)
    want = _np(jconv.build_layout(jnp.asarray(x), jl))
    got = tconv.build_layout(torch.tensor(x), tl)
    assert got.dtype == torch.bfloat16 and got.shape == (tl.rows, max(c, 16))
    np.testing.assert_array_equal(_np(got), want[:, : got.shape[1]])
    assert not want[:, got.shape[1]:].any()
    back = tconv.unlayout(got, tl)
    np.testing.assert_array_equal(
        _np(back), _np(jconv.unlayout(jnp.asarray(want), jl))[..., : back.shape[-1]])
    valid = tconv.valid_rows(tl, "cpu")
    assert int(valid.sum()) == h * w
    assert not _np(got)[~valid.numpy()].any()


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("h,w,ci,co", SHAPES, ids=SHAPE_IDS)
def test_conv3x3_layout_matches_jax(h, w, ci, co, relu):
    """Kernel 3's plain version against conv3x3_layout_raw, one layer."""
    _, x, wk, b = _conv_case(h, w, ci, co, h * 31 + w)
    jl = _jax_layout(h, w, ci, co)
    want = jconv.conv3x3_layout_raw(
        jconv.build_layout(jnp.asarray(x), jl), jnp.asarray(wk),
        jnp.asarray(b), relu, jl, interpret=True)
    tl = _port_layout(h, w, ci, co)
    p = tconv.pack_conv3x3(torch.tensor(wk), torch.tensor(b))
    got = tconv.conv3x3_layout_raw(tconv.build_layout(torch.tensor(x), tl),
                                   p.w, p.b, relu, tl)
    assert got.dtype == torch.bfloat16 and got.shape == (tl.rows, p.co)
    _assert_bf16_close(got[:, :co], _np(want)[:, :co], "conv")
    assert not _np(got)[:, co:].any()


@pytest.mark.parametrize("h,w,ci,co", SHAPES, ids=SHAPE_IDS)
def test_conv3x3_layout_dx_matches_jax(h, w, ci, co):
    """Kernel 4's plain version against conv3x3_layout_dx_raw: a random
    bf16 cotangent (junk rows too) masked by the layer's own output."""
    rng, x, wk, b = _conv_case(h, w, ci, co, h * 17 + w)
    jl = _jax_layout(h, w, ci, co)
    yl = jconv.conv3x3_layout_raw(
        jconv.build_layout(jnp.asarray(x), jl), jnp.asarray(wk),
        jnp.asarray(b), True, jl, interpret=True)
    g = rng.normal(0, 1, (jl.rows, co)).astype(np.float32)
    g = _np(jnp.asarray(g, jnp.bfloat16))
    gl = jnp.pad(jnp.asarray(g, jnp.bfloat16), ((0, 0), (0, yl.shape[1] - co)))
    w_t = jnp.flip(jnp.asarray(wk), axis=(0, 1)).transpose(0, 1, 3, 2)
    want = jconv.conv3x3_layout_dx_raw(gl, yl, w_t, jl, interpret=True)

    tl = _port_layout(h, w, ci, co)
    p = tconv.pack_conv3x3(torch.tensor(wk), torch.tensor(b))
    pad = p.co - co
    g_t = torch.nn.functional.pad(torch.tensor(g), (0, pad)).to(torch.bfloat16)
    y_t = torch.tensor(_np(yl)[:, : p.co]).to(torch.bfloat16)
    got = tconv.conv3x3_layout_dx_raw(g_t, y_t, p.w_t, tl)
    assert got.shape == (tl.rows, p.ci)
    _assert_bf16_close(got[:, :ci], _np(want)[:, :ci], "dx")
    assert not _np(got)[:, ci:].any()


@pytest.mark.parametrize("rows,c", [(96, 64), (40, 512), (8, 16)])
def test_head_stage_matches_jax(rows, c):
    """Kernels 5 and 6's plain versions against head_stage_layout, with
    all-zero rows in both features and in one only. Value: 1e-6 relative
    (fp32 sums in another order). Gradients: bf16, exact or one ulp, and
    beyond one ulp only where the port is no farther than JAX from the
    float64 head (_head_f64), plus one ulp."""
    rng = np.random.RandomState(rows + c)
    a = rng.normal(0, 1, (rows, c)).astype(np.float32)
    b = rng.normal(0, 1, (rows, c)).astype(np.float32)
    a[::5] = 0
    b[::5] = 0
    b[1] = 0
    a, b = (_np(jnp.asarray(v, jnp.bfloat16)) for v in (a, b))
    lin = (rng.uniform(0, 1, (c,)) / c / 37).astype(np.float32)
    ct = 1.7
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    jlin = jnp.asarray(lin)[None]
    want, vjp = jax.vjp(
        lambda u, v: jconv.head_stage_layout(u, v, jlin, True), ja, jb)
    want_da, want_db = vjp(jnp.asarray(ct, jnp.float32))

    ta = torch.tensor(a).to(torch.bfloat16).requires_grad_(True)
    tb = torch.tensor(b).to(torch.bfloat16).requires_grad_(True)
    got = tconv.head_stage_layout(ta, tb, torch.tensor(lin))
    da, db = torch.autograd.grad(got * ct, [ta, tb])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert da.dtype == db.dtype == torch.bfloat16
    _, exact_da, exact_db = _head_f64(a, b, lin, ct)
    _assert_bf16_close(da, want_da, "da", exact=exact_da)
    _assert_bf16_close(db, want_db, "db", exact=exact_db)


# (h, w, c): head stages on real layouts: 64 channels, which the JAX
# layout carries in 128 lanes, and 512 at a stage of one row block.
HEAD_STAGES = [(32, 32, 64), (8, 8, 512)]
HEAD_STAGE_IDS = ["32x32x64", "8x8x512"]


def _head_layout_case(h, w, c):
    """Stage features of both packages' build_layout (border rows zero),
    with a pixel that is zero in both and one zero in b only, the head's
    lin_eff, and the port's StageLayout."""
    rng = np.random.RandomState(h * w + c)
    x1 = rng.normal(0, 1, (h, w, c)).astype(np.float32)
    x2 = rng.normal(0, 1, (h, w, c)).astype(np.float32)
    x1[0, 0] = x2[0, 0] = 0
    x2[1, 2] = 0
    lin = (rng.uniform(0, 1, (c,)) / c / (h * w)).astype(np.float32)
    jl = jconv.StageLayout(h, w, max(c, 128))
    tl = tconv.StageLayout(h, w, max(c, 128))
    ja, jb = (jconv.build_layout(jnp.asarray(x), jl) for x in (x1, x2))
    ta, tb = (tconv.build_layout(torch.tensor(x), tl) for x in (x1, x2))
    np.testing.assert_array_equal(_np(ta), _np(ja)[:, :c])
    return ja, jb, ta, tb, lin, tl


@pytest.mark.parametrize("need_db", [True, False], ids=["da_db", "da_only"])
@pytest.mark.parametrize("h,w,c", HEAD_STAGES, ids=HEAD_STAGE_IDS)
def test_head_stage_span_matches_jax(h, w, c, need_db):
    """head_stage_layout over the layout's pixel span (the train step's
    form: with L, and da alone where b is detached) against the JAX head
    over every row of its layout. Tolerances as in
    test_head_stage_matches_jax. The float64 head is what decides at
    32x32x64: one db entry out of 1024x64 lies 2 ulps from JAX's (port
    1.05160e-11, JAX 1.04023e-11, float64 1.04870e-11), where d_normed's
    two terms cancel and the fp32 sums' order decides the rounding; the
    port is the nearer of the two."""
    ja, jb, ta, tb, lin, L = _head_layout_case(h, w, c)
    jlin = jnp.zeros((1, ja.shape[1]), jnp.float32).at[0, :c].set(lin)
    ct = 1.7
    want, vjp = jax.vjp(
        lambda u, v: jconv.head_stage_layout(u, v, jlin, True), ja, jb)
    want_da, want_db = vjp(jnp.asarray(ct, jnp.float32))

    ta.requires_grad_(True)
    tb.requires_grad_(need_db)
    got = tconv.head_stage_layout(ta, tb, torch.tensor(lin), L)
    grads = torch.autograd.grad(got * ct, [ta, tb] if need_db else [ta])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    _, exact_da, exact_db = _head_f64(ta, tb, lin, ct)
    _assert_bf16_close(grads[0], _np(want_da)[:, :c], "da", exact=exact_da)
    if need_db:
        _assert_bf16_close(grads[1], _np(want_db)[:, :c], "db",
                           exact=exact_db)


@pytest.mark.parametrize("h,w,c", HEAD_STAGES, ids=HEAD_STAGE_IDS)
def test_head_plain_span_equals_every_row(h, w, c):
    """The plain versions over the pixel span and over every row of a
    layout whose other rows are zero: the value within 1e-6 relative (fp32
    sums of another length), the gradients bit for bit, and the da-only
    form's da equal to the two-output form's."""
    _, _, a, b, lin, L = _head_layout_case(h, w, c)
    lin = torch.tensor(lin)
    assert L.m_blk > 0 and L.m_blk + L.n_valid < L.rows
    np.testing.assert_allclose(tconv.head_fwd_torch(a, b, lin, L).item(),
                               tconv.head_fwd_torch(a, b, lin).item(),
                               rtol=1e-6)
    lin_scaled = lin * 1.7
    da, db = tconv.head_bwd_torch(a, b, lin_scaled)
    da_span, db_span = tconv.head_bwd_torch(a, b, lin_scaled, L)
    da_only, none = tconv.head_bwd_torch(a, b, lin_scaled, L, need_db=False)
    assert none is None
    assert torch.equal(da_span, da) and torch.equal(db_span, db)
    assert torch.equal(da_only, da_span)
    assert da.abs().max() > 0 and db.abs().max() > 0


def test_maxpool2x2_layout_matches_jax_with_ties():
    """Values equal, and gradients equal under the chain's invariant (no
    cotangent on rows that hold no pixel), with ties in the windows: both
    split a tie's gradient evenly."""
    rng = np.random.RandomState(3)
    for h, w in ((32, 32), (45, 64)):
        jla, jlb = jconv.StageLayout(h, w, 128), jconv.StageLayout(h // 2, w // 2, 128)
        tla, tlb = tconv.StageLayout(h, w, 128), tconv.StageLayout(h // 2, w // 2, 128)
        x = (rng.randint(0, 4, (h, w, 16)) / 4).astype(np.float32)
        xl = jconv.build_layout(jnp.asarray(x), jla)
        want, vjp = jax.vjp(lambda a: jconv.maxpool2x2_layout(a, jla, jlb), xl)
        ct = rng.normal(0, 1, (jlb.rows, 16)).astype(np.float32)
        ct = ct * tconv.valid_rows(tlb, "cpu").numpy()[:, None]
        ct = _np(jnp.asarray(ct, jnp.bfloat16))
        ct_j = jnp.pad(jnp.asarray(ct, jnp.bfloat16), ((0, 0), (0, 112)))
        (want_g,) = vjp(ct_j)

        txl = tconv.build_layout(torch.tensor(x), tla).requires_grad_(True)
        got = tconv.maxpool2x2_layout(txl, tla, tlb)
        np.testing.assert_array_equal(_np(got), _np(want)[:, :16])
        (g,) = torch.autograd.grad(got, [txl], torch.tensor(ct).to(torch.bfloat16))
        np.testing.assert_array_equal(_np(g), _np(want_g)[:, :16])
        win = x[: h // 2 * 2].reshape(h // 2, 2, w // 2, 2, 16)
        ties = (win == win.max(axis=(1, 3), keepdims=True)).sum(axis=(1, 3))
        assert (ties > 1).mean() > 0.3  # the case has many ties


def test_maxpool2x2_matches_jax():
    x = np.random.RandomState(4).normal(0, 1, (17, 9, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tconv.maxpool2x2(torch.tensor(x))),
        _np(jconv.maxpool2x2(jnp.asarray(x))))


@pytest.mark.parametrize("h,w,ci,co", SHAPES, ids=SHAPE_IDS)
def test_conv3x3_image_matches_jax(h, w, ci, co):
    """Kernel 7 (the conv of a plain [H, W, Ci] image) against
    conv3x3_raw, and its gradient (through the dx conv) against conv3x3's
    custom VJP under a random cotangent."""
    rng, x, wk, b = _conv_case(h, w, ci, co, h * 13 + w)
    want = jconv.conv3x3_raw(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b),
                             True, interpret=True)
    p = tconv.pack_conv3x3(torch.tensor(wk), torch.tensor(b))
    tx = torch.tensor(x).requires_grad_(True)
    got = tconv.conv3x3(tx, p, True)
    assert got.shape == (h, w, co)
    _assert_bf16_close(got, want, "conv3x3")
    np.testing.assert_array_equal(
        _np(tconv.conv3x3_raw(torch.tensor(x), p, True)), _np(got))

    r = rng.normal(0, 1, (h, w, co)).astype(np.float32)
    r = _np(jnp.asarray(r, jnp.bfloat16))
    _, vjp = jax.vjp(lambda v: jconv.conv3x3(v, jnp.asarray(wk),
                                             jnp.asarray(b), True, True),
                     jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(r, jnp.bfloat16))
    (g,) = torch.autograd.grad(got, [tx], torch.tensor(r).to(torch.bfloat16))
    assert g.dtype == torch.float32
    _assert_bf16_close(g, want_g, "conv3x3 dx")


@pytest.mark.parametrize("h,w,ci,co", SHAPES[:2], ids=SHAPE_IDS[:2])
def test_conv3x3_image_linear_matches_jax(h, w, ci, co):
    """Kernel 7 without ReLU, whose gradient is the conv with the dx
    weights and no bias, against conv3x3's custom VJP; on the CPU no
    kernel's launch count moves."""
    rng, x, wk, b = _conv_case(h, w, ci, co, h * 5 + w)
    want = jconv.conv3x3_raw(jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b),
                             False, interpret=True)
    counts = [f.launches for f in (tconv.conv3x3_image_cuda,
                                   tconv.conv3x3_layout_cuda,
                                   tconv.conv3x3_layout_dx_cuda)]
    p = tconv.pack_conv3x3(torch.tensor(wk), torch.tensor(b))
    tx = torch.tensor(x).requires_grad_(True)
    got = tconv.conv3x3(tx, p, False)
    _assert_bf16_close(got, want, "conv3x3 linear")

    r = _np(jnp.asarray(rng.normal(0, 1, (h, w, co)), jnp.bfloat16))
    _, vjp = jax.vjp(lambda v: jconv.conv3x3(v, jnp.asarray(wk),
                                             jnp.asarray(b), False, True),
                     jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(r, jnp.bfloat16))
    (g,) = torch.autograd.grad(got, [tx], torch.tensor(r).to(torch.bfloat16))
    _assert_bf16_close(g, want_g, "conv3x3 linear dx")
    assert counts == [f.launches for f in (tconv.conv3x3_image_cuda,
                                           tconv.conv3x3_layout_cuda,
                                           tconv.conv3x3_layout_dx_cuda)]


def test_random_lpips_params_bit_equal_and_convert():
    """VGG16 and, since the AlexNet metric is ported, AlexNet: the same
    draws as the JAX package's; an arch of neither raises."""
    for arch in ("vgg", "alex"):
        want = jlpips.random_lpips_params(0, arch)
        got = tlpips.random_lpips_params(0, arch, device="cpu")
        assert list(got) == list(want)
        assert tlpips.infer_arch(got) == jlpips.infer_arch(want) == arch
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          k)
        back = lpips_params_from_numpy(
            {k: np.asarray(v) for k, v in want.items()}, "cpu")
        for k, v in lpips_params_to_numpy(back).items():
            np.testing.assert_array_equal(v, np.asarray(want[k]), k)
    with pytest.raises(KeyError):
        tlpips.random_lpips_params(0, "squeeze", device="cpu")


def test_load_lpips_params_reads_the_converter_npz(tmp_path):
    params = tlpips.random_lpips_params(1, device="cpu")
    path = tmp_path / "vgg.npz"
    np.savez(path, **lpips_params_to_numpy(params))
    loaded = tlpips.load_lpips_params(str(path), device="cpu")
    want = jlpips.load_lpips_params(str(path))
    assert set(loaded) == set(want) == set(params)
    for k in params:
        np.testing.assert_array_equal(loaded[k].numpy(), np.asarray(want[k]))
    assert tlpips.load_lpips_params(str(tmp_path / "none.npz")) is None
    logs = []
    _, mode = tlpips.resolve_lpips_params_mode(str(path), log=logs.append,
                                               device="cpu")
    assert mode == "vgg:pretrained"
    p, mode = tlpips.resolve_lpips_params_mode("", log=logs.append,
                                               device="cpu")
    assert mode == "vgg:random-feature" and set(p) == set(params)
    assert tlpips.resolve_lpips_params_mode(
        "", allow_fallback=False, log=logs.append, device="cpu") == (None, "off")


def test_resolve_lpips_engine():
    """The five names of loss.lpips_conv: "auto" is the layout chain for
    VGG16 and "xla" for AlexNet; AlexNet runs on "xla" alone; an unknown
    name raises."""
    params = tlpips.random_lpips_params(0, device="cpu")
    alex = tlpips.random_lpips_params(0, "alex", device="cpu")
    assert tlpips.resolve_lpips_engine("auto", params) == "pallas"
    assert tlpips.resolve_lpips_engine("auto", alex) == "xla"
    for name in ("pallas", "xla", "xla_dx", "xla_dx_bf16"):
        assert tlpips.resolve_lpips_engine(name, params) == name
    assert tlpips.resolve_lpips_engine("xla", alex) == "xla"
    for name in ("pallas", "xla_dx", "xla_dx_bf16"):
        with pytest.raises(ValueError, match="VGG16 only"):
            tlpips.resolve_lpips_engine(name, alex)
    with pytest.raises(ValueError, match="unknown lpips_conv"):
        tlpips.resolve_lpips_engine("cudnn", params)


def test_make_train_step_checks_the_lpips_engine_once():
    """The step builder resolves loss.lpips_conv when it is built: every
    engine name builds, an unknown one raises; without lpips_loss in the
    loss list, lpips_conv is not read."""
    import dataclasses

    from manus_tpu_torch import config as tconfig
    from manus_tpu_torch.train import workloads as twork

    params = tlpips.random_lpips_params(0, device="cpu")
    cfg = tconfig.hand_config()
    cfg.skin_init = "mano_init_points"
    for conv in ("auto", "pallas", "xla", "xla_dx", "xla_dx_bf16"):
        cfg.loss = dataclasses.replace(cfg.loss, lpips_conv=conv)
        assert callable(twork.make_train_step(cfg, 1.0, True,
                                              lpips_params=params))
    cfg.loss = dataclasses.replace(cfg.loss, lpips_conv="cudnn")
    with pytest.raises(ValueError, match="cudnn"):
        twork.make_train_step(cfg, 1.0, True, lpips_params=params)
    cfg.loss = dataclasses.replace(cfg.loss, losses=("rgb_loss",),
                                   loss_weight=(1.0,))
    assert callable(twork.make_train_step(cfg, 1.0, True, lpips_params=params))


@pytest.fixture(scope="module")
def distance_case():
    """LPIPS value and image gradient at 32x32 from the JAX package's
    layout engine (Pallas, interpret mode), computed once."""
    rng = np.random.RandomState(2)
    img1 = rng.rand(32, 32, 3).astype(np.float32)
    img2 = rng.rand(32, 32, 3).astype(np.float32)
    params = jlpips.random_lpips_params(0, "vgg")
    d, g = jax.value_and_grad(lambda a: jlpips.lpips_distance_pallas(
        params, a, jnp.asarray(img2), interpret=True))(jnp.asarray(img1))
    return dict(img1=img1, img2=img2, params=params, d=float(d),
                g=np.asarray(g))


def _port_distance(params, img1, img2, cached=False):
    x = torch.tensor(img1).requires_grad_(True)
    if cached:
        feats = tlpips.lpips_features(params, torch.tensor(img2))
        d = tlpips.lpips_distance_cached(params, x, feats)
    else:
        d = tlpips.lpips_distance(params, x, torch.tensor(img2))
    (g,) = torch.autograd.grad(d, [x])
    return d, g


def test_lpips_distance_matches_jax(distance_case):
    """Value within 1e-4 relative and image gradient with cosine above
    0.9999 and norm within 1e-3 (measured: 5.4e-6, 0.999985, 7.3e-5):
    the chains agree bit for bit except where one bf16 rounding goes the
    other way (conv sums in another order), and such a flip moves a few
    downstream values by an ulp."""
    c = distance_case
    params = lpips_params_from_numpy(
        {k: np.asarray(v) for k, v in c["params"].items()}, "cpu")
    d, g = _port_distance(params, c["img1"], c["img2"])
    assert d.dtype == torch.float32 and d.item() > 0
    assert abs(d.item() - c["d"]) <= 1e-4 * c["d"], (d.item(), c["d"])
    g, want = g.numpy().ravel(), c["g"].ravel()
    cos = g @ want / (np.linalg.norm(g) * np.linalg.norm(want))
    rel = abs(np.linalg.norm(g) / np.linalg.norm(want) - 1)
    assert cos > 0.9999 and rel < 1e-3, (cos, rel)


def test_lpips_distance_cached_equals_uncached(distance_case):
    c = distance_case
    params = tlpips.random_lpips_params(0, device="cpu")
    d0, g0 = _port_distance(params, c["img1"], c["img2"])
    d1, g1 = _port_distance(params, c["img1"], c["img2"], cached=True)
    assert d1.item() == d0.item()
    np.testing.assert_array_equal(g1.numpy(), g0.numpy())
    same = tlpips.lpips_distance(params, torch.tensor(c["img1"]),
                                 torch.tensor(c["img1"]))
    assert same.item() < 1e-6


def test_compute_losses_l2_and_lpips_terms():
    """l2_loss against the JAX package's; lpips_loss is 0 without params,
    an fp32 0 below the gate, and the distance of the pooled images above
    it (with or without the gt features)."""
    rng = np.random.RandomState(5)
    pred = rng.rand(32, 32, 3).astype(np.float32)
    gt = rng.rand(32, 32, 3).astype(np.float32)
    sc = rng.rand(10, 3).astype(np.float32)
    names, weights = ("rgb_loss", "l2_loss", "lpips_loss"), (0.8, 0.5, 0.1)
    jtot, jparts = jlosses.compute_losses(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(sc),
        jnp.ones(10, bool), names, weights)
    t = dict(pred_image=torch.tensor(pred), gt_image=torch.tensor(gt),
             scaling=torch.tensor(sc), active=torch.ones(10, dtype=torch.bool),
             loss_names=names, loss_weights=weights)
    tot, parts = tlosses.compute_losses(**t)
    np.testing.assert_allclose(parts["l2_loss"].item(),
                               float(jparts["l2_loss"]), rtol=1e-6)
    np.testing.assert_allclose(tot.item(), float(jtot), rtol=1e-6)
    assert parts["lpips_loss"].item() == 0.0

    params = tlpips.random_lpips_params(0, device="cpu")
    _, parts = tlosses.compute_losses(**t, lpips_params=params,
                                      lpips_enabled=False)
    assert parts["lpips_loss"].item() == 0.0
    assert parts["lpips_loss"].dtype == torch.float32
    _, parts = tlosses.compute_losses(**t, lpips_params=params,
                                      lpips_downsample=2)
    want = tlpips.lpips_distance(params, tlpips.pool_avg(t["pred_image"], 2),
                                 tlpips.pool_avg(t["gt_image"], 2))
    assert parts["lpips_loss"].item() == want.item() > 0
    feats = tlpips.lpips_features(params, t["gt_image"])
    _, parts = tlosses.compute_losses(**t, lpips_params=params,
                                      lpips_gt_feats=feats)
    assert parts["lpips_loss"].item() == tlpips.lpips_distance(
        params, t["pred_image"], t["gt_image"]).item()
    np.testing.assert_allclose(
        tlpips.pool_avg(t["pred_image"], 2).numpy(),
        np.asarray(jlpips.pool_avg(jnp.asarray(pred), 2)), rtol=1e-6)


def test_pack_lpips_params():
    params = tlpips.random_lpips_params(0, device="cpu")
    packed = tlpips.pack_lpips_params(params)
    assert tlpips.pack_lpips_params(packed) is packed
    assert packed.source is params and tlpips.infer_arch(packed) == "vgg"
    w = packed.conv(0, 0)
    assert w.w.shape == (9 * 16, 64) and w.w_t.shape == (9 * 64, 16)
    assert (w.n_in, w.n_out) == (3, 64)
    assert packed.conv(4, 2).w.shape == (9 * 512, 512)
    # the dx weights are the forward's, flipped in space, Ci and Co swapped
    w_hwio = params["conv1_0_w"].to(torch.bfloat16)
    p = packed.conv(1, 0)
    np.testing.assert_array_equal(
        _np(p.w_t.reshape(3, 3, 128, 64)),
        _np(torch.flip(w_hwio, (0, 1)).transpose(2, 3)))
    L = tconv.StageLayout(8, 8, 128)
    assert packed.lin_eff(2, L) is packed.lin_eff(2, L)
    np.testing.assert_array_equal(packed.lin_eff(2, L).numpy(),
                                  params["lin2_w"].numpy() / 64.0)
