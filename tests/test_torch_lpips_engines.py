"""The port's fp32 LPIPS engines against the JAX package's same-named
ones at 64x64 on the CPU: "xla" (fp32 convs with autograd), "xla_dx"
(fp32 convs with an input-gradient-only backward, the head on fp32 rows)
and "xla_dx_bf16" (bf16 activations, fp32 accumulation), each distance
and image gradient; AlexNet through every entry point; the cached gt
features on each engine; and the loss term on the engine it is given.

Tolerances: the fp32 engines' distance within 1e-5 relative and their
gradients within 1e-3 of the largest entry (summation order only: XLA
fuses the jitted backward differently), stage features within 1e-4; the
bf16 engine's distance within 1e-3 relative and its gradient at a cosine
of 0.999 (bf16 activations round differently where torch rounds the conv
output before the bias, as JAX does not)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manus_tpu.train import lpips as jlpips
from manus_tpu_torch.train import lpips as tlpips
from manus_tpu_torch.utils import losses as tlosses


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _images(size=64, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.rand(size, size, 3).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def _jax_value_and_grad(engine, params, a, b):
    if engine == "xla":
        def f(x, y):
            return jlpips.lpips_distance(params, x, y)
    else:
        dt = jnp.bfloat16 if engine == "xla_dx_bf16" else jnp.float32

        def f(x, y):
            return jlpips.lpips_distance_xla_dx(params, x, y, dt)
    d, g = jax.jit(jax.value_and_grad(f))(jnp.asarray(a), jnp.asarray(b))
    return float(d), np.asarray(g)


def _port_value_and_grad(engine, params, a, b):
    x = torch.tensor(a, requires_grad=True)
    d = tlpips.lpips_distance(params, x, torch.tensor(b), engine)
    d.backward()
    return d.item(), x.grad.numpy()


@pytest.mark.parametrize("engine", ["xla", "xla_dx", "xla_dx_bf16"])
def test_engine_matches_jax(engine):
    a, b = _images()
    dj, gj = _jax_value_and_grad(engine, jlpips.random_lpips_params(0), a, b)
    dt, gt = _port_value_and_grad(
        engine, tlpips.random_lpips_params(0, device="cpu"), a, b)
    cos = (gj * gt).sum() / np.linalg.norm(gj) / np.linalg.norm(gt)
    if engine == "xla_dx_bf16":
        assert abs(dt - dj) <= 1e-3 * dj and cos >= 0.999, (dt, dj, cos)
    else:
        assert abs(dt - dj) <= 1e-5 * dj, (dt, dj)
        assert np.abs(gt - gj).max() <= 1e-3 * np.abs(gj).max()


def test_alexnet_through_every_entry_point():
    """AlexNet is the "xla" engine's: distance and gradient as JAX's, the
    cached distance equal to the uncached, "auto" resolving to it."""
    a, b = _images(96, seed=1)
    dj, gj = _jax_value_and_grad("xla", jlpips.random_lpips_params(0, "alex"),
                                 a, b)
    params = tlpips.random_lpips_params(0, "alex", device="cpu")
    dt, gt = _port_value_and_grad("auto", params, a, b)
    assert abs(dt - dj) <= 1e-5 * dj
    assert np.abs(gt - gj).max() <= 1e-3 * np.abs(gj).max()
    feats = tlpips.lpips_features(params, torch.tensor(b))
    want = jlpips.lpips_features(jlpips.random_lpips_params(0, "alex"),
                                 jnp.asarray(b), "xla")
    for f, w in zip(feats, want):
        np.testing.assert_allclose(f.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    cached = tlpips.lpips_distance_cached(params, torch.tensor(a), feats)
    assert abs(cached.item() - dt) <= 1e-6 * dt


@pytest.mark.parametrize("engine", ["pallas", "xla", "xla_dx", "xla_dx_bf16"])
def test_cached_gt_features_on_each_engine(engine):
    """The gt features of an engine skip the gt forward and change
    nothing: the cached distance and gradient equal the uncached ones, and
    compute_losses runs the lpips term on the engine it is given."""
    a, b = _images(32, seed=2)
    params = tlpips.random_lpips_params(0, device="cpu")
    feats = tlpips.lpips_features(params, torch.tensor(b), engine)
    x = torch.tensor(a, requires_grad=True)
    d = tlpips.lpips_distance_cached(params, x, feats, engine)
    (g,) = torch.autograd.grad(d, x)
    y = torch.tensor(a, requires_grad=True)
    d2 = tlpips.lpips_distance(params, y, torch.tensor(b), engine)
    (g2,) = torch.autograd.grad(d2, y)
    assert d.item() == d2.item()
    torch.testing.assert_close(g, g2, rtol=0, atol=0)
    total, parts = tlosses.compute_losses(
        torch.tensor(a), torch.tensor(b), torch.ones(4, 3), None,
        ("lpips_loss",), (1.0,), lpips_params=params, lpips_engine=engine,
        lpips_gt_feats=feats)
    assert parts["lpips_loss"].item() == d.item() == total.item()


def test_fp32_head_rows_match_jax():
    """The head on fp32 rows (the xla_dx engine's, the head kernel's fp32
    form on a card) against the JAX package's Pallas head in interpret
    mode: value and both gradients."""
    from manus_tpu.ops import conv_pallas as jconv
    from manus_tpu_torch.ops import conv as tconv

    rng = np.random.RandomState(3)
    a = rng.normal(size=(40, 64)).astype(np.float32)
    b = rng.normal(size=(40, 64)).astype(np.float32)
    a[5] = 0.0  # a zero row: its norm guarded, its gradient g / eps
    lin = (rng.uniform(0, 1, 64) / 64).astype(np.float32)
    dj, (gaj, gbj) = jax.value_and_grad(
        lambda x, y: jconv.head_stage_layout(x, y, jnp.asarray(lin)[None],
                                             True), (0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    d = tconv.head_stage_layout(ta, tb, torch.tensor(lin))
    d.backward()
    assert abs(d.item() - float(dj)) <= 1e-6 * float(dj)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(gaj), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gbj), rtol=1e-5,
                               atol=1e-7)
    assert ta.grad.dtype == torch.float32
