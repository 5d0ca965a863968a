"""The port's colormaps and contact maps (utils/colormap.py,
ops/contacts.py) against the JAX package on the CPU, on the same numpy
inputs from fixed seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manus_tpu.data.synthetic import procedural_skeleton
from manus_tpu.ops import contacts as jcontacts
from manus_tpu.utils import colormap as jcolormap
from manus_tpu.utils.structures import Bones
from manus_tpu_torch.ops import contacts as tcontacts
from manus_tpu_torch.utils import colormap as tcolormap

U = 2.0 ** -24  # float32 unit roundoff
C = tcontacts.CONTACT_THRESHOLD


@pytest.mark.parametrize("name", ["gray", "magma"])
def test_lut_and_apply_colormap_match_jax(name):
    """The tables equal JAX's bit for bit (magma is matplotlib's, carried
    as data), and the lookup picks the same entry at 0, 1, out of range,
    at and between the table's steps: exact."""
    np.testing.assert_array_equal(tcolormap.lut(name), jcolormap._lut(name))
    rng = np.random.RandomState(0)
    vals = np.concatenate([
        [0.0, 1.0, -0.5, 1.5, -1e6, 1e6, 0.5, 1 / 255, 254.5 / 255],
        np.arange(256) / 255.0,
        rng.uniform(-0.2, 1.2, 500),
    ]).astype(np.float32).reshape(-1, 5)
    got = tcolormap.apply_colormap(torch.tensor(vals), name).numpy()
    want = np.asarray(jcolormap.apply_colormap(jnp.asarray(vals), name))
    assert got.shape == vals.shape + (3,)
    np.testing.assert_array_equal(got, want)


def test_apply_colormap_nan_and_unknown_name():
    """A NaN takes a table entry (the index is clamped after the cast);
    a name without a table raises, listing those there are (the JAX
    package falls back to a made-up ramp instead)."""
    out = tcolormap.apply_colormap(torch.tensor([float("nan"), 0.5]), "gray")
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="gray.*magma"):
        tcolormap.apply_colormap(torch.zeros(2), "viridis")


def _clouds(seed, n=700, m=900, contact=True):
    """Two clouds at the hand's scale (|x| ~ 0.1-0.4 m), the second with
    a part within a few mm of the first, so some distances fall under the
    4 mm threshold and some under 1e-4 m."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(-0.15, 0.15, (n, 3)) + np.array([0.1, 0.2, 0.05])
    b = rng.uniform(-0.15, 0.15, (m, 3)) + np.array([0.1, 0.2, 0.05])
    if contact:
        k = m // 3
        b[:k] = a[rng.randint(0, n, k)] + rng.normal(0, 0.002, (k, 3))
        b[:20] = a[:20] + rng.normal(0, 2e-5, (20, 3))
    return a.astype(np.float32), b.astype(np.float32)


def _check_contact(x, y, y_valid, got, want):
    """Port (d01, idx) against JAX's for queries x, references y.

    Both compute d^2 = |x|^2 + |y|^2 - 2 x.y in float32, in different
    orders, so each side's d^2 is off the exact value by at most
    eps = 8 u (|x| + |y|)^2 (three rounded terms, a 3-term dot product;
    |y| the largest reference norm). Then two distances d_a, d_b from
    d^2 values eps apart obey |d_a - d_b| <= min(sqrt(2 eps),
    2 eps / (d_a + d_b)): near contact (d under ~1e-4 m, where
    sqrt(2 eps) ~ 1e-4 m, 0.02 of d01) the expansion is ill-conditioned,
    which is what the bound allows, and it is tight elsewhere. The
    distances are read back from d01 as c (1 - d01) (clipped at c).
    Indices must be equal where the float64 nearest neighbour beats the
    second by more than 4 eps in d^2."""
    (d01_t, idx_t), (d01_j, idx_j) = got, want
    yv = y[y_valid] if y_valid is not None else y
    eps = 8 * U * (np.linalg.norm(x, axis=1)
                   + np.linalg.norm(yv, axis=1).max()) ** 2
    d_t, d_j = C * (1.0 - d01_t.astype(np.float64)), C * (1.0 - d01_j)
    bound = np.minimum(np.sqrt(2 * eps), 2 * eps / np.maximum(d_t + d_j,
                                                              1e-30))
    err = np.abs(d_t - d_j)
    assert (err <= bound + 1e-9).all(), f"max excess {(err - bound).max()}"
    assert (d01_t >= 0).all() and (d01_t <= 1).all()

    d2 = ((x[:, None, :].astype(np.float64) - y[None].astype(np.float64))
          ** 2).sum(-1)
    if y_valid is not None:
        d2[:, ~y_valid] = np.inf
    part = np.partition(d2, 1, axis=1)
    unique = part[:, 1] - part[:, 0] > 4 * eps
    best = d2.argmin(1)
    np.testing.assert_array_equal(idx_t[unique], best[unique])
    np.testing.assert_array_equal(idx_j[unique], best[unique])
    assert unique.mean() > 0.9


@pytest.mark.parametrize("masks", [False, True], ids=["all", "valid_masks"])
def test_contact_map_matches_jax(masks):
    x, y = _clouds(0)
    rng = np.random.RandomState(1)
    xv = rng.uniform(size=len(x)) > 0.2 if masks else None
    yv = rng.uniform(size=len(y)) > 0.2 if masks else None

    def opt(a, f):
        return None if a is None else f(a)

    d01_t, idx_t, col_t = tcontacts.contact_map(
        torch.tensor(x), torch.tensor(y), opt(xv, torch.tensor),
        opt(yv, torch.tensor), cmap_type="magma")
    d01_j, idx_j, col_j = jcontacts.contact_map(
        jnp.asarray(x), jnp.asarray(y), opt(xv, jnp.asarray),
        opt(yv, jnp.asarray), cmap_type="magma")
    d01_t, d01_j = d01_t.numpy(), np.asarray(d01_j)
    valid = xv if masks else np.ones(len(x), bool)
    assert (d01_t[~valid] == 0).all()
    assert 50 < (d01_t > 0).sum() < len(x)  # some in contact, not all
    _check_contact(x[valid], y, yv, (d01_t[valid], idx_t.numpy()[valid]),
                   (d01_j[valid], np.asarray(idx_j)[valid]))
    # colours: the LUT entry of d01, the same wherever d01 * 255 does not
    # straddle an integer between the two
    same = np.floor(d01_t * 255) == np.floor(d01_j * 255)
    assert same.mean() > 0.98
    np.testing.assert_array_equal(col_t.numpy()[same], np.asarray(col_j)[same])


def test_contact_map_beyond_threshold_is_zero():
    """Beyond the threshold the port's d01 is exactly 0, as the
    reference's 1 - clip(d, 0, c) / c is, and as the JAX package's is run
    op by op. Under jax.jit, as the JAX composite renders it, XLA on the
    CPU turns the division into a product with the reciprocal and gives
    1 - c * (1 / c), about 1.4e-8, so there `d01 > 0` holds for every
    active point; the port pins the reference's value (ROADMAP Queue C)."""
    x = np.array([[0.0, 0, 0], [1.0, 0, 0], [0.002, 0, 0]], np.float32)
    y = np.array([[0.0, 0, 0.001]], np.float32)
    d01_t, _, _ = tcontacts.contact_map(torch.tensor(x), torch.tensor(y))
    d01_e, _, _ = jcontacts.contact_map(jnp.asarray(x), jnp.asarray(y))
    d01_j, _, _ = jax.jit(jcontacts.contact_map)(jnp.asarray(x),
                                                 jnp.asarray(y))
    d01_t, d01_j = d01_t.numpy(), np.asarray(d01_j)
    assert d01_t[1] == 0.0 and float(d01_e[1]) == 0.0
    assert 0 < d01_j[1] < 1e-7
    np.testing.assert_allclose(d01_t[[0, 2]], d01_j[[0, 2]], atol=1e-6)
    np.testing.assert_allclose(d01_t[0], 0.75, atol=1e-6)


def test_nocs_grid_and_colors_match_jax():
    """The grid (float32 from the same float64 numpy) equal; the
    trilinear colours at hand-like positions within 1e-6 (float32 sums of
    eight corners in another order)."""
    skel = procedural_skeleton(2)
    bones = Bones(heads=jnp.asarray(skel["rest_heads"]),
                  tails=jnp.asarray(skel["rest_tails"]),
                  transforms=jnp.asarray(skel["rest_transforms"]))
    kp = np.asarray(bones.keypoints())
    for res, ratio in [(16, (1.0, 1.0, 1.0)), (12, (1.1, 0.9, 0.65))]:
        jg = jcontacts.get_nocs_grid(bones, res, ratio)
        tg = tcontacts.get_nocs_grid(kp, res, ratio, device="cpu")
        for f in jg._fields:
            np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                          np.asarray(getattr(jg, f)), f)
        rng = np.random.RandomState(res)
        xyz = (kp[rng.randint(0, len(kp), 300)]
               + rng.normal(0, 0.03, (300, 3))).astype(np.float32)
        got = tcontacts.get_nocs_colors(torch.tensor(xyz), tg).numpy()
        want = np.asarray(jcontacts.get_nocs_colors(jnp.asarray(xyz), jg))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["random", "empty_pred", "both_empty",
                                  "equal"])
def test_contact_iou_f1_matches_jax(case):
    """float32 ratios of the same integer counts: equal."""
    rng = np.random.RandomState(4)
    pred = rng.uniform(size=(32, 40)) > 0.6
    gt = rng.uniform(size=(32, 40)) > 0.5
    if case == "empty_pred":
        pred[:] = False
    elif case == "both_empty":
        pred[:], gt[:] = False, False
    elif case == "equal":
        gt = pred.copy()
    got = tcontacts.contact_iou_f1(pred, torch.tensor(gt))
    want = jcontacts.contact_iou_f1(jnp.asarray(pred), jnp.asarray(gt))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert float(g) == float(w)
