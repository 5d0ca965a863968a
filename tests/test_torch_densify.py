"""Parity of the port's densification events with the JAX package, on CPU.

Each case builds a padded model with the JAX package from a numpy seed,
gives it random Adam moments (so that the resets show), runs the JAX
event and carries the same state across to the port, which runs with
the split noise JAX drew (`k1, k2 = jax.random.split(rng)`, one normal
[N_max, 3] draw each). Activity masks, slot assignments and the info
counters must be equal; parameters, moments and skin weights within
1e-6 absolute (float32 math of the same order of operations; the split
offset is a 3-term sum in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from manus_tpu.data.synthetic import procedural_skeleton, sample_gaussians_on_bones
from manus_tpu.models import densify as jdensify
from manus_tpu.models.gaussians import GaussianOpts as JOpts
from manus_tpu.models.gaussians import init_gaussian_model as j_init
from manus_tpu.ops import outliers as joutliers
from manus_tpu.train import optim as joptim
from manus_tpu_torch.models import densify as tdensify
from manus_tpu_torch.models.convert import model_from_numpy
from manus_tpu_torch.models.gaussians import GaussianOpts, GaussianParams
from manus_tpu_torch.ops import outliers as toutliers
from manus_tpu_torch.train import optim as toptim

ATOL = 1e-6


def _model(n0, cap, seed=0, skin_bones=0, isotropic=False):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (n0, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n0, 3)).astype(np.float32)
    skin = None
    if skin_bones:
        skin = rng.dirichlet(np.ones(skin_bones), size=n0).astype(np.float32)
    opts = JOpts(isotropic_scaling=isotropic)
    m = j_init(jnp.asarray(pts), jnp.asarray(cols), cap, opts=opts,
               skin_weights=skin)
    # distinct rotations, so the split offsets exercise build_rotation
    rot = rng.normal(size=(cap, 4)).astype(np.float32)
    return m._replace(params=m.params._replace(rotation=jnp.asarray(rot)))


def _opt(params, seed=1):
    rng = np.random.RandomState(seed)
    m = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=x.shape).astype(np.float32)), params)
    v = jax.tree.map(lambda x: jnp.asarray(
        rng.uniform(0, 1, x.shape).astype(np.float32)), params)
    return joptim.AdamState(m=m, v=v, step=jnp.asarray(7, jnp.int32))


def _to_port(jm, jopt):
    d = dict(jax.tree.map(np.asarray, jm.params)._asdict(),
             active=np.asarray(jm.active))
    if jm.skin_weights is not None:
        d["skin_weights"] = np.asarray(jm.skin_weights)
    model = model_from_numpy(d, "cpu")

    def leaves(tree):
        return GaussianParams(*(torch.tensor(np.asarray(x)) for x in tree))

    return model, toptim.AdamState(m=leaves(jopt.m), v=leaves(jopt.v),
                                   step=int(jopt.step))


def _stats(cap, grad_accum, denom, max_radii=None):
    max_radii = np.zeros(cap, np.float32) if max_radii is None else max_radii
    arrs = [np.asarray(x, np.float32) for x in (grad_accum, denom, max_radii)]
    return (jdensify.DensifyStats(*(jnp.asarray(a) for a in arrs)),
            tdensify.DensifyStats(*(torch.tensor(a) for a in arrs)))


def _jax_noise(key, cap):
    k1, k2 = jax.random.split(key)
    return torch.tensor(np.stack([np.asarray(jax.random.normal(k, (cap, 3)))
                                  for k in (k1, k2)]))


def _port_opts(jopts):
    return GaussianOpts(**dataclasses.asdict(jopts))


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=what)


def _compare(tm, topt, jm, jopt):
    np.testing.assert_array_equal(tm.active.numpy(), np.asarray(jm.active))
    for name in jm.params._fields:
        _close(getattr(tm.params, name), getattr(jm.params, name), name)
        _close(getattr(topt.m, name), getattr(jopt.m, name), f"m {name}")
        _close(getattr(topt.v, name), getattr(jopt.v, name), f"v {name}")
    assert topt.step == int(jopt.step)
    if jm.skin_weights is None:
        assert tm.skin_weights is None
    else:
        _close(tm.skin_weights, jm.skin_weights, "skin_weights")


def _densify(jm, jopt, jstats, tstats, jopts, extent, key, use_size):
    """Both events from one state; returns both results after comparing."""
    jm2, jopt2, jstats2, jinfo = jdensify.densify_and_prune(
        jm, jopt, jstats, jopts, extent, key,
        use_size_threshold=jnp.asarray(use_size))
    tm, topt = _to_port(jm, jopt)
    tm2, topt2, tstats2, tinfo = tdensify.densify_and_prune(
        tm, topt, tstats, _port_opts(jopts), extent,
        _jax_noise(key, jm.capacity), use_size_threshold=use_size)
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        assert torch.is_tensor(tinfo[k]) and tinfo[k].dim() == 0
        assert int(tinfo[k]) == int(jinfo[k]), k
    _compare(tm2, topt2, jm2, jopt2)
    for s in tstats2:
        assert float(s.abs().max()) == 0.0
    return (tm2, topt2, tinfo), (jm2, jopt2, jinfo)


def _clone_split_scene(cap, skin_bones=0, isotropic=False):
    """8 live slots; slot 0 small (clones), 1 and 2 large (split), both
    over the gradient threshold; the rest below it."""
    m = _model(8, cap, skin_bones=skin_bones, isotropic=isotropic)
    s = m.params.scaling
    s = s.at[0].set(np.log(0.001)).at[1].set(np.log(0.5)).at[2].set(
        np.log(0.3))
    m = m._replace(params=m.params._replace(scaling=s))
    ga = np.zeros(cap, np.float32)
    ga[[0, 1, 2]] = 1.0
    ga[3] = 0.4
    denom = np.ones(cap, np.float32)
    denom[4] = 0.0  # no visible step: a mean gradient of 0
    return m, _stats(cap, ga, denom)


# (skin bones, isotropic): the JAX clone-and-split case, then the same with
# per-point skin weights (clones and children carry their parent's row)
# and with isotropic scaling (children keep one scale column)
@pytest.mark.parametrize("skin_bones,isotropic", [(0, False), (5, False),
                                                  (0, True)],
                         ids=["plain", "skin_weights", "isotropic"])
def test_densify_clone_and_split_matches_jax(skin_bones, isotropic):
    cap = 64
    m, (jst, tst) = _clone_split_scene(cap, skin_bones, isotropic)
    jopts = JOpts(densify_grad_threshold=0.5, percent_dense=0.01,
                  isotropic_scaling=isotropic)
    (tm, _, tinfo), _ = _densify(m, _opt(m.params), jst, tst, jopts, 1.0,
                                 jax.random.PRNGKey(0), False)
    assert int(tinfo["clones"]) == 1 and int(tinfo["splits"]) == 2
    assert int(tinfo["num_active"]) == 8 + 1 + 4 - 2
    assert tm.params.scaling.shape[1] == (1 if isotropic else 3)


def test_densify_capacity_overflow_matches_jax():
    """One free slot: one clone, the other seven dropped; and with three
    free slots a split whose second child does not fit must not run."""
    m = _model(8, 9)
    jopts = JOpts(densify_grad_threshold=0.5, percent_dense=1e9)
    jst, tst = _stats(9, np.ones(9), np.ones(9))
    (_, _, tinfo), _ = _densify(m, _opt(m.params), jst, tst, jopts, 1.0,
                                jax.random.PRNGKey(0), False)
    assert int(tinfo["clones"]) == 1 and int(tinfo["alloc_dropped"]) == 7

    m = _model(8, 11)
    jopts = JOpts(densify_grad_threshold=0.5, percent_dense=0.0)
    ga = np.zeros(11, np.float32)
    ga[[1, 4]] = 1.0
    jst, tst = _stats(11, ga, np.ones(11))
    (_, _, tinfo), _ = _densify(m, _opt(m.params), jst, tst, jopts, 1.0,
                                jax.random.PRNGKey(3), False)
    assert int(tinfo["splits"]) == 1 and int(tinfo["alloc_dropped"]) == 1


@pytest.mark.parametrize("use_size", [False, True])
def test_prune_low_opacity_then_reset_matches_jax(use_size):
    """Slot 3 near zero opacity, slot 5 with a NaN scale, slot 6 large on
    screen and slot 7 large in the world: the size prune takes 6 and 7
    only under use_size_threshold (extent 10: the world limit is 1.0). Then
    the opacity reset."""
    m = _model(8, 16)
    p = m.params
    p = p._replace(opacity=p.opacity.at[3].set(-20.0),
                   scaling=p.scaling.at[5, 1].set(jnp.nan).at[7].set(
                       np.log(2.0)))
    m = m._replace(params=p)
    radii = np.zeros(16, np.float32)
    radii[6] = 40.0
    jst, tst = _stats(16, np.zeros(16), np.zeros(16), radii)
    jopt = _opt(m.params)
    (tm, topt, tinfo), (jm, jopt2, _) = _densify(
        m, jopt, jst, tst, JOpts(), 10.0, jax.random.PRNGKey(1), use_size)
    assert not bool(tm.active[3]) and not bool(tm.active[5])
    assert bool(tm.active[6]) == bool(tm.active[7]) == (not use_size)

    jm3, jopt3 = jdensify.reset_opacity(jm, jopt2)
    tm3, topt3 = tdensify.reset_opacity(tm, topt)
    _compare(tm3, topt3, jm3, jopt3)
    assert float(torch.sigmoid(tm3.params.opacity).max()) <= 0.0101


def test_prune_by_mask_matches_jax():
    m = _model(8, 16)
    jopt = _opt(m.params)
    mask = np.zeros(16, bool)
    mask[[2, 5, 12]] = True  # slot 12 is free already
    jm2, jopt2, jn = jdensify.prune_by_mask(m, jopt, jnp.asarray(mask))
    tm, topt = _to_port(m, jopt)
    tm2, topt2, tn = tdensify.prune_by_mask(tm, topt, torch.tensor(mask))
    assert int(tn) == int(jn) == 2 and tn.dim() == 0
    _compare(tm2, topt2, jm2, jopt2)


@pytest.mark.parametrize("n_pad", [0, 53])
def test_loop_outliers_match_jax(n_pad):
    """The JAX outlier case (a cluster and three floaters; with n_pad, a
    cloud that is not a multiple of the block and inactive slots):
    LoOP probabilities within 1e-5 (float32 distance sums in another
    order), equal masks, then the prune by that mask."""
    rng = np.random.RandomState(0)
    cluster = rng.normal(0, 0.05, (200, 3)).astype(np.float32)
    floaters = np.array([[5.0, 5.0, 5.0], [-6.0, 2.0, 4.0], [0.0, -8.0, 1.0]],
                        np.float32)
    pts = np.concatenate([cluster, floaters])
    cap = 256 + n_pad
    m = j_init(jnp.asarray(pts), jnp.asarray(rng.uniform(0, 1, pts.shape)
                                             .astype(np.float32)), cap)
    xyz, act = np.asarray(m.params.xyz), np.asarray(m.active)
    block = 64
    pad = (-cap) % block
    xyz_p = np.concatenate([xyz, np.zeros((pad, 3), np.float32)])
    act_p = np.concatenate([act, np.zeros(pad, bool)])
    want = np.asarray(joutliers.loop_outlier_probability(
        jnp.asarray(xyz_p), jnp.asarray(act_p), k=16, block=block))[:cap]
    got = toutliers.outlier_probability(torch.tensor(xyz), torch.tensor(act),
                                        k=16, block=block)
    _close(got, want, "LoOP probability", atol=1e-5)

    jmask = np.asarray(joutliers.outlier_mask(m.params.xyz, m.active,
                                              prob=0.8, k=16))
    tmask = toutliers.outlier_mask(torch.tensor(xyz), torch.tensor(act),
                                   prob=0.8, k=16)
    np.testing.assert_array_equal(tmask.numpy(), jmask)
    assert jmask[200:203].all() and jmask[:200].sum() <= 4
    assert not jmask[203:].any()

    jopt = _opt(m.params)
    jm2, jopt2, jn = jdensify.prune_by_mask(m, jopt, jnp.asarray(jmask))
    tm, topt = _to_port(m, jopt)
    tm2, topt2, tn = tdensify.prune_by_mask(tm, topt, tmask)
    assert int(tn) == int(jn)
    _compare(tm2, topt2, jm2, jopt2)


def _loop_float64(pts, k, lam=3.0):
    """LoOP of every point from float64 distances (no float32 ties)."""
    p = pts.astype(np.float64)
    d2 = sum((p[:, None, c] - p[None, :, c]) ** 2 for c in range(3))
    np.fill_diagonal(d2, np.inf)
    idx = np.argpartition(d2, k, axis=1)[:, :k]
    sigma = np.sqrt(np.take_along_axis(d2, idx, 1).mean(1))
    plof = sigma / sigma[idx].mean(1) - 1.0
    nplof = lam * np.sqrt((plof * plof).mean())
    return np.maximum(scipy.special.erf(plof / (nplof * np.sqrt(2.0))), 0.0)


@pytest.mark.parametrize("bone", [0, 5])
def test_loop_outliers_dense_cloud_against_jax(bone):
    """LoOP on 4,096 points of one bone at the flagship's sampling density
    (131,072 points on procedural_skeleton(8)), k=32. The port sums
    squared coordinate differences and stays within 1e-5 of a float64
    LoOP (measured 5e-7); the JAX package's |x|^2 + |y|^2 - 2 x.y
    cancels in so dense a cloud and moves probabilities by up to 0.009
    (measured, both bones). So the port is held to float64, and to JAX
    within 0.02: a mask that differs from JAX's must have JAX's
    probability within 0.02 of 0.8 (none do here)."""
    skel = procedural_skeleton(8)
    j = len(skel["bnames"])
    per_bone = 131072 // (j + j // 2)
    pts, _ = sample_gaussians_on_bones(
        skel["rest_heads"], skel["rest_tails"], skel["rest_transforms"],
        per_bone, seed=0)
    # bone b's samples are every j-th row of the bone draws, then of the
    # joint draws
    ids = np.arange(len(pts))
    n_bone = per_bone * j
    own = np.where(ids < n_bone, ids, ids - n_bone) % j == bone
    sub = pts[own][:4096]
    valid = np.ones(len(sub), bool)
    exact = _loop_float64(sub, 32)
    got = toutliers.outlier_probability(torch.tensor(sub), torch.tensor(valid),
                                        k=32)
    want = np.asarray(joutliers.loop_outlier_probability(
        jnp.asarray(sub), jnp.asarray(valid), k=32, block=1024))
    _close(got, exact, "LoOP against float64", atol=1e-5)
    _close(got, want, "LoOP against JAX", atol=0.02)
    got = got.numpy()
    differ = (got > 0.8) != (want > 0.8)
    assert (np.abs(want[differ] - 0.8) <= 0.02).all(), int(differ.sum())
    assert 0 < (got > 0.8).sum() < 200


def test_array_adam_matches_jax():
    """The skin weights' Adam at step 3, and the row reset."""
    rng = np.random.RandomState(0)
    p, g = (rng.uniform(0, 1, (16, 5)).astype(np.float32) for _ in range(2))
    m, v = rng.normal(size=(16, 5)).astype(np.float32), \
        rng.uniform(0, 1, (16, 5)).astype(np.float32)
    active = np.arange(16) < 12
    jp, js = joptim.array_adam_update(
        jnp.asarray(p), jnp.asarray(g), joptim.ArrayAdamState(jnp.asarray(m),
                                                              jnp.asarray(v)),
        0.01, jnp.asarray(active), jnp.asarray(3, jnp.int32))
    tp, ts = toptim.array_adam_update(
        torch.tensor(p), torch.tensor(g),
        toptim.ArrayAdamState(torch.tensor(m), torch.tensor(v)), 0.01,
        torch.tensor(active), 3)
    _close(tp, jp, "p")
    _close(ts.m, js.m, "m")
    _close(ts.v, js.v, "v")
    rows = np.arange(16) % 3 == 0
    jr = joptim.array_reset_rows(js, jnp.asarray(rows))
    tr = toptim.array_reset_rows(ts, torch.tensor(rows))
    _close(tr.m, jr.m, "reset m")
    _close(tr.v, jr.v, "reset v")
