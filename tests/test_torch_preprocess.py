"""The port's preprocessing pipeline (manus_tpu_torch/preprocess/) against
the JAX package's on the same numpy inputs from a seed, on the CPU:
triangulation (plain and with outliers), the one-euro filter, FK, the IK
loss and its gradient, AdaBelief against optax step for step, solve_ik,
the whole pipeline and its CLI, frame filtering, and novel poses.

Tolerances: float32 throughout. Triangulated points agree to 2e-5 (an SVD
each side); FK, the loss and its gradient to a few float32 ulps;
AdaBelief's state to 1e-6 relative (the bias corrections' float32 powers
may differ by an ulp). IK is chaotic near its optimum (AdaBelief with eps
1e-16 takes lr-sized steps on gradients of any size), so solve_ik agrees
step for step over its first 30 iterations (1e-5) and, at 300, both
packages' losses meet the same bound and their keypoints agree to 5 mm.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from manus_tpu.preprocess import ik as jik
from manus_tpu.preprocess import novel_pose as jnp_pose
from manus_tpu.preprocess import one_euro as jeuro
from manus_tpu.preprocess import pipeline as jpipe
from manus_tpu.preprocess import triangulate as jtri
from manus_tpu_torch.data.synthetic import load_skeleton, procedural_skeleton
from manus_tpu_torch.preprocess import ik as tik
from manus_tpu_torch.preprocess import novel_pose as tnp_pose
from manus_tpu_torch.preprocess import one_euro as teuro
from manus_tpu_torch.preprocess import pipeline as tpipe
from manus_tpu_torch.preprocess import triangulate as ttri
from chip_smoke import hand20_skeleton
from tests.test_preprocess import _projection_setup, _two_finger_chain

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def hand20():
    """chip_smoke.py's 20-bone hand (default_hand_dof's layout: the thumb's
    4 bones from the wrist, then four fingers of 4) as make_chain's
    arguments."""
    s = hand20_skeleton()
    return (s["bnames"], s["parents"], s["rest_transforms"], s["rest_heads"],
            s["rest_tails"])


def _chains(*skel):
    return jik.make_chain(*skel), tik.make_chain(*skel)


def _views(pts, P, noise=0.0, seed=0):
    """[V, J, 3] (x, y, conf 1) of points [J, 3] seen by P [V, 3, 4]."""
    homo = np.concatenate([pts, np.ones((len(pts), 1))], 1)
    proj = np.einsum("vab,jb->vja", P, homo)
    xy = proj[..., :2] / proj[..., 2:]
    xy = xy + np.random.RandomState(seed).uniform(-noise, noise, xy.shape)
    return np.concatenate([xy, np.ones(xy.shape[:2] + (1,))], -1).astype(
        np.float32)


def test_batch_triangulate_matches_jax():
    """A frame batch at once equals JAX's frame loop; joints seen by fewer
    than min_view views are zero rows in both."""
    P = _projection_setup(num_views=6).astype(np.float32)
    rng = np.random.RandomState(1)
    kp = np.stack([_views(rng.uniform(-0.3, 0.3, (21, 3)), P, 1.0, f)
                   for f in range(3)])
    kp[0, :, 3, 2] = 0.0            # joint 3 of frame 0 unseen
    kp[1, 1:, 5, 2] = 0.0           # joint 5 of frame 1 in one view
    kp[2, :, :, 2] = rng.uniform(0.2, 1.0, (6, 21))  # weighted
    got = ttri.batch_triangulate(torch.tensor(kp), torch.tensor(P)).numpy()
    for f in range(3):
        want = np.asarray(jtri.batch_triangulate(jnp.asarray(kp[f]),
                                                 jnp.asarray(P)))
        np.testing.assert_allclose(got[f], want, atol=2e-5, rtol=0)
    assert (got[0, 3] == 0).all() and (got[1, 5] == 0).all()


def test_iterative_triangulate_rejects_outliers_as_jax():
    """Two views with 50 px outliers on a few joints: the same views are
    dropped, and the points agree to 2e-5 and lie within 5 mm of the
    truth (+-0.5 px of noise is ~3 mm at 3 m with a 500 px focal)."""
    P = _projection_setup(num_views=8).astype(np.float32)
    rng = np.random.RandomState(2)
    pts = rng.uniform(-0.3, 0.3, (21, 3))
    kp = np.stack([_views(pts, P, 0.5, f) for f in range(2)])
    kp[0, 1, [2, 7, 11], :2] += 50.0
    kp[1, 4, [0, 5], :2] -= 50.0
    kp[1, 6, [5, 9], 1] += 50.0
    got = ttri.iterative_triangulate(torch.tensor(kp),
                                     torch.tensor(P)).numpy()
    for f in range(2):
        want = np.asarray(jtri.iterative_triangulate(jnp.asarray(kp[f]),
                                                     jnp.asarray(P)))
        np.testing.assert_allclose(got[f], want, atol=2e-5, rtol=0)
    assert np.abs(got[..., :3] - pts).max() < 5e-3
    naive = ttri.batch_triangulate(torch.tensor(kp), torch.tensor(P)).numpy()
    assert np.abs(naive[..., :3] - pts).max() > 2e-2


def test_filter_sequence_matches_jax():
    rng = np.random.RandomState(0)
    ts = np.arange(40, dtype=np.float32)
    xs = (np.sin(ts / 7)[:, None, None] + rng.normal(0, 0.2, (40, 5, 3))
          ).astype(np.float32)
    for mc, beta in [(1.0, 0.0), (0.6, 0.1)]:
        want = np.asarray(jeuro.filter_sequence(jnp.asarray(ts),
                                                jnp.asarray(xs), mc, beta))
        got = teuro.filter_sequence(torch.tensor(ts), torch.tensor(xs), mc,
                                    beta).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    f_j = jeuro.OneEuroFilter(ts[:1], xs[0, :1, 0], min_cutoff=0.5)
    f_t = teuro.OneEuroFilter(ts[:1], xs[0, :1, 0], min_cutoff=0.5)
    for i in range(1, 10):
        np.testing.assert_array_equal(f_t(ts[i:i + 1], xs[i, :1, 0]),
                                      f_j(ts[i:i + 1], xs[i, :1, 0]))


def test_default_hand_dof_and_chain_match_jax():
    for n in (3, 5, 13, 20):
        for a, b in zip(jik.default_hand_dof(n), tik.default_hand_dof(n)):
            np.testing.assert_array_equal(a, b)
    jc, tc = _chains(*hand20())
    for f in ("parents", "rest_matrices", "heads", "tails", "bone_lengths",
              "dof", "limits"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    assert tc.kintree == jc.kintree


@pytest.mark.parametrize("skel", ["chain4", "hand20"])
def test_chain_forward_ik_loss_and_gradient_match_jax(skel):
    """FK, the loss (the 4-keypoint chain drops every fingertip index, as
    JAX's mode="drop"), and the loss's gradient in the translation and
    the angles."""
    if skel == "chain4":
        jc = _two_finger_chain()
        tc = tik.make_chain(jc.bnames, jc.parents, jc.rest_matrices,
                            jc.heads, jc.tails)
    else:
        jc, tc = _chains(*hand20())
    n = jc.num_bones + 1
    rng = np.random.RandomState(4)
    ang = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    tr = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
    tgt = rng.uniform(-0.1, 0.2, (n, 3)).astype(np.float32)
    use = rng.rand(n) > 0.2
    for want, got in zip(jik.chain_forward(jc, jnp.asarray(tr),
                                           jnp.asarray(ang)),
                         tik.chain_forward(tc, torch.tensor(tr),
                                           torch.tensor(ang))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-7,
                                   rtol=0)

    def jloss(t, a):
        d = jik.ik_loss(jc, t, a, jnp.asarray(tgt), jnp.asarray(use))
        return d["keypoint_loss"] + d["limit_loss"]

    lj, (gtj, gaj) = jax.jit(jax.value_and_grad(jloss, (0, 1)))(
        jnp.asarray(tr), jnp.asarray(ang))
    t_t = torch.tensor(tr, requires_grad=True)
    a_t = torch.tensor(ang, requires_grad=True)
    d = tik.ik_loss(tc, t_t, a_t, torch.tensor(tgt), torch.tensor(use))
    lt = d["keypoint_loss"] + d["limit_loss"]
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    np.testing.assert_allclose(t_t.grad.numpy(), np.asarray(gtj), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(a_t.grad.numpy(), np.asarray(gaj), rtol=1e-5,
                               atol=1e-7)
    assert d["limit_loss"] > 0  # some angles are past their limits
    if skel == "chain4":
        np.testing.assert_array_equal(
            tik.chain_tensors(tc, CPU).tip_w.numpy(), np.ones(4))


def test_adabelief_matches_optax_step_for_step():
    """20 steps on the same gradients: parameters, mu and nu as optax
    0.2.6's adabelief(lr, eps=1e-16) gives them."""
    rng = np.random.RandomState(5)
    p0 = rng.normal(size=(66,)).astype(np.float32)
    grads = rng.normal(size=(20, 66)).astype(np.float32) * np.logspace(
        -6, 0, 66, dtype=np.float32)
    opt = optax.adabelief(0.1, b1=0.9, b2=0.999, eps=1e-16)
    pj = jnp.asarray(p0)
    state = opt.init(pj)
    pt = torch.tensor(p0)
    mu, nu = torch.zeros_like(pt), torch.zeros_like(pt)
    bc1, bc2 = tik.bias_corrections(20, CPU)
    for t in range(20):
        upd, state = opt.update(jnp.asarray(grads[t]), state, pj)
        pj = optax.apply_updates(pj, upd)
        tik.adabelief_step(pt, torch.tensor(grads[t]), mu, nu, bc1[t],
                           bc2[t], 0.1)
        belief = state[0]
        np.testing.assert_allclose(mu.numpy(), np.asarray(belief.mu),
                                   rtol=1e-6)
        np.testing.assert_allclose(nu.numpy(), np.asarray(belief.nu),
                                   rtol=1e-6)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6,
                                   atol=1e-7)


def test_solve_ik_chain4_matches_jax():
    """The JAX test's chain (its fingertip indices all dropped), the
    unconstrained fit of test_ik_recovers_pose: the same answer."""
    jc = _two_finger_chain()
    tc = tik.make_chain(jc.bnames, jc.parents, jc.rest_matrices, jc.heads,
                        jc.tails)
    gt = np.zeros((4, 3), np.float32)
    gt[3, 2] = -0.5
    target = np.asarray(jik.chain_forward(
        jc, jnp.asarray([0.05, -0.02, 0.03]), jnp.asarray(gt))[0])
    tj, aj, lj = jik.solve_ik(jc, jnp.asarray(target), jnp.ones(4, bool),
                              constraint=False, limit=False, lr=5e-2,
                              max_iter=400)
    tt_, at_, lt = tik.solve_ik(tc, torch.tensor(target),
                                torch.ones(4, dtype=torch.bool),
                                constraint=False, limit=False, lr=5e-2,
                                max_iter=400)
    assert lj < 1e-5 and lt < 1e-5
    pj = np.asarray(jik.chain_forward(jc, tj, aj)[0])
    pt = tik.chain_forward(tc, tt_, at_)[0].numpy()
    np.testing.assert_allclose(pt, pj, atol=5e-3, rtol=0)
    np.testing.assert_allclose(pt, target, atol=5e-3, rtol=0)


def test_solve_ik_hand20_matches_jax():
    jc, tc = _chains(*hand20())
    rng = np.random.RandomState(0)
    ang = np.where(jc.dof, rng.uniform(-0.3, 0.3, (21, 3)), 0).astype(
        np.float32)
    target = np.asarray(jik.chain_forward(
        jc, jnp.asarray([0.01, 0.02, 0.0]), jnp.asarray(ang))[0])
    target = target + rng.normal(0, 0.002, target.shape).astype(np.float32)
    use = np.ones(21, bool)
    use[9] = False
    for iters in (30, 300):
        tj, aj, lj = jik.solve_ik(jc, jnp.asarray(target), jnp.asarray(use),
                                  max_iter=iters)
        tt_, at_, lt = tik.solve_ik(tc, torch.tensor(target),
                                    torch.tensor(use), max_iter=iters)
        if iters == 30:
            np.testing.assert_allclose(at_.numpy(), np.asarray(aj),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(tt_.numpy(), np.asarray(tj),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(lt, lj, rtol=1e-4)
    assert lj < 1e-4 and lt < 1e-4
    # non-DOF angles stay 0 under the constraint
    assert (at_.numpy()[~jc.dof] == 0).all()
    pj = np.asarray(jik.chain_forward(jc, tj, aj)[0])
    pt = tik.chain_forward(tc, tt_, at_)[0].numpy()
    np.testing.assert_allclose(pt, pj, atol=5e-3, rtol=0)


def _e2e_scene():
    """tests/test_preprocess.py's end-to-end scene: a moving 3-bone chain
    seen by 5 cameras over 3 frames."""
    chain = _two_finger_chain()
    P = _projection_setup(num_views=5)
    kp2d = np.zeros((3, 5, 4, 3), np.float32)
    gt = []
    for f in range(3):
        angles = np.zeros((4, 3), np.float32)
        angles[3, 2] = -0.2 * f
        kp = np.asarray(jik.chain_forward(chain, jnp.zeros(3),
                                          jnp.asarray(angles))[0])
        gt.append(kp)
        kp2d[f] = _views(kp, P)
    return chain, P, kp2d, np.stack(gt)


def test_run_pipeline_matches_jax():
    chain, P, kp2d, gt = _e2e_scene()
    tc = tik.make_chain(chain.bnames, chain.parents, chain.rest_matrices,
                        chain.heads, chain.tails)
    want = jpipe.run_pipeline(kp2d, P, chain, constraint=False, max_iter=250)
    timings = {}
    got = tpipe.run_pipeline(kp2d, P, tc, constraint=False, max_iter=250,
                             device="cpu", timings=timings)
    assert set(got) == set(want)
    assert set(timings) == {"triangulate_s", "ik_s", "smooth_s"}
    np.testing.assert_allclose(got["keypoints3d"], want["keypoints3d"],
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(got["keypoints3d"][..., :3], gt, atol=1e-3)
    np.testing.assert_allclose(got["bone_lengths"], want["bone_lengths"],
                               rtol=1e-5)
    assert got["ik_losses"].max() < 1e-4 and want["ik_losses"].max() < 1e-4
    assert got["angles_smooth"].shape == got["angles"].shape
    # the smoothing of the port's own angles, as JAX smooths them
    np.testing.assert_allclose(
        got["angles_smooth"], np.asarray(jpipe.smooth_sequence(got["angles"])),
        atol=1e-6, rtol=0)


def test_pipeline_cli(tmp_path, capsys):
    chain, P, kp2d, _ = _e2e_scene()
    src = tmp_path / "kp2d.npz"
    np.savez(src, keypoints2d=kp2d, projections=P,
             bnames=np.asarray(chain.bnames), parents=chain.parents,
             rest_matrices=chain.rest_matrices, heads=chain.heads,
             tails=chain.tails)
    out = tpipe.main([str(src), str(tmp_path / "out.npz"), "--no-constraint",
                      "--max-iter", "120", "--device", "cpu"])
    assert "pipeline: 3 frames" in capsys.readouterr().out
    with np.load(tmp_path / "out.npz") as d:
        assert set(d.files) == {"keypoints3d", "trans", "angles",
                                "angles_smooth", "ik_losses", "bone_lengths"}
        np.testing.assert_array_equal(d["angles"], out["angles"])


def test_filter_pose_frames_and_faulty_sequences_match_jax():
    rng = np.random.default_rng(0)
    kyps = np.concatenate([rng.normal(size=(23, 21, 3)),
                           (rng.random((23, 21, 1)) > 0.08).astype(float)],
                          axis=-1)
    for kw in (dict(bin_size=5), dict(bin_size=5, ignore_missing_tip=True),
               dict(bin_size=4, start_frame=3),
               dict(bin_size=3, frame_ids=np.arange(23) * 2 + 7)):
        assert tpipe.filter_pose_frames(kyps, **kw) == \
            jpipe.filter_pose_frames(kyps, **kw)
    for chosen, last in [([0, 5, 90], 100), ([0, 5, 70], 100), ([], 100),
                         ([3], 0), ([80], 100)]:
        assert tpipe.sequence_is_faulty(chosen, last) == \
            jpipe.sequence_is_faulty(chosen, last)


@pytest.mark.parametrize("skel", ["procedural", "hand20"])
def test_novel_pose_pkl_matches_jax(skel, tmp_path):
    """generate_flexion_sequence's pkl key for key (the 20-bone hand runs
    default_hand_dof's limits), and it loads back through load_skeleton;
    generate_novel_pose with a root motion and interpolate_eulers too."""
    s = (procedural_skeleton(num_frames=2) if skel == "procedural"
         else hand20_skeleton())
    path = str(tmp_path / "novel_pose.pkl")
    want = jnp_pose.generate_flexion_sequence(s, num_frames=6)
    got = tnp_pose.generate_flexion_sequence(s, num_frames=6, out_path=path,
                                             device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        if np.asarray(want[k]).dtype.kind in "US":
            np.testing.assert_array_equal(got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], want[k], atol=2e-6, rtol=0)
    with open(path, "rb") as f:
        assert list(pickle.load(f)) == list(want)
    loaded = load_skeleton(path)
    np.testing.assert_allclose(loaded["pose_transforms"], got["pose_matrixs"],
                               atol=1e-6)
    rng = np.random.RandomState(0)
    j = len(s["bnames"])
    eul = rng.uniform(-0.5, 0.5, (3, j, 3)).astype(np.float32)
    rr = rng.uniform(-0.5, 0.5, (3, 3)).astype(np.float32)
    rt = rng.uniform(-0.5, 0.5, (3, 3)).astype(np.float32)
    want = jnp_pose.generate_novel_pose(s, eul, rr, rt)
    got = tnp_pose.generate_novel_pose(s, eul, rr, rt, device="cpu")
    for k in ("pose_matrixs", "pose_heads", "pose_tails", "pose_params"):
        np.testing.assert_allclose(got[k], want[k], atol=2e-6, rtol=0)
    np.testing.assert_array_equal(
        tnp_pose.interpolate_eulers(eul, 7),
        jnp_pose.interpolate_eulers(eul, 7))
    np.testing.assert_array_equal(
        tnp_pose.interpolate_eulers(eul, 7, ease=False),
        jnp_pose.interpolate_eulers(eul, 7, ease=False))
