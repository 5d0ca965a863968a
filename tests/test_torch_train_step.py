"""Parity of the PyTorch port's training step with the JAX package.

One and three HAND_GAUSSIAN steps at 64x64 with capacity 512 on
procedural_skeleton, per-point skin weights and a non-zero background:
the JAX step runs backend="xla", the port backend="torch" on the CPU.
The model is built by the JAX package and carried across as numpy, so
both steps start from the same state. Also: a step that trains the
point skin weights, the densify event after three steps, and a step of
the object workload.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manus_tpu import config as jconfig
from manus_tpu.data.synthetic import (
    hemisphere_cameras,
    procedural_skeleton,
    sample_gaussians_on_bones,
)
from manus_tpu.models.gaussians import init_gaussian_model as j_init
from manus_tpu.ops.skinning import bone_deformation_transforms as j_bone_tf
from manus_tpu.train import workloads as jwork
from manus_tpu.utils.camera import stack_cameras as j_stack
from manus_tpu_torch import config as tconfig
from manus_tpu_torch.models.convert import (
    camera_from_numpy,
    model_from_numpy,
    model_to_numpy,
)
from manus_tpu_torch.models import densify as densify_mod
from manus_tpu_torch.models.densify import DensifyStats
from manus_tpu_torch.models.gaussians import GaussianParams, init_gaussian_model
from manus_tpu_torch.train import workloads as twork
from manus_tpu_torch.train.optim import AdamState, ArrayAdamState
from manus_tpu_torch.utils.camera import TENSOR_FIELDS

W = H = 64
CAP = 512
BG = np.array([0.2, 0.3, 0.1], np.float32)


def _scene():
    skel = procedural_skeleton(8)
    j = len(skel["bnames"])
    pts, cols = sample_gaussians_on_bones(
        skel["rest_heads"], skel["rest_tails"], skel["rest_transforms"], 28,
        seed=0)
    pts, cols = pts[:480], cols[:480]  # 32 padded slots stay inactive
    rng = np.random.RandomState(0)
    skin = rng.dirichlet(np.ones(j) * 0.1, size=pts.shape[0]).astype(np.float32)
    center = skel["rest_heads"].mean(axis=0)
    # cameras close enough that the hand spans ~20 pixels
    cams = hemisphere_cameras(4, W, H, dist=0.45, center=center)[:2]
    frame = 3
    kp = np.concatenate([skel["pose_heads"][frame][:1],
                         skel["pose_tails"][frame]]).astype(np.float32)
    gt = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    # Segmentation mask: discs of 9 pixels around the palm's two keypoints
    # in view 0 (11x11 dilation makes them 14). The mask prune keeps the
    # palm and cuts the fingertips; its keypoint guard gets the palm's two
    # keypoints, which lie inside.
    P = np.asarray(cams[0].K) @ np.asarray(cams[0].extr)[:3]
    hom = np.concatenate([kp[:2], np.ones((2, 1), np.float32)], 1) @ P.T
    kp2d = hom[:, :2] / hom[:, 2:]
    yy, xx = np.mgrid[0:H, 0:W]
    d2 = ((xx[None] - kp2d[:, 0, None, None]) ** 2
          + (yy[None] - kp2d[:, 1, None, None]) ** 2)
    mask = np.repeat((d2.min(0) < 81).astype(np.float32)[None, :, :, None],
                     2, axis=0)
    return dict(pts=pts, cols=cols, skin=skin, cams=cams, kp=kp, gt=gt,
                mask=mask, pose=skel["pose_transforms"][frame],
                rest=skel["rest_transforms"])


def _keypoints(sc, remove_seg_end):
    """All 14 keypoints for the far-from-skeleton prune; the palm's two,
    inside the mask, while the mask prune runs."""
    return sc["kp"] if remove_seg_end == 0 else sc["kp"][:2]


def _hand_opts(opts, remove_seg_end):
    # a skeleton-distance threshold at ~90th percentile of this scene, so
    # the far prune removes some points
    return dataclasses.replace(opts, remove_seg_end=remove_seg_end,
                               skeleton_dist_threshold=0.085)


def _cfg(config_mod, backend, remove_seg_end, articulated=True, voxel=False,
         **model):
    """The scene's config for either package: the hand's with its LPIPS
    term off (skin weights from a grid with `voxel`, else per point), or
    the object workload's; `model` overrides GaussianOpts."""
    cfg = config_mod.hand_config() if articulated \
        else config_mod.ExperimentConfig(workload="object")
    cfg.skin_init = "mano_init_voxel" if voxel else "mano_init_points"
    cfg.capacity = CAP
    cfg.dataset.width, cfg.dataset.height = W, H
    cfg.loss = dataclasses.replace(
        cfg.loss, losses=("rgb_loss", "ssim_loss", "isotropic_reg"),
        loss_weight=(0.8, 0.2, 0.1))
    cfg.model = dataclasses.replace(_hand_opts(cfg.model, remove_seg_end),
                                    **model)
    cfg.raster = dataclasses.replace(
        cfg.raster, backend=backend, max_pairs_per_tile=1024, tg_max=64,
        pair_budget_factor=2, multi_frac=0.25)
    return cfg


def _jax_step(sc, remove_seg_end, voxel_grid=None, articulated=True,
              skin=True, **model):
    """(step, state, batch) of the JAX package; with voxel_grid the bone
    transforms carry the background channel's identity."""
    cfg = _cfg(jconfig, "xla", remove_seg_end, articulated,
               voxel_grid is not None, **model)
    sw = sc["skin"] if skin and articulated and voxel_grid is None else None
    jmodel = j_init(sc["pts"], sc["cols"], CAP, skin_weights=sw)
    batch = dict(rgb=jnp.asarray(sc["gt"]), mask=jnp.asarray(sc["mask"]),
                 cameras=j_stack(sc["cams"]), bg=jnp.asarray(BG))
    if articulated:
        batch["bone_tf"] = j_bone_tf(
            jnp.asarray(sc["pose"]), jnp.asarray(sc["rest"]),
            append_identity=voxel_grid is not None)
        batch["keypoints"] = jnp.asarray(_keypoints(sc, remove_seg_end))
    step = jwork.make_train_step(cfg, extent=1.0, articulated=articulated,
                                 voxel_grid=voxel_grid)
    return step, jwork.init_train_state(jmodel), batch


def _port_batch(jbatch):
    cams = jbatch["cameras"]
    out = dict(
        rgb=torch.tensor(np.asarray(jbatch["rgb"])),
        mask=torch.tensor(np.asarray(jbatch["mask"])),
        cameras=camera_from_numpy(
            dict({f: np.asarray(getattr(cams, f)) for f in TENSOR_FIELDS},
                 width=cams.width, height=cams.height), "cpu"),
        bg=torch.tensor(np.asarray(jbatch["bg"])))
    for k in ("bone_tf", "keypoints"):
        if k in jbatch:
            out[k] = torch.tensor(np.asarray(jbatch[k]))
    return out


def _port_step(sc, remove_seg_end, jstate, jbatch, voxel_grid=None,
               articulated=True, **model):
    cfg = _cfg(tconfig, "torch", remove_seg_end, articulated,
               voxel_grid is not None, **model)
    step = twork.make_train_step(cfg, extent=1.0, articulated=articulated,
                                 voxel_grid=voxel_grid)
    return step, _port_state(jstate), _port_batch(jbatch)


def _close(got, want, atol, rtol, what):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _port_state(jstate):
    """The JAX train state carried across as numpy (the generator is the
    port's own, seeded 0)."""
    m = jstate.model
    d = dict(jax.tree.map(np.asarray, m.params)._asdict(),
             active=np.asarray(m.active))
    if m.skin_weights is not None:
        d["skin_weights"] = np.asarray(m.skin_weights)
    model = model_from_numpy(d, "cpu")

    def leaves(tree):
        return GaussianParams(*(torch.tensor(np.asarray(x)) for x in tree))

    skin_opt = None
    if jstate.skin_opt is not None:
        skin_opt = ArrayAdamState(*(torch.tensor(np.asarray(x))
                                    for x in jstate.skin_opt))
    return twork.init_train_state(model)._replace(
        opt=AdamState(m=leaves(jstate.opt.m), v=leaves(jstate.opt.v),
                      step=int(jstate.opt.step)),
        stats=DensifyStats(*(torch.tensor(np.asarray(x)) for x in jstate.stats)),
        step=int(jstate.step),
        mask_pruned_flag=torch.tensor(bool(jstate.mask_pruned_flag)),
        skin_opt=skin_opt,
    )


def _compare_states(tstate, jstate, k):
    np.testing.assert_array_equal(tstate.model.active.numpy(),
                                  np.asarray(jstate.model.active))
    assert tstate.step == int(jstate.step) == k + 1
    assert tstate.opt.step == int(jstate.opt.step)
    assert bool(tstate.mask_pruned_flag) == bool(jstate.mask_pruned_flag)
    for name in jstate.model.params._fields:
        # Adam moments hold raw gradients: 2e-3 of the largest entry of
        # each leaf, the normalised tolerance of the render gradients.
        m_j = np.asarray(getattr(jstate.opt.m, name))
        for mom in ("m", "v"):
            want = np.asarray(getattr(getattr(jstate.opt, mom), name))
            got = getattr(getattr(tstate.opt, mom), name)
            scale = np.abs(want).max()
            _close(got, want, 2e-3 * scale + 1e-30, 0,
                   f"step {k} adam {mom} {name}")
        # Parameters: 2e-5 max abs. Adam divides by sqrt(v) + 1e-15, so a
        # gradient that float32 rounding leaves unresolved (|m| below 1e-4
        # of the leaf's largest) still moves its slot by up to the
        # learning rate, in a direction the rounding decides: those slots
        # are exempt, and there must be few of them (< 1% of the leaf).
        want = np.asarray(getattr(jstate.model.params, name))
        got = getattr(tstate.model.params, name).numpy()
        unresolved = np.abs(m_j) < 1e-4 * np.abs(m_j).max()
        bad = np.abs(got - want) > 2e-5
        assert not (bad & ~unresolved).any(), (
            f"step {k} param {name}: max abs err "
            f"{np.abs(got - want)[~unresolved].max()}")
        assert bad.sum() <= 0.01 * bad.size, f"step {k} param {name}"
    for name in jstate.stats._fields:
        want = np.asarray(getattr(jstate.stats, name))
        _close(getattr(tstate.stats, name), want,
               1e-3 * np.abs(want).max() + 1e-12, 0, f"step {k} stats {name}")
    assert (tstate.skin_opt is None) == (jstate.skin_opt is None)
    if jstate.model.skin_weights is None:
        assert tstate.model.skin_weights is None


def run_steps(jstep, jstate, jbatch, tstep, tstate, tbatch, steps):
    """`steps` steps of both packages, each compared after it and each
    started from the same (the JAX) state. Returns the last states and
    metrics and the mask-pruned count."""
    pruned = 0
    for k in range(steps):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        assert set(tm) == set(jm)
        # losses and metrics: float32 sums over the image in another
        # order, rtol 1e-5
        for name in jm:
            _close(tm[name], jm[name], 1e-6, 1e-5, f"step {k} metric {name}")
        _compare_states(tstate, jstate, k)
        pruned += int(tm["mask_pruned"])
        if k + 1 < steps:
            tstate = _port_state(jstate)
    return jstate, tstate, jm, tm, pruned


# (steps, remove_seg_end): one step that runs the far-from-skeleton prune
# (step 0 >= remove_seg_end), three steps of which the first two run the
# segmentation-mask prune. Each step of both starts from the same state:
# after the comparison, the JAX state is carried across to the port, so a
# slot that rounding moved one way does not grow into a different scene.
@pytest.mark.parametrize("steps,remove_seg_end", [(1, 0), (3, 2)],
                         ids=["1_step_far_prune", "3_steps_mask_prune"])
def test_hand_train_steps_match_jax(steps, remove_seg_end):
    sc = _scene()
    jstep, jstate, jbatch = _jax_step(sc, remove_seg_end)
    tstep, tstate, tbatch = _port_step(sc, remove_seg_end, jstate, jbatch)
    *_, pruned = run_steps(jstep, jstate, jbatch, tstep, tstate, tbatch,
                           steps)
    assert pruned > 0  # the prune path ran and removed points


def test_trainable_skin_weights_step_matches_jax():
    """One point-mode step with optimize_skin_weights: the skin weights
    (Adam at skinning_lr, clamped and renormalised) within 1e-6 absolute,
    their moments within 2e-3 of the largest (raw gradients, as the
    parameters' moments), and each live row a convex blend."""
    sc = _scene()
    opts = dict(optimize_skin_weights=True, skinning_lr=0.01)
    jstep, jstate, jbatch = _jax_step(sc, 0, **opts)
    tstep, tstate, tbatch = _port_step(sc, 0, jstate, jbatch, **opts)
    assert tstate.skin_opt is not None
    jstate, tstate, *_ = run_steps(jstep, jstate, jbatch, tstep, tstate,
                                   tbatch, 1)
    sw0, sw1 = jstate.model.skin_weights, tstate.model.skin_weights
    _close(sw1, sw0, 1e-6, 0, "skin weights")
    for got, want in zip(tstate.skin_opt, jstate.skin_opt):
        _close(got, want, 2e-3 * np.abs(np.asarray(want)).max(), 0,
               "skin moments")
    act = tstate.model.active.numpy()
    w = sw1.numpy()[act]
    assert (w >= 0).all()
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-5)
    moved = np.abs(w - sc["skin"][act[:480]]).max()
    assert moved > 1e-5, "skin weights did not move"


def test_densify_step_after_three_steps_matches_jax():
    """make_densify_step on the state three steps left (statistics
    accumulated; opacity_reset_interval 2, so the size prune runs; 32 free
    slots, so some splits fit and the rest are dropped), against JAX's.
    Its split noise comes from the state's generator, not from JAX's key:
    the children's positions are held to the port's own densify_and_prune
    on the same draw, everything else to JAX's event."""
    sc = _scene()
    opts = dict(opacity_reset_interval=2)
    jstep, jstate, jbatch = _jax_step(sc, 0, **opts)
    tstep, tstate, tbatch = _port_step(sc, 0, jstate, jbatch, **opts)
    jstate, *_ = run_steps(jstep, jstate, jbatch, tstep, tstate, tbatch, 3)
    tstate = _port_state(jstate)
    cfg_j = _cfg(jconfig, "xla", 0, **opts)
    cfg_t = _cfg(tconfig, "torch", 0, **opts)
    jdens, jreset = jwork.make_densify_step(cfg_j, extent=1.0)
    tdens, treset = twork.make_densify_step(cfg_t, extent=1.0)
    gen = torch.Generator().manual_seed(0)
    gen.set_state(tstate.gen.get_state())
    noise = torch.randn((2, CAP, 3), generator=gen)
    want_model = densify_mod.densify_and_prune(
        tstate.model, tstate.opt, tstate.stats, cfg_t.model, 1.0, noise,
        use_size_threshold=True)[0]

    j2, jinfo = jdens(jstate)
    t2, tinfo = tdens(tstate)
    for k in jinfo:
        assert int(tinfo[k]) == int(jinfo[k]), k
    assert int(tinfo["splits"]) > 0 and int(tinfo["alloc_dropped"]) > 0
    children = (t2.model.active & ~tstate.model.active).numpy()
    np.testing.assert_array_equal(t2.model.active.numpy(),
                                  np.asarray(j2.model.active))
    for name in j2.model.params._fields:
        got = getattr(t2.model.params, name)
        want = np.asarray(getattr(j2.model.params, name))
        if name == "xyz":
            _close(got[children], want_model.params.xyz[children], 0, 0,
                   "children xyz")
            got, want = got[~children], want[~children]
        _close(got, want, 1e-6, 0, f"densified {name}")
        for mom in ("m", "v"):
            _close(getattr(getattr(t2.opt, mom), name),
                   getattr(getattr(j2.opt, mom), name), 1e-6, 0,
                   f"densified {mom} {name}")
    for got, want in zip(t2.stats, j2.stats):
        _close(got, want, 0, 0, "stats reset")
    for got, want in zip(t2.skin_opt, j2.skin_opt):
        _close(got, want, 1e-6, 0, "skin moments after densify")

    j3, t3 = jreset(j2), treset(t2)
    _close(t3.model.params.opacity, j3.model.params.opacity, 1e-5, 0,
           "reset opacity")
    _close(t3.opt.m.opacity, j3.opt.m.opacity, 0, 0, "reset opacity m")


def test_object_train_step_matches_jax():
    """One step of the object workload (articulated=False: no skinning,
    the mask prune without dilation or keypoints) from the scene's points
    in their rest pose."""
    sc = _scene()
    jstep, jstate, jbatch = _jax_step(sc, 1, articulated=False)
    tstep, tstate, tbatch = _port_step(sc, 1, jstate, jbatch,
                                       articulated=False)
    *_, pruned = run_steps(jstep, jstate, jbatch, tstep, tstate, tbatch, 1)
    assert pruned > 0


def test_init_gaussian_model_matches_jax():
    """The port's init (kNN log-scales on the points' device) against the
    JAX package's host kNN init: 1e-5 max abs on log-scales (float32
    distance sums in another order), exact elsewhere."""
    sc = _scene()
    want = j_init(sc["pts"], sc["cols"], CAP, skin_weights=sc["skin"])
    got = model_to_numpy(init_gaussian_model(
        sc["pts"], sc["cols"], CAP, skin_weights=sc["skin"], device="cpu"))
    for name in want.params._fields:
        tol = 1e-5 if name == "scaling" else 1e-6
        _close(got[name], getattr(want.params, name), tol, 0, name)
    np.testing.assert_array_equal(got["active"], np.asarray(want.active))
    _close(got["skin_weights"], want.skin_weights, 0, 0, "skin_weights")
