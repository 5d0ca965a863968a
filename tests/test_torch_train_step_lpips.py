"""Parity of the port's hand training step with the LPIPS term on.

Two HAND_GAUSSIAN steps at 32x32 with capacity 512 on procedural_skeleton,
two views, per-point skin weights, a non-zero background, losses
rgb/ssim/isotropy/lpips and start_lpips_iter = 1: step 0 is below the
gate, step 1 above it. The LPIPS weight is 10 rather than the config's
0.1: at 0.1 this small scene's LPIPS gradient moves the Adam moments by
4e-4 of their size, too little for a comparison to see; at 10 it is
about 4% of them. The JAX step runs backend="xla" with
lpips_conv="pallas" (the layout engine, its kernels in interpret
mode on the CPU; "auto" would pick the fp32 XLA engine there), the port
backend="torch" on the CPU, where the conv and head kernels run their
plain versions. Both take the gt's LPIPS features from the batch, as
bench.py's step does, and the random-feature VGG16 of seed 0. After each
step the JAX state is carried across to the port, so both start every
step from the same state.
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
from manus_tpu.train import lpips as jlpips
from manus_tpu.train import workloads as jwork
from manus_tpu.utils.camera import stack_cameras as j_stack
from manus_tpu_torch import config as tconfig
from manus_tpu_torch.models.convert import (
    camera_from_numpy,
    lpips_params_from_numpy,
    model_from_numpy,
)
from manus_tpu_torch.models.densify import DensifyStats
from manus_tpu_torch.models.gaussians import GaussianParams
from manus_tpu_torch.ops import conv as tconv
from manus_tpu_torch.train import workloads as twork
from manus_tpu_torch.train.optim import AdamState, group_learning_rates
from manus_tpu_torch.utils.camera import TENSOR_FIELDS

W = H = 32
CAP = 512
BG = np.array([0.2, 0.3, 0.1], np.float32)
LOSSES = ("rgb_loss", "ssim_loss", "isotropic_reg", "lpips_loss")
WEIGHTS = (0.8, 0.2, 0.1, 10.0)


def _configure(cfg, backend):
    cfg.capacity = CAP
    cfg.skin_init = "mano_init_points"
    cfg.dataset.width, cfg.dataset.height = W, H
    cfg.loss = dataclasses.replace(cfg.loss, losses=LOSSES,
                                   loss_weight=WEIGHTS, lpips_conv="pallas")
    cfg.model = dataclasses.replace(cfg.model, remove_seg_end=0,
                                    start_lpips_iter=1)
    cfg.raster = dataclasses.replace(cfg.raster, backend=backend,
                                     max_pairs_per_tile=1024)
    return cfg


def _port_state(jstate):
    m = jstate.model
    model = model_from_numpy(
        dict(jax.tree.map(np.asarray, m.params)._asdict(),
             active=np.asarray(m.active), skin_weights=np.asarray(m.skin_weights)),
        "cpu")

    def leaves(tree):
        return GaussianParams(*(torch.tensor(np.asarray(x)) for x in tree))

    return twork.init_train_state(model)._replace(
        opt=AdamState(m=leaves(jstate.opt.m), v=leaves(jstate.opt.v),
                      step=int(jstate.opt.step)),
        stats=DensifyStats(*(torch.tensor(np.asarray(x)) for x in jstate.stats)),
        step=int(jstate.step),
        mask_pruned_flag=torch.tensor(bool(jstate.mask_pruned_flag)),
    )


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step's two steps: for each, the state it started from, its
    metrics and the state it made, all as numpy; and the port's batch."""
    skel = procedural_skeleton(8)
    j = len(skel["bnames"])
    pts, cols = sample_gaussians_on_bones(
        skel["rest_heads"], skel["rest_tails"], skel["rest_transforms"], 28,
        seed=0)
    pts, cols = pts[:480], cols[:480]
    rng = np.random.RandomState(0)
    skin = rng.dirichlet(np.ones(j) * 0.1, size=pts.shape[0]).astype(np.float32)
    cams = j_stack(hemisphere_cameras(
        4, W, H, dist=0.3, center=skel["rest_heads"].mean(axis=0))[:2])
    frame = 3
    kp = np.concatenate([skel["pose_heads"][frame][:1],
                         skel["pose_tails"][frame]]).astype(np.float32)
    gt = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    params = jlpips.random_lpips_params(0, "vgg")
    feats = [jlpips.lpips_features(params, jnp.asarray(gt[i]), "pallas",
                                   interpret=True) for i in range(2)]
    batch = dict(
        rgb=jnp.asarray(gt), mask=jnp.ones((2, H, W, 1), jnp.float32),
        cameras=cams, bg=jnp.asarray(BG),
        bone_tf=j_bone_tf(jnp.asarray(skel["pose_transforms"][frame]),
                          jnp.asarray(skel["rest_transforms"])),
        keypoints=jnp.asarray(kp),
        lpips_gt_feats=tuple(jnp.stack([f[s] for f in feats])
                             for s in range(5)),
    )
    cfg = _configure(jconfig.hand_config(), "xla")
    step = jwork.make_train_step(cfg, extent=1.0, articulated=True,
                                 lpips_params=params)
    state = jwork.init_train_state(
        j_init(pts, cols, CAP, skin_weights=skin))
    runs = []
    for _ in range(2):
        start = state
        state, metrics = step(state, batch)
        runs.append((start, {k: float(v) for k, v in metrics.items()}, state))

    tcams = camera_from_numpy(
        dict({f: np.asarray(getattr(cams, f)) for f in TENSOR_FIELDS},
             width=cams.width, height=cams.height), "cpu")
    tbatch = dict(
        rgb=torch.tensor(gt), mask=torch.ones(2, H, W, 1), cameras=tcams,
        bg=torch.tensor(BG), bone_tf=torch.tensor(np.asarray(batch["bone_tf"])),
        keypoints=torch.tensor(kp),
        lpips_gt_feats=tuple(
            torch.tensor(np.asarray(f, np.float32))[..., : c].to(torch.bfloat16)
            for f, c in zip(batch["lpips_gt_feats"], (64, 128, 256, 512, 512))),
    )
    tparams = lpips_params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, "cpu")
    return dict(runs=runs, batch=tbatch, params=tparams)


def _port_step(run, k):
    start, metrics, want = run["runs"][k]
    cfg = _configure(tconfig.hand_config(), "torch")
    step = twork.make_train_step(cfg, extent=1.0, articulated=True,
                                 lpips_params=run["params"])
    state, got = step(_port_state(start), run["batch"])
    assert set(got) == set(metrics)
    return start, state, got, metrics, want


def _check_state(start, tstate, jstate, grad_tol, jax_limits=None):
    """The port's state after one step from JAX's `start` against JAX's.

    Adam moments: within grad_tol of each leaf's largest entry. The
    parameters are held to the optimiser itself, on every active slot:
    masked Adam applied in float64 to the port's own moments and the
    pre-step parameters, at group_learning_rates' rates and the float32
    bias corrections, within 4 float32 ulps of the parameter plus 1e-6
    of the learning rate (the port computes in float32; measured, at most
    0.17 of that). So each parameter is what its moments, held to JAX's,
    make it. A limit on the parameters against JAX's would not follow
    from the moment tolerance: Adam's step is lr * m_hat / sqrt(v_hat),
    and at a slot whose first moment is 0.1 of the leaf's largest,
    moments within 2e-3 of the largest move that step by up to about 2%
    of lr (1e-3 at the opacity rate of 0.05); such a limit passes or
    fails on how one slot's rounding falls on a given CPU. Every slot
    lies within two learning rates of JAX's: a slot whose moment is at
    the noise floor takes an Adam step of up to about the learning rate
    in whichever direction its rounding decides.

    jax_limits = (resolved, tol, share), for the fp32-only step below the
    LPIPS gate, where the moments agree to 1.5e-5: slots whose first
    moment is at least `resolved` of the leaf's largest lie within `tol`
    of JAX's parameters, and at most `share` of a leaf lies beyond it."""
    np.testing.assert_array_equal(tstate.model.active.numpy(),
                                  np.asarray(jstate.model.active))
    assert tstate.step == int(jstate.step)
    assert tstate.opt.step == int(jstate.opt.step)
    lrs = group_learning_rates(_configure(tconfig.hand_config(), "torch").model,
                               int(jstate.step) - 1)
    # the bias corrections as both packages compute them, in float32 (1 -
    # 0.999 is 4.7e-5 off 1e-3 there, which moves the step by 2.3e-5 of it)
    t = tstate.opt.step
    bc1, bc2 = (float(1.0 - torch.tensor(beta, dtype=torch.float32) ** t)
                for beta in (0.9, 0.999))
    active = tstate.model.active.numpy()
    for name in jstate.model.params._fields:
        for mom in ("m", "v"):
            want = np.asarray(getattr(getattr(jstate.opt, mom), name))
            got = getattr(getattr(tstate.opt, mom), name).numpy()
            scale = np.abs(want).max()
            np.testing.assert_allclose(got, want, atol=grad_tol * scale + 1e-30,
                                       rtol=0, err_msg=f"adam {mom} {name}")
        lr = float(getattr(lrs, name))
        got = getattr(tstate.model.params, name).numpy()
        m = getattr(tstate.opt.m, name).numpy().astype(np.float64)
        v = getattr(tstate.opt.v, name).numpy().astype(np.float64)
        p0 = np.asarray(getattr(start.model.params, name), np.float64)
        adam = p0 - lr * (m / bc1) / (np.sqrt(v / bc2) + 1e-15)
        act = np.broadcast_to(active.reshape((-1,) + (1,) * (m.ndim - 1)),
                              m.shape)
        off = np.abs(got - adam) > 4 * np.spacing(np.abs(got)) + 1e-6 * lr
        assert not (off & act).any(), (
            f"{name}: {int((off & act).sum())} active slots off the "
            f"optimiser's step, max {np.abs(got - adam)[act].max():.3g}")
        err = np.abs(got - np.asarray(getattr(jstate.model.params, name)))
        assert err.max() <= 2 * lr + 2e-5, name
        if jax_limits is not None:
            resolved, tol, share = jax_limits
            m_j = np.abs(np.asarray(getattr(jstate.opt.m, name)))
            assert not ((err > tol) & (m_j >= resolved * m_j.max())).any(), \
                name
            assert (err > tol).sum() <= share * err.size, name


def test_lpips_step_below_the_gate_runs_no_conv(jax_run, monkeypatch):
    """Step 0 < start_lpips_iter: the lpips part is 0 on both sides, and
    the port runs no conv and no head. Tolerances as in
    test_torch_train_step (no bf16 on this path)."""
    def no_conv(*args, **kwargs):
        raise AssertionError("a conv ran below the LPIPS gate")

    monkeypatch.setattr(tconv, "conv3x3_layout_torch", no_conv)
    monkeypatch.setattr(tconv, "head_fwd_torch", no_conv)
    start, tstate, got, want, jstate = _port_step(jax_run, 0)
    assert want["loss/lpips_loss"] == 0.0
    assert got["loss/lpips_loss"].item() == 0.0
    for name in want:
        np.testing.assert_allclose(got[name].item(), want[name], atol=1e-6,
                                   rtol=1e-5, err_msg=name)
    # as in test_torch_train_step
    _check_state(start, tstate, jstate, 2e-3, jax_limits=(1e-4, 2e-5, 0.01))


def test_lpips_step_above_the_gate_matches_jax(jax_run):
    """Step 1 >= start_lpips_iter. The VGG16 runs in bf16 on both sides,
    with the same rounding sites, so the chains agree but for the rare
    bf16 rounding that fp32 sums in another order send the other way.
    Metrics: 1e-4 relative (measured 7e-7 on the total loss, 4.5e-6 on
    the LPIPS value). Adam moments: 2e-3 of each leaf's largest entry, as
    in test_torch_train_step (measured up to 6e-4 here, 1.5e-5 without
    LPIPS): the LPIPS image gradient arrives bf16-rounded, and where one
    pixel's rounding went the other way (one ulp, 2^-8 of it) the
    gaussians over that pixel see the difference. Parameters: the
    optimiser check of _check_state (Adam in float64 on the port's own
    moments) on every active slot, and every slot within two learning
    rates of JAX's. No limit against JAX's parameters: 85 to 123 of the
    512 opacity slots move by more than 2e-5, as the CPU's rounding falls
    (at most 3.4e-3, against a learning rate of 0.05), and on some CPUs
    one of them has a moment of 0.132 of the largest: there the
    port's m = -8.3562e-6, v = 4.6678e-12 against JAX's -8.3404e-6,
    4.6592e-12 (0.19% of m, inside the moment tolerance of 1.26e-7), and
    the parameter moves 4.46e-5 from JAX's."""
    start, tstate, got, want, jstate = _port_step(jax_run, 1)
    assert want["loss/lpips_loss"] > 0
    for name in want:
        np.testing.assert_allclose(got[name].item(), want[name], atol=1e-6,
                                   rtol=1e-4, err_msg=name)
    _check_state(start, tstate, jstate, 2e-3)
