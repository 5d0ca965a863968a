"""Inverse kinematics for the 20-bone hand skeleton (the JAX package's
preprocess/ik.py): anatomical DOF masks and joint limits, differentiable
FK with bone-length rescaling, the keypoint and hinge-limit loss, bone
lengths from triangulated keypoints, and a per-frame AdaBelief solve.

AdaBelief is written out here (no optimiser package on the card's
machine), to optax's rule: mu = b1 mu + (1 - b1) g; the prediction error
g - mu with the new mu; nu = b2 nu + (1 - b2) (g - mu)^2 + eps_root, kept
in the state; p -= lr mu_hat / (sqrt(nu_hat) + eps) with the bias
corrections 1 - b^t. A frame's iterations run on the device with no host
sync: the chain's constants go to the device before the loop, the best
loss is tracked with torch.where, and the caller reads it once a frame.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from manus_tpu_torch.utils.device import resolve_device
from manus_tpu_torch.utils.transforms import (
    euler_angles_to_matrix,
    rest_local_points,
)

TIP_JOINTS = (4, 8, 12, 16, 20)  # fingertip keypoints weigh 2x in the loss
B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-16, 1e-16


@dataclasses.dataclass
class HandChain:
    """The chain's static description (host side, numpy)."""

    bnames: list
    parents: np.ndarray  # [J]
    rest_matrices: np.ndarray  # [J, 4, 4]
    heads: np.ndarray  # [J, 3]
    tails: np.ndarray  # [J, 3]
    bone_lengths: np.ndarray  # [J]
    dof: np.ndarray  # [J+1, 3] bool (root + per-bone euler dof)
    limits: np.ndarray  # [J+1, 3, 2]

    @property
    def kintree(self) -> dict:
        return {str(i): int(p) for i, p in enumerate(self.parents)}

    @property
    def num_bones(self) -> int:
        return len(self.bnames)


def default_hand_dof(n_bones: int = 20):
    """Anatomical DOF and limits (dof [J+1, 3] bool, limits [J+1, 3, 2]).
    Row 0 is the global root (every axis); then 1-2 thumb CMC (xz), 3
    thumb MCP (xz), 4 thumb IP (z), and per finger MCP (xz) / PIP (z) /
    DIP (z) at strides of 4."""
    j1 = n_bones + 1
    dof = np.zeros((j1, 3), bool)
    limits = np.zeros((j1, 3, 2), np.float32)
    limits[:, :, 0] = -np.pi
    limits[:, :, 1] = np.pi
    xz = [True, False, True]
    dof[0, :] = True
    if j1 > 1:
        dof[1, xz] = True
        limits[1, 0] = (-np.pi / 9, np.pi / 9)
    if j1 > 2:
        dof[2, xz] = True
        limits[2, 0] = (-np.pi / 9, np.pi / 9)
    if j1 > 3:
        dof[3, xz] = True
    if j1 > 4:
        dof[4, 2] = True
    if j1 > 6:
        dof[6:19:4, xz] = True
        limits[6:19:4, 0] = (-np.pi / 6, np.pi / 6)
        limits[6:19:4, 2] = (-np.pi / 2, np.pi / 9)
        dof[7:20:4, 2] = True
        limits[7:20:4, 2] = (-np.pi / 2, np.pi / 9)
        dof[8:21:4, 2] = True
        limits[8:21:4, 2] = (-np.pi / 2, 0.0)
    return dof, limits


def make_chain(bnames, parents, rest_matrices, heads, tails,
               bone_lengths=None) -> HandChain:
    parents = np.asarray(parents, np.int32)
    heads = np.asarray(heads, np.float32)
    tails = np.asarray(tails, np.float32)
    if bone_lengths is None:
        bone_lengths = np.linalg.norm(tails - heads, axis=1)
    dof, limits = default_hand_dof(len(bnames))
    return HandChain(
        bnames=list(bnames), parents=parents,
        rest_matrices=np.asarray(rest_matrices, np.float32),
        heads=heads, tails=tails,
        bone_lengths=np.asarray(bone_lengths, np.float32),
        dof=dof, limits=limits,
    )


def _levels(parents: np.ndarray) -> list:
    """The bones by depth in the tree, [(bones, parents' positions in the
    level above), ...] from the roots down: FK takes one batched step a
    level instead of one a bone."""
    depth = {}
    for i, p in enumerate(parents):
        depth[i] = 0 if p == -1 else depth[int(p)] + 1
    out, prev = [], []
    for d in range(max(depth.values()) + 1):
        bones = [i for i in range(len(parents)) if depth[i] == d]
        out.append((bones, [prev.index(int(parents[i])) for i in bones]
                    if d else []))
        prev = bones
    return out


class ChainLevel(NamedTuple):
    """One depth level of a chain on a device: its bones, where their
    parents sit in the level above, rest_inv[parent] @ rest of each bone
    (a root's rest), its heads [n, 4, 1] and tail - head [n, 4, 1] (w 0)
    in the bone's rest frame, and its bone lengths [n, 1]."""

    bones: torch.Tensor
    parent_pos: torch.Tensor
    local_rest: torch.Tensor
    head_local: torch.Tensor
    dir_local: torch.Tensor
    lengths: torch.Tensor


class ChainTensors(NamedTuple):
    """A chain's constants on one device, built once before a solve: its
    levels, the permutation from level order back to bone order, the
    limits, the DOF mask (bool and float), the tip weights, and the eye
    and (3, 3) unit of a homogeneous matrix."""

    levels: tuple
    order: torch.Tensor  # [J]: bone order's positions in the levels' cat
    limits: torch.Tensor  # [J+1, 3, 2]
    dof: torch.Tensor  # [J+1, 3] bool
    dof_f: torch.Tensor  # [J+1, 3] float
    tip_w: torch.Tensor  # [J+1]
    unit33: torch.Tensor  # [4, 4]: 1 at (3, 3)


def chain_tensors(chain: HandChain, device=None) -> ChainTensors:
    """The chain's constants on `device` (the card by default). The rest
    inverses are taken here, once: on a CUDA tensor an inverse
    synchronises the host."""
    device = resolve_device(device)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    rest = np.asarray(chain.rest_matrices, np.float64)
    rest_inv = np.linalg.inv(rest)
    rest_t, inv_t = t(rest), t(rest_inv.astype(np.float32))
    ends = rest_local_points(
        rest_t.repeat(2, 1, 1), t(np.concatenate([chain.heads, chain.tails])),
        inv_t.repeat(2, 1, 1)).reshape(2, -1, 4)  # [2, J, 4]
    levels, order = [], []
    for bones, ppos in _levels(chain.parents):
        local = [rest_t[i] if not ppos else
                 inv_t[int(chain.parents[i])] @ rest_t[i] for i in bones]
        levels.append(ChainLevel(
            bones=t(bones, torch.long), parent_pos=t(ppos, torch.long),
            local_rest=torch.stack(local),
            head_local=ends[0, bones][..., None],
            dir_local=(ends[1, bones] - ends[0, bones])[..., None],
            lengths=t(chain.bone_lengths[bones])[:, None]))
        order.extend(bones)
    # the fingertip weights: JAX's .at[TIP_JOINTS].set(2.0, mode="drop")
    # silently drops the indices past the keypoints of a short chain
    n_kp = chain.num_bones + 1
    tip_w = np.ones(n_kp, np.float32)
    tip_w[[i for i in TIP_JOINTS if i < n_kp]] = 2.0
    unit33 = np.zeros((4, 4), np.float32)
    unit33[3, 3] = 1.0
    return ChainTensors(
        levels=tuple(levels), order=t(np.argsort(order), torch.long),
        limits=t(chain.limits), dof=t(chain.dof, torch.bool),
        dof_f=t(chain.dof), tip_w=t(tip_w), unit33=t(unit33))


def chain_forward(chain: HandChain, trans: torch.Tensor,
                  angles: torch.Tensor, tensors: ChainTensors = None):
    """FK -> (keypoints [J+1, 3]: the root's head and the scaled bone
    tails, scaled heads [J, 3], scaled tails [J, 3]). angles [J+1, 3] is
    the full Euler set, root first (intrinsic XYZ). Bone directions come
    from the posed matrices and each bone starts at its parent's scaled
    tail with its estimated length; a root is global @ rest @ pose, a
    child parent @ (rest_inv[parent] @ rest @ pose), one level of the
    tree at a time. tensors: chain_tensors(chain) on trans's device, built
    here when not given."""
    ct = tensors if tensors is not None else chain_tensors(chain,
                                                           trans.device)
    pose_m = euler_angles_to_matrix(angles, "XYZ", intrinsic=True)
    pose_h = F.pad(pose_m, (0, 1, 0, 1)) + ct.unit33  # [J+1, 4, 4]
    global_trans = F.pad(torch.cat([pose_m[0], trans[:, None]], -1),
                         (0, 0, 0, 1)) + ct.unit33
    bone_pose = pose_h[1:]
    heads, tails = [], []
    m = end = None
    # homogeneous 4-vectors throughout: points w = 1, directions w = 0
    for lv in ct.levels:
        pose = bone_pose.index_select(0, lv.bones)
        if m is None:
            m = (global_trans @ lv.local_rest) @ pose
            start = (m @ lv.head_local)[..., 0]
        else:
            m = m.index_select(0, lv.parent_pos) @ (lv.local_rest @ pose)
            start = end.index_select(0, lv.parent_pos)
        d = (m @ lv.dir_local)[..., 0]  # tail - head, posed
        end = start + d / torch.linalg.norm(d, dim=1, keepdim=True) \
            * lv.lengths
        heads.append(start)
        tails.append(end)
    ends = torch.cat([torch.cat(heads), torch.cat(tails)], 1)
    ends = ends.index_select(0, ct.order)
    heads_s, tails_s = ends[:, :3], ends[:, 4:7]
    return torch.cat([heads_s[:1], tails_s], 0), heads_s, tails_s


def ik_loss(chain: HandChain, trans, angles_full, target, to_use,
            limit: bool = True, tensors: ChainTensors = None,
            count=None) -> dict:
    """The weighted keypoint loss (fingertips 2x, joints of to_use only,
    over their count) and, with limit, the squared hinge of the angles
    past their limits on the DOF axes. count: to_use's count, clamped to
    1, when the caller has it."""
    ct = tensors if tensors is not None else chain_tensors(chain,
                                                           trans.device)
    pred = chain_forward(chain, trans, angles_full, ct)[0]
    err = ((pred - target) ** 2).sum(1) * ct.tip_w
    err = torch.where(to_use, err, 0.0)
    if count is None:
        count = to_use.sum().clamp_min(1).float()
    out = {"keypoint_loss": err.sum() / count}
    if limit:
        hi = torch.relu(angles_full - ct.limits[..., 1]) ** 2
        lo = torch.relu(ct.limits[..., 0] - angles_full) ** 2
        out["limit_loss"] = ((hi + lo) * ct.dof_f).sum()
    return out


def update_bone_lengths(chain: HandChain, keypoints: np.ndarray) -> HandChain:
    """Each bone's mean observed length over the frames whose two
    endpoints have a confidence. keypoints [F, J+1, 4] (xyz, conf)."""
    lengths = chain.bone_lengths.copy()
    for i in range(chain.num_bones):
        cur, par = i + 1, int(chain.parents[i]) + 1
        ok = ~(np.isclose(keypoints[:, cur, 3], 0)
               | np.isclose(keypoints[:, par, 3], 0))
        if not ok.any():
            raise ValueError(f"no frame has length of bone {chain.bnames[i]}")
        vecs = keypoints[ok, cur, :3] - keypoints[ok, par, :3]
        lengths[i] = float(np.linalg.norm(vecs, axis=1).mean())
    return dataclasses.replace(chain, bone_lengths=lengths)


def bias_corrections(max_iter: int, device) -> tuple:
    """1 - b1^t and 1 - b2^t for t = 1..max_iter, in float32 on device."""
    t = torch.arange(1, max_iter + 1, dtype=torch.float32, device=device)
    b1 = torch.full((), B1, dtype=torch.float32, device=device)
    b2 = torch.full((), B2, dtype=torch.float32, device=device)
    return 1 - b1 ** t, 1 - b2 ** t


def adabelief_step(p, g, mu, nu, bc1, bc2, lr: float):
    """One AdaBelief update of p in place (optax 0.2.6's scale_by_belief,
    then -lr), mu and nu with it, each product rounded where optax rounds
    it: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) (g - mu)^2 +
    eps_root, p += -lr ((mu / bc1) / (sqrt(nu / bc2) + eps))."""
    mu.mul_(B1).add_(g * (1 - B1))
    err = g - mu
    nu.mul_(B2).add_((err * err) * (1 - B2)).add_(EPS_ROOT)
    p.add_((mu / bc1) / (nu / bc2).sqrt_().add_(EPS) * -lr)


def adabelief_loop(loss_fn, p: torch.Tensor, lr: float, max_iter: int,
                   bc=None):
    """max_iter AdaBelief steps on the flat parameter vector p from zero
    moments, with no host sync. loss_fn(p) -> 0-d loss. As the JAX
    package's scan, a step's loss is that of the parameters before the
    step, and where it improves on the best so far the parameters after
    the step are kept. Returns (best loss, best parameters), on the
    device."""
    bc1, bc2 = bc if bc is not None else bias_corrections(max_iter, p.device)
    p = p.detach().clone()
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    best_loss = torch.full((), float("inf"), device=p.device)
    best_p = p.clone()
    for t in range(max_iter):
        x = p.requires_grad_(True)
        loss = loss_fn(x)
        (g,) = torch.autograd.grad(loss, x)
        p = x.detach()
        with torch.no_grad():
            adabelief_step(p, g, mu, nu, bc1[t], bc2[t], lr)
            best_p = torch.where(loss < best_loss, p, best_p)
            best_loss = torch.minimum(loss, best_loss)
    return best_loss, best_p


def solve_ik(chain: HandChain, target: torch.Tensor, to_use: torch.Tensor,
             constraint: bool = True, limit: bool = True, lr: float = 1e-1,
             trans_init: Optional[torch.Tensor] = None,
             angles_init: Optional[torch.Tensor] = None,
             max_iter: int = 500, tensors: ChainTensors = None):
    """One frame's IK by AdaBelief on target [J+1, 3] (the joints of
    to_use [J+1] bool), on target's device. Returns (trans [3], angles
    [J+1, 3], best loss as a float: the frame's one host sync). With
    constraint only the anatomical DOF entries move; the others stay 0.
    tensors: chain_tensors(chain) on that device (built here when not
    given; a sequence builds it once)."""
    dev = target.device
    ct = tensors if tensors is not None else chain_tensors(chain, dev)
    n = chain.num_bones + 1
    trans0 = trans_init if trans_init is not None else torch.zeros(
        3, device=dev)
    angles0 = angles_init if angles_init is not None else torch.zeros(
        (n, 3), device=dev)

    def expand(angles_p):
        return torch.where(ct.dof, angles_p, 0.0) if constraint else angles_p

    count = to_use.sum().clamp_min(1).float()

    def loss_fn(p):
        losses = ik_loss(chain, p[:3], expand(p[3:].reshape(n, 3)), target,
                         to_use, limit, ct, count)
        return losses["keypoint_loss"] + losses.get("limit_loss", 0.0)

    p0 = torch.cat([trans0.reshape(3), angles0.reshape(-1)]).float()
    best_loss, best_p = adabelief_loop(loss_fn, p0, lr, max_iter)
    return best_p[:3], expand(best_p[3:].reshape(n, 3)), float(best_loss)
