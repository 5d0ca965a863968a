"""The deformation kernels' math (manus_tpu_torch/csrc/deform.cu), on the CPU.

The kernels cannot run here, so this file writes their closed-form
backwards once more in plain torch (`covariance_vjp`, `skin_vjp`,
`skin_sample_vjp`), term by term as the .cu computes them, and holds them
to autograd of the plain chain they replace, in float64: through the
autograd Functions of ops/deform.py, whose kernel wrappers are swapped
for the plain forward and these backwards, in the compositions the
callers make (the object's covariance; the hand's voxel weights with the
positions detached; the fine-tune's sample traced to the positions;
trainable per-point weights; an isotropic model's expanded scale; points
outside the grid; near-degenerate quaternions). It also holds the CPU
path to the frozen plain chain bit for bit and checks that the CUDA-only
wrappers refuse CPU tensors. tests/test_torch_cuda.py holds the kernels
themselves to the plain chain on a card.
"""
import pytest
import torch

from manus_tpu_torch.ops import deform
from manus_tpu_torch.ops.grid_sample import (
    skinning_weights_from_voxel_grid,
    skinning_weights_from_voxel_grid_torch,
)
from manus_tpu_torch.ops.skinning import skin_gaussians, skin_gaussians_torch
from manus_tpu_torch.utils.transforms import (
    build_symmetric,
    covariance_from_scaling_rotation,
    covariance_from_scaling_rotation_torch,
    quaternion_to_matrix,
)
from portbench.reference import frozen

PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
BONES = 4  # skinned rows' bones; the grid has BONES + 1 channels
# The closed forms against autograd, both in float64: they differ in the
# order of their sums only, so the largest gap of a leaf's gradient is a
# few ulps of its largest entry (read: under 1e-14); 1e-10 leaves room
# and fails any wrong term, which moves a gradient by its own size.
RTOL = 1e-10


def _upper(g):
    """[N, 6] upper-triangle rows -> the [N, 3, 3] matrix M with M[a, b] =
    g_ab for a <= b and 0 below the diagonal."""
    m = g.new_zeros(g.shape[0], 3, 3)
    for p, (a, b) in enumerate(PAIRS):
        m[:, a, b] = g[:, p]
    return m


def covariance_vjp(scaling, rotation, modifier, g_cov, need=(True, True)):
    """covariance_bwd_kernel: (d scaling [N, 3], d rotation [N, 4])."""
    x = scaling * modifier
    s2 = x * x
    nrm = torch.linalg.norm(rotation, dim=-1, keepdim=True)
    qn = rotation / nrm
    r, i, j, k = qn.unbind(-1)
    ts = 2.0 / (qn * qn).sum(-1)
    R = quaternion_to_matrix(qn)
    gs2 = sum(g_cov[:, p, None] * R[:, a, :] * R[:, b, :]
              for p, (a, b) in enumerate(PAIRS))
    g_s = gs2 * (2.0 * x) * modifier
    m = _upper(g_cov)
    gR = ((m + m.transpose(1, 2)) @ R * s2[:, None, :]).reshape(-1, 9)
    g0, g1, g2, g3, g4, g5, g6, g7, g8 = gR.unbind(-1)
    gts = (-g0 * (j * j + k * k) + g1 * (i * j - k * r) + g2 * (i * k + j * r)
           + g3 * (i * j + k * r) - g4 * (i * i + k * k) + g5 * (j * k - i * r)
           + g6 * (i * k - j * r) + g7 * (j * k + i * r)
           - g8 * (i * i + j * j))
    gq = ts[:, None] * torch.stack([
        -k * g1 + j * g2 + k * g3 - i * g5 - j * g6 + i * g7,
        j * g1 + k * g2 + j * g3 - 2 * i * g4 - r * g5 + k * g6 + r * g7
        - 2 * i * g8,
        -2 * j * g0 + i * g1 + r * g2 + i * g3 + k * g5 - r * g6 + k * g7
        - 2 * j * g8,
        -2 * k * g0 - r * g1 + i * g2 + r * g3 - 2 * k * g4 + j * g5 + i * g6
        + j * g7], -1)
    gq = gq - (ts * ts * gts)[:, None] * qn
    g_nrm = -(gq * rotation).sum(-1, keepdim=True) / (nrm * nrm)
    g_r = gq / nrm + rotation * (g_nrm / nrm)
    return tuple(g if want else None for g, want in zip((g_s, g_r), need))


def skin_vjp(xyz, cov, w, transforms, g_xyz, g_cov, g_tf,
             need=(True, True, True)):
    """skin_bwd_kernel: (d xyz [N, 3], d cov [N, 6], d w [N, B])."""
    b = transforms.shape[0]
    tf = (w @ transforms.reshape(b, 16)).reshape(-1, 4, 4)
    A = tf[:, :3, :3]
    gt = torch.zeros_like(tf) if g_tf is None else g_tf.clone()
    dx = torch.zeros_like(xyz)
    ds = torch.zeros_like(cov)
    if g_xyz is not None:
        dx = (A * g_xyz[:, :, None]).sum(1)
        gt[:, :3, :3] += g_xyz[:, :, None] * xyz[:, None, :]
        gt[:, :3, 3] += g_xyz
    if g_cov is not None:
        m = _upper(g_cov)
        gh = (m + m.transpose(1, 2)) / 2
        gt[:, :3, :3] += 2 * gh @ A @ build_symmetric(cov)
        h = A.transpose(1, 2) @ gh @ A
        ds = torch.stack([h[:, a, b] * (1 if a == b else 2)
                          for a, b in PAIRS], -1)
    dw = gt.reshape(-1, 16) @ transforms.reshape(b, 16).T
    return tuple(g if want else None
                 for g, want in zip((dx, ds, dw), need))


def _corner(lo, t, q, dims):
    """Corner q (dz-major, then dy, dx) of the voxel below each point:
    (inside, clamped voxel [N], per-axis weights [N, 3], offsets)."""
    off = (q & 1, (q >> 1) & 1, q >> 2)
    v = lo + lo.new_tensor(off)
    inside = ((v >= 0) & (v < lo.new_tensor(dims))).all(-1)
    idx = torch.minimum(v.clamp(min=0), lo.new_tensor(dims) - 1).long()
    voxel = (idx[:, 2] * dims[1] + idx[:, 1]) * dims[0] + idx[:, 0]
    wk = torch.stack([t[:, a] if off[a] else 1 - t[:, a] for a in range(3)],
                     -1)
    return inside, voxel, wk, off


def skin_sample_vjp(xyz, center, scale, grid, g_w):
    """skin_sample_bwd_kernel: d xyz [N, 3] of the normalised sample."""
    d, h, w, c = grid.shape
    dims = (w, h, d)
    size = xyz.new_tensor([w - 1, h - 1, d - 1])
    f = (xyz - center) / scale
    f = (f + 1.0) * 0.5 * size
    lo = torch.floor(f)
    t = f - lo
    flat = grid.reshape(-1, c)
    raw = torch.zeros_like(g_w)
    corners = []
    for q in range(8):
        inside, voxel, wk, off = _corner(lo, t, q, dims)
        vals = flat[voxel]
        raw = raw + torch.where(inside, wk.prod(-1), 0.0)[:, None] * vals
        corners.append((inside, vals, wk, off))
    denom = raw.sum(-1)
    ok = denom != 0
    den = torch.where(ok, denom, 1.0)
    g_den = -(g_w * raw).sum(-1) / (den * den)
    # d raw_ch, which each corner's weight takes dotted with its channels
    coef = g_w / den[:, None] + g_den[:, None]
    dt = torch.zeros_like(xyz)
    for inside, vals, wk, off in corners:
        gw = torch.where(inside & ok, (coef * vals).sum(-1), 0.0)
        gxy = gw * wk[:, 2]
        gk = torch.stack([gxy * wk[:, 1], gxy * wk[:, 0],
                          gw * wk[:, 0] * wk[:, 1]], -1)
        dt = dt + gk * xyz.new_tensor([1 if o else -1 for o in off])
    return dt * size * 0.5 / scale


@pytest.fixture
def mirrored(monkeypatch):
    """ops/deform.py's kernel wrappers as the plain forward and the closed
    forms above, so that its autograd Functions run on the CPU."""
    monkeypatch.setattr(deform, "covariance_fwd_cuda",
                        covariance_from_scaling_rotation_torch)
    monkeypatch.setattr(deform, "covariance_bwd_cuda", covariance_vjp)
    monkeypatch.setattr(deform, "skin_fwd_cuda",
                        lambda *a: tuple(skin_gaussians_torch(*a)))
    monkeypatch.setattr(deform, "skin_bwd_cuda", skin_vjp)
    monkeypatch.setattr(deform, "skin_sample_fwd_cuda",
                        skinning_weights_from_voxel_grid_torch)
    monkeypatch.setattr(deform, "skin_sample_bwd_cuda", skin_sample_vjp)


def _inputs(case, n=300, seed=0):
    """float64 leaves and constants of one case."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, dtype=torch.float64)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    rot = randn(n, 4)
    if case == "degenerate_quats":
        # norms down to 1e-6, and rows with two or three zero components
        rot = rot * torch.logspace(-6, 0, n, dtype=torch.float64)[:, None]
        rot[::3, 1:] = 0.0
        rot[1::3, :2] = 0.0
    spread = 1.6 if case == "outside_grid" else 0.9
    xyz = (rand(n, 3) - 0.5) * 2 * spread
    if case == "outside_grid":
        # a tenth of the rows with every corner outside the grid
        out = n // 10
        xyz[:out] = xyz[:out].sign() * (3.0 + rand(out, 3))
    transforms = torch.eye(4, dtype=torch.float64).repeat(BONES + 1, 1, 1)
    transforms[:, :3, :] += 0.3 * randn(BONES + 1, 3, 4)
    weights = rand(n, BONES + 1)
    return dict(
        xyz=xyz, rot=rot,
        scaling=rand(n, 1 if case == "isotropic" else 3) * 0.5 + 0.05,
        weights=weights / weights.sum(-1, keepdim=True),
        transforms=transforms,
        center=randn(3) * 0.1, scale=rand(3) * 0.5 + 0.75,
        grid=rand(5, 6, 7, BONES + 1),
        cot=[randn(n, 6), randn(n, 3), randn(n, 6), randn(n, 4, 4)])


# (case, what differentiates): the leaves each case takes gradients of
CASES = {
    "object": ("scaling", "rot"),
    "isotropic": ("scaling", "rot"),
    "degenerate_quats": ("scaling", "rot"),
    "hand_voxel_detached": ("xyz", "scaling", "rot"),
    "finetune_traced": ("xyz", "scaling", "rot"),
    "trainable_weights": ("xyz", "scaling", "rot", "weights"),
    "outside_grid": ("xyz", "scaling", "rot"),
}


def _pipeline(case, x, cov_fn, skin_fn, sample_fn):
    """The case's chain as its caller composes it; returns the loss."""
    scaling = x["scaling"]
    if scaling.shape[1] == 1:  # get_scaling's isotropic view
        scaling = scaling[:, :1].expand(scaling.shape[0], 3)
    cov = cov_fn(scaling, x["rot"], 1.0)
    c_cov, c_xyz, c_pcov, c_tf = x["cot"]
    loss = (cov * c_cov).sum()
    if case in ("object", "isotropic", "degenerate_quats"):
        return loss
    if case == "trainable_weights":
        w = x["weights"]
    else:
        xyz = x["xyz"] if case != "hand_voxel_detached" else x["xyz"].detach()
        w = sample_fn(xyz, x["center"], x["scale"], x["grid"])
    pxyz, pcov, tf = skin_fn(x["xyz"], cov, w, x["transforms"])
    loss = loss + (pxyz * c_xyz).sum() + (pcov * c_pcov).sum()
    if tf.requires_grad:  # the projection's SH term reads tf
        loss = loss + (tf * c_tf).sum()
    return loss


def _grads(case, cov_fn, skin_fn, sample_fn):
    x = _inputs(case)
    leaves = [x[k].requires_grad_(True) for k in CASES[case]]
    loss = _pipeline(case, x, cov_fn, skin_fn, sample_fn)
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("case", list(CASES))
def test_closed_form_backwards_match_autograd(case, mirrored):
    want = _grads(case, covariance_from_scaling_rotation_torch,
                  lambda *a: tuple(skin_gaussians_torch(*a)),
                  skinning_weights_from_voxel_grid_torch)
    got = _grads(case, deform._Covariance.apply, deform._Skin.apply,
                 deform._SkinSample.apply)
    for name, g, w in zip(CASES[case], got, want):
        assert g.shape == w.shape, name
        assert torch.isfinite(w).all(), name
        # over the leaf's largest entry, or 1 where that is rounding alone:
        # an isotropic Sigma = s^2 I takes no gradient to the rotation
        gap = ((g - w).abs().max() / w.abs().max().clamp(min=1.0)).item()
        assert gap <= RTOL, f"{case}: d {name} {gap:.2e} from autograd's"


def test_tf_carries_no_gradient_without_trainable_weights(mirrored):
    """With the weights detached tf is non-differentiable, as the plain
    chain's (w @ T) is, so the projection skips its gradient."""
    x = _inputs("hand_voxel_detached")
    xyz = x["xyz"].requires_grad_(True)
    w = deform._SkinSample.apply(xyz.detach(), x["center"], x["scale"],
                                 x["grid"])
    pxyz, pcov, tf = deform._Skin.apply(xyz, x["rot"][:, :3].repeat(1, 2),
                                        w, x["transforms"])
    assert pxyz.requires_grad and pcov.requires_grad
    assert not tf.requires_grad
    plain = skin_gaussians_torch(xyz, x["rot"][:, :3].repeat(1, 2), w,
                                 x["transforms"])
    assert not plain.tf.requires_grad


def _float32_inputs(n=500, seed=3):
    x = _inputs("outside_grid", n, seed)
    return {k: v.float() if torch.is_tensor(v) else v for k, v in x.items()}


@pytest.mark.parametrize("fn", ["covariance", "skin", "skin_sample"])
def test_cpu_call_is_the_frozen_plain_chain(fn):
    """A CPU tensor takes the plain chain, unchanged: the same bits as the
    frozen copy portbench's reference runs."""
    x = _float32_inputs()
    cov = frozen.covariance_from_scaling_rotation(x["scaling"], x["rot"])
    if fn == "covariance":
        got = covariance_from_scaling_rotation(x["scaling"], x["rot"])
        assert torch.equal(got, cov)
    elif fn == "skin":
        w = x["weights"]
        got = skin_gaussians(x["xyz"], cov, w, x["transforms"])
        want = frozen.skin_gaussians(x["xyz"], cov, w, x["transforms"])
        for g, v in zip(got, want):
            assert torch.equal(g, v)
    else:
        got = skinning_weights_from_voxel_grid(x["xyz"], x["center"],
                                               x["scale"], x["grid"])
        want = frozen.skinning_weights_from_voxel_grid(
            x["xyz"], x["center"], x["scale"], x["grid"])
        assert torch.equal(got, want)
        assert (got[:50, -1] == 1).all()  # outside: the background channel


def _cpu_calls():
    x = _float32_inputs(n=8)
    s, r, xyz, w = x["scaling"], x["rot"], x["xyz"], x["weights"]
    cov, T = torch.zeros(8, 6), x["transforms"]
    c, sc, grid = x["center"], x["scale"], x["grid"]
    return {
        "covariance_fwd_cuda": lambda: deform.covariance_fwd_cuda(s, r),
        "covariance_bwd_cuda": lambda: deform.covariance_bwd_cuda(
            s, r, 1.0, cov),
        "covariance_cuda": lambda: deform.covariance_cuda(s, r),
        "skin_fwd_cuda": lambda: deform.skin_fwd_cuda(xyz, cov, w, T),
        "skin_bwd_cuda": lambda: deform.skin_bwd_cuda(xyz, cov, w, T, xyz,
                                                      None, None),
        "skin_cuda": lambda: deform.skin_cuda(xyz, cov, w, T),
        "skin_sample_fwd_cuda": lambda: deform.skin_sample_fwd_cuda(
            xyz, c, sc, grid),
        "skin_sample_bwd_cuda": lambda: deform.skin_sample_bwd_cuda(
            xyz, c, sc, grid, w),
        "skin_sample_cuda": lambda: deform.skin_sample_cuda(xyz, c, sc,
                                                            grid),
    }


@pytest.mark.parametrize("name", list(_cpu_calls()))
def test_cuda_wrappers_refuse_cpu_tensors(name):
    """Each CUDA-only entry point raises on a CPU tensor before it builds
    or launches anything, and counts no launch."""
    before = deform.LIBRARY.lib
    with pytest.raises(ValueError, match="CUDA tensors"):
        _cpu_calls()[name]()
    assert deform.LIBRARY.lib is before
    for fn in (deform.covariance_fwd_cuda, deform.covariance_bwd_cuda,
               deform.skin_fwd_cuda, deform.skin_bwd_cuda,
               deform.skin_sample_fwd_cuda, deform.skin_sample_bwd_cuda):
        assert fn.launches == 0
