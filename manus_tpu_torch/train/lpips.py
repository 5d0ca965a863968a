"""The LPIPS perceptual distance: the VGG16 loss and the AlexNet metric,
on four conv engines.

Counterpart of the JAX package's train/lpips.py. Features are taken after
the ReLU of each of the backbone's 5 stages, unit-normalised along
channels, squared differences weighted by the 1x1 heads `lin{k}_w`,
averaged over pixels and summed over stages. The engines (the JAX
config's loss.lpips_conv names):

  "pallas"       VGG16's 13 3x3 convs as the layout chain of ops/conv.py
                 (bf16 features, fp32 accumulation) and the head kernel;
  "xla"          fp32 torch convs with autograd and an fp32 head in torch
                 ops, either backbone (the JAX package's XLA path);
  "xla_dx"       VGG16 on fp32 torch convs whose backward gives the input
                 gradient alone (frozen weights), the head on the head
                 kernel's fp32 rows;
  "xla_dx_bf16"  the same with bf16 activations and fp32 accumulation,
                 the head on the kernel's bf16 rows.

"auto" is the layout chain for VGG16 and "xla" for AlexNet, on the card
and on the CPU alike (the JAX package's "auto" is "xla" off a TPU).
AlexNet, the validation metric (the reference evaluates with AlexNet and
trains with VGG, loss_utils.py:17-19), runs on "xla" only.

Params are a dict with the JAX package's keys and layouts:
conv{stage}_{layer}_w [3, 3, Ci, Co] (HWIO), conv{stage}_{layer}_b [Co],
lin{stage}_w [C]. The weights are frozen; `pack_lpips_params` packs them
for the kernels once per dict (bf16 forward and dx weights, channels
padded to 16), and the distance functions accept the dict or the packed
form. Pretrained weights load from the npz of
scripts/convert_lpips_weights.py; without them, the seeded random-feature
VGG16 of `random_lpips_params` draws the same weights as the JAX package's
from the same seed.
"""
from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from manus_tpu_torch.ops.conv import (
    HEAD_EPS,
    ConvWeights,
    StageLayout,
    build_layout,
    conv3x3_layout,
    head_stage_layout,
    maxpool2x2_layout,
    pack_conv3x3,
)
from manus_tpu_torch.utils.device import resolve_device

# VGG16: 5 blocks of 3x3 convs (out_channels, kernel, stride, pad), a 2x2/2
# max pool before every block but the first; LPIPS taps each block's
# post-ReLU output.
VGG_PLAN = dict(
    stages=[
        [(64, 3, 1, 1)] * 2,
        [(128, 3, 1, 1)] * 2,
        [(256, 3, 1, 1)] * 3,
        [(512, 3, 1, 1)] * 3,
        [(512, 3, 1, 1)] * 3,
    ],
    pool=(2, 2),
    pool_before=(1, 2, 3, 4),
)

# AlexNet (torchvision features[0..11], the slices lpips.alexnet uses):
# conv1 11x11/4 p2 -> pool3/2 -> conv2 5x5 p2 -> pool3/2 -> conv3..5 3x3 p1
ALEX_PLAN = dict(
    stages=[
        [(64, 11, 4, 2)],
        [(192, 5, 1, 2)],
        [(384, 3, 1, 1)],
        [(256, 3, 1, 1)],
        [(256, 3, 1, 1)],
    ],
    pool=(3, 2),
    pool_before=(1, 2),
)
PLANS = {"vgg": VGG_PLAN, "alex": ALEX_PLAN}

SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)

ENGINES = ("pallas", "xla", "xla_dx", "xla_dx_bf16")


def infer_arch(params) -> str:
    """VGG16's first stage has two convs (conv0_1_w), AlexNet's one."""
    keys = params.source if isinstance(params, PackedLpips) else params
    return "vgg" if "conv0_1_w" in keys else "alex"


def resolve_lpips_engine(lpips_conv: str, params) -> str:
    """The conv engine for the loss and the gt-feature cache, which must
    be built with the loss's engine: "auto" is "pallas" (the layout
    chain) for VGG16 and "xla" for AlexNet; every engine but "xla" is
    VGG16's alone."""
    if lpips_conv not in ("auto",) + ENGINES:
        raise ValueError(f"unknown lpips_conv {lpips_conv!r}; one of "
                         f"{('auto',) + ENGINES}")
    arch = infer_arch(params)
    if lpips_conv == "auto":
        return "pallas" if arch == "vgg" else "xla"
    if lpips_conv != "xla" and arch != "vgg":
        raise ValueError(f"the {lpips_conv!r} LPIPS engine runs VGG16 "
                         f"only; AlexNet runs on 'xla'")
    return lpips_conv


def random_lpips_params(seed: int = 0, arch: str = "vgg",
                        device=None) -> dict:
    """Seeded He-init VGG16 or AlexNet, the random-feature fallback: the
    same numpy draws in the same order as the JAX package's, so the same
    seed gives the same float32 weights."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    params = {}
    c_in = 3
    for si, stage in enumerate(PLANS[arch]["stages"]):
        for li, (c_out, k, _, _) in enumerate(stage):
            fan = k * k * c_in
            w = rng.normal(0, np.sqrt(2.0 / fan), (k, k, c_in, c_out))
            params[f"conv{si}_{li}_w"] = torch.tensor(
                w.astype(np.float32), device=device)
            params[f"conv{si}_{li}_b"] = torch.zeros(c_out, device=device)
            c_in = c_out
        lin = rng.uniform(0, 1, (c_in,)) / c_in
        params[f"lin{si}_w"] = torch.tensor(lin.astype(np.float32),
                                            device=device)
    return params


def load_lpips_params(path: str, device=None) -> Optional[dict]:
    """LPIPS weights from an npz of scripts/convert_lpips_weights.py (keys
    conv{i}_{j}_w HWIO, conv{i}_{j}_b, lin{k}_w); None if there is none."""
    if not path or not os.path.exists(path):
        return None
    device = resolve_device(device)
    data = np.load(path)
    return {k: torch.tensor(np.asarray(data[k], np.float32), device=device)
            for k in data.files}


def resolve_lpips_params_mode(weights_path: str, allow_fallback: bool = True,
                              seed: int = 0, log=print, arch: str = "vgg",
                              device=None):
    """(params, mode): the pretrained npz if there is one, else the seeded
    random-feature net, else (None, "off"). mode is "<arch>:pretrained",
    "<arch>:random-feature" or "off"."""
    params = load_lpips_params(weights_path, device)
    if params is not None:
        arch = infer_arch(params)
        log(f"[lpips] loaded pretrained {arch} weights from {weights_path}")
        return params, f"{arch}:pretrained"
    if allow_fallback:
        log(f"[lpips] WARNING: no pretrained weights "
            f"({weights_path or 'weights path unset'}); using seeded "
            f"random-feature {arch}. Values are NOT comparable with "
            "published LPIPS; convert real weights with "
            "scripts/convert_lpips_weights.py.")
        return random_lpips_params(seed, arch, device), \
            f"{arch}:random-feature"
    log("[lpips] disabled: no weights and fallback off; lpips is 0")
    return None, "off"


# ---------------------------------------------------------------------------
# Packed weights.


class PackedLpips(NamedTuple):
    """A VGG16-LPIPS params dict packed for the kernels: one ConvWeights
    per conv in VGG_PLAN order, the heads as fp32 [C] (padded like the
    stage's features), the input normalisation on the weights' device, and
    the dict it came from."""

    convs: tuple
    lins: tuple
    shift: torch.Tensor
    scale: torch.Tensor
    source: dict
    lin_eff_cache: dict  # (stage, h, w) -> lin / (h * w)

    def conv(self, si: int, li: int) -> ConvWeights:
        return self.convs[sum(len(s) for s in VGG_PLAN["stages"][:si]) + li]

    def lin_eff(self, si: int, L: StageLayout):
        """The stage's head with the spatial mean folded in, lin / (h*w)."""
        key = (si, L.h, L.w)
        out = self.lin_eff_cache.get(key)
        if out is None:
            out = self.lin_eff_cache[key] = self.lins[si] / float(L.h * L.w)
        return out


def pack_lpips_params(params) -> PackedLpips:
    """Pack a VGG16-LPIPS params dict for the kernels (a PackedLpips is
    returned as it is). A caller that runs the loss every step packs once
    and passes the result, as make_train_step does; the distance
    functions pack a dict on each call."""
    if isinstance(params, PackedLpips):
        return params
    if infer_arch(params) != "vgg":
        raise ValueError("the layout chain runs VGG16 only")
    convs, lins = [], []
    for si, stage in enumerate(VGG_PLAN["stages"]):
        for li in range(len(stage)):
            convs.append(pack_conv3x3(params[f"conv{si}_{li}_w"],
                                      params[f"conv{si}_{li}_b"]))
        lin = params[f"lin{si}_w"].detach().to(torch.float32)
        lins.append(torch.nn.functional.pad(lin, (0, convs[-1].co
                                                  - lin.shape[0])))
    dev = lins[0].device
    return PackedLpips(tuple(convs), tuple(lins),
                       torch.as_tensor(SHIFT, device=dev),
                       torch.as_tensor(SCALE, device=dev), params, {})


# ---------------------------------------------------------------------------
# The distance.


def _vgg_stage_layouts(h: int, w: int) -> list:
    """One StageLayout per VGG stage for an h x w input."""
    layouts = []
    for si, stage in enumerate(VGG_PLAN["stages"]):
        if si in VGG_PLAN["pool_before"]:
            h, w = h // 2, w // 2
        c_max = max(c for c, *_ in stage)
        layouts.append(StageLayout(h, w, max(c_max, 128)))
    return layouts


def vgg16_features(params, x) -> list:
    """The 5 post-ReLU VGG16 stage features of x ([H, W, 3] in [-1, 1]),
    as [(layout array [L.rows, C] bf16, StageLayout), ...]."""
    packed = pack_lpips_params(params)
    x = (x - packed.shift) / packed.scale
    layouts = _vgg_stage_layouts(x.shape[0], x.shape[1])
    feats = []
    xl = None
    for si, stage in enumerate(VGG_PLAN["stages"]):
        L = layouts[si]
        if si in VGG_PLAN["pool_before"]:
            xl = maxpool2x2_layout(xl, layouts[si - 1], L)
        else:
            xl = build_layout(x, L)
        for li in range(len(stage)):
            xl = conv3x3_layout(xl, packed.conv(si, li), True, L)
        feats.append((xl, L))
    return feats


def _lpips_head_layout(params, f1: list, f2: list):
    """The head over layout-form stage features: only each stage's pixel
    span is read (the rows outside it are zero in both and add nothing);
    the mean over the h*w pixels is folded into lin (the head is linear in
    lin)."""
    packed = pack_lpips_params(params)
    total = None
    for k, ((a, L), (b, _)) in enumerate(zip(f1, f2)):
        d = head_stage_layout(a, b, packed.lin_eff(k, L), L)
        total = d if total is None else total + d
    return total


@contextlib.contextmanager
def _fp32_conv():
    """Float32 convs on CUDA in full precision (no TF32) inside."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def backbone_features(params: dict, x, arch: str) -> list:
    """The 5 post-ReLU stage outputs ([N, h, w, C] fp32) of the chosen
    backbone for x ([N, H, W, 3] in [-1, 1]), with fp32 torch convs and
    VALID max pools (the JAX package's XLA path)."""
    plan = PLANS[arch]
    shift = torch.as_tensor(SHIFT, device=x.device)
    scale = torch.as_tensor(SCALE, device=x.device)
    x = ((x - shift) / scale).permute(0, 3, 1, 2)
    pk, ps = plan["pool"]
    feats = []
    with _fp32_conv():
        for si, stage in enumerate(plan["stages"]):
            if si in plan["pool_before"]:
                x = F.max_pool2d(x, pk, ps)
            for li, (_, _, stride, pad) in enumerate(stage):
                w = params[f"conv{si}_{li}_w"].permute(3, 2, 0, 1)
                x = torch.relu(F.conv2d(x, w, params[f"conv{si}_{li}_b"],
                                        stride=stride, padding=pad))
            feats.append(x.permute(0, 2, 3, 1))
    return feats


def _lpips_head(params: dict, f1: list, f2: list):
    """Unit-normalise the stage features, squared difference, the 1x1
    heads, mean over pixels, sum over stages, in fp32 (the JAX package's
    _lpips_head)."""
    total = None
    for k, (a, b) in enumerate(zip(f1, f2)):
        a, b = a.float(), b.float()
        na = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + HEAD_EPS)
        nb = b / (torch.linalg.norm(b, dim=-1, keepdim=True) + HEAD_EPS)
        npix = float(np.prod(a.shape[:-1]))
        d = ((na - nb) ** 2 * params[f"lin{k}_w"]).sum() / npix
        total = d if total is None else total + d
    return total


class Conv3x3DxFn(torch.autograd.Function):
    """A stride-1 SAME 3x3 conv, bias and ReLU of [1, Ci, H, W]
    activations in `dtype` with fp32 accumulation (the JAX package's
    _conv3x3_xla; in bf16 the conv's output is rounded once before the
    fp32 bias and once after the ReLU, where JAX rounds once), whose
    backward is the input gradient alone: the cotangent masked by y > 0,
    convolved with the flipped, transposed weights (frozen weights: no dw,
    no db)."""

    @staticmethod
    def forward(ctx, x, w, b, dtype):
        with _fp32_conv():
            y = F.conv2d(x.to(dtype), w.to(dtype), padding=1)
        y = torch.relu(y.float() + b[:, None, None]).to(dtype)
        ctx.save_for_backward(y, w)
        ctx.dtype, ctx.x_dtype = dtype, x.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        y, w = ctx.saved_tensors
        g = torch.where(y > 0, g, 0.0)
        w_t = w.flip(2, 3).transpose(0, 1)
        with _fp32_conv():
            dx = F.conv2d(g.to(ctx.dtype), w_t.to(ctx.dtype), padding=1)
        return dx.to(ctx.x_dtype), None, None, None


def vgg16_features_xla_dx(params: dict, x, dtype=torch.float32) -> list:
    """The 5 VGG16 stage features ([h, w, C] in dtype) of x ([H, W, 3] in
    [-1, 1]) on Conv3x3DxFn convs and VALID 2x2 max pools."""
    shift = torch.as_tensor(SHIFT, device=x.device)
    scale = torch.as_tensor(SCALE, device=x.device)
    x = ((x - shift) / scale).to(dtype).permute(2, 0, 1)[None]
    feats = []
    for si, stage in enumerate(VGG_PLAN["stages"]):
        if si in VGG_PLAN["pool_before"]:
            x = F.max_pool2d(x, 2, 2)
        for li in range(len(stage)):
            x = Conv3x3DxFn.apply(
                x, params[f"conv{si}_{li}_w"].permute(3, 2, 0, 1),
                params[f"conv{si}_{li}_b"].float(), dtype)
        feats.append(x[0].permute(1, 2, 0))
    return feats


def _lpips_head_rows(params: dict, f1: list, f2: list):
    """The head over [h, w, C] stage features as [h w, C] rows on the head
    kernel (fp32 or bf16 rows; the JAX package's _lpips_head_rows, which
    runs its Pallas head), 1/(h w) folded into lin."""
    total = None
    for k, (a, b) in enumerate(zip(f1, f2)):
        c = a.shape[-1]
        npix = float(np.prod(a.shape[:-1]))
        lin_eff = params[f"lin{k}_w"].float() * (1.0 / npix)
        d = head_stage_layout(a.reshape(-1, c).contiguous(),
                              b.reshape(-1, c).contiguous(), lin_eff)
        total = d if total is None else total + d
    return total


def _xla_features(params, x, engine: str) -> list:
    """Stage features [h, w, C] of x ([H, W, 3] in [-1, 1]) on a torch-conv
    engine."""
    if engine == "xla":
        return [f[0] for f in backbone_features(params, x[None].float(),
                                                infer_arch(params))]
    dt = torch.bfloat16 if engine == "xla_dx_bf16" else torch.float32
    return vgg16_features_xla_dx(params, x, dt)


def _head(params, engine: str, f1: list, f2: list):
    if engine == "xla":
        return _lpips_head(params, f1, f2)
    return _lpips_head_rows(params, f1, f2)


def lpips_distance(params, img1, img2, engine: str = "auto"):
    """LPIPS distance of two [H, W, 3] images in [0, 1], an fp32 scalar
    differentiable in both, on `engine` (resolve_lpips_engine's names;
    "auto": VGG16 on the layout chain, the JAX package's
    lpips_distance_pallas, AlexNet on fp32 torch convs, its
    lpips_distance)."""
    engine = resolve_lpips_engine(engine, params)
    if engine != "pallas" and isinstance(params, PackedLpips):
        params = params.source
    if engine == "pallas":
        params = pack_lpips_params(params)
        f1 = vgg16_features(params, img1 * 2.0 - 1.0)
        f2 = vgg16_features(params, img2 * 2.0 - 1.0)
        return _lpips_head_layout(params, f1, f2)
    f1 = _xla_features(params, img1 * 2.0 - 1.0, engine)
    f2 = _xla_features(params, img2 * 2.0 - 1.0, engine)
    return _head(params, engine, f1, f2)


def pool_avg(img, k: int):
    """k x k average pool of [H, W, C] (the loss.lpips_downsample knob),
    shared by the loss and the gt-feature cache."""
    if k <= 1:
        return img
    h, w = img.shape[0] // k * k, img.shape[1] // k * k
    return img[:h, :w].reshape(h // k, k, w // k, k, img.shape[2]).mean(
        dim=(1, 3))


def lpips_features(params, img, engine: str = "auto") -> list:
    """The stage features of img ([H, W, 3] in [0, 1]) on `engine`, for
    the gt-feature cache: layout arrays on "pallas" (their layouts follow
    from the image shape), [h, w, C] maps on the others."""
    engine = resolve_lpips_engine(engine, params)
    if engine != "pallas" and isinstance(params, PackedLpips):
        params = params.source
    if engine == "pallas":
        return [f for f, _ in vgg16_features(params, img * 2.0 - 1.0)]
    return _xla_features(params, img * 2.0 - 1.0, engine)


def lpips_distance_cached(params, img1, gt_feats: list, engine: str = "auto"):
    """LPIPS distance between img1 and a gt whose features lpips_features
    computed on the same engine: the gt forward is skipped. Exact: no
    gradient flows to the gt branch either way."""
    engine = resolve_lpips_engine(engine, params)
    if engine != "pallas" and isinstance(params, PackedLpips):
        params = params.source
    gt_feats = [g.detach() for g in gt_feats]
    if engine == "pallas":
        params = pack_lpips_params(params)
        f1 = vgg16_features(params, img1 * 2.0 - 1.0)
        f2 = [(g, L) for g, (_, L) in zip(gt_feats, f1)]
        return _lpips_head_layout(params, f1, f2)
    f1 = _xla_features(params, img1 * 2.0 - 1.0, engine)
    return _head(params, engine, f1, gt_feats)
