"""3x3 convolutions and the LPIPS head on the flat padded layout.

Counterpart of the JAX package's ops/conv_pallas.py: the VGG16 of the
LPIPS loss runs as a chain of 3x3 SAME stride-1 convs whose feature maps
stay in one flat, zero-bordered layout between layers, so that a layer's
output is the next layer's input with no copy in between.

  layout L(H, W): [L.rows, C] with pixel (y, x) at row m_blk + y*(W+2) + x.
  The two columns x = W, W+1 of every pixel row, the rows y >= H, and the
  first and last m_blk rows are zero. The 9 taps of the output at row r
  are the rows r + (dy-1)*(W+2) + (dx-1): contiguous row windows, so a
  conv is 9 shifted [rows, Ci] x [Ci, Co] matmuls (an implicit GEMM).

Kernels (csrc/conv3x3.cu, csrc/lpips_head.cu), each beside its plain
PyTorch version; a wrapper launches the kernel for a CUDA tensor and runs
the plain version for a CPU tensor:

  * `conv3x3_layout_raw`: bf16 conv on the layout with fp32 accumulation,
    bias, optional ReLU and the zeroing of the non-pixel rows; bf16 out.
    The kernel's tile, K-chunk and split of K come from `conv_plan`, a
    plan per layer shape made here on the host;
  * `conv3x3_layout_dx_raw`: the dx of a ReLU'd layer: the upstream
    gradient masked by y > 0 on load, convolved with the flipped,
    channel-transposed weights;
  * `head_fwd` / `head_bwd`: the LPIPS head of one stage,
    sum((a/(|a|+eps) - b/(|b|+eps))^2 * lin_eff) over the rows of the
    layout's pixel span, and its closed-form gradient (da alone where the
    second features need none).

`conv3x3_layout` and `head_stage_layout` are the autograd functions over
them (LPIPS weights are frozen: the only gradient is the input's), and
`conv3x3_raw` / `conv3x3` are the same conv on a plain [H, W, Ci] image
(the conv kernel on the image's layout, counted as a launch of its own).

Channels are padded only to a multiple of 16 (the image's 3 channels go
to 16); padded channels are zero in the weights and so in every output.
The rows keep the JAX package's geometry (StageLayout), so layout arrays
compare row for row with it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from manus_tpu_torch.utils import cuda_build

HEAD_EPS = 1e-10
CHANNEL_ALIGN = 16
# The JAX package's row-block memory budget (bytes), which sets tile_h.
_TPU_BLOCK_BUDGET = 11 << 20


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class StageLayout:
    """Geometry of one VGG stage's layout: the same rows as the JAX
    package's StageLayout. Its row block (tile_h image rows) was sized
    there for a TPU core's memory budget; it is kept so that the layouts
    match row for row, and the CUDA kernels do not depend on it."""

    __slots__ = ("h", "w", "tile_h", "m_blk", "n_blocks", "rows", "lead",
                 "shift")

    def __init__(self, h: int, w: int, c_max: int):
        gran = 8 if (w + 2) % 2 == 0 else 16
        c_l = max(c_max, 128)
        best = gran
        for th in range(gran, _round_up(max(h, gran), gran) + gran, gran):
            m_blk = th * (w + 2)
            m_halo = _round_up(m_blk + 2 * (w + 2) + 2 + 16, 16)
            budget = (m_blk * c_l * 4 + 2 * m_halo * c_l * 2
                      + 9 * c_l * c_l * 2 + 2 * m_blk * c_l * 2)
            if budget > _TPU_BLOCK_BUDGET and th > gran:
                break
            best = th
            if m_blk >= 4096 or th >= h + gran - 1:
                break
        self.h, self.w, self.tile_h = h, w, best
        self.m_blk = best * (w + 2)
        self.n_blocks = _round_up(h, best) // best
        self.rows = (self.n_blocks + 2) * self.m_blk
        self.lead = self.m_blk - (w + 3)
        self.shift = (-(w + 3)) % 16

    @property
    def n_valid(self) -> int:
        """Rows from m_blk on that hold pixel rows (junk columns included)."""
        return self.h * (self.w + 2)

    def _key(self):
        return (self.h, self.w, self.tile_h)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, StageLayout) and self._key() == other._key()

    def __repr__(self):
        return f"StageLayout(h={self.h}, w={self.w}, tile_h={self.tile_h})"


def valid_rows(L: StageLayout, device) -> torch.Tensor:
    """[L.rows] bool: the rows that hold a pixel."""
    q = torch.arange(L.rows, device=device) - L.m_blk
    return (q >= 0) & (q < L.n_valid) & (q % (L.w + 2) < L.w)


def build_layout(x, L: StageLayout, dtype=torch.bfloat16):
    """[H, W, C] -> layout [L.rows, C rounded up to 16] in `dtype`, zero
    borders and padding channels."""
    h, w, c = x.shape
    cp = _round_up(c, CHANNEL_ALIGN)
    h_pad = L.tile_h * L.n_blocks
    core = F.pad(x.to(dtype), (0, cp - c, 1, 1, 1, 1 + h_pad - h))
    core = core.reshape(-1, cp)
    return F.pad(core, (0, 0, L.lead, L.rows - L.lead - core.shape[0]))


def unlayout(xl, L: StageLayout):
    """Layout [L.rows, C] -> [H, W, C] (padding channels kept)."""
    h_pad = L.tile_h * L.n_blocks
    x = xl[L.m_blk: L.m_blk + h_pad * (L.w + 2)]
    return x.reshape(h_pad, L.w + 2, x.shape[-1])[: L.h, : L.w]


def maxpool2x2(x):
    """VALID 2x2 stride-2 max pool of [H, W, C]. amax splits the gradient
    of a tie evenly among the tied inputs, as JAX's max does."""
    h2, w2 = x.shape[0] // 2, x.shape[1] // 2
    return x[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, x.shape[-1]).amax(
        dim=(1, 3))


def maxpool2x2_layout(xl, La: StageLayout, Lb: StageLayout):
    """2x2/2 max pool from layout La to layout Lb, equal in value to
    build_layout(maxpool2x2(unlayout(xl, La)), Lb) without its copies.

    Pixel (y, x) sits at row La.m_blk + y*(Wa+2) + x with zeros at
    x = Wa, Wa+1, so the junk pair pools to the zero column the pooled row
    needs; one more zero column and Lb's borders are padded on. Needs
    La.w even and Lb.w == La.w // 2 (every VGG boundary). Its gradient
    routes a cotangent at the pooled junk column into the junk input
    pair, where the composed form drops it; in the conv chain that
    cotangent is zero (the dx kernels and the head zero junk rows)."""
    w2a = La.w + 2
    c = xl.shape[-1]
    h2, w2b = Lb.h, Lb.w + 2
    if La.w % 2 or 2 * Lb.w != La.w or 2 * h2 > La.tile_h * La.n_blocks:
        raise ValueError(f"cannot pool {La} into {Lb}")
    core = xl[La.m_blk: La.m_blk + 2 * h2 * w2a]
    ym = core.reshape(h2, 2, w2a // 2, 2, c).amax(dim=(1, 3))
    ym = F.pad(ym, (0, 0, 0, w2b - w2a // 2))
    out = ym.reshape(h2 * w2b, c)
    return F.pad(out, (0, 0, Lb.m_blk, Lb.rows - Lb.m_blk - out.shape[0]))


# ---------------------------------------------------------------------------
# Frozen conv weights, packed once.


class ConvWeights(NamedTuple):
    """One frozen 3x3 layer, packed for the kernels.

    w: [9 * ci_pad, co_pad] bf16, row tap*ci_pad + ci, tap = 3*dy + dx;
    b: [co_pad] fp32; w_t: the dx weights, flip(w, (0, 1)) with Ci and Co
    swapped, [9 * co_pad, ci_pad] bf16; n_in, n_out: the real channel
    counts."""

    w: torch.Tensor
    b: torch.Tensor
    w_t: torch.Tensor
    n_in: int
    n_out: int

    @property
    def ci(self) -> int:
        return self.w_t.shape[1]

    @property
    def co(self) -> int:
        return self.w.shape[1]


def pack_conv3x3(w, b) -> ConvWeights:
    """HWIO weights [3, 3, Ci, Co] and bias [Co] -> ConvWeights on w's
    device, channels zero-padded to multiples of 16."""
    _, _, ci, co = w.shape
    cip, cop = _round_up(ci, CHANNEL_ALIGN), _round_up(co, CHANNEL_ALIGN)
    wb = F.pad(w.detach().to(torch.bfloat16), (0, cop - co, 0, cip - ci))
    w_t = torch.flip(wb, dims=(0, 1)).transpose(2, 3)
    bias = F.pad(b.detach().to(torch.float32), (0, cop - co))
    return ConvWeights(
        w=wb.reshape(9 * cip, cop).contiguous(), b=bias.contiguous(),
        w_t=w_t.reshape(9 * cop, cip).contiguous(), n_in=ci, n_out=co)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels.


def _tap_offsets(L: StageLayout):
    w2 = L.w + 2
    return [(dy - 1) * w2 + (dx - 1) for dy in range(3) for dx in range(3)]


def conv3x3_layout_torch(xl, w, b, relu: bool, L: StageLayout,
                         mask_by=None):
    """Plain version of the conv kernels. Each tap is an fp32 matmul of
    bf16 values (a product of two bf16 values is exact in fp32), added to
    the bias (None: zero) in tap order; bf16 out, non-pixel rows zero. With
    `mask_by` (the dx kernel), xl is zeroed where mask_by <= 0 first."""
    ci = xl.shape[1]
    co = w.shape[1]
    x = xl.float()
    if mask_by is not None:
        x = torch.where(mask_by > 0, x, 0.0)
    wf = w.float().reshape(9, ci, co)
    lo, hi = L.m_blk, L.m_blk + L.n_valid
    out = (torch.zeros(co, device=xl.device) if b is None
           else b.float()).expand(hi - lo, co)
    for k, off in enumerate(_tap_offsets(L)):
        out = out + x[lo + off: hi + off] @ wf[k]
    if relu:
        out = torch.clamp_min(out, 0.0)
    y = torch.zeros(L.rows, co, dtype=torch.float32, device=xl.device)
    y[lo:hi] = out
    y = torch.where(valid_rows(L, xl.device)[:, None], y, 0.0)
    return y.to(torch.bfloat16)


def conv3x3_layout_plan_torch(xl, w, b, relu: bool, L: StageLayout,
                              plan: "ConvPlan", mask_by=None):
    """The conv in the order csrc/conv3x3.cu computes it under `plan`, in
    plain PyTorch: tile by tile from L.m_blk on, each split-K slice its
    own fp32 sum over its chunks (a chunk is plan.kc channels of the three
    taps of one dy), the slices added in index order, then bias, ReLU, the
    pixel mask and one rounding to bf16; every other row zero. It shows on
    the CPU that a plan's tiles and chunks cover the conv exactly once;
    conv3x3_layout_torch stays the version every kernel is held against."""
    ci, co = xl.shape[1], w.shape[1]
    w2 = L.w + 2
    x = xl.float()
    if mask_by is not None:
        x = torch.where(mask_by > 0, x, 0.0)
    # rows before 0 and past the end read as zeros, as the TMA box fills
    x = F.pad(x, (0, 0, w2 + 1, w2 + 1 + plan.bm))
    wf = w.float()
    bias = torch.zeros(co, device=xl.device) if b is None else b.float()
    per_dy = ci // plan.kc
    per_split = plan.chunks // plan.split_k
    keep = valid_rows(L, xl.device)
    y = torch.zeros(L.rows, co, dtype=torch.float32, device=xl.device)
    for r0, r1 in plan_row_tiles(L, plan):
        for n0 in range(0, co, plan.bn):
            total = None
            for z in range(plan.split_k):
                part = torch.zeros(plan.bm, plan.bn, device=xl.device)
                for c in range(z * per_split, (z + 1) * per_split):
                    dy, cc = divmod(c, per_dy)
                    for dx in range(3):
                        top = r0 + (dy - 1) * w2 + dx - 1 + w2 + 1
                        k0 = ((3 * dy + dx) * per_dy + cc) * plan.kc
                        part = part + (
                            x[top: top + plan.bm,
                              cc * plan.kc: (cc + 1) * plan.kc]
                            @ wf[k0: k0 + plan.kc, n0: n0 + plan.bn])
                total = part if total is None else total + part
            out = bias[n0: n0 + plan.bn] + total
            if relu:
                out = torch.clamp_min(out, 0.0)
            y[r0:r1, n0: n0 + plan.bn] = out[: r1 - r0]
    return torch.where(keep[:, None], y, 0.0).to(torch.bfloat16)


def head_span(rows: int, L: StageLayout = None) -> tuple:
    """The [lo, hi) rows of a head's input that may hold a pixel: on L's
    layout [m_blk, m_blk + n_valid), without a layout every row."""
    if L is None:
        return 0, rows
    if L.rows != rows:
        raise ValueError(f"head features have {rows} rows, {L} has {L.rows}")
    return L.m_blk, L.m_blk + L.n_valid


def head_fwd_torch(a, b, lin_eff, L: StageLayout = None):
    """Plain version of the head forward: the fp32 sum over the rows of
    head_span(rows, L) and the channels of (unit(a) - unit(b))^2 * lin_eff.
    The rows outside the span are zero in a and b and would add nothing."""
    lo, hi = head_span(a.shape[0], L)
    a, b = a[lo:hi].float(), b[lo:hi].float()
    na = a / (torch.sqrt((a * a).sum(1, keepdim=True)) + HEAD_EPS)
    nb = b / (torch.sqrt((b * b).sum(1, keepdim=True)) + HEAD_EPS)
    return ((na - nb) ** 2 * lin_eff).sum()


def _d_normed(x, r, g):
    """d/dx [x / (|x| + eps)] applied to g, zero-norm rows guarded."""
    dot = (x * g).sum(1, keepdim=True)
    safe_r = torch.where(r > 0, r, 1.0)
    return g / (r + HEAD_EPS) - x * (dot / (safe_r * (r + HEAD_EPS) ** 2))


def head_bwd_torch(a, b, lin_scaled, L: StageLayout = None,
                   need_db: bool = True):
    """Plain version of the head backward: (da, db) in the dtypes of a
    and b, for lin_scaled = lin_eff * cotangent; zero outside
    head_span(rows, L); db is None unless need_db."""
    rows = a.shape[0]
    lo, hi = head_span(rows, L)
    af, bf = a[lo:hi].float(), b[lo:hi].float()
    ra = torch.sqrt((af * af).sum(1, keepdim=True))
    rb = torch.sqrt((bf * bf).sum(1, keepdim=True))
    g = 2.0 * lin_scaled * (af / (ra + HEAD_EPS) - bf / (rb + HEAD_EPS))

    def full(x, dtype):  # the span's rows into zero rows outside it
        return F.pad(x.to(dtype), (0, 0, lo, rows - hi))

    da = full(_d_normed(af, ra, g), a.dtype)
    db = full(-_d_normed(bf, rb, g), b.dtype) if need_db else None
    return da, db


# ---------------------------------------------------------------------------
# The conv kernel's plan for one layer shape.

SM_COUNT = 132  # streaming multiprocessors of an H100
PLAN_BM = 128   # output rows per CTA (two warpgroups of 64)
PLAN_BN = (256, 128, 64, 16)  # channel tiles the kernel is built for
# Fewest K-chunks a split-K slice may hold.
MIN_CHUNKS_PER_SPLIT = 2
# Share of the card's SMs that the tiles of a plan without a split should
# fill before a wider channel tile is preferred to more tiles.
WAVE_FILL = 0.9


class ConvPlan(NamedTuple):
    """How csrc/conv3x3.cu runs one layer: a CTA computes bm rows x bn
    channels, walking K in chunks of kc channels of the three taps of one
    dy; split_k CTAs share a tile's chunks. The working tiles are the
    m_tiles row tiles from L.m_blk on (where the pixel rows are) times the
    n_tiles channel tiles; grid is the number of working CTAs and
    workspace the fp32 elements of the split-K partial sums (0 without a
    split)."""

    bm: int
    bn: int
    kc: int
    split_k: int
    m_tiles: int
    n_tiles: int
    chunks: int
    grid: int
    workspace: int

    @property
    def waves(self) -> float:
        """Working CTAs over the card's SMs."""
        return self.grid / SM_COUNT


@functools.lru_cache(maxsize=None)
def conv_plan(L: StageLayout, ci: int, co: int) -> ConvPlan:
    """The plan of a 3x3 conv from ci to co channels (multiples of 16) on
    layout L, for the conv and the dx form alike.

    K-chunks are 64 channels wide, or 16 where ci is no multiple of 64
    (the narrow path: the image's 3 channels padded to 16). The rules for
    the channel tile and the split come from per-plan times on an H100
    (scripts/torch_conv_tune.py). A wide tile re-reads A less often, so
    the tile is the widest that divides co and whose tiles still fill
    WAVE_FILL of the CTAs the card holds at once (one an SM, two for a
    tile of 64 channels or fewer), else 128. Where the tiles fill no more than half
    the SMs, K is split by the largest divisor of the chunks that keeps
    the working CTAs within one wave (one CTA an SM was faster than two
    waves of shorter CTAs, whose partial sums cross memory twice)."""
    if ci % CHANNEL_ALIGN or co % CHANNEL_ALIGN or ci <= 0 or co <= 0:
        raise ValueError(f"conv channels must be multiples of "
                         f"{CHANNEL_ALIGN}, got {ci} -> {co}")
    kc = 64 if ci % 64 == 0 else 16
    m_tiles = -(-L.n_valid // PLAN_BM)
    # the narrow K path is built for tiles up to 64 channels
    widths = [n for n in PLAN_BN if co % n == 0 and (kc == 64 or n <= 64)]
    widths = [n for n in widths if n >= 64] or widths  # 16 as a last resort
    # a tile of 64 channels or fewer runs two CTAs an SM
    full = [n for n in widths if m_tiles * (co // n)
            >= WAVE_FILL * SM_COUNT * (2 if n <= 64 else 1)]
    bn = full[0] if full else min(widths[0], 128)
    n_tiles = co // bn
    chunks = 3 * ci // kc
    tiles = m_tiles * n_tiles
    split = 1
    if 2 * tiles <= SM_COUNT:
        split = max(s for s in range(1, chunks + 1) if chunks % s == 0
                    and tiles * s <= SM_COUNT
                    and (s == 1 or chunks // s >= MIN_CHUNKS_PER_SPLIT))
    workspace = split * m_tiles * PLAN_BM * co if split > 1 else 0
    return ConvPlan(PLAN_BM, bn, kc, split, m_tiles, n_tiles, chunks,
                    tiles * split, workspace)


def plan_row_tiles(L: StageLayout, plan: ConvPlan) -> list:
    """The [start, stop) layout rows of the plan's working row tiles: from
    L.m_blk on, cut at the layout's end. Every other row holds no pixel
    and is zero-filled."""
    return [(r0, min(r0 + plan.bm, L.rows))
            for r0 in range(L.m_blk, L.m_blk + plan.m_tiles * plan.bm,
                            plan.bm)]


# ---------------------------------------------------------------------------
# CUDA wrappers.

_P, _I32 = ctypes.c_void_p, ctypes.c_int
CONV_LIBRARY = cuda_build.Kernels("conv3x3", {
    "conv3x3_layout": (
        [_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
         _I32, _I32, _I32, _P],
        ctypes.c_int),
})
HEAD_LIBRARY = cuda_build.Kernels("lpips_head", {
    "lpips_head_fwd": ([_P, _P, _P, _I32, _I32, _I32, _I32, _I32, _P, _P,
                        _P], ctypes.c_int),
    "lpips_head_bwd": ([_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _P,
                        _P, _P], ctypes.c_int),
    "lpips_head_fwd_f32": ([_P, _P, _P, _I32, _I32, _I32, _I32, _I32, _P,
                            _P, _P], ctypes.c_int),
    "lpips_head_bwd_f32": ([_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                            _P, _P, _P], ctypes.c_int),
    "lpips_head_workspace_words": ([_I32], ctypes.c_int),
})
# The widest head the kernels take; C must also be a multiple of 8 (a row
# is read as 16-byte vectors of 8 bf16 channels, or two of 8 fp32 ones).
HEAD_MAX_C = 512
HEAD_DTYPES = (torch.bfloat16, torch.float32)
# The kernels read every tensor in 16-byte vectors.
ALIGN = 16


def _launch_conv(xl, mask_by, w, b, relu: bool, L: StageLayout,
                 plan: ConvPlan = None, counter=None):
    """Launch the conv kernel (the dx form with mask_by) under `plan`
    (default: conv_plan's; a tuning script may pass its own)."""
    if not xl.is_cuda:
        raise ValueError("the CUDA conv needs a CUDA layout tensor")
    dev = xl.device
    ci, co = xl.shape[1], w.shape[1]
    if ci % CHANNEL_ALIGN or co % CHANNEL_ALIGN or w.shape[0] != 9 * ci:
        raise ValueError(f"conv weights {tuple(w.shape)} do not fit a "
                         f"layout of {ci} channels (multiples of "
                         f"{CHANNEL_ALIGN})")
    check = cuda_build.check_tensor
    check(xl, "layout", torch.bfloat16, (L.rows, ci), dev, ALIGN)
    check(w, "weights", torch.bfloat16, (9 * ci, co), dev, ALIGN)
    if mask_by is not None:
        check(mask_by, "mask", torch.bfloat16, (L.rows, ci), dev, ALIGN)
    if b is not None:
        check(b, "bias", torch.float32, (co,), dev, ALIGN)
    if plan is None:
        plan = conv_plan(L, ci, co)
    y = torch.empty(L.rows, co, dtype=torch.bfloat16, device=dev)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=dev) \
        if plan.split_k > 1 else None
    ptr = cuda_build.ptr
    CONV_LIBRARY.launch(
        "conv3x3_layout", ptr(xl), ptr(mask_by), ptr(w), ptr(b), ptr(y),
        ptr(ws), L.rows, ci, co, L.w, L.m_blk, L.n_valid, int(relu), plan.kc,
        plan.bn, plan.split_k, device=dev, counter=counter)
    return y


@cuda_build.counted
def conv3x3_layout_cuda(xl, w, b, relu: bool, L: StageLayout):
    """Launch the conv kernel: xl [L.rows, Ci] bf16, w [9*Ci, Co] bf16,
    b [Co] fp32 or None (zero) -> [L.rows, Co] bf16."""
    return _launch_conv(xl, None, w, b, relu, L, counter=conv3x3_layout_cuda)


@cuda_build.counted
def conv3x3_layout_dx_cuda(gl, yl, w_t, L: StageLayout):
    """Launch the dx kernel: gl, yl [L.rows, Co] bf16 (yl the layer's
    output, whose > 0 masks gl), w_t [9*Co, Ci] -> [L.rows, Ci] bf16."""
    return _launch_conv(gl, yl, w_t, None, False, L,
                        counter=conv3x3_layout_dx_cuda)


# The head forward's workspace on each device: its CTAs' ticket counter
# (which the kernel leaves at 0) and partial sums.
_head_workspaces: dict = {}


def _head_workspace(dev):
    ws = _head_workspaces.get(dev)
    if ws is None:
        ws = _head_workspaces[dev] = torch.zeros(
            HEAD_LIBRARY.get().lpips_head_workspace_words(SM_COUNT),
            dtype=torch.int32, device=dev)
    return ws


def _check_head(a, b, lin, L):
    if not a.is_cuda:
        raise ValueError("the CUDA LPIPS head needs CUDA feature tensors")
    if a.dim() != 2 or a.shape[1] % 8 or not 0 < a.shape[1] <= HEAD_MAX_C:
        raise ValueError(f"head features must be [rows, C], C a multiple of "
                         f"8 up to {HEAD_MAX_C}, got {tuple(a.shape)}")
    if a.dtype not in HEAD_DTYPES:
        raise ValueError(f"head features must be bf16 or fp32, got {a.dtype}")
    check = cuda_build.check_tensor
    check(a, "a", a.dtype, a.shape, a.device, ALIGN)
    check(b, "b", a.dtype, a.shape, a.device, ALIGN)
    check(lin, "lin_eff", torch.float32, (a.shape[1],), a.device, ALIGN)
    return head_span(a.shape[0], L)


@cuda_build.counted
def head_fwd_cuda(a, b, lin_eff, L: StageLayout = None):
    """Launch the head forward kernel over the rows of head_span(rows, L):
    a, b [rows, C] bf16 (or both fp32: the kernel's fp32 form), lin_eff
    [C] fp32 -> fp32 scalar, summed on the card in a fixed order (no
    float atomics) by the same launch."""
    lo, hi = _check_head(a, b, lin_eff, L)
    rows, c = a.shape
    out = torch.empty((), dtype=torch.float32, device=a.device)
    ptr = cuda_build.ptr
    HEAD_LIBRARY.launch(
        "lpips_head_fwd" if a.dtype == torch.bfloat16
        else "lpips_head_fwd_f32", ptr(a), ptr(b), ptr(lin_eff), rows, c, lo,
        hi, SM_COUNT, ptr(_head_workspace(a.device)), ptr(out),
        device=a.device, counter=head_fwd_cuda)
    return out


@cuda_build.counted
def head_bwd_cuda(a, b, lin_eff, ct, L: StageLayout = None,
                  need_db: bool = True):
    """Launch the head backward kernel: (da, db) [rows, C] in the features'
    type for the fp32 scalar cotangent ct (read on the card), zero outside
    head_span(rows, L); db is None, and not computed, unless need_db."""
    lo, hi = _check_head(a, b, lin_eff, L)
    cuda_build.check_tensor(ct, "cotangent", torch.float32, (), a.device,
                            ALIGN)
    rows, c = a.shape
    da = torch.empty_like(a)
    db = torch.empty_like(b) if need_db else None
    ptr = cuda_build.ptr
    HEAD_LIBRARY.launch(
        "lpips_head_bwd" if a.dtype == torch.bfloat16
        else "lpips_head_bwd_f32", ptr(a), ptr(b), ptr(lin_eff), ptr(ct),
        rows, c, lo, hi, SM_COUNT, ptr(da), ptr(db), device=a.device,
        counter=head_bwd_cuda)
    return da, db


# ---------------------------------------------------------------------------
# Entry points: the kernel for a CUDA tensor, the plain version for a CPU one.


def conv3x3_layout_raw(xl, w, b, relu: bool, L: StageLayout):
    """One 3x3 SAME conv layer on the layout, not differentiable:
    xl [L.rows, Ci] bf16 -> [L.rows, Co] bf16 (w, b as in ConvWeights)."""
    if xl.is_cuda:
        return conv3x3_layout_cuda(xl, w, b, relu, L)
    return conv3x3_layout_torch(xl, w, b, relu, L)


def conv3x3_layout_dx_raw(gl, yl, w_t, L: StageLayout):
    """dx of a ReLU'd layout conv: gl masked by yl > 0, convolved with the
    dx weights w_t; [L.rows, Co] -> [L.rows, Ci] bf16."""
    if gl.is_cuda:
        return conv3x3_layout_dx_cuda(gl, yl, w_t, L)
    return conv3x3_layout_torch(gl, w_t, None, False, L, mask_by=yl)


class ConvLayoutFn(torch.autograd.Function):
    """conv3x3_layout_raw with the dx conv as its gradient (frozen
    weights: no dw, no db). The dx of a layout conv is another layout
    conv: zero borders in, zero borders out."""

    @staticmethod
    def forward(ctx, xl, p: ConvWeights, relu: bool, L: StageLayout):
        y = conv3x3_layout_raw(xl, p.w, p.b, relu, L)
        ctx.save_for_backward(y)
        ctx.p, ctx.relu, ctx.L, ctx.x_dtype = p, relu, L, xl.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        p, L = ctx.p, ctx.L
        g = g.to(torch.bfloat16).contiguous()
        if ctx.relu:
            dx = conv3x3_layout_dx_raw(g, y, p.w_t, L)
        else:
            dx = conv3x3_layout_raw(g, p.w_t, None, False, L)
        return dx.to(ctx.x_dtype), None, None, None


def conv3x3_layout(xl, p: ConvWeights, relu: bool, L: StageLayout):
    """Differentiable layout conv of frozen weights (gradient in xl only)."""
    return ConvLayoutFn.apply(xl, p, relu, L)


class HeadStageFn(torch.autograd.Function):
    """One LPIPS head stage over [rows, C] features, with its closed-form
    backward (lin_eff is frozen: no gradient; db only where b needs one)."""

    @staticmethod
    def forward(ctx, a, b, lin_eff, L):
        ctx.save_for_backward(a, b, lin_eff)
        ctx.L = L
        if a.is_cuda:
            return head_fwd_cuda(a, b, lin_eff, L)
        return head_fwd_torch(a, b, lin_eff, L)

    @staticmethod
    def backward(ctx, ct):
        a, b, lin_eff = ctx.saved_tensors
        need_db = ctx.needs_input_grad[1]
        ct = ct.to(torch.float32).contiguous()
        if a.is_cuda:
            da, db = head_bwd_cuda(a, b, lin_eff, ct, ctx.L, need_db)
        else:
            da, db = head_bwd_torch(a, b, lin_eff * ct, ctx.L, need_db)
        return da, db, None, None


def head_stage_layout(a, b, lin_eff, L: StageLayout = None):
    """sum((unit(a) - unit(b))^2 * lin_eff) over [rows, C] feature pairs
    (layout arrays or any row-major features). The caller folds the
    spatial 1/(H*W) into lin_eff; channels beyond the real ones must be
    zero in a and b. With the stage's layout L only its pixel span
    [L.m_blk, L.m_blk + L.n_valid) is read: the rows outside it are zero
    in both (the conv chain zero-fills them) and add nothing, and their
    gradient is zero. Without L every row is read."""
    return HeadStageFn.apply(a, b, lin_eff, L)


# ---------------------------------------------------------------------------
# The same conv on a plain [H, W, Ci] image.


def _image_layout(x, p: ConvWeights) -> StageLayout:
    h, w, _ = x.shape
    return StageLayout(h, w, max(p.ci, p.co, 128))


@cuda_build.counted
def conv3x3_image_cuda(x, p: ConvWeights, relu: bool):
    """Launch the conv kernel on the layout of one [H, W, Ci] CUDA image:
    -> [H, W, Co] bf16, padding channels cut."""
    L = _image_layout(x, p)
    y = _launch_conv(build_layout(x, L), None, p.w, p.b, relu, L,
                     counter=conv3x3_image_cuda)
    return unlayout(y, L)[..., : p.n_out]


def conv3x3_raw(x, p: ConvWeights, relu: bool):
    """3x3 SAME stride-1 conv (+ bias, optional ReLU) of one [H, W, Ci]
    image, not differentiable: bf16 in, fp32 accumulation, bf16 out,
    [H, W, Co] with the padding channels cut."""
    if x.is_cuda:
        return conv3x3_image_cuda(x, p, relu)
    L = _image_layout(x, p)
    y = conv3x3_layout_torch(build_layout(x, L), p.w, p.b, relu, L)
    return unlayout(y, L)[..., : p.n_out]


class ConvImageFn(torch.autograd.Function):
    """conv3x3_raw with the dx conv on the image's layout as its gradient
    (frozen weights: no dw, no db)."""

    @staticmethod
    def forward(ctx, x, p: ConvWeights, relu: bool):
        y = conv3x3_raw(x, p, relu)
        ctx.save_for_backward(y)
        ctx.p, ctx.relu, ctx.L, ctx.x_dtype = p, relu, _image_layout(x, p), \
            x.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        p, L = ctx.p, ctx.L
        gl = build_layout(g, L)
        if ctx.relu:
            dx = conv3x3_layout_dx_raw(gl, build_layout(y, L), p.w_t, L)
        else:
            dx = conv3x3_layout_raw(gl, p.w_t, None, False, L)
        return unlayout(dx, L)[..., : p.n_in].to(ctx.x_dtype), None, None


def conv3x3(x, p: ConvWeights, relu: bool = True):
    """Differentiable conv3x3_raw (gradient in x only, through the dx
    kernel): [H, W, Ci] -> [H, W, Co] bf16."""
    return ConvImageFn.apply(x, p, relu)
