"""Densification and pruning under a fixed capacity.

The reference's adaptive density control on the padded model: capacity
is a static N_max and `active` marks live slots. Clone and split write
their children into free slots, found by a stable argsort of `active`
and placed by prefix sums; prunes flip mask bits; the Adam moments of
touched rows are zeroed. Every step of an event is a tensor operation on
the model's device: no host round-trip, no boolean indexing, no
`nonzero`. Statistics are viewspace gradient norms in the CUDA NDC
half-size convention (pixel gradient * 0.5*[W, H]) and per-slot max 2D
radii.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from manus_tpu_torch.models.gaussians import (
    GaussianModel,
    GaussianOpts,
    GaussianParams,
    get_opacity,
    get_scaling,
)
from manus_tpu_torch.train.optim import (
    AdamState,
    reset_moments_leaf,
    reset_moments_rows,
)
from manus_tpu_torch.utils import trace
from manus_tpu_torch.utils.transforms import build_rotation


class DensifyStats(NamedTuple):
    """Running densification signals, all [N_max] float32."""

    grad_accum: torch.Tensor  # sum of viewspace grad norms
    denom: torch.Tensor  # number of accumulations
    max_radii2d: torch.Tensor  # max screen radius seen


def init_stats(capacity: int, device) -> DensifyStats:
    def z():
        return torch.zeros(capacity, dtype=torch.float32, device=device)

    return DensifyStats(grad_accum=z(), denom=z(), max_radii2d=z())


def accumulate_stats(
    stats: DensifyStats,
    viewspace_grad: torch.Tensor,  # [N, 2] d(loss)/d(means2d) in pixels
    radii: torch.Tensor,  # [N] int32
    width: int,
    height: int,
) -> DensifyStats:
    """Add one view's signals, rescaled by 0.5*[W, H] so thresholds tuned
    on the CUDA rasterizer transfer unchanged."""
    visible = radii > 0
    scaled = viewspace_grad * viewspace_grad.new_tensor(
        [0.5 * width, 0.5 * height])
    norm = torch.linalg.norm(scaled, dim=-1)
    return DensifyStats(
        grad_accum=stats.grad_accum + torch.where(visible, norm, 0.0),
        denom=stats.denom + visible.to(torch.float32),
        max_radii2d=torch.maximum(
            stats.max_radii2d,
            torch.where(visible, radii.to(torch.float32), 0.0),
        ),
    )


def mean_gradient(stats: DensifyStats) -> torch.Tensor:
    """Each slot's mean viewspace gradient norm; 0 where it was never
    visible (or the mean is NaN)."""
    grads = torch.where(stats.denom > 0, stats.grad_accum / stats.denom, 0.0)
    return torch.where(torch.isnan(grads), 0.0, grads)


def _write_rows(dst: torch.Tensor, src: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """dst with dst[idx[i]] = src[i]; rows routed to idx == len(dst) land
    in one extra row that is thrown away (the JAX scatter's mode="drop")."""
    buf = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
    buf.index_copy_(0, idx, src)
    return buf[:-1]


def densify_and_prune(
    model: GaussianModel,
    opt_state: AdamState,
    stats: DensifyStats,
    opts: GaussianOpts,
    scene_extent: float,
    noise: torch.Tensor,  # [2, N_max, 3] standard normal: child 1, child 2
    use_size_threshold: bool,  # step > opacity_reset_interval
) -> Tuple[GaussianModel, AdamState, DensifyStats, dict]:
    """One densify-and-prune event (reference densify_and_prune).

    Slots whose mean viewspace gradient reaches the threshold are cloned
    (small) or split in two (large; the parent dies only when both
    children find a slot). Then low-opacity slots, with
    `use_size_threshold` also too large ones, and slots with non-finite
    scaling are pruned. Returns (model, opt_state, fresh stats, info);
    info holds 0-d tensors: clones, splits, pruned, alloc_dropped,
    num_active.
    """
    params = model.params
    active = model.active
    cap = active.shape[0]

    grads = mean_gradient(stats)
    scaling = get_scaling(params, opts.isotropic_scaling)
    max_scale = scaling.amax(dim=1)
    over_thr = active & (grads >= opts.densify_grad_threshold)
    small = max_scale <= opts.percent_dense * scene_extent
    clone_mask = over_thr & small
    split_mask = over_thr & ~small

    # free (inactive) slots first, in slot order
    free_order = torch.argsort(active.to(torch.uint8), stable=True)
    n_free = cap - active.sum()
    clone_rank = torch.cumsum(clone_mask, 0) - 1
    n_clone = clone_mask.sum()
    split_rank = torch.cumsum(split_mask, 0) - 1

    def slot_at(pos, valid):
        # non-candidates carry rank -1: clamp before the lookup
        ok = valid & (pos < n_free)
        return torch.where(ok, free_order[pos.clamp(0, cap - 1)], cap), ok

    clone_dst, clone_ok = slot_at(clone_rank, clone_mask)
    split1_dst, _ = slot_at(n_clone + 2 * split_rank, split_mask)
    split2_dst, split_ok = slot_at(n_clone + 2 * split_rank + 1, split_mask)
    # a split proceeds only when both children fit (the second slot is
    # the later one)
    split1_dst = torch.where(split_ok, split1_dst, cap)

    new_params = GaussianParams(*(_write_rows(p, p, clone_dst) for p in params))
    sw = model.skin_weights
    new_sw = None if sw is None else _write_rows(sw, sw, clone_dst)

    # children drawn from the parent gaussian, scales / (0.8 * 2)
    rots = build_rotation(params.rotation)
    child_scaling = torch.log(scaling / (0.8 * 2))
    if params.scaling.shape[1] == 1:
        child_scaling = child_scaling[:, :1]
    for eps, dst in zip(noise, (split1_dst, split2_dst)):
        offset = (rots * (eps * scaling)[:, None, :]).sum(-1)
        child = params._replace(xyz=params.xyz + offset, scaling=child_scaling)
        new_params = GaussianParams(*(_write_rows(p, c, dst)
                                      for p, c in zip(new_params, child)))
        if new_sw is not None:
            new_sw = _write_rows(new_sw, sw, dst)

    written = torch.zeros_like(active)
    for dst in (clone_dst, split1_dst, split2_dst):
        written = _write_rows(written, torch.ones_like(active), dst)
    new_active = (active | written) & ~(split_mask & split_ok)

    # prune (reference densify_and_prune)
    prune = new_active & (get_opacity(new_params)[:, 0]
                          < opts.min_opacity_threshold)
    if use_size_threshold:
        big_vs = stats.max_radii2d > opts.size_threshold
        big_ws = get_scaling(new_params, opts.isotropic_scaling).amax(
            dim=1) > 0.1 * scene_extent
        prune = prune | (new_active & (big_vs | big_ws))
    bad = ~torch.isfinite(new_params.scaling).all(dim=-1)
    prune = prune | (new_active & bad)
    new_active = new_active & ~prune

    # moments are zeroed on written rows and rows whose activity flipped;
    # surviving rows, clone parents included, keep theirs
    new_opt = reset_moments_rows(opt_state, (new_active != active) | written)
    clone_lost = clone_mask & ~clone_ok
    split_lost = split_mask & ~split_ok
    info = dict(
        clones=clone_ok.sum(),
        splits=split_ok.sum(),
        pruned=prune.sum(),
        alloc_dropped=clone_lost.sum() + split_lost.sum(),
        num_active=new_active.sum(),
    )
    # children, a split's two each counted (summed when the counters are
    # read)
    trace.count("densify.children_written", info["clones"], info["splits"],
                info["splits"])
    trace.count("densify.children_dropped", clone_lost, split_lost,
                split_lost)
    out = GaussianModel(params=new_params, active=new_active,
                        skin_weights=new_sw)
    return out, new_opt, init_stats(cap, active.device), info


def prune_by_mask(model: GaussianModel, opt_state: AdamState,
                  mask: torch.Tensor):
    """Deactivate the masked live slots and zero their moments. Returns
    (model, opt_state, n_removed as a 0-d tensor)."""
    kill = model.active & mask
    return (model._replace(active=model.active & ~kill),
            reset_moments_rows(opt_state, kill), kill.sum())


def reset_opacity(model: GaussianModel, opt_state: AdamState):
    """Clamp opacities to at most 0.01 and zero the opacity moments
    (reference reset_opacity)."""
    op = torch.clamp(get_opacity(model.params), max=0.01)
    params = model.params._replace(opacity=torch.log(op / (1 - op)))
    return (model._replace(params=params),
            reset_moments_leaf(opt_state, "opacity"))
