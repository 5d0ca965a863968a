"""Per-group Adam for the padded gaussian parameters.

The reference's torch.optim.Adam with six named groups and per-group
learning rates (eps 1e-15), written functionally over GaussianParams and
masked by `active`; densify surgery is a masked moment reset. The xyz
group follows the log-linear decay of expon_lr. A single extra array (the
trainable skin weights) has its own moments, ArrayAdamState, and shares
the main state's step.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from manus_tpu_torch.models.gaussians import GaussianOpts, GaussianParams

BETA1, BETA2 = 0.9, 0.999
EPS = 1e-15


class AdamState(NamedTuple):
    m: GaussianParams
    v: GaussianParams
    step: int  # optimiser steps taken


def init_adam(params: GaussianParams) -> AdamState:
    return AdamState(
        m=GaussianParams(*(torch.zeros_like(p) for p in params)),
        v=GaussianParams(*(torch.zeros_like(p) for p in params)),
        step=0,
    )


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def expon_lr(step: int, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1000000) -> torch.Tensor:
    """Log-linear LR interpolation, a 0-d float32 tensor; 0 when both
    endpoints are 0 ("disable this parameter")."""
    if lr_init == 0.0 and lr_final == 0.0:
        return _f32(0.0)
    step = _f32(step)
    delay_rate = _f32(1.0)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(_f32(math.log(lr_init)) * (1 - t)
                         + _f32(math.log(lr_final)) * t)
    return delay_rate * log_lerp


def group_learning_rates(opts: GaussianOpts, step: int) -> GaussianParams:
    """Per-leaf learning rates for the current step."""
    return GaussianParams(
        xyz=expon_lr(
            step,
            opts.position_lr_init * opts.spatial_lr_scale,
            opts.position_lr_final * opts.spatial_lr_scale,
            lr_delay_mult=opts.position_lr_delay_mult,
            max_steps=opts.position_lr_max_steps,
        ),
        features_dc=_f32(opts.feature_lr),
        features_rest=_f32(opts.feature_lr / 20.0),
        scaling=_f32(opts.scaling_lr),
        rotation=_f32(opts.rotation_lr),
        opacity=_f32(opts.opacity_lr),
    )


def _row_mask(mask, x):
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def adam_update(params: GaussianParams, grads: GaussianParams,
                state: AdamState, lrs: GaussianParams, active: torch.Tensor):
    """One masked Adam step; inactive slots are not updated. Bias
    correction uses the global step. Returns (params, state), new tensors."""
    step = state.step + 1
    bc1 = 1.0 - _f32(BETA1) ** step
    bc2 = 1.0 - _f32(BETA2) ** step
    new_p, new_m, new_v = [], [], []
    for p, g, m, v, lr in zip(params, grads, state.m, state.v, lrs):
        mask = _row_mask(active, p)
        g = torch.where(mask, g, 0.0)
        m = BETA1 * m + (1 - BETA1) * g
        v = BETA2 * v + (1 - BETA2) * g * g
        upd = p - lr.to(p.device) * (m / bc1.to(p.device)) / (
            torch.sqrt(v / bc2.to(p.device)) + EPS)
        new_p.append(torch.where(mask, upd, p))
        new_m.append(m)
        new_v.append(v)
    return GaussianParams(*new_p), AdamState(
        m=GaussianParams(*new_m), v=GaussianParams(*new_v), step=step)


def reset_moments_rows(state: AdamState, rows_mask: torch.Tensor) -> AdamState:
    """Zero first and second moments of the masked rows (densify surgery)."""

    def zero_rows(x):
        return torch.where(_row_mask(rows_mask, x), 0.0, x)

    return AdamState(
        m=GaussianParams(*(zero_rows(x) for x in state.m)),
        v=GaussianParams(*(zero_rows(x) for x in state.v)),
        step=state.step,
    )


def reset_moments_leaf(state: AdamState, leaf: str) -> AdamState:
    """Zero the moments of one whole parameter group (opacity reset)."""
    m = state.m._replace(**{leaf: torch.zeros_like(getattr(state.m, leaf))})
    v = state.v._replace(**{leaf: torch.zeros_like(getattr(state.v, leaf))})
    return AdamState(m=m, v=v, step=state.step)


class ArrayAdamState(NamedTuple):
    """Adam moments of one auxiliary array (the skin weights); its bias
    correction uses the main AdamState's step."""

    m: torch.Tensor
    v: torch.Tensor


def init_array_adam(x: torch.Tensor) -> ArrayAdamState:
    return ArrayAdamState(m=torch.zeros_like(x), v=torch.zeros_like(x))


def array_adam_update(p: torch.Tensor, g: torch.Tensor, state: ArrayAdamState,
                      lr: float, active: torch.Tensor, step: int):
    """Masked Adam step of one array (the skinning_lr group). `step` is the
    main optimiser's post-increment step; the bias corrections are the
    float32 ones of adam_update, passed as scalars so that nothing is
    copied to the device. Returns (p, state)."""
    bc1 = float(1.0 - _f32(BETA1) ** step)
    bc2 = float(1.0 - _f32(BETA2) ** step)
    mask = _row_mask(active, p)
    g = torch.where(mask, g, 0.0)
    m = BETA1 * state.m + (1 - BETA1) * g
    v = BETA2 * state.v + (1 - BETA2) * g * g
    upd = p - lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS)
    return torch.where(mask, upd, p), ArrayAdamState(m=m, v=v)


def array_reset_rows(state: ArrayAdamState,
                     rows_mask: torch.Tensor) -> ArrayAdamState:
    mask = _row_mask(rows_mask, state.m)
    return ArrayAdamState(m=torch.where(mask, 0.0, state.m),
                          v=torch.where(mask, 0.0, state.v))
