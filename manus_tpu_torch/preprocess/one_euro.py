"""The one-euro filter over joint-angle sequences (the JAX package's
preprocess/one_euro.py): a streaming class in numpy and a whole-sequence
filter that loops over frames on the tensors' device, every joint at
once, with no host sync.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def smoothing_factor(t_e, cutoff):
    r = 2.0 * math.pi * cutoff * t_e
    return r / (r + 1.0)


def filter_sequence(ts: torch.Tensor, xs: torch.Tensor,
                    min_cutoff: float = 1.0, beta: float = 0.0,
                    d_cutoff: float = 1.0) -> torch.Tensor:
    """Smooth xs [F, ...] at timestamps ts [F] (or frame indices); frame 0
    passes through unchanged."""
    flat = xs.reshape(xs.shape[0], -1)
    x_prev, dx_prev, t_prev = flat[0], torch.zeros_like(flat[0]), ts[0]
    out = [flat[0]]
    for i in range(1, flat.shape[0]):
        t, x = ts[i], flat[i]
        t_e = (t - t_prev).clamp_min(1e-9)
        a_d = smoothing_factor(t_e, d_cutoff)
        dx = (x - x_prev) / t_e
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        dx_hat = a_d * dx + (1 - a_d) * dx_prev
        a = smoothing_factor(t_e, min_cutoff + beta * dx_hat.abs())
        x_hat = a * x + (1 - a) * x_prev
        x_prev, dx_prev, t_prev = x_hat, dx_hat, t
        out.append(x_hat)
    return torch.stack(out).reshape(xs.shape)


class OneEuroFilter:
    """Streaming one-euro filter with the reference class's interface, in
    float64 numpy."""

    def __init__(self, t0, x0, dx0=None, min_cutoff=1.0, beta=0.0,
                 d_cutoff=1.0):
        self.min_cutoff = float(min_cutoff)
        self.beta = float(beta)
        self.d_cutoff = float(d_cutoff)
        self.x_prev = np.array(x0, np.float64)
        self.dx_prev = (np.array(dx0, np.float64) if dx0 is not None
                        else np.zeros_like(self.x_prev))
        self.t_prev = np.array(t0, np.float64)

    def __call__(self, t, x):
        t = np.asarray(t, np.float64)
        x = np.asarray(x, np.float64)
        t_e = t - self.t_prev
        a_d = np.asarray(smoothing_factor(t_e, self.d_cutoff))
        dx = (x - self.x_prev) / t_e[..., None]
        dx[~np.isfinite(dx)] = 0
        dx_hat = a_d[..., None] * dx + (1 - a_d[..., None]) * self.dx_prev
        cutoff = self.min_cutoff + self.beta * np.abs(dx_hat)
        a = np.asarray(smoothing_factor(t_e[..., None], cutoff))
        x_hat = a * x + (1 - a) * self.x_prev
        self.x_prev = x_hat.copy()
        self.dx_prev = dx_hat.copy()
        self.t_prev = t.copy()
        return x_hat
