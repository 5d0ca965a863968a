"""Colormaps by table lookup: values in [0, 1] -> RGB.

A 256-entry table per name, sampled at the index trunc(value * 255),
clipped to the table. "gray" is computed; "magma" is matplotlib's table,
carried as data (colormap_data.py). Another name raises: there is no
made-up fallback ramp.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from manus_tpu_torch.utils.colormap_data import MAGMA

LUT_SIZE = 256
NAMES = ("gray", "magma")


@functools.lru_cache(maxsize=None)
def lut(name: str) -> np.ndarray:
    """The [256, 3] float32 table of `name`, read-only (it is cached)."""
    if name == "gray":
        g = np.linspace(0, 1, LUT_SIZE)
        table = np.stack([g, g, g], axis=1).astype(np.float32)
    elif name == "magma":
        table = np.asarray(MAGMA, np.float32)
    else:
        raise ValueError(f"unknown colormap {name!r}; one of {NAMES}")
    table.setflags(write=False)
    return table


def apply_colormap(values: torch.Tensor, name: str = "magma") -> torch.Tensor:
    """values (any shape) -> [..., 3] RGB on values' device. Out-of-range
    values take the end colours; the index is clamped again after the
    cast, where a NaN lands (torch's float -> int of NaN is undefined)."""
    table = torch.tensor(lut(name), device=values.device)
    idx = (values * (LUT_SIZE - 1)).clamp(0, LUT_SIZE - 1).to(torch.int64)
    return table[idx.clamp(0, LUT_SIZE - 1)]
