"""Device choice for the port's entry points.

Entry points run on the card unless the caller names another device. A
machine without CUDA raises rather than falling back to the CPU, so a
measurement can never quietly time the host.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the first CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "manus_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
