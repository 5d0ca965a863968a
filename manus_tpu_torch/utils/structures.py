"""Skeleton bones as a frozen dataclass of tensors."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Bones:
    """A (possibly batched) skeleton snapshot.

    heads/tails: [J, 3] bone endpoints; transforms: [J, 4, 4] bone matrices
    (armature->world); eulers: [J, 3] local joint angles. kintree maps
    str(bone index) to its parent index.
    """

    heads: Any
    tails: Any
    transforms: Any
    eulers: Optional[Any] = None
    root_translation: Optional[Any] = None
    root_rotation: Optional[Any] = None
    kintree: Optional[dict] = None
    bnames: Optional[tuple] = None

    def __getitem__(self, idx):
        def take(x):
            return x[idx] if isinstance(x, torch.Tensor) else x

        return dataclasses.replace(
            self, **{f.name: take(getattr(self, f.name))
                     for f in dataclasses.fields(self)}
        )

    @property
    def num_bones(self) -> int:
        return self.transforms.shape[-3]

    def keypoints(self):
        """[J+1, 3] skeleton keypoints = first head + all tails."""
        return torch.cat([self.heads[..., :1, :], self.tails], dim=-2)
