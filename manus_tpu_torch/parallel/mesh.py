"""The rank mesh of sharded training: torch.distributed process groups
laid out as the JAX package's (data, gauss) device mesh.

One process drives one card, so a mesh of n_data x n_gauss is that many
ranks. Rank r sits at row r // n_gauss (its data index) and column
r % n_gauss (its gauss index), JAX's row-major order. Views are sharded
over the data axis: the loss and the gradients are averaged over a
column's ranks (`data_group`). The gaussians are sharded over the gauss
axis: a row's ranks (`gauss_group`) each take a contiguous N / n_gauss
block of the N-leading model leaves inside the step, as
P("gauss") lays them out in JAX, and gather what binning needs.

The train state stays replicated on every rank (`replicate_state`), as
JAX's replicated state does: only the gradient computation is sharded,
and everything after it runs on the same values everywhere.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from manus_tpu_torch.parallel.collectives import all_gather_stack, broadcast
from manus_tpu_torch.utils.camera import index_camera

DATA_AXIS = "data"
GAUSS_AXIS = "gauss"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an n_data x n_gauss grid of ranks.

    ranks: [n_data, n_gauss] global ranks; rank: this process's global
    rank; data_index / gauss_index: its row and column (-1 outside the
    mesh). data_group: the ranks of its column, over which views are
    sharded; gauss_group: those of its row, over which gaussians are;
    group: every rank of the mesh. A group of one rank is None.
    """

    ranks: np.ndarray
    rank: int
    data_index: int
    gauss_index: int
    data_group: Any = None
    gauss_group: Any = None
    group: Any = None

    @property
    def n_data(self) -> int:
        return self.ranks.shape[0]

    @property
    def n_gauss(self) -> int:
        return self.ranks.shape[1]

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, GAUSS_AXIS: self.n_gauss}

    @property
    def member(self) -> bool:
        return self.data_index >= 0

    @property
    def is_first(self) -> bool:
        """The mesh's first rank: the one that writes files."""
        return self.rank == int(self.ranks[0, 0])


def _new_group(members):
    return dist.new_group(list(members)) if len(members) > 1 else None


def make_mesh(n_data: Optional[int] = None, n_gauss: int = 1) -> Mesh:
    """The n_data x n_gauss mesh over the world's first n_data * n_gauss
    ranks. Every rank of the world must call it, in the same order, since
    each group is made by all of them; a rank outside the mesh gets one
    with member False. Without an initialised process group only the
    1 x 1 mesh exists."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_gauss
    assert n_data * n_gauss <= world, (
        f"mesh {n_data}x{n_gauss} exceeds {world} ranks")
    grid = np.arange(n_data * n_gauss).reshape(n_data, n_gauss)
    cols = [_new_group(grid[:, g]) for g in range(n_gauss)]
    rows = [_new_group(grid[d]) for d in range(n_data)]
    whole = _new_group(grid.reshape(-1))
    where = np.argwhere(grid == me)
    if where.shape[0] == 0:
        return Mesh(grid, me, -1, -1)
    d, g = (int(i) for i in where[0])
    return Mesh(grid, me, d, g, cols[g], rows[d], whole)


def view_rows(num_views: int, mesh: Mesh) -> slice:
    """The views of this rank's data row: a contiguous V / n_data block,
    as P("data") shards the view axis."""
    assert num_views % mesh.n_data == 0, (num_views, mesh.n_data)
    per = num_views // mesh.n_data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def gauss_rows(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous N / n_gauss block of the gaussians."""
    assert n % mesh.n_gauss == 0, (n, mesh.n_gauss)
    per = n // mesh.n_gauss
    return slice(mesh.gauss_index * per, (mesh.gauss_index + 1) * per)


SHARDED_KEYS = ("rgb", "mask", "cameras", "lpips_gt_feats")


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """The rank's part of a view-batched dict: the [V, ...] leaves of
    rgb, mask, cameras and lpips_gt_feats cut to its data row's views,
    the rest (bg, bone_tf, keypoints) as they are."""
    rows = view_rows(batch["rgb"].shape[0], mesh)
    out = dict(batch)
    for key in SHARDED_KEYS:
        if key not in batch:
            continue
        val = batch[key]
        if key == "cameras":
            out[key] = index_camera(val, torch.arange(
                rows.start, rows.stop, device=batch["rgb"].device))
        elif isinstance(val, (tuple, list)):
            out[key] = type(val)(a[rows] for a in val)
        else:
            out[key] = val[rows]
    return out


def _leaves(tree, prefix=""):
    """(name, tensor) of every tensor in a tree of NamedTuples."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        for name, x in zip(names, tree):
            yield from _leaves(x, f"{prefix}.{name}")


def _rebuild(tree, values: dict, prefix=""):
    if isinstance(tree, torch.Tensor):
        return values[prefix]
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        items = [_rebuild(x, values, f"{prefix}.{name}")
                 for name, x in zip(names, tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


def state_digest(state) -> str:
    """A digest of every tensor leaf's bytes and of the generator state."""
    h = hashlib.sha256()
    for name, x in _leaves(state):
        h.update(name.encode())
        h.update(x.detach().cpu().contiguous().view(torch.uint8).numpy()
                 if x.numel() else b"")
    gen = getattr(state, "gen", None)
    if gen is not None:
        h.update(gen.get_state().numpy().tobytes())
    h.update(str(getattr(state, "step", "")).encode())
    return h.hexdigest()


def check_replicated(state, mesh: Mesh, what: str = "state"):
    """Raise unless every rank of the mesh holds the same state bits."""
    if mesh.group is None:
        return
    mine = torch.tensor(np.frombuffer(bytes.fromhex(state_digest(state)),
                                      np.uint8).astype(np.int64))
    if dist.get_backend(mesh.group) == dist.Backend.NCCL:
        mine = mine.cuda()
    every = all_gather_stack(mine, mesh.group).cpu()
    if not bool((every == every[0]).all()):
        raise RuntimeError(f"the ranks' {what} differ")


def replicate_state(state, mesh: Mesh):
    """Every tensor leaf of `state` broadcast from the mesh's first rank,
    then checked equal on every rank (the generator state and step too,
    which each rank makes from the same seed)."""
    if mesh.group is None:
        return state
    values = {name: broadcast(x, 0, mesh.group) for name, x in _leaves(state)}
    state = _rebuild(state, values)
    check_replicated(state, mesh)
    return state
