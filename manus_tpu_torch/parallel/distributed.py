"""Multi-process bring-up: torch.distributed and the mesh across nodes.

One process runs per card. `initialize_distributed` joins the process
group (NCCL when every rank of a node has a card of its own, gloo on the
CPU or when a node's ranks share cards, which NCCL refuses);
`make_multihost_mesh` lays the data axis across nodes and keeps the
gauss axis inside a node, where its gathers into binning ride NVLink;
`process_local_batch_indices` names the views a rank loads.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from manus_tpu_torch.parallel.mesh import Mesh, make_mesh, view_rows

# Environment variables by which a launcher says it started the process
# as one rank of several: torchrun's, SLURM's and Open MPI's.
LAUNCHER_MARKERS = ("RANK", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE")


def _env_int(*names, default=-1) -> int:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return default


def launcher_env() -> dict:
    """What a launcher's environment says: world size, rank, local rank
    and local world size (-1 where it says nothing)."""
    return dict(
        world=_env_int("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"),
        rank=_env_int("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK"),
        local_rank=_env_int("LOCAL_RANK", "SLURM_LOCALID",
                            "OMPI_COMM_WORLD_LOCAL_RANK"),
        local_world=_env_int("LOCAL_WORLD_SIZE",
                             "OMPI_COMM_WORLD_LOCAL_SIZE"),
    )


def choose_backend(device_type: str, local_world: int) -> str:
    """NCCL when each of a node's ranks has a card of its own; gloo on the
    CPU, or when a node holds more ranks than cards (NCCL refuses two
    ranks on one card, gloo stages CUDA tensors through the host,
    parallel/collectives.py)."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize_distributed(coordinator: str = "", num_processes: int = -1,
                           process_id: int = -1,
                           device_type: str = "cuda") -> bool:
    """Join the process group. Returns True when more than one process
    takes part after the call.

    coordinator is `host:port` of rank 0's store (default: MASTER_ADDR and
    MASTER_PORT, as a launcher sets them). With no arguments the process
    joins only under a launcher's markers (torchrun's RANK/WORLD_SIZE,
    SLURM_JOB_ID, OMPI_COMM_WORLD_SIZE), else it stays alone, as the JAX
    package's initialize_distributed does. The backend is choose_backend's
    for the ranks on this node (the launcher's LOCAL_WORLD_SIZE, else the
    world).
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = launcher_env()
    explicit = bool(coordinator) or num_processes > 0 or process_id >= 0
    if not explicit and not any(m in os.environ for m in LAUNCHER_MARKERS):
        return False
    world = num_processes if num_processes > 0 else env["world"]
    rank = process_id if process_id >= 0 else env["rank"]
    if world <= 0 or rank < 0:
        raise ValueError(
            f"distributed run without a world size ({world}) or rank "
            f"({rank}): set trainer.num_processes and trainer.process_id, "
            "or launch with torchrun")
    if coordinator:
        addr = f"tcp://{coordinator}"
    else:
        addr = (f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
                f"{os.environ['MASTER_PORT']}")
    local_world = env["local_world"] if env["local_world"] > 0 else world
    backend = choose_backend(device_type, local_world)
    dist.init_process_group(backend, init_method=addr, world_size=world,
                            rank=rank)
    return world > 1


def local_rank() -> int:
    """This process's rank on its node: the launcher's LOCAL_RANK, else
    the global rank (one node)."""
    lr = launcher_env()["local_rank"]
    if lr >= 0:
        return lr
    return dist.get_rank() if dist.is_initialized() else 0


def make_multihost_mesh(n_data: Optional[int] = None,
                        n_gauss: int = 1) -> Mesh:
    """The (data, gauss) mesh over every rank. Ranks are numbered node by
    node, so with n_gauss dividing a node's ranks (the launcher's
    LOCAL_WORLD_SIZE, else the world) a gauss row lies inside one node
    and the data axis spans the nodes."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    lw = launcher_env()["local_world"]
    local_world = lw if lw > 0 else world
    if n_data is None:
        n_data = world // n_gauss
    assert n_gauss <= local_world and local_world % n_gauss == 0, (
        f"gauss axis ({n_gauss}) must fit inside one node ({local_world} "
        "local ranks): its gathers into binning must not cross nodes")
    assert n_data * n_gauss == world, (
        f"mesh {n_data}x{n_gauss} != {world} ranks")
    return make_mesh(n_data=n_data, n_gauss=n_gauss)


def process_local_batch_indices(num_views: int, mesh: Mesh) -> np.ndarray:
    """The view indices this rank loads of a [V, ...] batch: its data
    row's block."""
    rows = view_rows(num_views, mesh)
    return np.arange(rows.start, rows.stop, dtype=np.int64)
