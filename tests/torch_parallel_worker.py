"""One rank of the gloo world that tests/test_torch_parallel.py spawns.
Not a test module: it imports torch and the port, no JAX.

`run(rank, world, port, job_path, out_dir)` joins the world, then for
each case of the job makes its mesh (every rank takes part in making
every mesh's groups; a rank outside the mesh skips the step), runs one
sharded train step from the job's state on the rank's part of the
case's batch, and writes what came out to {out_dir}/{case}_{rank}.npz; then
owner-mode binning of the job's scene over the 1 x world mesh's gauss
row, to {out_dir}/bins_{rank}.npz.
"""
import pickle

import numpy as np
import torch
import torch.distributed as dist

from manus_tpu_torch.models.convert import camera_from_numpy, model_from_numpy
from manus_tpu_torch.ops.rasterizer.binning import bin_gaussians
from manus_tpu_torch.ops.rasterizer.projection import project_gaussians
from manus_tpu_torch.parallel.mesh import make_mesh, replicate_state, shard_batch
from manus_tpu_torch.train.workloads import init_train_state, make_train_step


def port_batch(b: dict) -> dict:
    out = dict(rgb=torch.tensor(b["rgb"]), mask=torch.tensor(b["mask"]),
               cameras=camera_from_numpy(b["cameras"], "cpu"),
               bg=torch.tensor(b["bg"]))
    for k in ("bone_tf", "keypoints"):
        if k in b:
            out[k] = torch.tensor(b[k])
    return out


def state_arrays(state, metrics) -> dict:
    out = {f"params/{k}": v.numpy()
           for k, v in state.model.params._asdict().items()}
    out.update({f"stats/{k}": v.numpy()
                for k, v in state.stats._asdict().items()})
    out.update({f"metrics/{k}": np.asarray(v) for k, v in metrics.items()})
    out["active"] = state.model.active.numpy()
    if state.model.skin_weights is not None:
        out["skin_weights"] = state.model.skin_weights.numpy()
    return out


def run(rank: int, world: int, port: int, job_path: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    for name, n_data, n_gauss, cfg, batch in job["cases"]:
        mesh = make_mesh(n_data, n_gauss)
        if mesh.member:
            model = model_from_numpy(job["model"], "cpu")
            step = make_train_step(cfg, 1.0, True, mesh=mesh)
            state = replicate_state(init_train_state(model), mesh)
            new, metrics = step(state, shard_batch(port_batch(batch), mesh))
            np.savez(f"{out_dir}/{name}_{rank}.npz",
                     **state_arrays(new, metrics))
        dist.barrier()

    sc = job["bin_scene"]
    mesh = make_mesh(1, world)
    proj = project_gaussians(torch.tensor(sc["means"]), torch.tensor(sc["cov6"]),
                             camera_from_numpy(sc["camera"], "cpu"))
    bins = bin_gaussians(proj, sc["ntx"], sc["nty"], owner=mesh.gauss_index,
                         num_owners=world, group=mesh.gauss_group, **sc["kw"])
    np.savez(f"{out_dir}/bins_{rank}.npz",
             **{k: v.numpy() for k, v in bins._asdict().items()})
    dist.barrier()
    dist.destroy_process_group()
