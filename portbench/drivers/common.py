"""What the drivers share: the configuration as run, the inputs from the
seed, the port's objects built from them, and the numbers that decide
`correct` for a training cell."""
from __future__ import annotations

import copy
import statistics

import numpy as np
import torch

from portbench import scene as sc

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def config_as_run(config_file: dict, traffic: dict, scale: dict) -> dict:
    """The configuration dict the cell runs: the config file's, the
    traffic's overrides, then `scale` (the harness's own tests shrink a
    cell with it; a measured run passes none)."""
    cfg = copy.deepcopy(config_file["config"])
    for k, v in list(traffic.get("overrides", {}).items()) + list(
            scale.items()):
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = node[p]
        if leaf not in node:
            raise KeyError(f"config has no {k}")
        node[leaf] = v
    return cfg


def _flatten(d: dict, prefix: str = ""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def port_config(preset: str, cfg_dict: dict, seed: int):
    """The port's ExperimentConfig: the preset with every value of the
    configuration as run set on it (an unknown key raises), its seed
    from the run's."""
    from manus_tpu_torch.config import CONFIGS

    cfg = CONFIGS[preset]()
    for dotted, value in _flatten(cfg_dict):
        *path, leaf = dotted.split(".")
        obj = cfg
        for p in path:
            obj = getattr(obj, p)
        if not hasattr(obj, leaf):
            raise KeyError(f"config has no {dotted}")
        if isinstance(getattr(obj, leaf), tuple) and isinstance(value, list):
            value = tuple(value)
        object.__setattr__(obj, leaf, value)
    cfg.trainer.seed = seed % 2**32
    return cfg


def build_inputs(cfg: dict, scene_opts: dict, seed: int, device,
                 images: bool = False, vgg: bool = False,
                 obj: bool = False) -> dict:
    """The scene from the seed (portbench/scene.py): the skeleton, its
    poses and the rig as numpy, the hand's initial cloud on the device;
    with `images` the gt frames on the host, with `vgg` the VGG16, with
    `obj` the object's cloud."""
    d = cfg["dataset"]
    skel = sc.hand20_skeleton()
    poses = sc.hand_poses(skel, d["num_frames"])
    centre = 0.5 * (skel["heads"].mean(0) + skel["tails"].mean(0))
    K, extr = sc.ring_cameras(d["num_cameras"], d["width"], d["height"],
                              centre, dist=scene_opts["cam_dist_m"],
                              fov_deg=scene_opts["fov_deg"])
    out = dict(
        K=K, extr=extr, extent=sc.scene_extent(extr),
        init=sc.init_cloud(skel, d["sample_size"], cfg["capacity"], seed,
                           device),
        rest=skel["rest"].astype(np.float32),
        rest_heads=skel["heads"].astype(np.float32),
        rest_tails=skel["tails"].astype(np.float32),
        pose=poses["pose"], heads=poses["heads"], tails=poses["tails"],
        images=None, vgg=None, obj=None)
    if images:
        out["images"] = sc.gt_images(poses["heads"], poses["tails"], K, extr,
                                     d["width"], d["height"], seed, device,
                                     radius=scene_opts["capsule_radius_m"])
    if vgg:
        out["vgg"] = sc.vgg16_weights(seed, device)
    if obj:
        out["obj"] = sc.object_cloud(scene_opts["object_centre"],
                                     scene_opts["object_radius_m"],
                                     scene_opts["object_shell_m"],
                                     cfg["capacity"], seed, device)
    return out


def decode(u8):
    """uint8 RGBA -> float32 rgb [..., 3] and mask [..., 1] in [0, 1], as a
    capture's loader hands them over."""
    x = u8.astype(np.float32) * np.float32(1.0 / 255.0)
    return x[..., :3], x[..., 3:]


def port_scene(cfg, inputs: dict, device):
    """The port's stacked cameras, its rest and posed Bones, and its voxel
    skinning grid, from the inputs."""
    from manus_tpu_torch.data.voxel import make_voxel_grid
    from manus_tpu_torch.utils.camera import make_camera, stack_cameras
    from manus_tpu_torch.utils.structures import Bones

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    d = cfg.dataset
    cams = stack_cameras([make_camera(k, e, d.width, d.height, device=device)
                          for k, e in zip(inputs["K"], inputs["extr"])])
    rest = Bones(heads=t(inputs["rest_heads"]), tails=t(inputs["rest_tails"]),
                 transforms=t(inputs["rest"]))
    posed = [Bones(heads=t(h), tails=t(tl), transforms=t(p))
             for h, tl, p in zip(inputs["heads"], inputs["tails"],
                                 inputs["pose"])]
    grid = make_voxel_grid(cfg, rest.keypoints().cpu().numpy(), mano=None,
                           num_bones=rest.num_bones, device=device)
    return cams, rest, posed, grid


def port_model(cloud: dict):
    """A GaussianModel of the port holding a copy of the cloud."""
    from manus_tpu_torch.models.gaussians import GaussianModel, GaussianParams

    return GaussianModel(
        params=GaussianParams(*(cloud[k].clone() for k in LEAVES)),
        active=cloud["active"].clone(), skin_weights=None)


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double())) for k, v in
            tensors.items()}


def compare(program: dict, reference: dict, init: dict) -> dict:
    """The numbers `correct` compares for a training cell, each the worst
    over the leaves:

    loss: the largest relative gap of a step's loss;
    grad: the gap between the norms of the first step's gradient (as
      Adam's first moment holds it) of a leaf, over the larger of the
      reference's norm of that leaf and of the median leaf;
    change: the same for the change of a leaf over the steps, counting
      only the leaves whose reference gradient is at least a thousandth
      of the median leaf's (others move by round-off alone under Adam).
    """
    loss = max(abs(p - r) / max(abs(r), 1e-30) for p, r in
               zip(program["losses"], reference["losses"]))
    g_p, g_r = _norms(program["grad1"]), _norms(reference["grad1"])
    med = statistics.median(g_r.values())
    grad = max(abs(g_p[k] - g_r[k]) / max(g_r[k], med, 1e-30) for k in g_r)
    moved = [k for k in g_r if g_r[k] >= 1e-3 * med]
    d_p = _norms({k: program["params"][k] - init[k] for k in moved})
    d_r = _norms({k: reference["params"][k] - init[k] for k in moved})
    med_d = statistics.median(d_r.values())
    change = max(abs(d_p[k] - d_r[k]) / max(d_r[k], med_d, 1e-30)
                 for k in moved)
    return dict(loss=loss, grad=grad, change=change)


def compare_densify(program: dict, reference: dict, before: dict) -> dict:
    """The numbers `correct` compares for a densify event:

    densify_slots: the slots whose liveness after the event differs from
      the reference's, plus the gaps between the event's counts (clones,
      splits, pruned, dropped, live); an exact comparison;
    densify_state: the worst leaf of the parameters, Adam's moments and
      the densify statistics after the event: the norm of the program's
      difference from the reference, over the larger of the reference
      leaf's norm after the event and before it.
    """
    slots = int((program["active"].cpu() != reference["active"].cpu()).sum())
    slots += sum(abs(int(program["counts"][k]) - int(v))
                 for k, v in reference["counts"].items())
    worst = 0.0
    for group in ("params", "m", "v", "stats"):
        for k, want in reference[group].items():
            want = want.double().cpu()
            got = program[group][k].double().cpu()
            scale = max(float(torch.linalg.norm(want)),
                        float(torch.linalg.norm(before[group][k].double())),
                        1e-30)
            worst = max(worst, float(torch.linalg.norm(got - want)) / scale)
    return dict(densify_slots=slots, densify_state=worst)
