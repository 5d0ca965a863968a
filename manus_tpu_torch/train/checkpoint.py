"""Checkpoints: flat npz snapshots of the train state, with "best" lookup.

The npz is the JAX package's, key for key: each leaf of the TrainState
under its pytree path (".model/.params/.xyz", ".opt/.m/.opacity",
".opt/.step", ".stats/.denom", ".step", ".rng", ".mask_pruned_flag",
".skin_opt/.m", ...) with the JAX dtypes (the steps as () int32, the
active mask and the prune flag as bool), and extras under "__extra__/".
So a checkpoint of either package loads into the other. Files are named
step{step:06d}-loss{loss:.6f}[-vpsnr{psnr:.4f}].npz; "best" is the
highest held-out PSNR when a name carries one, else the lowest loss,
ties to the latest step.

The random state differs by design. The JAX state carries a PRNG key,
the port a torch.Generator, and their split noise cannot match. The port
writes ".rng" as PRNGKey(seed) would be, [0, seed], and the generator's
own state as "__extra__/torch_gen_state", which the JAX loader sets aside
as an extra. A checkpoint without that state (a JAX one) reseeds the
generator from .rng[1].
"""
from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from manus_tpu_torch.models.densify import DensifyStats
from manus_tpu_torch.models.gaussians import GaussianModel, GaussianParams
from manus_tpu_torch.train.optim import AdamState, ArrayAdamState
from manus_tpu_torch.train.workloads import TrainState, VoxelGrid
from manus_tpu_torch.utils.device import resolve_device

_CKPT_RE = re.compile(
    r"step(\d+)-loss([-\d.einf]+?)(?:-vpsnr([-\d.einf]+))?\.npz$"
)
GEN_STATE = "torch_gen_state"


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def state_to_arrays(state: TrainState) -> dict:
    """The state's leaves as numpy arrays under the JAX package's keys."""
    out = {}
    model = state.model
    for name, leaf in model.params._asdict().items():
        out[f".model/.params/.{name}"] = _np(leaf)
    out[".model/.active"] = _np(model.active)
    if model.skin_weights is not None:
        out[".model/.skin_weights"] = _np(model.skin_weights)
    for mom in ("m", "v"):
        for name, leaf in getattr(state.opt, mom)._asdict().items():
            out[f".opt/.{mom}/.{name}"] = _np(leaf)
    out[".opt/.step"] = np.asarray(state.opt.step, np.int32)
    for name, leaf in state.stats._asdict().items():
        out[f".stats/.{name}"] = _np(leaf)
    out[".step"] = np.asarray(state.step, np.int32)
    out[".rng"] = np.asarray([0, state.gen.initial_seed() & 0xFFFFFFFF],
                             np.uint32)
    out[".mask_pruned_flag"] = _np(state.mask_pruned_flag).astype(bool)
    if state.skin_opt is not None:
        out[".skin_opt/.m"] = _np(state.skin_opt.m)
        out[".skin_opt/.v"] = _np(state.skin_opt.v)
    return out


def state_from_arrays(arrays: dict, template: TrainState,
                      gen_state: Optional[np.ndarray] = None) -> TrainState:
    """A TrainState of the template's structure and device from the
    arrays of state_to_arrays (or a JAX checkpoint). A leaf the template
    has and the arrays lack raises KeyError. The generator takes
    `gen_state` when given (and made on the same device type), else the
    seed .rng[1]."""
    dev = template.model.active.device

    def get(key, dtype=torch.float32):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        return torch.tensor(np.asarray(arrays[key]), dtype=dtype, device=dev)

    def params(prefix):
        return GaussianParams(*(get(f"{prefix}/.{name}")
                                for name in GaussianParams._fields))

    model = GaussianModel(
        params=params(".model/.params"),
        active=get(".model/.active", torch.bool),
        skin_weights=None if template.model.skin_weights is None
        else get(".model/.skin_weights"),
    )
    gen = torch.Generator(device=dev)
    # a generator state of another device type (a CPU run's on a CUDA
    # device) has another size and cannot be set: reseed then
    if gen_state is not None and np.asarray(gen_state).size == \
            gen.get_state().numel():
        gen.set_state(torch.tensor(np.asarray(gen_state), dtype=torch.uint8))
    else:
        gen.manual_seed(int(np.asarray(arrays[".rng"])[1]))
    return TrainState(
        model=model,
        opt=AdamState(m=params(".opt/.m"), v=params(".opt/.v"),
                      step=int(arrays[".opt/.step"])),
        stats=DensifyStats(*(get(f".stats/.{name}")
                             for name in DensifyStats._fields)),
        step=int(arrays[".step"]),
        gen=gen,
        mask_pruned_flag=get(".mask_pruned_flag", torch.bool).reshape(()),
        skin_opt=None if template.skin_opt is None
        else ArrayAdamState(m=get(".skin_opt/.m"), v=get(".skin_opt/.v")),
    )


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int, loss: float,
                    extra: Optional[dict] = None,
                    val_psnr: Optional[float] = None) -> str:
    """Write the state (and extras) atomically; the name carries the step,
    the loss and, when finite, the held-out PSNR. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = state_to_arrays(state)
    extra = dict(extra or {})
    extra[GEN_STATE] = state.gen.get_state().numpy()
    for k, v in extra.items():
        payload[f"__extra__/{k}"] = np.asarray(v)
    name = f"step{step:06d}-loss{loss:.6f}"
    if val_psnr is not None and np.isfinite(val_psnr):
        name += f"-vpsnr{val_psnr:.4f}"
    path = os.path.join(ckpt_dir, name + ".npz")
    # a kill mid-save leaves the .tmp, never a corrupt "best"; uncompressed
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
    return path


def find_best_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Best = highest held-out PSNR when any name carries one, else lowest
    train loss; ties to the latest step. None when there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    best_val = None
    best_loss = None
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.search(name)
        if not m:
            continue
        step, loss = int(m.group(1)), float(m.group(2))
        if m.group(3) is not None:
            key = (-float(m.group(3)), -step)
            if best_val is None or key < best_val[0]:
                best_val = (key, name)
        key = (loss, -step)
        if best_loss is None or key < best_loss[0]:
            best_loss = (key, name)
    best = best_val or best_loss
    return os.path.join(ckpt_dir, best[1]) if best else None


def load_raw(path: str):
    """(arrays keyed by pytree path, extras) of a checkpoint, as numpy."""
    data = np.load(path)
    extra, arrays = {}, {}
    for key in data.files:
        if key.startswith("__extra__/"):
            extra[key[len("__extra__/"):]] = data[key]
        else:
            arrays[key] = data[key]
    return arrays, extra


def load_checkpoint(path: str, state_template: TrainState
                    ) -> Tuple[TrainState, dict]:
    """Restore a state of the template's structure; returns (state,
    extras)."""
    arrays, extra = load_raw(path)
    return state_from_arrays(arrays, state_template,
                             extra.get(GEN_STATE)), extra


def load_gaussian_model(path: str, device=None):
    """(model, voxel grid or None, extras) from a checkpoint, with no
    template: capacity and skinning layout come from the file. Non-finite
    slots are deactivated. A JAX checkpoint's brick table (an extra) has
    no counterpart here and is not read."""
    device = resolve_device(device)
    arrays, extra = load_raw(path)

    def find(suffix, dtype=torch.float32):
        for k, v in arrays.items():
            if k.endswith(suffix):
                return torch.tensor(v, dtype=dtype, device=device)
        return None

    model = GaussianModel(
        params=GaussianParams(*(find(f"params/.{name}")
                                for name in GaussianParams._fields)),
        active=find("model/.active", torch.bool),
        skin_weights=find("model/.skin_weights"),
    )
    voxel_grid = None
    if "vg_weights" in extra:
        def t(k):
            return torch.tensor(np.asarray(extra[k], np.float32), device=device)

        voxel_grid = VoxelGrid(center=t("vg_center"), scale=t("vg_scale"),
                               weights=t("vg_weights"))
    model, _ = scrub_nan_slots(model)
    return model, voxel_grid, extra


def scrub_nan_slots(model: GaussianModel):
    """Deactivate slots with a non-finite parameter (the reference's
    remove_nans_from_checkpoint). Returns (model, number of active slots
    deactivated, a 0-d tensor)."""
    bad = torch.zeros_like(model.active)
    for leaf in model.params:
        bad = bad | ~torch.isfinite(leaf.reshape(leaf.shape[0], -1)).all(-1)
    return model._replace(active=model.active & ~bad), (bad & model.active).sum()
