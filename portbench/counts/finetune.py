"""The contact stage's fine-tune step, counted: the hand's per-gaussian
stages both ways and its Adam (counts/gaussians.py), the frozen object's
rows read once forward (no gradient, no update: its rows in the
program's backward are work the step does not need), the composite's
evaluations of the concatenated scene (counts/composite.py, on the
reference's bins, which drop no pair) and the image losses."""
from __future__ import annotations

import torch

from portbench.counts import composite as ccount
from portbench.counts import gaussians as gcount
from portbench.counts.peaks import least_s
from portbench.reference import composite_finetune as ref


@torch.no_grad()
def step_work(cfg: dict, scene: dict, hand: dict, h_active, views,
              device) -> dict:
    """Least seconds of a step's parts on the card, the mean over `views`
    ((frame, camera) a step) with the hand's leaves `hand` (by name) and
    the scene's object: the composite's evaluations forward and
    backward, the hand's stages, the object's forward read and the image
    losses; `evaluations` is the mean count, not a time."""
    d = cfg["dataset"]
    rig = ref.Rig(cfg, scene, device)
    obj = {k: x.to(device) for k, x in scene["obj"].items()}
    fwd = bwd = evals = 0.0
    for f, v in views:
        work = ref.view_payload(cfg, rig, obj, hand, h_active, f, v)
        bins = work["bins"]
        n_eval = ccount.walk_counts(work["pay"], bins.tile_offsets,
                                    bins.tile_counts, work["ntx"])
        t_f, t_b = ccount.least_times(n_eval)
        fwd, bwd = fwd + t_f, bwd + t_b
        evals += float(n_eval.sum())
    n = max(len(views), 1)
    n_obj = obj["xyz"].shape[0]
    return dict(composite_fwd=fwd / n, composite_bwd=bwd / n,
                gaussians=gcount.step_least_s(h_active.shape[0]),
                frozen_read=least_s(nbytes=4.0 * gcount.PARAM_FLOATS
                                    * n_obj),
                image_losses=gcount.image_losses_least_s(d["height"],
                                                         d["width"]),
                evaluations=evals / n)
