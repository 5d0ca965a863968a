"""The object's training step, counted: the per-gaussian stages of a
static cloud (no skinning, no voxel corners), the composite's
evaluations (counts/composite.py, on the reference's bins, which drop no
pair) and the image losses."""
from __future__ import annotations

from types import SimpleNamespace

import torch

from portbench.counts import composite as ccount
from portbench.counts import gaussians as gcount
from portbench.counts.peaks import least_s
from portbench.reference import frozen as fz
from portbench.reference import object_step as ref
from portbench.reference.hand_step import LEAVES


def step_bytes(live: int) -> float:
    """Bytes a step needs to move over the `live` gaussians (free slots
    need nothing): each leaf read forward and its gradient written,
    Adam's read of the parameter, its gradient and both moments and its
    write of the parameter and the moments."""
    return float(live * 4 * gcount.PARAM_FLOATS * (1 + 1 + 4 + 3))


@torch.no_grad()
def step_work(cfg: dict, scene: dict, params: dict, active, views,
              device) -> dict:
    """Least seconds of a step's parts on the card, the mean over `views`
    (a camera a step) on the state `params` (by leaf name) and `active`:
    the composite's evaluations forward and backward (the plain walk of
    the reference's payload), the per-gaussian stages over the live
    gaussians and the image losses; `evaluations` is the mean count, not
    a time."""
    d = cfg["dataset"]
    opts = SimpleNamespace(**cfg["model"])
    p = fz.GaussianParams(*(params[k] for k in LEAVES))
    bg = torch.zeros(3, device=device)
    fwd = bwd = evals = 0.0
    for v in views:
        cam = fz.make_camera(scene["K"][v], scene["extr"][v], d["width"],
                             d["height"], device=device)
        _, work = ref.render(p, active, cam, opts, bg)
        bins = work["bins"]
        n_eval = ccount.walk_counts(work["pay"], bins.tile_offsets,
                                    bins.tile_counts, work["ntx"])
        t_f, t_b = ccount.least_times(n_eval)
        fwd, bwd = fwd + t_f, bwd + t_b
        evals += float(n_eval.sum())
    n = max(len(views), 1)
    return dict(composite_fwd=fwd / n, composite_bwd=bwd / n,
                gaussians=least_s(nbytes=step_bytes(int(active.sum()))),
                image_losses=gcount.image_losses_least_s(d["height"],
                                                         d["width"]),
                evaluations=evals / n)
