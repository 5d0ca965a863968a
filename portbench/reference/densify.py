"""A plain densify-and-prune event under a fixed capacity, for the
benchmark's reference.

Written from the event's rule (the 3D Gaussian Splatting reference's
densify_and_clone, densify_and_split and prune, on a model of a fixed
number of slots of which `active` marks the live ones), not from the
port's code: it finds candidates and free slots with `nonzero` and
writes rows one index list at a time.

- A live slot whose mean viewspace gradient (accumulated norm over the
  number of views that saw it; 0 where none did, or where that is NaN)
  reaches the threshold is cloned when its largest scale is at most
  percent_dense * extent, and split otherwise.
- Children go to the free slots in slot order: first the clones, a slot
  each in the order of their parents; then the splits, two slots each,
  starting after as many slots as there were clone candidates. A child
  whose slot lies past the last free slot is dropped; a split is made
  only when both of its children find a slot, and then its parent dies.
- A clone copies its parent's row. A split child copies it too, but for
  its position, parent + R (eps * s), and its log-scale, log(s / 1.6).
- Then live slots are pruned whose opacity is under the minimum, whose
  scaling is not finite, and with the size rule also those whose
  largest screen radius so far exceeds size_threshold or whose largest
  scale exceeds a tenth of the extent.
- Adam's moments are zeroed on every slot a child was written to and on
  every slot whose liveness changed; the statistics start again at zero.
"""
from __future__ import annotations

import torch

from portbench.reference import frozen as fz


def densify(params: dict, active, stats: dict, m: dict, v: dict, opts,
            extent: float, noise, use_size_threshold: bool,
            dtype=torch.float32) -> dict:
    """The state after one event, from the state before it: `params`,
    `m`, `v` by leaf name, `stats` (grad_accum, denom, max_radii2d),
    `noise` [2, N, 3] the children's standard normals. `dtype` is the
    precision the children's positions and scales are worked out in.
    Returns params, m, v, stats, active and the counts."""
    cap = active.shape[0]
    denom = stats["denom"]
    grads = torch.zeros_like(denom)
    seen = denom > 0
    grads[seen] = stats["grad_accum"][seen] / denom[seen]
    grads[torch.isnan(grads)] = 0.0
    p = fz.GaussianParams(**params)
    scaling = fz.get_scaling(p, opts.isotropic_scaling)
    over = active & (grads >= opts.densify_grad_threshold)
    small = scaling.max(dim=1).values <= opts.percent_dense * extent
    clone_parents = torch.nonzero(over & small).flatten()
    split_parents = torch.nonzero(over & ~small).flatten()
    free = torch.nonzero(~active).flatten()
    n_free, n_clone = free.numel(), clone_parents.numel()

    out = {k: x.clone() for k, x in params.items()}
    written = torch.zeros_like(active)

    placed = clone_parents[:n_free]
    slots = free[:placed.numel()]
    for k in out:
        out[k][slots] = params[k][placed]
    written[slots] = True

    # the splits' slot pairs, after the clone candidates' slots
    first = n_clone + 2 * torch.arange(split_parents.numel(),
                                       device=active.device)
    fits = first + 1 < n_free
    parents = split_parents[fits]
    slot_a, slot_b = free[first[fits]], free[first[fits] + 1]
    s = scaling[parents].to(dtype)
    rot = fz.build_rotation(params["rotation"][parents]).to(dtype)
    child_scaling = torch.log(s / (0.8 * 2)).to(torch.float32)
    if params["scaling"].shape[1] == 1:
        child_scaling = child_scaling[:, :1]
    for eps, slots in zip(noise, (slot_a, slot_b)):
        offset = torch.einsum("nij,nj->ni", rot, eps[parents].to(dtype) * s)
        for k in out:
            out[k][slots] = params[k][parents]
        out["xyz"][slots] = (params["xyz"][parents].to(dtype)
                             + offset).to(torch.float32)
        out["scaling"][slots] = child_scaling
        written[slots] = True

    live = active | written
    live[parents] = False

    q = fz.GaussianParams(**out)
    prune = live & (fz.get_opacity(q)[:, 0] < opts.min_opacity_threshold)
    if use_size_threshold:
        big = ((stats["max_radii2d"] > opts.size_threshold)
               | (fz.get_scaling(q, opts.isotropic_scaling).max(dim=1).values
                  > 0.1 * extent))
        prune |= live & big
    prune |= live & ~torch.isfinite(out["scaling"]).all(dim=-1)
    live &= ~prune

    reset = written | (live != active)
    m_out, v_out = {}, {}
    for k in m:
        m_out[k], v_out[k] = m[k].clone(), v[k].clone()
        m_out[k][reset] = 0.0
        v_out[k][reset] = 0.0
    counts = dict(clones=placed.numel(), splits=parents.numel(),
                  pruned=int(prune.sum()),
                  alloc_dropped=(n_clone - placed.numel())
                  + (split_parents.numel() - parents.numel()),
                  num_active=int(live.sum()))
    return dict(params=out, m=m_out, v=v_out, active=live,
                stats={k: torch.zeros_like(x) for k, x in stats.items()},
                counts=counts)
