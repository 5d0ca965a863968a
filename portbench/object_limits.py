"""Readings that the object cell's limits are set from, at its own size.

    python3 portbench/object_limits.py --workload object_growth \
        --seeds 1,2,3 [--program] [--control] \
        [--faults tuned_raster,altered,half_batch,densify_skipped,\
init_neighbours,init_blockwise]

portbench/check_limits.py, with the object cell's control and more
faults:

--control  the reference in the program's place at the next precision
           down, against the reference: the initial cloud's distances
           from bfloat16 coordinates summed in float32, against the
           float64 rule; its steps with TF32 in their float32 matmuls and
           convolutions, on the first steps the Trainer's sampler draws
           from the seed; a densify event on the state those steps leave,
           every live slot a candidate, with the children's positions and
           scales in bfloat16;
--faults   besides those of portbench/faults.py: `tuned_raster`, the
           OBJ_GAUSSIAN preset's own raster settings (tg_max 64, a 2N pair
           budget, 4,096 pairs a tile, a quarter of N multi-tile), which
           drop pairs at the object's depth; `init_neighbours`, the
           initial scales from two neighbours in place of three;
           `init_blockwise`, each block of 4,096 initial points searched
           for neighbours among itself only.
One JSON line per reading. Needs a CUDA card.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import check_limits  # noqa: E402
from portbench import faults as faults_mod  # noqa: E402


def tuned_raster():
    """The train step bins with the preset's tuned raster settings in
    place of the cell's."""
    from manus_tpu_torch.train import workloads

    def make(fn):
        def tuned(cfg):
            return fn(cfg)._replace(tg_max=64, pair_budget_factor=2,
                                    max_pairs_per_tile=4096, multi_frac=0.25)
        return tuned

    return faults_mod._patched(workloads, "make_raster_config", make)


def init_neighbours():
    """init_gaussian_model's scales from the two nearest neighbours."""
    from manus_tpu_torch.models import gaussians

    def make(fn):
        def two(points, k=3, **kwargs):
            return fn(points, k=2, **kwargs)
        return two

    return faults_mod._patched(gaussians, "knn_self_distances", make)


def init_blockwise():
    """init_gaussian_model's neighbour search confined to each block of
    4,096 points (a block path that loses the other blocks' columns)."""
    import torch

    from manus_tpu_torch.models import gaussians

    def make(fn):
        def blockwise(points, k=3, block=4096):
            return torch.cat([fn(points[i:i + block], k=k)
                              for i in range(0, points.shape[0], block)])
        return blockwise

    return faults_mod._patched(gaussians, "knn_self_distances", make)


FAULTS = dict(faults_mod.FAULTS, tuned_raster=tuned_raster,
              init_neighbours=init_neighbours, init_blockwise=init_blockwise)


def control_reading(registry, workload: str, seed: int, device="cuda",
                    scale=None) -> dict:
    """The TF32 steps and the bfloat16 densify event against the plain
    float32 reference (see the module docstring); `scale` shrinks the
    cell as run.run_cell's does."""
    import numpy as np
    import torch

    from manus_tpu_torch.models.gaussians import init_gaussian_model
    from portbench import object_scene
    from portbench.drivers import common
    from portbench.drivers.object_train import init_gap
    from portbench.reference import densify as ref_densify
    from portbench.reference import object_step as ref

    w = registry.workload(workload)
    config, traffic = registry.config(w["config"]), registry.traffic(
        w["traffic"])
    cfg = common.config_as_run(config, traffic, scale or {})
    inputs = object_scene.build(cfg, config["scene"], seed, device)
    port_cfg = common.port_config(config["preset"], cfg, seed)
    model = init_gaussian_model(inputs["points"], inputs["colors"],
                                cfg["capacity"], opts=port_cfg.model,
                                device=device)
    inputs["init"] = dict(zip(common.LEAVES, model.params),
                          active=model.active)
    opts = SimpleNamespace(**cfg["model"])
    rule = [ref.init_cloud(inputs["points"], inputs["colors"],
                           cfg["capacity"], opts, device, **kw)
            for kw in ({}, dict(dtype=torch.float32,
                                operands=torch.bfloat16))]
    init = init_gap(rule[1], rule[0])
    del rule
    # the Trainer's own draw of a step's view (trainer.py sample_batch)
    rng = np.random.RandomState(seed % 2**32)
    batches = []
    for _ in range(traffic["check_steps"]):
        v = int(rng.randint(0, cfg["dataset"]["num_cameras"], size=1)[0])
        batches.append((v, *common.decode(inputs["images"][0, v])))
    t0 = time.perf_counter()
    reference = ref.run_steps(cfg, inputs, batches, device, tf32=False)
    t_ref = time.perf_counter() - t0
    control = ref.run_steps(cfg, inputs, batches, device, tf32=True)
    out = dict(init=init, **common.compare(control, reference,
                                           inputs["init"]))
    # the densify event on the reference's state after its steps, every
    # live slot over the threshold, so that every free slot is written
    params, active = reference["params"], reference["active"]
    stats = dict(grad_accum=2 * opts.densify_grad_threshold * active.float(),
                 denom=active.float(),
                 max_radii2d=torch.zeros_like(active, dtype=torch.float32))
    zeros = {k: torch.zeros_like(x) for k, x in params.items()}
    gen = torch.Generator(device=device).manual_seed(seed % (2**63 - 1))
    noise = torch.randn((2, cfg["capacity"], 3), generator=gen,
                        device=device)
    events = [ref_densify.densify(params, active, stats, zeros, zeros, opts,
                                  inputs["extent"], noise, False,
                                  dtype=dtype)
              for dtype in (torch.float32, torch.bfloat16)]
    before = dict(params=params, m=zeros, v=zeros, stats=stats)
    out.update(common.compare_densify(events[1], events[0], before))
    return dict(kind="control", seed=seed, reference_s=t_ref, **out)


def main(argv=None) -> int:
    check_limits.CONTROLS["object_train"] = control_reading
    faults_mod.FAULTS.update(FAULTS)
    return check_limits.main(argv)


if __name__ == "__main__":
    sys.exit(main())
