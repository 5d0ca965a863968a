"""Binning parity at the bench shape: JAX package vs PyTorch port, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_binning_parity.py

Builds bench.py's primary hand scene with the JAX package (65,536
gaussians, 512x512), projects its first view with both packages from the
same numpy inputs and bins it with the bench raster settings; prints
whether every projection and binning output is equal, and the overflow
counts. Takes about a minute.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench  # noqa: E402
from manus_tpu.ops.rasterizer.binning import bin_gaussians as j_bin  # noqa: E402
from manus_tpu.ops.rasterizer.projection import project_gaussians as j_project  # noqa: E402
from manus_tpu.train.workloads import forward_gaussians as j_forward  # noqa: E402
from manus_tpu.utils.camera import index_camera  # noqa: E402
from manus_tpu_torch.models.convert import camera_from_numpy  # noqa: E402
from manus_tpu_torch.ops.rasterizer.binning import bin_gaussians  # noqa: E402
from manus_tpu_torch.ops.rasterizer.projection import project_gaussians  # noqa: E402
from manus_tpu_torch.utils.camera import TENSOR_FIELDS  # noqa: E402

# bench.py's primary leg: 32x32 tiles, tg_max 64, lane 128, budget 2N,
# per-tile cap 4096, multi_frac 0.25
BIN_ARGS = (32, 32, 64, 128, 2, 4096, 0.25)


def main():
    t0 = time.time()
    _, state, batch, parts = bench.build_workload(
        "xla", 65536, 512, 512, 1, gt=jnp.zeros((1, 512, 512, 3)),
        return_parts=True)
    m = state.model
    posed, cov, _ = j_forward(m.params, m.active, m.skin_weights,
                              batch["bone_tf"], parts["cfg"].model)
    cam = index_camera(batch["cameras"], 0)
    jproj = j_project(posed, cov, cam, active=m.active)
    jbins = j_bin(jproj, *BIN_ARGS)
    print(f"jax: {time.time() - t0:.1f} s, overflow {int(jbins.overflow_count)}"
          f" of which far {int(jbins.overflow_far)}")

    tcam = camera_from_numpy(
        dict({f: np.asarray(getattr(cam, f)) for f in TENSOR_FIELDS},
             width=512, height=512), "cpu")
    tproj = project_gaussians(torch.tensor(np.asarray(posed)),
                              torch.tensor(np.asarray(cov)), tcam,
                              active=torch.tensor(np.asarray(m.active)))
    tbins = bin_gaussians(tproj, *BIN_ARGS)
    for name, ours, ref in (
            [(f, getattr(tproj, f), getattr(jproj, f))
             for f in ("radius", "tile_rect", "visible")]
            + [(f, getattr(tbins, f), getattr(jbins, f)) for f in jbins._fields]):
        print(f"{name} equal {np.array_equal(ours.numpy(), np.asarray(ref))}")
    print(f"port: overflow {int(tbins.overflow_count)} of which far "
          f"{int(tbins.overflow_far)}, visible {int(tproj.visible.sum())}, "
          f"pairs in segments {int(tbins.tile_counts.sum())}")


if __name__ == "__main__":
    main()
