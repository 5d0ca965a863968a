"""Parity of the port's sharded training (manus_tpu_torch/parallel/, the
gauss-sharded render, the mesh branch of make_train_step) with the JAX
package's shard_map step, on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py. The
port side runs in one world of WORLD gloo ranks, started once for the
module with torch.multiprocessing.spawn (one torch thread each; the
ranks are tests/torch_parallel_worker.py); every mesh shape of CASES is
made in that world from sub-groups. Both start from the same numpy
scene and model (test_torch_train_step's), so the steps see the same
inputs.

Tolerances are tests/test_sharding.py's: the loss within rtol 1e-5, the
opacity, xyz and scaling leaves within 1e-5 of the leaf's largest value,
grad_accum within 1e-5, the overflow counts equal.
"""
import dataclasses
import os
import pickle
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from manus_tpu import config as jconfig
from manus_tpu.ops.rasterizer import pallas_backend
from manus_tpu.ops.rasterizer.binning import bin_gaussians as j_bin
from manus_tpu.ops.rasterizer.binning import tile_owner_tables as j_tables
from manus_tpu.ops.rasterizer.projection import project_gaussians as j_project
from manus_tpu.parallel import mesh as jmesh
from manus_tpu.train import workloads as jwork
from manus_tpu_torch import config as tconfig
from manus_tpu_torch.ops.rasterizer import composite
from manus_tpu_torch.ops.rasterizer.binning import bin_gaussians
from manus_tpu_torch.ops.rasterizer.binning import tile_owner_tables
from manus_tpu_torch.ops.rasterizer.projection import project_gaussians
from manus_tpu_torch.parallel import mesh as tmesh
from manus_tpu_torch.parallel.distributed import process_local_batch_indices
from manus_tpu_torch.train import workloads as twork
from manus_tpu_torch.utils.camera import TENSOR_FIELDS
from tests import torch_parallel_worker as worker
from tests.test_torch_raster import (
    T,
    _jax_payload,
    assert_close_normalised,
    port_camera,
)
from tests.test_torch_train_step import (
    _cfg,
    _jax_step,
    _port_batch,
    _port_state,
    _scene,
)
from tests.utils import make_test_camera, random_scene

WORLD = 4
# (name, n_data, n_gauss, tile_shard_mode, remove_seg_end): one step each.
# remove_seg_end 0 with a far skeleton threshold prunes nothing, so the
# densify statistics accumulate; 2 runs the mask prune of the batch's
# first view, which the data group's first rank holds.
CASES = [
    ("data2", 2, 1, "owner", 0),
    ("data2_gauss2_owner", 2, 2, "owner", 0),
    ("gauss4_owner", 1, 4, "owner", 0),
    ("gauss4_pairslice", 1, 4, "pairslice", 0),
    ("gauss4_hybrid", 1, 4, "hybrid", 0),
    ("data2_mask_prune", 2, 1, "owner", 2),
]
HOT_SPLIT_TILES = 4
FAR = 10.0  # a skeleton-distance threshold no slot exceeds
BIN_SCENE = dict(n=300, seed=5, scale_range=(0.08, 0.25))
BIN_KW = dict(tg_max=64, pair_budget_factor=1, max_pairs_per_tile=12)


def _config(pkg, backend, mode, remove_seg_end):
    """test_torch_train_step's config with the pair budget at 8N, which
    this scene does not fill, and a per-tile cap of 128 pairs, which drops
    836 of them. An owner keeps 1.5x its share of the budget (JAX's
    binning rule), so where the budget bites the owner-mode step is
    another function than the unsharded one, in both packages; the cap
    drops the same pairs in every mode."""
    cfg = _cfg(pkg, backend, remove_seg_end, skeleton_dist_threshold=FAR)
    cfg.raster = dataclasses.replace(cfg.raster, tile_shard_mode=mode,
                                     hot_split_tiles=HOT_SPLIT_TILES,
                                     pair_budget_factor=8,
                                     max_pairs_per_tile=128)
    return cfg


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _numpy_batch(jbatch):
    cams = jbatch["cameras"]
    b = {k: np.asarray(v) for k, v in jbatch.items() if k != "cameras"}
    b["cameras"] = dict({f: np.asarray(getattr(cams, f))
                         for f in TENSOR_FIELDS},
                        width=cams.width, height=cams.height)
    return b


@pytest.fixture(scope="module")
def setup():
    """The scene, the JAX init state and batch, and what the port's
    world gave for every case (a dict case -> [per-rank arrays])."""
    sc = _scene()
    _, jstate, jbatch = _jax_step(sc, 0)
    # the mask prune's batch: the keypoint guard holds the palm's two
    jbatches = {0: jbatch, 2: _jax_step(sc, 2)[2]}
    m = jstate.model
    model = dict(jax.tree.map(np.asarray, m.params)._asdict(),
                 active=np.asarray(m.active),
                 skin_weights=np.asarray(m.skin_weights))
    s = random_scene(**BIN_SCENE)
    cam = make_test_camera(64, 64)
    cam_np = dict({f: np.asarray(getattr(cam, f)) for f in TENSOR_FIELDS},
                  width=cam.width, height=cam.height)
    job = dict(
        model=model,
        cases=[(name, d, g, _config(tconfig, "torch", mode, rse),
                _numpy_batch(jbatches[rse]))
               for name, d, g, mode, rse in CASES],
        bin_scene=dict(means=s["means"], cov6=s["cov6"], camera=cam_np,
                       ntx=4, nty=4, kw=BIN_KW))
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                       f"torch_parallel_{os.getpid()}")
    os.makedirs(out, exist_ok=True)
    job_path = os.path.join(out, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    mp.spawn(worker.run, args=(WORLD, _free_port(), job_path, out),
             nprocs=WORLD, join=True)
    ranks = {}
    for name, d, g, *_ in CASES:
        ranks[name] = [dict(np.load(os.path.join(out, f"{name}_{r}.npz")))
                       for r in range(d * g)]
    ranks["bins"] = [dict(np.load(os.path.join(out, f"bins_{r}.npz")))
                     for r in range(WORLD)]
    return dict(sc=sc, jstate=jstate, jbatches=jbatches, ranks=ranks,
                scene=s, cam=cam)


def _jax_sharded(setup, n_data, n_gauss, mode, remove_seg_end):
    cfg = _config(jconfig, "xla", mode, remove_seg_end)
    mesh = jmesh.make_mesh(n_data=n_data, n_gauss=n_gauss)
    step = jwork.make_train_step(cfg, 1.0, articulated=True, mesh=mesh)
    with mesh:
        state = jmesh.replicate_state(setup["jstate"], mesh)
        batch = jmesh.shard_batch(setup["jbatches"][remove_seg_end], mesh)
        return step(state, batch)


def _port_single(setup, mode, remove_seg_end):
    cfg = _config(tconfig, "torch", mode, remove_seg_end)
    step = twork.make_train_step(cfg, 1.0, articulated=True)
    return step(_port_state(setup["jstate"]),
                _port_batch(setup["jbatches"][remove_seg_end]))


def _param_close(got, want, what):
    """Within 1e-5 of the leaf's largest value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / (np.abs(want).max() + 1e-8)
    assert (err <= 1e-5).all(), f"{what}: max normalised err {err.max()}"


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_step_matches_jax(setup, case):
    """The port's sharded step on every rank against JAX's shard_map step
    on the same mesh shape, and every rank holding the same state."""
    name, n_data, n_gauss, mode, rse = case
    ranks = setup["ranks"][name]
    for r in ranks[1:]:
        for k in ranks[0]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    got = ranks[0]
    jstate, jm = _jax_sharded(setup, n_data, n_gauss, mode, rse)
    np.testing.assert_allclose(float(got["metrics/loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for name_ in ("opacity", "xyz", "scaling"):
        _param_close(got[f"params/{name_}"],
                     getattr(jstate.model.params, name_), f"{name}: {name_}")
    np.testing.assert_allclose(got["stats/grad_accum"],
                               np.asarray(jstate.stats.grad_accum), atol=1e-5)
    np.testing.assert_array_equal(got["active"], np.asarray(jstate.model.active))
    for k in ("pair_overflow", "pair_overflow_far", "num_active",
              "mask_pruned", "max_radius"):
        assert int(got[f"metrics/{k}"]) == int(jm[k]), k
    assert int(jm["pair_overflow_far"]) > 0
    if rse:
        assert int(jm["mask_pruned"]) > 0
    else:
        assert np.abs(got["stats/grad_accum"]).max() > 0


@pytest.mark.parametrize("case", [c for c in CASES if c[3] == "owner"],
                         ids=[c[0] for c in CASES if c[3] == "owner"])
def test_sharded_step_matches_single_process(setup, case):
    """Owner mode and the data axis against the port's own step on one
    process: the same function, with nothing left out."""
    name, _, _, mode, rse = case
    got = setup["ranks"][name][0]
    tstate, tm = _port_single(setup, mode, rse)
    np.testing.assert_allclose(float(got["metrics/loss"]), float(tm["loss"]),
                               rtol=1e-5)
    for name_ in ("opacity", "xyz", "scaling"):
        _param_close(got[f"params/{name_}"],
                     getattr(tstate.model.params, name_).numpy(),
                     f"{name}: {name_}")
    np.testing.assert_allclose(got["stats/grad_accum"],
                               tstate.stats.grad_accum.numpy(), atol=1e-5)
    assert int(got["metrics/pair_overflow"]) == int(tm["pair_overflow"])


@pytest.mark.parametrize("grid,n", [((4, 4), 2), ((4, 4), 4), ((32, 32), 4),
                                    ((80, 45), 4), ((7, 6), 3), ((80, 45), 8)])
def test_tile_owner_tables_match_jax(grid, n):
    got = tile_owner_tables(*grid, n)
    want = j_tables(*grid, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    owner, rank, owned, perm = got
    assert sorted(perm.tolist()) == list(range(grid[0] * grid[1]))
    np.testing.assert_array_equal(owned.reshape(-1)[perm],
                                  np.arange(grid[0] * grid[1]))


def _jax_owner_bins(proj, ntx, nty, n, kw):
    mesh = jmesh.make_mesh(n_data=1, n_gauss=n)

    def col(p):
        b = j_bin(p, ntx, nty, tile_owner_axis=jmesh.GAUSS_AXIS,
                  num_owners=n, **kw)
        return jax.tree.map(lambda x: x[None], b)

    return jax.jit(shard_map(col, mesh=mesh, in_specs=(P(),),
                             out_specs=P(jmesh.GAUSS_AXIS),
                             check_vma=False))(proj)


@pytest.mark.parametrize("n,scene,kw", [
    (2, dict(n=300, seed=0), dict(tg_max=64)),
    (4, dict(n=300, seed=5, scale_range=(0.08, 0.25)),
     dict(tg_max=64, pair_budget_factor=1, max_pairs_per_tile=12)),
    (4, dict(n=300, seed=7, scale_range=(0.05, 0.2)),
     dict(tg_max=3, pair_budget_factor=0, max_pairs_per_tile=0)),
], ids=["n2", "n4_budget_cap", "n4_trunc"])
def test_owner_binning_matches_jax(n, scene, kw):
    """Owner-mode binning per owner against JAX's per mesh column: the
    pair array and the local segments integer for integer. Without a
    group the drops are the owner's own; they add up to JAX's totals."""
    cam = make_test_camera(64, 64)
    s = random_scene(**scene)
    want = _jax_owner_bins(
        j_project(jnp.asarray(s["means"]), jnp.asarray(s["cov6"]), cam),
        4, 4, n, kw)
    tproj = project_gaussians(T(s["means"]), T(s["cov6"]), port_camera(cam))
    far = 0
    for c in range(n):
        got = bin_gaussians(tproj, 4, 4, owner=c, num_owners=n, **kw)
        for field in ("pair_src", "tile_offsets", "tile_counts"):
            np.testing.assert_array_equal(
                getattr(got, field).numpy(),
                np.asarray(getattr(want, field))[c], f"owner {c} {field}")
        far += int(got.overflow_far)
    assert far == int(np.asarray(want.overflow_far)[0])


def test_owner_binning_over_the_group_matches_jax(setup):
    """The world's ranks binning as owners over their gauss group: every
    field of each rank's bins, the drop totals summed over the group
    included, equal to JAX's column, and the budget and cap bite."""
    s, cam = setup["scene"], setup["cam"]
    want = _jax_owner_bins(
        j_project(jnp.asarray(s["means"]), jnp.asarray(s["cov6"]), cam),
        4, 4, WORLD, BIN_KW)
    for c, got in enumerate(setup["ranks"]["bins"]):
        for field in want._fields:
            np.testing.assert_array_equal(
                got[field], np.asarray(getattr(want, field))[c],
                f"rank {c} {field}")
    assert int(np.asarray(want.overflow_far)[0]) > 0


def _slots(bins, ntx, nty, n, col, hybrid):
    """(offsets, counts, tile ids) of one column: its dealt tiles, and in
    hybrid form the HOT_SPLIT_TILES deepest tiles' depth ranges for the
    column (api.py's rule; top_k ties to the lower id)."""
    offs = np.asarray(bins.tile_offsets)
    cnts = np.asarray(bins.tile_counts)
    owned = tile_owner_tables(ntx, nty, n)[2][col]
    o, c, ids = offs[owned], cnts[owned].copy(), owned
    if hybrid:
        hot = np.argsort(-cnts, kind="stable")[:HOT_SPLIT_TILES]
        share = -(-cnts[hot] // n)
        lo = offs[hot] + np.minimum(col * share, cnts[hot])
        hi = offs[hot] + np.minimum((col + 1) * share, cnts[hot])
        c[np.isin(owned, hot)] = 0
        o, c = np.concatenate([o, lo]), np.concatenate([c, hi - lo])
        ids = np.concatenate([owned, hot])
    return (o.astype(np.int32), c.astype(np.int32), ids.astype(np.int32))


@pytest.mark.parametrize("hybrid", [False, True], ids=["owner", "hybrid"])
def test_tile_id_composite_matches_pallas_interpret(hybrid):
    """The plain composite on a subset of the 64x64 grid (one owner
    column's tiles of four, and that column's hybrid slots) against the
    Pallas kernel in interpret mode with the same tile_ids, forward and
    VJP; and the plain model of the kernels' depth-chunk split (its
    forward and backward) on the same slots. Tolerance: normalised max
    abs 1e-4, test_plain_composite_matches_pallas_interpret's."""
    cam = make_test_camera(64, 64)
    s = random_scene(400, seed=3)
    pay, bins = _jax_payload(s, cam)
    for col in (1, 2):
        offs, cnts, ids = _slots(bins, 4, 4, 4, col, hybrid)
        assert cnts.sum() > 0
        rng = np.random.RandomState(col)
        d_rgb = rng.normal(size=(ids.shape[0], 3, 256)).astype(np.float32)
        d_tf = rng.normal(size=(ids.shape[0], 256)).astype(np.float32)
        (rgb_j, tf_j), vjp = jax.vjp(
            lambda p: pallas_backend.composite_tiles_pallas(
                p, jnp.asarray(offs), jnp.asarray(cnts), 4, 4, tile=16,
                chunk=64, interpret=True, tile_ids=jnp.asarray(ids)), pay)
        (dpay_j,) = vjp((jnp.asarray(d_rgb), jnp.asarray(d_tf)))

        tpay = T(pay).requires_grad_(True)
        args = (T(offs, torch.int32), T(cnts, torch.int32), 4, 4)
        rgb_t, tf_t = composite.composite_tiles(tpay, *args, chunk=64,
                                                tile_ids=T(ids, torch.int32))
        (dpay_t,) = torch.autograd.grad([rgb_t, tf_t], [tpay],
                                        [T(d_rgb), T(d_tf)])
        assert_close_normalised(rgb_j, rgb_t.detach(), 1e-4, "rgb")
        assert_close_normalised(1 - np.asarray(tf_j), 1 - tf_t.detach(),
                                1e-4, "t_final")
        assert_close_normalised(dpay_j, dpay_t, 1e-4, "d_payload")

        fwd = composite.composite_tiles_split_torch(
            T(pay), *args, chunk=32, tile_ids=T(ids, torch.int32))
        assert_close_normalised(rgb_j, fwd[0], 1e-4, "split rgb")
        d_split = composite.composite_split_backward_torch(
            T(pay), *args, 32, T(d_rgb), T(d_tf), *fwd[1:],
            tile_ids=T(ids, torch.int32))
        assert_close_normalised(dpay_j, d_split, 1e-4, "split d_payload")


def test_view_rows_and_local_indices():
    """A rank's views are its data row's contiguous block (P("data")):
    the rows of a 4 x 2 mesh are disjoint and cover the batch."""
    seen = []
    for d in range(4):
        m = tmesh.Mesh(np.arange(8).reshape(4, 2), 2 * d, d, 0)
        idx = process_local_batch_indices(8, m)
        np.testing.assert_array_equal(idx, np.arange(2 * d, 2 * d + 2))
        seen += idx.tolist()
    assert sorted(seen) == list(range(8))
