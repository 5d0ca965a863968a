"""The OBJ_GAUSSIAN step of the port against the benchmark's plain
reference (portbench/reference/object_step.py, densify.py), at 4,096
slots, 96x64 and three cameras on the CPU: the loss, every leaf's
gradient and Adam update over three steps; the initial cloud against
the published rule; a densify event with free slots; the port's
uncapped binning against the reference's, pair for pair; and a tile
more than 8 chunks of 128 pairs deep through the model of the CUDA
kernels (and, on the card, the kernels), forward and backward. No JAX here: the card's case runs in this file too.

Tolerances, each with its reason:
- the step, 1e-6 of a quantity's scale (the loss; a leaf's largest
  gradient or update): the port's CPU path and the reference run the
  same float32 operations in the same order but for their binning code,
  which gives the same pairs, so they agree to rounding; bfloat16 (8
  bits) would miss by ~1e-3 and TF32 (10 bits, in the composite's and
  SSIM's matmuls) by ~1e-4;
- the densify event: the slots exactly; the rows to 1e-6 of the leaf
  (the children's offsets are the same products summed in another
  order); bfloat16 positions miss by ~1e-3;
- the initial cloud: ops/knn.py's bound on float32 squared distances,
  carried to the log-scale (the test says how); bfloat16 coordinates
  and two neighbours in place of three fail it;
- binning: exact (integers);
- the deep tile: values 1e-5 max abs and gradients 1e-4 of the field's
  largest (the chunked walk sums the same float32 terms in another
  order, tests/test_torch_composite_split.py's bounds); on the card the
  same, the kernels' float32 against the plain version.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from manus_tpu_torch.models.gaussians import init_gaussian_model
from manus_tpu_torch.ops.rasterizer import composite
from manus_tpu_torch.ops.rasterizer.binning import bin_gaussians
from manus_tpu_torch.ops.rasterizer.payload import NUM_LIVE
from manus_tpu_torch.ops.rasterizer.projection import project_gaussians
from manus_tpu_torch.train import workloads
from manus_tpu_torch.train.optim import BETA1
from manus_tpu_torch.utils.camera import index_camera, make_camera, \
    stack_cameras
from portbench import object_limits, object_scene
from portbench.drivers import common, object_train
from portbench.reference import densify as ref_densify
from portbench.reference import frozen as fz
from portbench.reference import object_step as ref
from portbench.registry import Registry

SEED = 2**31 + 23
SCALE = {"capacity": 4096, "dataset.width": 96, "dataset.height": 64,
         "dataset.num_cameras": 3, "dataset.sample_size": 1500}
LEAVES = common.LEAVES


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cell():
    """The object_growth cell as run, shrunk: the configuration dict, the
    port's config (the plain composite on the CPU), the inputs with the
    initial cloud the port's init_gaussian_model makes, and the
    cameras."""
    reg = Registry()
    w = reg.workload("object_growth")
    config = reg.config(w["config"])
    cfg_dict = common.config_as_run(config, reg.traffic(w["traffic"]), SCALE)
    cfg = common.port_config(config["preset"], cfg_dict, SEED)
    cfg.raster.backend = "torch"
    inputs = object_scene.build(cfg_dict, config["scene"], SEED, "cpu")
    model = init_gaussian_model(inputs["points"], inputs["colors"],
                                cfg.capacity, opts=cfg.model, device="cpu")
    inputs["init"] = dict(zip(LEAVES, model.params), active=model.active)
    d = cfg_dict["dataset"]
    cams = stack_cameras([make_camera(k, e, d["width"], d["height"],
                                      device="cpu")
                          for k, e in zip(inputs["K"], inputs["extr"])])
    return cfg_dict, cfg, inputs, model, cams


def _batch(inputs, cams, v):
    rgb, mask = common.decode(inputs["images"][0, [v]])
    return dict(rgb=torch.as_tensor(rgb), mask=torch.as_tensor(mask),
                cameras=index_camera(cams, torch.tensor([v])),
                bg=torch.zeros(3))


VIEWS = (2, 0, 1)


@pytest.fixture(scope="module")
def port_steps(cell):
    """Three steps of the port's object step: each step's loss, state and
    Adam's first moment."""
    cfg_dict, cfg, inputs, model, cams = cell
    step = workloads.make_train_step(cfg, inputs["extent"], False)
    state = workloads.init_train_state(model, seed=7)
    out = []
    for v in VIEWS:
        state, metrics = step(state, _batch(inputs, cams, v))
        out.append((float(metrics["loss"]), state))
    return out


def _reference(cell, n):
    cfg_dict, _, inputs, _, _ = cell
    batches = []
    for v in VIEWS[:n]:
        rgb, mask = common.decode(inputs["images"][0, v])
        batches.append((v, rgb, mask))
    return ref.run_steps(cfg_dict, inputs, batches, device="cpu")


def _close(got, want, tol, what):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * max(scale, 1e-30), f"{what}: {err} of {scale}"


def test_the_step_matches_the_reference(cell, port_steps):
    """The loss of each of three steps, each leaf's first gradient (as
    Adam's first moment holds it) and each step's Adam update of each
    leaf."""
    init = cell[2]["init"]
    prev = {k: init[k] for k in LEAVES}
    for n in range(1, 4):
        want = _reference(cell, n)
        loss, state = port_steps[n - 1]
        assert abs(loss - want["losses"][-1]) <= 1e-6 * abs(
            want["losses"][-1]), n
        got = dict(zip(LEAVES, state.model.params))
        if n == 1:
            for k, m in zip(LEAVES, state.opt.m):
                _close(m / (1 - BETA1), want["grad1"][k], 1e-6,
                       f"gradient of {k}")
        for k in LEAVES:
            moved = want["params"][k] - prev[k]
            # xyz never moves (spatial_lr_scale 0), nor the rotations of
            # the initial cloud's round gaussians (no gradient)
            if k not in ("xyz", "rotation"):
                assert moved.abs().max() > 0, k
            _close(got[k] - prev[k], moved, 1e-6, f"step {n} update of {k}")
        assert torch.equal(state.model.active, want["active"])
        prev = {k: want["params"][k] for k in LEAVES}


def test_a_densify_event_with_free_slots_matches_the_reference(cell,
                                                               port_steps):
    """The port's event on the state three steps left (its statistics
    from those steps), against the plain event with the same split noise:
    children written into free slots, and with every free slot taken,
    the rest dropped."""
    cfg_dict, cfg, inputs, _, _ = cell
    state = port_steps[-1][1]
    densify_step, _ = workloads.make_densify_step(cfg, inputs["extent"])
    state.gen.manual_seed(11)
    after, info = densify_step(state)
    noise = torch.randn((2, cfg.capacity, 3),
                        generator=torch.Generator().manual_seed(11))

    def parts(s):
        return dict(params=dict(zip(LEAVES, s.model.params)),
                    m=dict(zip(LEAVES, s.opt.m)),
                    v=dict(zip(LEAVES, s.opt.v)),
                    stats={k: getattr(s.stats, k) for k in
                           ("grad_accum", "denom", "max_radii2d")})

    before = parts(state)
    opts = cfg.model
    want = ref_densify.densify(before["params"], state.model.active,
                               before["stats"], before["m"], before["v"],
                               opts, inputs["extent"], noise,
                               use_size_threshold=False)
    got = dict(parts(after), active=after.model.active,
               counts={k: int(x) for k, x in info.items()})
    cmp = common.compare_densify(got, want, before)
    assert cmp["densify_slots"] == 0
    assert cmp["densify_state"] <= 1e-6
    n_live = int(state.model.active.sum())
    assert int(info["splits"]) > 0 and int(info["alloc_dropped"]) > 0
    assert int(info["num_active"]) > n_live


@pytest.mark.parametrize("variant", ["program", "two_neighbours",
                                     "bfloat16_coordinates"])
def test_the_initial_cloud_follows_the_published_rule(cell, variant):
    """The port's init_gaussian_model against the reference's init_cloud
    (float64), as a run compares them (`init`): the port passes; its
    scales from two neighbours, and the rule from bfloat16 coordinates,
    fail. The bound is ops/knn.py's: float32 squared distances lie within
    8 u (|x| + |y|)^2 of the exact, so the log of the root of their mean
    within half that over the least mean; the other leaves are one
    float32 rounding of the same arithmetic."""
    cfg_dict, cfg, inputs, model, _ = cell
    opts = SimpleNamespace(**cfg_dict["model"])
    rule = ref.init_cloud(inputs["points"], inputs["colors"], cfg.capacity,
                          opts, "cpu")
    if variant == "program":
        got = dict(inputs["init"])
    elif variant == "two_neighbours":
        with object_limits.FAULTS["init_neighbours"]():
            m = init_gaussian_model(inputs["points"], inputs["colors"],
                                    cfg.capacity, opts=cfg.model,
                                    device="cpu")
        got = dict(zip(LEAVES, m.params), active=m.active)
    else:
        got = ref.init_cloud(inputs["points"], inputs["colors"],
                             cfg.capacity, opts, "cpu",
                             dtype=torch.float32, operands=torch.bfloat16)
    live = rule["active"]
    reach = 2 * float(torch.as_tensor(inputs["points"]).norm(dim=1).max())
    least = float(torch.exp(2 * rule["scaling"][live]).min())
    bound = 0.5 * 8 * 2.0**-24 * reach**2 / least + 1e-6
    gap = object_train.init_gap(got, rule)
    assert (gap <= bound) == (variant == "program"), (gap, bound)


def _object_proj(cell, v=0):
    _, _, inputs, model, cams = cell
    cov = fz.get_covariance(fz.GaussianParams(*model.params))
    return project_gaussians(model.params.xyz, cov, index_camera(cams, v),
                             active=model.active)


def _big_rects_proj():
    """Gaussians of up to a third of a 256x256 image across, about the
    camera's axis: rects far past 64 tiles."""
    gen = torch.Generator().manual_seed(3)
    n = 400
    xyz = torch.rand(n, 3, generator=gen) - 0.5
    xyz[:, 2] += 3.0
    s = torch.exp(torch.empty(n, 3).uniform_(-4.5, -1.2, generator=gen))
    q = torch.randn(n, 4, generator=gen)
    params = fz.GaussianParams(xyz, torch.zeros(n, 1, 3),
                               torch.zeros(n, 15, 3), torch.log(s), q,
                               torch.zeros(n, 1))
    K = np.array([[200.0, 0, 127.5], [0, 200.0, 127.5], [0, 0, 1]])
    extr = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    cam = make_camera(K, extr, 256, 256, device="cpu")
    return project_gaussians(xyz, fz.get_covariance(params), cam)


@pytest.mark.parametrize("scene,tg_max,multi_frac,budget,cap", [
    ("object", 0, 0.25, 1, 16), ("big_rects", 0, 0.25, 1, 16),
    ("big_rects", 256, 1.0, 0, 0)],
    ids=["object_uncapped", "big_rects_uncapped", "tiers_that_keep_all"])
def test_uncapped_binning_gives_the_references_pairs(cell, scene, tg_max,
                                                     multi_frac, budget,
                                                     cap):
    """The port's binning keeps the reference's pairs in the reference's
    order: with tg_max 0 whatever the budget, the per-tile cap and
    multi_frac say (here they would drop pairs under tg_max 64), and
    through the static tiers with no budget and no cap where the tiers'
    capacities admit every pair."""
    if scene == "object":
        proj, ntx, nty = _object_proj(cell), 6, 4
    else:
        proj, ntx, nty = _big_rects_proj(), 16, 16
    got = bin_gaussians(proj, ntx, nty, tg_max, pair_budget_factor=budget,
                        max_pairs_per_tile=cap, multi_frac=multi_frac)
    if tg_max == 0:
        tuned = bin_gaussians(proj, ntx, nty, 64, pair_budget_factor=budget,
                              max_pairs_per_tile=cap, multi_frac=multi_frac)
        assert int(tuned.overflow_count) > 0
    want = ref.bin_all_pairs(proj, ntx, nty)
    p = want.pair_src.shape[0]
    assert p > 4 * int(proj.visible.sum()) or scene == "object"
    assert torch.equal(got.pair_src[:p], want.pair_src)
    assert bool((got.pair_src[p:] == -1).all())
    assert torch.equal(got.tile_offsets, want.tile_offsets)
    assert torch.equal(got.tile_counts, want.tile_counts)
    assert int(got.overflow_count) == 0 and int(got.overflow_far) == 0
    if scene == "big_rects":
        rect = proj.tile_rect
        cells = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
        assert int(cells[proj.visible].max()) > 64


def _deep_tile(depth: int, device):
    """A payload of `depth` pairs in tile 0 of a 2x2 grid (and a few in
    the others), from the reference's bins of a cluster of gaussians over
    that tile: low opacity, so that pixels stop at many depths past the
    eighth chunk of 128."""
    gen = torch.Generator().manual_seed(5)
    xy = torch.rand(depth, 2, generator=gen) * 14 + 1
    means2d = torch.cat([xy, torch.rand(12, 2, generator=gen) * 32])
    n = means2d.shape[0]
    sig = 2 + 3 * torch.rand(n, generator=gen)
    conic = torch.stack([1 / sig ** 2, torch.zeros(n), 1 / sig ** 2], 1)
    depth_z = 1 + torch.rand(n, generator=gen)
    x0 = (means2d[:, 0] - 3 * sig).div(16).floor().clamp(0, 2)
    y0 = (means2d[:, 1] - 3 * sig).div(16).floor().clamp(0, 2)
    x1 = (means2d[:, 0] + 3 * sig + 15).div(16).floor().clamp(0, 2)
    y1 = (means2d[:, 1] + 3 * sig + 15).div(16).floor().clamp(0, 2)
    rect = torch.stack([x0, y0, x1, y1], 1).to(torch.int32)
    proj = fz.ProjectedGaussians(
        means2d=means2d, conic=conic, depth=depth_z,
        radius=(3 * sig).ceil().to(torch.int32), tile_rect=rect,
        visible=torch.ones(n, dtype=torch.bool))
    bins = ref.bin_all_pairs(proj, 2, 2)
    colors = torch.rand(n, 3, generator=gen)
    opacity = 0.01 + 0.02 * torch.rand(n, generator=gen)
    pay = fz.build_payload(proj, colors, opacity, bins)
    return (pay.to(device), bins.tile_offsets.to(device),
            bins.tile_counts.to(device))


def _plain(pay, offs, cnts, d_rgb, d_tfin):
    pay = pay.detach().clone().requires_grad_(True)
    rgb, tfin = fz.composite_tiles_torch(pay, offs, cnts, 2, 2)
    (d_pay,) = torch.autograd.grad([rgb, tfin], [pay], [d_rgb, d_tfin])
    return rgb.detach(), tfin.detach(), d_pay


def _check(rgb, tfin, d_pay, want):
    rgb_w, tfin_w, d_w = want
    assert float((rgb - rgb_w).abs().max()) <= 1e-5
    assert float((tfin - tfin_w).abs().max()) <= 1e-5
    for f in range(NUM_LIVE):
        scale = float(d_w[f].abs().max())
        assert scale > 0, f
        assert float((d_pay[f] - d_w[f]).abs().max()) <= 1e-4 * scale, f


def _cotangents(device):
    gen = torch.Generator().manual_seed(8)
    return (torch.randn(4, 3, 256, generator=gen).to(device),
            torch.randn(4, 256, generator=gen).to(device))


def test_a_tile_deeper_than_8_chunks_in_the_kernels_model():
    """composite_tiles_split_torch and its backward (the CUDA kernels'
    design, chunks of the kernels' 128 pairs) on a tile of 3,000 pairs,
    against the reference's plain composite and its autograd; the pixels
    stop in several chunks past the eighth."""
    pay, offs, cnts = _deep_tile(3000, "cpu")
    assert int(cnts[0]) > 8 * 128
    d_rgb, d_tfin = _cotangents("cpu")
    want = _plain(pay, offs, cnts, d_rgb, d_tfin)
    rgb, tfin, log_t, n_walk, state = composite.composite_tiles_split_torch(
        pay, offs, cnts, 2, 2, chunk=128)
    stop_chunks = set(((n_walk[0] - 1) // 128).tolist())
    assert len({c for c in stop_chunks if c >= 8}) >= 3
    d_pay = composite.composite_split_backward_torch(
        pay, offs, cnts, 2, 2, 128, d_rgb, d_tfin, tfin, log_t, n_walk,
        state)
    _check(rgb, tfin, d_pay, want)


@pytest.mark.cuda
def test_a_tile_deeper_than_8_chunks_on_the_card():
    """The CUDA kernels on a tile of 8,000 pairs (the object's depth),
    against the reference's plain composite and its autograd."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    pay, offs, cnts = _deep_tile(8000, "cuda")
    d_rgb, d_tfin = _cotangents("cuda")
    with ref.precision(False):
        want = _plain(pay, offs, cnts, d_rgb, d_tfin)
    p = pay.detach().clone().requires_grad_(True)
    rgb, tfin = composite.CompositeFn.apply(p, offs, cnts, 2, 2)
    (d_pay,) = torch.autograd.grad([rgb, tfin], [p], [d_rgb, d_tfin])
    _check(rgb.detach(), tfin.detach(), d_pay, want)
