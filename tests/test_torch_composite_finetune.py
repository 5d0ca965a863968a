"""The contact stage's hand fine-tune of the port against the benchmark's
plain reference (portbench/reference/composite_finetune.py), on the CPU
at a 1,024-slot hand and a 4,096-slot object, 96x64 and three cameras,
from the seed's inputs (portbench/composite_scene.py): the loss, every
hand leaf's gradient and Adam update over three steps; the frozen
object untouched; the reference without the object failing; the spans
and counters of a traced fine-tune through main.run_composite, and the
share of the backward's rows that no optimiser reads; the cell shrunk
through the harness, and the faults of
portbench/finetune_limits.py failing it. No JAX here.

Tolerances, each with its reason:
- the steps, 1e-6 of a quantity's scale (the loss; a leaf's largest
  gradient or update over three steps): the port's CPU path and the
  reference run the same float32 operations in the same order (every
  pair binned, the plain composite at the same chunk), so they agree to
  rounding; bfloat16 (8 bits) would miss by ~1e-3 and TF32 (10 bits,
  in the composite's and SSIM's matmuls) by ~1e-4;
- the frozen object: exact (bit-identical leaves and liveness);
- object_dropped: the loss without the object's pixels misses by more
  than a tenth of its value.
"""
import copy

import numpy as np
import pytest
import torch

from manus_tpu_torch import main as port_main
from manus_tpu_torch.ops.rasterizer import api
from manus_tpu_torch.ops.rasterizer.projection import ProjectedGaussians
from manus_tpu_torch.train import composite as composite_mod
from manus_tpu_torch.train.composite import make_composite_finetune_step
from manus_tpu_torch.train.optim import BETA1
from manus_tpu_torch.train.workloads import init_train_state, \
    make_raster_config
from manus_tpu_torch.utils import trace
from manus_tpu_torch.utils.camera import index_camera
from portbench import composite_scene, finetune_limits
from portbench import run as run_mod
from portbench.drivers import common
from portbench.drivers import composite_finetune as driver
from portbench.drivers.object_train import _sums
from portbench.reference import composite_finetune as ref
from portbench.registry import Registry

SEED = 2**31 + 11
SCALE = {"capacity": 1024, "dataset.width": 96, "dataset.height": 64,
         "dataset.num_cameras": 3, "dataset.sample_size": 34,
         "dataset.grid_res": 24, "scene.object_slots": 4096}
LEAVES = common.LEAVES
STEPS = 3
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cell():
    """The composite_finetune cell as run, shrunk: the configuration dict,
    the port's config (the plain raster on the CPU), the inputs, the
    port's dataset and models as the driver hands them to
    run_composite, and the first batches run_composite draws."""
    reg = Registry()
    w = reg.workload("composite_finetune")
    config = reg.config(w["config"])
    scene, scale = driver.split_scale(config["scene"], SCALE)
    cfg_dict = common.config_as_run(config, reg.traffic(w["traffic"]), scale)
    cfg = common.port_config(config["preset"], cfg_dict, SEED)
    cfg.raster.backend = "torch"
    inputs = composite_scene.build(cfg_dict, scene, SEED, "cpu")
    cams, rest, posed, grid = common.port_scene(cfg, inputs, "cpu")
    ds = driver.Dataset(inputs["images"], cams, rest, posed)
    rng = np.random.RandomState(cfg.trainer.seed)
    draws = []
    for _ in range(STEPS):
        f = rng.randint(ds.num_frames)
        draws.append((f, rng.randint(ds.num_views)))
    return dict(cfg_dict=cfg_dict, cfg=cfg, inputs=inputs, ds=ds, grid=grid,
                draws=draws)


def port_batch(cell, f, v):
    raw = cell["ds"].get_batch(f, np.asarray([v]))
    return dict(rgb=torch.as_tensor(raw["rgb"][0]),
                mask=torch.as_tensor(raw["mask"][0]),
                camera=index_camera(cell["ds"].cameras, v),
                bg=torch.zeros(3),
                bone_tf=port_main._bone_tf(cell["ds"], f, cell["grid"]))


@pytest.fixture(scope="module")
def port_steps(cell):
    """Three steps of the port's fine-tune from the cell's initial hand
    against its object: each loss, the first gradient as Adam's first
    moment holds it, the hand after them, and the object before and
    after."""
    cfg = cell["cfg"]
    obj = common.port_model(cell["inputs"]["obj"])
    before = [p.clone() for p in obj.params] + [obj.active.clone()]
    step = make_composite_finetune_step(cfg, make_raster_config(cfg), "hand",
                                        voxel_grid=cell["grid"])
    state = init_train_state(common.port_model(cell["inputs"]["init"]))
    out = dict(losses=[])
    for i, (f, v) in enumerate(cell["draws"]):
        state, m = step(state, obj, port_batch(cell, f, v))
        out["losses"].append(float(m["loss"]))
        if i == 0:
            out["grad1"] = {k: x / (1.0 - BETA1)
                            for k, x in zip(LEAVES, state.opt.m)}
    out["params"] = dict(zip(LEAVES, state.model.params))
    out["obj_before"], out["obj"] = before, obj
    return out


def reference_steps(cell, with_object=True):
    batches = [(f, v, *common.decode(cell["inputs"]["images"][f, v]))
               for f, v in cell["draws"]]
    return ref.run_steps(cell["cfg_dict"], cell["inputs"], batches,
                         device="cpu", with_object=with_object)


@pytest.fixture(scope="module")
def reference(cell):
    return reference_steps(cell)


def test_the_losses_match_the_reference(port_steps, reference):
    for got, want in zip(port_steps["losses"], reference["losses"]):
        assert abs(got - want) <= TOL * abs(want)


@pytest.mark.parametrize("leaf", LEAVES)
def test_each_hand_leafs_gradient_matches_the_reference(port_steps,
                                                        reference, leaf):
    got, want = port_steps["grad1"][leaf], reference["grad1"][leaf]
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= TOL * scale


@pytest.mark.parametrize("leaf", LEAVES)
def test_each_hand_leafs_update_matches_the_reference(cell, port_steps,
                                                      reference, leaf):
    init = cell["inputs"]["init"][leaf]
    got = port_steps["params"][leaf] - init
    want = reference["params"][leaf] - init
    scale = float(want.abs().max())
    if leaf == "xyz":  # the stage's position learning rate is 0
        assert scale == 0.0 and float(got.abs().max()) == 0.0
        return
    assert scale > 0
    assert float((got - want).abs().max()) <= TOL * scale


def test_the_frozen_object_is_bit_identical_after_the_steps(port_steps):
    obj = port_steps["obj"]
    for a, b in zip(list(obj.params) + [obj.active],
                    port_steps["obj_before"]):
        assert torch.equal(a, b)


def test_the_reference_without_the_object_fails(port_steps, reference,
                                                cell):
    dropped = reference_steps(cell, with_object=False)
    want = reference["losses"][0]
    assert abs(dropped["losses"][0] - want) > 0.1 * want
    assert abs(port_steps["losses"][0] - want) <= TOL * want


def test_a_traced_finetune_records_its_spans_and_counters(cell,
                                                          monkeypatch):
    """Two steps of main.run_composite's fine-tune with the recorder on:
    a root span a step with its batch and the step's three spans under
    it; the rows each model places in the scene and the rows the
    projection's backward covers, a step."""
    cfg = copy.deepcopy(cell["cfg"])
    cfg.optimize_hand, cfg.finetune_steps = True, 2
    cfg.hand_ckpt_dir, cfg.object_ckpt_dir = "hand", "object"
    loaded = dict(hand=(common.port_model(cell["inputs"]["init"]),
                        cell["grid"]),
                  object=(common.port_model(cell["inputs"]["obj"]), None))

    class FineTuneDone(Exception):
        pass

    def no_frames(*args, **kwargs):
        def render(*a, **k):
            raise FineTuneDone
        return render

    monkeypatch.setattr(port_main, "build_dataset",
                        lambda cfg, split, device=None: cell["ds"])
    monkeypatch.setattr(port_main, "_load_model",
                        lambda ckpt_dir, device: loaded[ckpt_dir])
    monkeypatch.setattr(port_main, "make_composite_render", no_frames)
    trace.clear()
    trace.enable()
    try:
        with pytest.raises(FineTuneDone):
            port_main.run_composite(cfg, "unused", device="cpu")
    finally:
        trace.disable()
    spans = {s.id: s for s in trace.records()}
    counts = trace.counters()
    trace.clear()
    roots = [s for s in spans.values() if s.name == "composite.finetune_step"]
    assert [s.attrs["step"] for s in roots] == [0, 1]
    assert all(s.parent is None for s in roots)
    for name in ("composite.finetune_batch", "step.forward", "step.backward",
                 "step.update"):
        got = [s for s in spans.values() if s.name == name]
        assert len(got) == 2, name
        assert {spans[s.parent].name for s in got} == {
            "composite.finetune_step"}, name
    by_name = {}
    for c in counts:
        by_name.setdefault(c.name, []).append(c.value)
    assert by_name["composite.rows_trained"] == [1024.0, 1024.0]
    # the backward covers the object's 4,096 rows beside the hand's
    assert by_name["raster.grad_rows"] == [5120.0, 5120.0]


def object_projected_without_grad(n_trained):
    """render_gaussians with the scene's first `n_trained` rows projected
    with their gradient and the rest under no_grad, then one raster of
    both: a fine-tune whose backward covers the trained rows alone."""
    def render(posed_means, posed_cov, cano_means, cano_features,
               cano_opacity, camera, bg_color, sh_degree=3, tf=None,
               active=None, config=None):
        parts = []
        for rows, grad in ((slice(None, n_trained), True),
                           (slice(n_trained, None), False)):
            with torch.set_grad_enabled(grad):
                parts.append(api.project(
                    posed_means[rows], posed_cov[rows], cano_means[rows],
                    cano_features[rows], cano_opacity[rows], camera, None,
                    sh_degree, tf[rows], active[rows], config))
        (p_t, c_t, o_t, backend), (p_f, c_f, o_f, _) = parts
        proj = ProjectedGaussians(*(torch.cat([a, b])
                                    for a, b in zip(p_t, p_f)))
        return api.rasterize(proj, torch.cat([c_t, c_f]),
                             torch.cat([o_t, o_f]), bg_color, camera, config,
                             backend)
    return render


def traced_step_counts(cell, render=None):
    """A traced fine-tune step of the port from the cell's initial hand:
    its loss and the stretch's counters summed, as the driver hands them
    to the readers."""
    cfg = cell["cfg"]
    step = make_composite_finetune_step(cfg, make_raster_config(cfg), "hand",
                                        voxel_grid=cell["grid"])
    state = init_train_state(common.port_model(cell["inputs"]["init"]))
    obj = common.port_model(cell["inputs"]["obj"])
    f, v = cell["draws"][0]
    trace.clear()
    trace.enable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            if render is not None:
                mp.setattr(composite_mod, "render_gaussians", render)
            _, m = step(state, obj, port_batch(cell, f, v))
    finally:
        trace.disable()
    counts = _sums(trace.counters())
    trace.clear()
    return float(m["loss"]), counts


@pytest.mark.parametrize("form", ["joint_backward", "object_without_grad"])
def test_the_frozen_grad_share_reads_the_backwards_untrained_rows(cell,
                                                                  form):
    """finetune.frozen_grad_share on a traced step's counters: the
    object's 4,096 of the 5,120 rows the joint backward covers (80%),
    and 0 where the object is projected without its gradient, the same
    loss rendered."""
    reader = Registry().metric_reader("finetune.frozen_grad_share")
    loss, counts = traced_step_counts(cell)
    if form == "joint_backward":
        assert reader.read(dict(stretch_counts=counts)) == 80.0
        return
    loss_t, counts_t = traced_step_counts(
        cell, object_projected_without_grad(1024))
    assert counts_t["raster.grad_rows"] == 1024.0
    assert reader.read(dict(stretch_counts=counts_t)) == 0.0
    assert abs(loss_t - loss) <= TOL * loss
    assert reader.read(dict(stretch_counts={})) is None


def test_the_cell_runs_shrunk_and_is_correct():
    line = run_mod.run_cell(Registry(), "composite_finetune", SEED, 0.3,
                            False, device="cpu", scale=SCALE)
    assert line["correct"], line["compared"]
    assert line["compared"]["frozen"]["value"] == 0.0
    assert line["metrics"]["train_step_ms"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(finetune_limits.FAULTS))
def test_each_fault_fails_the_cell(fault):
    with finetune_limits.FAULTS[fault]():
        line = run_mod.run_cell(Registry(), "composite_finetune", SEED, 0.3,
                                False, device="cpu", scale=SCALE)
    assert not line["correct"], line["compared"]


