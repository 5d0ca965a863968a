"""Checkpoints of the port against the JAX package's: the same npz keys and
dtypes, so a checkpoint of either loads into the other leaf for leaf; the
same "best" resolution and NaN scrub."""
import os

import jax
import numpy as np
import pytest
import torch

from manus_tpu.models.gaussians import init_gaussian_model as j_init
from manus_tpu.train import checkpoint as jck
from manus_tpu.train.workloads import init_train_state as j_init_state
from manus_tpu_torch.models.gaussians import init_gaussian_model as t_init
from manus_tpu_torch.train import checkpoint as tck
from manus_tpu_torch.train.workloads import init_train_state as t_init_state


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tensors here are small, and test workers
    side by side, each with a full OpenMP team, oversubscribe the CPU
    (the new port test files took 115 s under -n 5 so, 26 s with one)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

CAP, N0, BONES = 64, 40, 5


def _cloud(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 0.3, (N0, 3)).astype(np.float32),
            rng.uniform(0, 1, (N0, 3)).astype(np.float32))


def _skin(hand):
    if not hand:
        return None
    return np.random.RandomState(1).dirichlet(np.ones(BONES), N0).astype(
        np.float32)


def _randomise(arrays, seed):
    """Every float leaf random, the flags and steps set, so that a leaf
    loaded into the wrong slot shows."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in arrays.items():
        if v.dtype == np.float32:
            out[k] = rng.normal(size=v.shape).astype(np.float32)
        elif k == ".model/.active":
            out[k] = rng.uniform(size=v.shape) < 0.7
        else:
            out[k] = v
    out[".step"] = np.asarray(17, np.int32)
    out[".opt/.step"] = np.asarray(15, np.int32)
    out[".mask_pruned_flag"] = np.asarray(True)
    return out


def _port_state(hand, seed=3):
    pts, cols = _cloud()
    tmpl = t_init_state(t_init(pts, cols, CAP, skin_weights=_skin(hand),
                               device="cpu"), seed=seed)
    return tck.state_from_arrays(
        _randomise(tck.state_to_arrays(tmpl), 7), tmpl)


def _jax_template(hand, seed=3):
    pts, cols = _cloud()
    return j_init_state(j_init(pts, cols, CAP, skin_weights=_skin(hand)),
                        seed=seed)


def _jax_arrays(state):
    return jck._flatten_with_paths(state)


@pytest.mark.parametrize("hand", [False, True], ids=["object", "hand"])
def test_port_checkpoint_loads_in_jax_and_back(hand, tmp_path):
    state = _port_state(hand)
    path = tck.save_checkpoint(str(tmp_path / "t"), state, 17, 0.25,
                               extra=dict(num_active=np.asarray(
                                   int(state.model.active.sum()), np.int32)))
    ours = tck.state_to_arrays(state)
    jstate, extra = jck.load_checkpoint(path, _jax_template(hand))
    theirs = _jax_arrays(jstate)
    assert set(theirs) == set(ours)
    for k in ours:
        assert theirs[k].dtype == ours[k].dtype, k
        assert theirs[k].shape == ours[k].shape, k
        np.testing.assert_array_equal(theirs[k], ours[k], err_msg=k)
    np.testing.assert_array_equal(theirs[".rng"], [0, 3])
    assert tck.GEN_STATE in extra and extra["num_active"].dtype == np.int32

    # and back: JAX writes it, the port reads it
    jpath = jck.save_checkpoint(str(tmp_path / "j"), jstate, 17, 0.25)
    back, _ = tck.load_checkpoint(jpath, state)
    for k, v in tck.state_to_arrays(back).items():
        np.testing.assert_array_equal(v, ours[k], err_msg=k)
    assert back.step == 17 and back.opt.step == 15
    assert (back.skin_opt is None) == (not hand)


@pytest.mark.parametrize("hand", [False, True], ids=["object", "hand"])
def test_jax_checkpoint_loads_in_the_port(hand, tmp_path):
    jtmpl = _jax_template(hand, seed=11)
    jarr = _randomise(_jax_arrays(jtmpl), 5)
    jstate = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jtmpl),
        [jarr[k] for k in _jax_arrays(jtmpl)])
    path = jck.save_checkpoint(str(tmp_path), jstate, 3, 0.5)
    raw = np.load(path)
    assert raw[".step"].dtype == np.int32 and raw[".step"].shape == ()
    assert raw[".opt/.step"].dtype == np.int32
    assert raw[".rng"].dtype == np.uint32 and raw[".rng"].shape == (2,)
    assert raw[".mask_pruned_flag"].dtype == bool
    assert raw[".model/.active"].dtype == bool

    state, extra = tck.load_checkpoint(path, _port_state(hand))
    assert tck.GEN_STATE not in extra
    assert state.model.active.dtype == torch.bool
    assert isinstance(state.step, int) and isinstance(state.opt.step, int)
    got = tck.state_to_arrays(state)
    assert set(got) == set(jarr)
    for k in jarr:
        assert got[k].dtype == jarr[k].dtype, k
        np.testing.assert_array_equal(got[k], jarr[k], err_msg=k)
    # no generator state in a JAX file: reseeded from .rng[1]
    want = torch.randn(4, generator=torch.Generator().manual_seed(11))
    assert torch.equal(torch.randn(4, generator=state.gen), want)


def test_generator_state_round_trips(tmp_path):
    state = _port_state(True)
    torch.randn(7, generator=state.gen)  # move it off its seed
    path = tck.save_checkpoint(str(tmp_path), state, 1, 0.1)
    want = torch.randn(5, generator=state.gen)
    back, _ = tck.load_checkpoint(path, _port_state(True, seed=99))
    assert torch.equal(torch.randn(5, generator=back.gen), want)
    with pytest.raises(KeyError, match="missing leaf"):
        tck.state_from_arrays({".step": np.asarray(0)}, state)


@pytest.mark.parametrize("names", [
    ["step000100-loss0.200000.npz", "step000200-loss0.100000.npz",
     "step000300-loss0.100000.npz", "junk.npz"],
    ["step000100-loss0.200000-vpsnr21.0000.npz",
     "step000200-loss0.100000-vpsnr20.5000.npz",
     "step000300-loss0.050000.npz",
     "step000400-loss0.300000-vpsnr21.0000.npz"],
    ["step000010-lossnan.npz", "step000020-loss1.000000.npz"],
], ids=["loss", "val_keyed", "nan"])
def test_find_best_checkpoint_matches_jax(names, tmp_path):
    for n in names:
        (tmp_path / n).write_bytes(b"")
    got = tck.find_best_checkpoint(str(tmp_path))
    assert got == jck.find_best_checkpoint(str(tmp_path))
    assert got is not None and os.path.exists(got)
    assert tck.find_best_checkpoint(str(tmp_path / "none")) is None


def test_scrub_nan_slots_and_load_gaussian_model_match_jax(tmp_path):
    state = _port_state(True)
    params = state.model.params._replace(
        xyz=state.model.params.xyz.clone(),
        opacity=state.model.params.opacity.clone())
    params.xyz[2, 1] = float("nan")
    params.opacity[5, 0] = float("inf")
    active = state.model.active.clone()
    active[2] = active[5] = True
    active[9] = False
    params.xyz[9, 0] = float("nan")  # inactive: not counted
    state = state._replace(model=state.model._replace(params=params,
                                                      active=active))
    model, n_bad = tck.scrub_nan_slots(state.model)
    path = tck.save_checkpoint(str(tmp_path), state, 1, 0.1, extra=dict(
        vg_center=np.zeros(3, np.float32), vg_scale=np.ones(3, np.float32),
        vg_weights=np.full((4, 5, 6, BONES + 1), 1 / 6, np.float32)))
    jstate, _ = jck.load_checkpoint(path, _jax_template(True))
    jmodel, jn = jck.scrub_nan_slots(jstate.model)
    assert int(n_bad) == int(jn) == 2
    np.testing.assert_array_equal(model.active.numpy(),
                                  np.asarray(jmodel.active))
    tmodel, tgrid, _ = tck.load_gaussian_model(path, device="cpu")
    jm, jgrid, _ = jck.load_gaussian_model(path)
    np.testing.assert_array_equal(tmodel.active.numpy(), np.asarray(jm.active))
    np.testing.assert_array_equal(tmodel.skin_weights.numpy(),
                                  np.asarray(jm.skin_weights))
    for name in ("center", "scale", "weights"):
        np.testing.assert_array_equal(getattr(tgrid, name).numpy(),
                                      np.asarray(getattr(jgrid, name)))
