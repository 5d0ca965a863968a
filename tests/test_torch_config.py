"""The port's config tree against the JAX package's: the same fields and
defaults, the same dotted overrides, config.json snapshots that load in
either package, and the raster backend names mapped onto a device."""
import dataclasses

import pytest
import torch

import manus_tpu.config as jcfg
import manus_tpu_torch.config as tcfg
from manus_tpu_torch import main as tmain
from manus_tpu_torch.ops.rasterizer.api import resolve_raster_backend

# tests/test_cli.py's override lists
COMMON = [
    "dataset.width=64", "dataset.height=64", "dataset.num_cameras=3",
    "capacity=1024", "raster.backend=xla", "raster.max_pairs_per_tile=512",
    "model.remove_seg_end=0", "trainer.val_every=0",
]
OVERRIDES = {
    "OBJ_GAUSSIAN": COMMON + [
        "trainer.max_steps=8", "trainer.checkpoint_every=5",
        "dataset.sample_size=150", "trainer.exp_name=obj",
        "trainer.output_dir=/tmp/out",
    ],
    "HAND_GAUSSIAN": COMMON + [
        "dataset.num_frames=2", "dataset.sample_size=20",
        "dataset.grid_res=24", "trainer.max_steps=8",
        "trainer.checkpoint_every=5", "trainer.exp_name=hand",
        "trainer.output_dir=/tmp/out",
        "loss.losses=[rgb_loss,ssim_loss,isotropic_reg]",
        "loss.loss_weight=[0.8,0.2,0.1]",
    ],
    "COMPOSITE": COMMON + [
        "dataset.num_frames=2", "trainer.exp_name=comp",
        "optimize_hand=true", "finetune_steps=6", "hand_ckpt_dir=/x/h",
    ],
}
# The fields that differ by design: the port's default backend is its
# kernels' name ("cuda", the JAX package's "auto"), and the JAX default
# camera_path names a file outside any checkout ("" in the port).
BY_DESIGN = {("raster", "backend"), ("camera_path",)}


def _flat(d, prefix=()):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _diff(a: dict, b: dict):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert set(fa) == set(fb), set(fa) ^ set(fb)
    return {k for k in fa if fa[k] != fb[k]}


@pytest.mark.parametrize("name", sorted(tcfg.CONFIGS))
def test_defaults_match_jax(name):
    got = tcfg.config_to_dict(tcfg.CONFIGS[name]())
    want = jcfg.config_to_dict(jcfg.CONFIGS[name]())
    assert _diff(got, want) == BY_DESIGN
    assert got["raster"]["backend"] == "cuda"
    assert want["raster"]["backend"] == "auto"


@pytest.mark.parametrize("name", sorted(OVERRIDES))
def test_overrides_match_jax(name):
    got = tcfg.apply_overrides(tcfg.CONFIGS[name](), OVERRIDES[name])
    want = jcfg.apply_overrides(jcfg.CONFIGS[name](), OVERRIDES[name])
    got, want = tcfg.config_to_dict(got), jcfg.config_to_dict(want)
    assert _diff(got, want) == {("camera_path",)}
    assert got["raster"]["backend"] == want["raster"]["backend"] == "xla"
    assert isinstance(got["loss"]["loss_weight"][0], float)
    with pytest.raises(ValueError, match="key=value"):
        tcfg.apply_overrides(tcfg.object_config(), ["capacity"])
    with pytest.raises(AttributeError):
        tcfg.apply_overrides(tcfg.object_config(), ["trainer.nope=1"])


@pytest.mark.parametrize("name", ["OBJ_GAUSSIAN", "HAND_GAUSSIAN"])
def test_snapshots_load_in_both_packages(name, tmp_path):
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    jcfg.save_config(jcfg.apply_overrides(jcfg.CONFIGS[name](),
                                          OVERRIDES[name]), str(jpath))
    tcfg.save_config(tcfg.apply_overrides(tcfg.CONFIGS[name](),
                                          OVERRIDES[name]), str(tpath))
    from_j = tcfg.load_config_snapshot(str(jpath))
    from_t = jcfg.load_config_snapshot(str(tpath))
    assert isinstance(from_j.model, tcfg.GaussianOpts)
    assert isinstance(from_j.dataset.grid_size, tuple)
    want = tcfg.config_to_dict(tcfg.apply_overrides(tcfg.CONFIGS[name](),
                                                    OVERRIDES[name]))
    # the JAX snapshot carries its camera_path; all else is as the port's
    assert _diff(tcfg.config_to_dict(from_j), want) == {("camera_path",)}
    assert jcfg.config_to_dict(from_t) == jcfg.config_to_dict(
        dataclasses.replace(jcfg.apply_overrides(jcfg.CONFIGS[name](),
                                                 OVERRIDES[name]),
                            camera_path=""))
    # a run directory resolves to its config.json
    (tmp_path / "run").mkdir()
    tcfg.save_config(from_j, str(tmp_path / "run" / "config.json"))
    assert tcfg.config_to_dict(tcfg.load_config_snapshot(
        str(tmp_path / "run"))) == tcfg.config_to_dict(from_j)


def test_raster_backend_names_on_each_device():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for name in ("auto", "pallas", "cuda"):
        assert resolve_raster_backend(name, cuda) == "cuda"
        assert resolve_raster_backend(name, cpu) == "torch"
    for name in ("torch", "oracle"):
        assert resolve_raster_backend(name, cuda) == name
        assert resolve_raster_backend(name, cpu) == name
    assert resolve_raster_backend("xla", cpu) == "torch"
    with pytest.raises(ValueError, match="choose 'cuda'"):
        resolve_raster_backend("xla", cuda)
    with pytest.raises(ValueError, match="unknown raster.backend"):
        resolve_raster_backend("triton", cpu)


def test_cli_refuses_xla_on_a_cuda_device(monkeypatch, tmp_path):
    """With a (mocked) card, raster.backend=xla raises before anything is
    built or written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="raster.backend='xla'"):
        tmain.main(["--config-name", "HAND_GAUSSIAN", "raster.backend=xla",
                    f"trainer.output_dir={tmp_path}"])
    assert not any(tmp_path.iterdir())
