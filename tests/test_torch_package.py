"""Guards on the PyTorch port's package boundary and device rules."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "manus_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


# the card's machine has neither h5py nor OpenCV: the port reads HDF5,
# PNG and video frames itself, but for the one lazy OpenCV import that
# decodes video, inside a function of data/reader.py
FORBIDDEN = ("jax", "jaxlib", "manus_tpu", "h5py", "cv2")
LAZY_CV2 = ROOT / "manus_tpu_torch" / "data" / "reader.py"


def _imported_modules(path):
    """(module, whether the import is inside a function) of every import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    in_function = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            in_function.update(id(n) for n in ast.walk(node))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in in_function
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", id(node) in in_function


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    """Nor h5py nor OpenCV, but for data/reader.py's lazy cv2."""
    for mod, lazy in _imported_modules(path):
        top = mod.split(".")[0]
        if top == "cv2" and lazy and path == LAZY_CV2:
            continue
        assert top not in FORBIDDEN, f"{path}: imports {mod}"


def test_the_lazy_cv2_is_the_only_one():
    found = [(p, lazy) for p in PORT_FILES
             for mod, lazy in _imported_modules(p)
             if mod.split(".")[0] == "cv2"]
    assert found == [(LAZY_CV2, True)]


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "from manus_tpu_torch.train.workloads import make_train_step\n"
        "from manus_tpu_torch.ops.rasterizer.api import render_gaussians\n"
        "import manus_tpu_torch.main\n"
        "import manus_tpu_torch.train.checkpoint\n"
        "import manus_tpu_torch.data.prefetch\n"
        "import manus_tpu_torch.utils.io\n"
        "import manus_tpu_torch.utils.vis\n"
        "import manus_tpu_torch.preprocess.pipeline\n"
        "import manus_tpu_torch.data.brics\n"
        "import manus_tpu_torch.data.hdf5\n"
        "import manus_tpu_torch.data.validate\n"
        "import manus_tpu_torch.data.reader\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'manus_tpu', 'h5py', 'cv2')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_default_device_raises_without_cuda(monkeypatch):
    from manus_tpu_torch.models.gaussians import init_gaussian_model
    from manus_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_gaussian_model([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]],
                            [[0.5, 0.5, 0.5]] * 2, 4)
    assert resolve_device("cpu") == torch.device("cpu")


def _tiny_render_inputs(n: int = 8):
    """Eight gaussians in front of a 32x32 camera, on the CPU."""
    from manus_tpu_torch.utils.camera import make_camera

    cam = make_camera([[40.0, 0, 15.5], [0, 40.0, 15.5], [0, 0, 1]],
                      [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 3.0]],
                      32, 32, device="cpu")
    g = torch.Generator().manual_seed(3)
    means = torch.rand(n, 3, generator=g) - 0.5
    s2 = torch.full((n,), 0.01)
    z = torch.zeros(n)
    cov = torch.stack([s2, z, z, s2, z, s2], dim=-1)
    feats = torch.rand(n, 16, 3, generator=g)
    return (means, cov, means, feats, torch.full((n,), 0.8), cam,
            torch.zeros(3))


def test_cuda_backend_on_cpu_tensors_renders_plain():
    """One name means one thing: the kernels' names on CPU tensors are the
    plain path, as for every other op; only the CUDA wrappers refuse a CPU
    tensor, and only the config's conversion refuses an unknown
    tile_shard_mode."""
    from manus_tpu_torch.config import hand_config
    from manus_tpu_torch.ops.rasterizer import composite
    from manus_tpu_torch.ops.rasterizer.api import RasterConfig, render_gaussians
    from manus_tpu_torch.train.workloads import make_raster_config

    args = _tiny_render_inputs()
    plain = render_gaussians(*args, config=RasterConfig(backend="torch"))
    assert plain.t_final.min() < 1.0
    got = render_gaussians(*args, config=RasterConfig(backend="cuda"))
    assert torch.equal(got.render, plain.render)
    assert torch.equal(got.t_final, plain.t_final)
    with pytest.raises(ValueError, match="CUDA payload"):
        composite.composite_fwd_cuda(
            torch.zeros(16, 128), torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), 2, 2)
    # JAX falls back to owner on an unknown tile_shard_mode; the port raises
    cfg = hand_config()
    cfg.raster.tile_shard_mode = "stripes"
    with pytest.raises(ValueError, match="unknown tile_shard_mode"):
        make_raster_config(cfg)


@pytest.mark.parametrize("name", ["auto", "pallas", "cuda", "xla"])
def test_kernel_and_jax_backend_names_render_plain_on_cpu(name):
    """render_gaussians resolves the backend against its tensors' device:
    on the CPU every kernel name, and the JAX package's "xla", is the plain
    path, forward and backward."""
    from manus_tpu_torch.ops.rasterizer.api import RasterConfig, render_gaussians

    outs = []
    for backend in ("torch", name):
        means, cov, cano, feats, opac, cam, bg = _tiny_render_inputs()
        feats.requires_grad_(True)
        out = render_gaussians(means, cov, cano, feats, opac, cam, bg,
                               config=RasterConfig(backend=backend))
        out.render.square().sum().backward()
        outs.append((out.render.detach(), feats.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
