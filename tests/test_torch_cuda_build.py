"""The launch helper of the port's kernel modules (utils/cuda_build.py),
on the CPU: a stub stands in for a library's C interface, and the
current stream for the card's."""
import pathlib
import types

import pytest
import torch

from manus_tpu_torch.ops import conv, knn
from manus_tpu_torch.ops.rasterizer import composite, projection
from manus_tpu_torch.utils import cuda_build, losses

ROOT = pathlib.Path(__file__).resolve().parents[1]
LIBRARIES = {"composite": composite.LIBRARY, "project": projection.LIBRARY,
             "knn": knn.LIBRARY, "conv3x3": conv.CONV_LIBRARY,
             "lpips_head": conv.HEAD_LIBRARY, "ssim": losses.LIBRARY}


class StubLibrary:
    """A library whose entry `demo_run` returns `rc` and records its
    arguments, and whose error strings name the code."""

    def __init__(self, rc: int):
        self.rc, self.calls = rc, []

    def demo_run(self, *args):
        self.calls.append(args)
        return self.rc

    @staticmethod
    def demo_error_string(rc):
        return f"stub error {rc}".encode()


@pytest.fixture
def stream(monkeypatch):
    """torch.cuda.current_stream as a card's would answer: stream 77."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=77))


def _kernels(rc: int):
    k = cuda_build.Kernels("demo", {"demo_run": ([], None)})
    k.lib = StubLibrary(rc)
    return k


@cuda_build.counted
def _wrapper():
    """A kernel wrapper's count."""


@pytest.mark.parametrize("rc", [1, 2, 700])
def test_launch_raises_the_librarys_own_error_and_counts_nothing(stream, rc):
    k = _kernels(rc)
    before = _wrapper.launches
    with pytest.raises(RuntimeError,
                       match=rf"^demo_run launch failed: stub error {rc} "
                             rf"\({rc}\)$"):
        k.launch("demo_run", 5, None, device="cpu", counter=_wrapper)
    assert k.lib.calls == [(5, None, 77)]
    assert _wrapper.launches == before


def test_launch_passes_the_current_stream_last_and_counts(stream):
    k = _kernels(0)
    before = _wrapper.launches
    k.launch("demo_run", 1, 2.5, device="cpu", counter=_wrapper)
    k.launch("demo_run", 3, device="cpu")
    assert k.lib.calls == [(1, 2.5, 77), (3, 77)]
    assert _wrapper.launches == before + 1
    k.check(0, "demo_occupancy")
    with pytest.raises(RuntimeError, match="demo_occupancy launch failed"):
        k.check(4, "demo_occupancy")


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_each_kernel_module_decodes_with_its_own_error_string(name):
    """The signatures of each module's library, with the decoder its
    csrc/<name>.cu exports; importing the modules built and loaded
    nothing."""
    k = LIBRARIES[name]
    assert k.name == name
    assert k.signatures[f"{name}_error_string"][1] is not None
    src = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
    for fn in k.signatures:
        assert f"{fn}(" in src, fn


@pytest.mark.parametrize("bad, match", [
    (torch.zeros(4, 3, dtype=torch.float64), "float32"),
    (torch.zeros(5, 3), r"\(4, 3\)"),
    (torch.zeros(4, 3, 1), r"\(4, 3\)"),
    (torch.zeros(3, 4).t(), "contiguous"),
    (torch.zeros(4, 3, device="meta"), "on cpu, got .* on meta"),
])
def test_check_tensor_names_the_argument(bad, match):
    with pytest.raises(ValueError, match=f"^pts must be .*{match}"):
        cuda_build.check_tensor(bad, "pts", torch.float32, (4, 3),
                                torch.device("cpu"))


def test_check_tensor_takes_any_size_on_a_free_axis_and_checks_alignment():
    dev = torch.device("cpu")
    cuda_build.check_tensor(torch.zeros(16, 9), "payload", torch.float32,
                            (16, None), dev)
    with pytest.raises(ValueError, match="payload must be"):
        cuda_build.check_tensor(torch.zeros(15, 9), "payload",
                                torch.float32, (16, None), dev)
    buf = torch.zeros(65, dtype=torch.bfloat16)
    cuda_build.check_tensor(buf[:64], "a", torch.bfloat16, (64,), dev, 16)
    with pytest.raises(ValueError, match="a must be a contiguous, 16-byte "
                                         "aligned"):
        cuda_build.check_tensor(buf[1:], "a", torch.bfloat16, (64,), dev, 16)
    assert cuda_build.ptr(None) is None
    assert cuda_build.ptr(buf) == buf.data_ptr()


def test_launch_errors_are_formatted_in_the_helper_alone():
    """No kernel module decodes or formats a launch error of its own."""
    files = [p for p in (ROOT / "manus_tpu_torch").rglob("*.py")
             if p.name != "cuda_build.py"]
    for path in files:
        text = path.read_text()
        assert "launch failed" not in text, path
        assert "_error_string(" not in text, path
