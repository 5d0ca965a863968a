"""Build the port's native sources and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc for
Hopper (sm_90a); each `csrc/<name>.cpp` is host code compiled by the host
compiler (g++). Either goes into its own shared library under
`manus_tpu_torch/_build/`, named by a hash of its source and flags, so an
unchanged source is built once per checkout; the compiler's output (for
nvcc, ptxas's registers, shared memory and spills) is kept beside the
library under the same name, so a later process reads the report of a
library it did not build. Several sources build in parallel, one
compiler each, and a failed build raises.
Nothing is built when a module is imported: the first call that needs a
library builds it. `Kernels` is a kernel module's handle on its library:
the load, the launch, the raise on a failed launch and the count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl",
)
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def host_compiler() -> str:
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found is None:
        raise RuntimeError("g++ not found: the host libraries cannot be "
                           "built")
    return found


def source_path(name: str) -> Path:
    """csrc/<name>.cu, or csrc/<name>.cpp for host code."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


def _command(name: str, out: Path) -> list:
    src = source_path(name)
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [host_compiler(), *HOST_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    src = source_path(name)
    flags = NVCC_FLAGS if src.suffix == ".cu" else HOST_FLAGS
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output for the library library_path(name)."""
    return library_path(name).with_suffix(".log")


def build(names) -> dict[str, str]:
    """Compile every named source that has no library yet, all at once.

    Returns {name: the compiler's output} for every named source, read
    from the log kept beside its library when an earlier process built
    it; raises on a failed compile.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and log_path(name).exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{source_path(name).name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            # the log first: a library in place always has its log
            tmp_log = tmp.with_suffix(".log")
            tmp_log.write_text(log)
            os.replace(tmp_log, log_path(name))
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed\n" + "\n".join(failed))
    return {name: log_path(name).read_text() for name in names}


def _typed(lib: ctypes.CDLL, signatures: dict) -> ctypes.CDLL:
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of csrc/<name>.cu or .cpp, built if needed, with each
    function of `signatures` ({fn: (argtypes, restype)}) typed."""
    with _load_lock:  # a loader thread and the main one may both ask
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _typed(ctypes.CDLL(str(library_path(name))), signatures)
            _loaded[name] = lib
    return lib


def ptr(x: torch.Tensor | None):
    """The tensor's device pointer, or None (a null pointer) for None."""
    return None if x is None else x.data_ptr()


def check_tensor(x: torch.Tensor, name: str, dtype, shape, device,
                 align: int = 0):
    """x is a contiguous `dtype` tensor of `shape` (None: any size on that
    axis) on `device`, its data `align`-byte aligned where align is given;
    or ValueError naming it."""
    if x.device != device or x.dtype != dtype or x.dim() != len(shape) \
            or any(s is not None and s != d for s, d in zip(shape, x.shape)) \
            or not x.is_contiguous() or (align and x.data_ptr() % align):
        aligned = f", {align}-byte aligned" if align else ""
        raise ValueError(
            f"{name} must be a contiguous{aligned} {dtype} {tuple(shape)} "
            f"tensor on {device}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device}")


class Kernels:
    """The library of csrc/<name>.cu as a kernel module launches it.

    Every entry point returns a cudaError_t; those that launch take the
    stream last. `signatures` ({fn: (argtypes, restype)}) gains the
    library's `<name>_error_string`. The library is built and loaded at
    the first call that needs it; `lib` may be set to another build of
    the same source (`open`), as the tuning scripts do.
    """

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.signatures = {**signatures, f"{name}_error_string": (
            [ctypes.c_int], ctypes.c_char_p)}
        self.lib: ctypes.CDLL | None = None

    def get(self) -> ctypes.CDLL:
        if self.lib is None:
            self.lib = load(self.name, self.signatures)
        return self.lib

    def open(self, path) -> ctypes.CDLL:
        """Another build of the source, at `path`, typed alike."""
        return _typed(ctypes.CDLL(str(path)), self.signatures)

    def check(self, rc: int, what: str):
        """Raise on the non-zero return `rc` of the entry point `what`."""
        if rc != 0:
            decode = getattr(self.get(), f"{self.name}_error_string")
            raise RuntimeError(
                f"{what} launch failed: {decode(rc).decode()} ({rc})")

    def launch(self, entry: str, *args, device, counter=None):
        """entry(*args) on the current stream of `device`; raises on a
        non-zero return, and counts the launch on `counter.launches` (a
        wrapper's count, `counted`) once it is made."""
        rc = getattr(self.get(), entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
        self.check(rc, entry)
        if counter is not None:
            counter.launches += 1


def counted(fn):
    """A kernel wrapper with its `launches` count, which Kernels.launch
    moves: the kernels it actually launched since the process started."""
    fn.launches = 0
    return fn
