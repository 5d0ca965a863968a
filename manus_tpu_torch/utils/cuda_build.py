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
library builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

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


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of csrc/<name>.cu or .cpp, built if needed, with each
    function of `signatures` ({fn: (argtypes, restype)}) typed."""
    with _load_lock:  # a loader thread and the main one may both ask
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
    return lib
