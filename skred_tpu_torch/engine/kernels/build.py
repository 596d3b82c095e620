"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into
``build/kernels/<name>-<hash>.so`` at the repository root (the hash is of
the source, the shared ``csrc/*.cuh`` headers and the flags), with a plain C
entry point (no PyTorch headers, so a build takes seconds).  Importing
this module compiles nothing.  The flags keep the reference rounding:
no multiply-add contraction (``-fmad=false``), IEEE division and square
root, denormals kept, never ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
LOG: dict = {}          # name -> (seconds, compiler output) of this process


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def _target(name: str) -> pathlib.Path:
    # the hash covers the shared headers too: an edit of a .cuh rebuilds
    # every source that may include it
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{h}.so"


def build_all(names=None) -> dict:
    """Compile every (or the named) kernel source that has no current
    library, one nvcc process per source, all started together.  Returns
    {name: seconds} for the sources compiled by this call."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(".tmp.so")
        procs[n] = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    secs = {}
    failed = []
    for n, p in procs.items():
        out, _ = p.communicate()
        secs[n] = time.time() - t0
        LOG[n] = (secs[n], out)
        if p.returncode != 0:
            failed.append(f"{n}.cu:\n{out}")
            continue
        _target(n).with_suffix(".tmp.so").rename(_target(n))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
