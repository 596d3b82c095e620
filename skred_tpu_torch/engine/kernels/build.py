"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into
``build/kernels/<name>-<hash>.so`` at the repository root, with a plain C
entry point (no PyTorch headers, so a build takes seconds); nvcc's output
(ptxas's registers and spills) is kept beside it as ``<name>-<hash>.txt``
and read back by ``report``.  A source may
also be built under a set of ``-D`` defines (a *key*: a tuple of
``"NAME=VALUE"`` strings), as the cyclic kernel is once per voice count
and feature set; each key is a library of its own.  The hash covers the
source, the shared ``csrc/*.cuh`` headers, the flags and the key.
Importing this module compiles nothing.  The flags keep the reference
rounding: no multiply-add contraction (``-fmad=false``), IEEE division and
square root, denormals kept, never ``--use_fast_math``.  A key element
that starts with ``-`` is an nvcc option in place of the flag of the same
name: ``tools/fma_probe.py``'s ``-fmad=true`` build, the one that asks
nvcc to contract.
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

# sources that build under a key only (their defines select every
# feature): build_all() with no items leaves them out
KEY_ONLY = ("compat", "filt_smooth", "phase_walk", "tier")

_LIBS: dict = {}
LOG: dict = {}          # label -> (seconds, compiler output) of this process


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def nvcc_args(key=()) -> list:
    """nvcc's flags and defines for a build under ``key``: each element
    that starts with ``-`` is an option in place of the ``NVCC_FLAGS``
    entry of the same name, every other one a ``-D`` define."""
    opts = {k.split("=")[0]: k for k in key if k.startswith("-")}
    unknown = set(opts) - {f.split("=")[0] for f in NVCC_FLAGS}
    if unknown:
        raise ValueError(f"build: no flag {sorted(unknown)} to replace")
    return ([opts.get(f.split("=")[0], f) for f in NVCC_FLAGS]
            + ["-D" + d for d in key if not d.startswith("-")])


def _spec(item):
    """(name, key) of a build item: a source name or (name, key)."""
    if isinstance(item, str):
        return item, ()
    name, key = item
    return name, tuple(key)


def label(name: str, key=()) -> str:
    """A short name for a build: the source, and the key's hash."""
    if not key:
        return name
    return f"{name}[{hashlib.sha1(' '.join(key).encode()).hexdigest()[:8]}]"


def _target(name: str, key=()) -> pathlib.Path:
    # the hash covers the shared headers too: an edit of a .cuh rebuilds
    # every source that may include it
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha1(src + " ".join(nvcc_args(key)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{h}.so"


def build_all(items=None) -> dict:
    """Compile every (or each named) kernel source or key that has no
    current library, one nvcc process each, all started together
    (``items`` None: every source but ``KEY_ONLY``).
    ``items``: source names or (name, key) pairs.  Returns {label:
    seconds} for the builds made by this call; raises if any failed."""
    specs = [(p.stem, ()) for p in sorted(CSRC.glob("*.cu"))
             if p.stem not in KEY_ONLY] \
        if items is None else [_spec(i) for i in items]
    todo = list(dict.fromkeys(
        s for s in specs if not (_target(*s).exists()
                                 and _target(*s).with_suffix(".txt").exists())))
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = {}
    for name, key in todo:
        tmp = _target(name, key).with_suffix(".tmp.so")
        procs[name, key] = subprocess.Popen(
            [nvcc, *nvcc_args(key), "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    secs = {}
    failed = []
    for (name, key), p in procs.items():
        out, _ = p.communicate()
        lab = label(name, key)
        secs[lab] = time.time() - t0
        LOG[lab] = (secs[lab], out)
        if p.returncode != 0:
            failed.append(f"{name}.cu {' '.join(key)}:\n{out}")
            continue
        _target(name, key).with_suffix(".txt").write_text(out)
        _target(name, key).with_suffix(".tmp.so").rename(_target(name, key))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return secs


def load(name: str, key=(), entry: str | None = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (under ``key``'s
    defines), built if needed; ``entry`` (default ``<name>_launch``) is
    its launch function."""
    key = tuple(key)
    lib = _LIBS.get((name, key))
    if lib is None:
        build_all([(name, key)])
        lib = ctypes.CDLL(str(_target(name, key)))
        _LIBS[name, key] = lib
    fn = getattr(lib, entry or f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def report(name: str, key=()) -> str:
    """nvcc's output for ``csrc/<name>.cu`` under ``key``, built if needed:
    the same text whether this process built the library or found it."""
    build_all([(name, key)])
    return _target(name, key).with_suffix(".txt").read_text()
