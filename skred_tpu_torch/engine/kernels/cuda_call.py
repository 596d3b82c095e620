"""Argument checks and the launch call shared by the kernels' wrappers.

Each ``csrc/<name>.cu`` exports ``int <name>_launch(const Args*, void*
stream)`` (or another entry point, under a build key); its wrapper fills a
ctypes mirror of ``Args`` with pointers from tensors checked here, and
launches on the device's current stream.
"""

from __future__ import annotations

import ctypes
import os

import torch


def check(kernel, name, x, dev, dtype, shape):
    """The data pointer of ``x`` once it is a contiguous ``dtype`` tensor
    of ``shape`` on ``dev``; raise otherwise."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a tensor")
    if x.device != dev:
        raise ValueError(f"{kernel}: {name} on {x.device}, needs {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{kernel}: {name} is {x.dtype}, needs {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(x.shape)}, "
                         f"needs {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {name} is not contiguous")
    return x.data_ptr()


def launch(name: str, args: ctypes.Structure, device, key=(),
           entry: str | None = None) -> None:
    """Launch ``csrc/<name>.cu`` (built under ``key``; entry point
    ``entry``, default ``<name>_launch``) on ``device``'s current stream;
    raise if the launch is refused."""
    from skred_tpu_torch.engine.kernels import build

    entry = entry or f"{name}_launch"
    lib = build.load(name, key, entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{entry} failed: "
                           + ("the arguments are not the build's key"
                              if rc == -1 else f"CUDA error {rc}"))


def ablate_set(names, vocab, what) -> frozenset:
    """A timing-ablation set (``SKRED_MEGA_ABLATE``, ``SKRED_CYC_ABLATE``):
    ``names`` as a comma list or an iterable of phase names, checked
    against ``vocab``; an unknown name raises ValueError naming the
    vocabulary."""
    if isinstance(names, str):
        names = names.split(",")
    out = frozenset(x for x in names if x)
    bad = sorted(out - set(vocab))
    if bad:
        raise ValueError(f"{what}: no phase {', '.join(bad)}; the phases "
                         f"are {', '.join(vocab)}")
    return out


def ablate_env(var, vocab) -> frozenset:
    """The ablation set the environment variable ``var`` names (empty
    when unset), read once by each kernel module at import."""
    return ablate_set(os.environ.get(var, ""), vocab, var)
