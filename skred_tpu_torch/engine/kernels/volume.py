"""The master-volume kernel: a block's volume smoother and stereo output.

``volume(mix_l, mix_r, vf, vol_gain, n=n)`` is the end of the fused
block step: the smoother ``vg_t = 0.998·vg_{t-1} + 0.002·volume_final``
from the carry's ``vol_gain``, each row's mix times it, and the last
gain as the new carry.  Every ``vg_t`` rounds as the JAX package's
``jax.lax.associative_scan`` rounds it (``skred_tpu/engine/fused.py:
167-180``): ``volume_plain`` runs that combine tree in torch ops
(``_affine_scan``), ``csrc/volume.cu`` in its closed form, bit for bit
(the source says why they agree).

A CPU tensor runs ``volume_plain``; a CUDA tensor launches the kernel or
raises.  ``n`` may be 1 to ``MAX_N``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from skred_tpu_torch import spans
from skred_tpu_torch.engine.kernels import cuda_call
from skred_tpu_torch.engine.numerics import f32

F32 = torch.float32
MAX_N = 4096                # csrc/volume.cu's VOL_MAX_N


def _associative_scan(combine, elems):
    """Inclusive scan along dim 0 with jax.lax.associative_scan's combine
    tree (pairwise reduce, recurse on the odd elements, fill the even
    ones), so every element rounds as it does in the JAX package."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine([e[0:n - 1:2] for e in elems],
                      [e[1::2] for e in elems])
    odd = _associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = combine(odd, [e[2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[0] = e[0]
        r[2::2] = ev
        r[1::2] = od
        out.append(r)
    return out


def _affine_scan(a, b, x0):
    """x_t = a_t * x_{t-1} + b_t along dim 0 with initial value x0."""
    a = a.expand_as(b)
    b = torch.cat([(b[0] + a[0] * x0)[None], b[1:]], dim=0)

    def combine(l, r):
        return [l[0] * r[0], l[1] * r[0] + r[1]]

    return _associative_scan(combine, [a, b])[1]


def volume_plain(mix_l, mix_r, vf, vol_gain, *, n):
    """The kernel's function in torch ops: mix_l, mix_r [N, B], vf and
    vol_gain [B] → (out [N, B, 2], new vol_gain [B])."""
    a = f32(np.float32(1.0) - np.float32(0.002))
    vg = _affine_scan(torch.full_like(vf, a)[None],
                      (f32(0.002) * vf)[None].expand(n, vf.shape[0]),
                      vol_gain)                     # [N, B]
    return torch.stack([mix_l * vg, mix_r * vg], dim=-1), vg[-1]


class VolumeArgs(ctypes.Structure):
    """Mirrors csrc/volume.cu's VolumeArgs."""
    _fields_ = [("n", ctypes.c_int), ("b", ctypes.c_int)] \
        + [(k, ctypes.c_void_p) for k in ("mix_l", "mix_r", "vf", "vg0",
                                          "out", "vg_end")]


def _pack(mix_l, mix_r, vf, vol_gain, n):
    """Check the four inputs (contiguous f32 on ``mix_l``'s device) and
    fill the argument struct.  Returns (VolumeArgs, out, new gain)."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"volume: n = {n}, the kernel takes 1 to {MAX_N}")
    dev = mix_l.device
    b = vf.shape[0] if vf.dim() == 1 else -1
    chk = lambda name, x, shape: cuda_call.check("volume", name, x, dev,
                                                 F32, shape)
    a = VolumeArgs(n=n, b=b, mix_l=chk("mix_l", mix_l, (n, b)),
                   mix_r=chk("mix_r", mix_r, (n, b)), vf=chk("vf", vf, (b,)),
                   vg0=chk("vol_gain", vol_gain, (b,)))
    out = torch.empty((n, b, 2), dtype=F32, device=dev)
    gain = torch.empty(b, dtype=F32, device=dev)
    a.out, a.vg_end = out.data_ptr(), gain.data_ptr()
    return a, out, gain


def volume(mix_l, mix_r, vf, vol_gain, *, n):
    """One block's master volume over B rows: mix_l, mix_r [N, B] f32
    the stereo mix; vf [B] f32 the rows' volume_final; vol_gain [B] f32
    the gain at the end of the last block.  Returns (out [N, B, 2], the
    new vol_gain [B])."""
    with spans.span("kernel.volume", vf.numel()):
        dev = mix_l.device
        if dev.type == "cpu":
            return volume_plain(mix_l, mix_r, vf, vol_gain, n=n)
        if dev.type != "cuda":
            raise ValueError(f"volume: no kernel for device {dev}")
        args, out, gain = _pack(mix_l, mix_r, vf, vol_gain, n)
        cuda_call.launch("volume", args, dev)
        volume.launches += 1
        return out, gain


volume.launches = 0
