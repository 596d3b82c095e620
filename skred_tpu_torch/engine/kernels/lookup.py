"""The table-lookup kernel: wavetable reads from the packed table buffer.

One CUDA source (``csrc/lookup.cu``, a kernel for each layout) serves the
JAX package's two lookup kernels and the noise pass:

* ``lookup(table, base, limit, idx)``, the noise pass's form: time-major
  ``idx [N, M]`` → ``out[t, m] = table[base[m] + idx[t, m]]`` where
  ``0 <= idx[t, m] < limit[m]``, else 0.  With ``base = table_off`` and
  ``limit = max(table_size, 1)`` it is the XLA branch's
  ``table_buffer[table_off + idx]`` (``skred_tpu/engine/fused.py:573``).
* ``table_lookup_grouped`` and ``table_lookup_pallas``, the ports of the
  JAX functions of those names, with their signature ``(table3, slot,
  idx [M, N], slot_size)`` → ``[M, N]``: ``base = slot·slot_size`` and
  ``limit = slot_size``, so an index below 0 or past its slot reads 0.

Each form counts its own launches.  A CPU tensor runs ``lookup_plain``;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from skred_tpu_torch import spans
from skred_tpu_torch.engine.kernels import cuda_call

F32 = torch.float32
I32 = torch.int32

SLOT = 4096          # small-table slot (kernels.SLOT)


def lookup_plain(table, base, limit, idx, lane_major=False):
    """The kernel's arithmetic in torch ops: ``idx`` is [N, M] (lanes
    last) or, with ``lane_major``, [M, N]."""
    if lane_major:
        base, limit = base[:, None], limit[:, None]
    ok = (idx >= 0) & (idx < limit)
    flat = base.to(torch.int64) + torch.where(ok, idx, 0).to(torch.int64)
    return torch.where(ok, table[flat], 0.0)


class LookupArgs(ctypes.Structure):
    """Mirrors csrc/lookup.cu's LookupArgs."""
    _fields_ = [("n", ctypes.c_int), ("m", ctypes.c_int),
                ("lane_major", ctypes.c_int)] \
        + [(k, ctypes.c_void_p) for k in ("table", "base", "limit", "idx",
                                          "out")]


INDEX_LIMIT = 2 ** 31   # the kernel's index arithmetic is 32-bit


def _pack_args(table, base, limit, idx, lane_major):
    dev = table.device
    chk = lambda name, x, dt, shape: cuda_call.check("lookup", name, x, dev,
                                                     dt, shape)
    if table.dim() != 1 or idx.dim() != 2:
        raise ValueError("lookup: table must be [R] and idx 2-D")
    if table.numel() >= INDEX_LIMIT or idx.numel() >= INDEX_LIMIT:
        raise ValueError("lookup: the table and the index block must each "
                         "hold fewer than 2^31 elements")
    m, n = idx.shape if lane_major else idx.shape[::-1]
    a = LookupArgs(n=n, m=m, lane_major=int(lane_major))
    a.table = chk("table", table, F32, tuple(table.shape))
    a.base = chk("base", base, I32, (m,))
    a.limit = chk("limit", limit, I32, (m,))
    a.idx = chk("idx", idx, I32, tuple(idx.shape))
    out = torch.empty(idx.shape, dtype=F32, device=dev)
    a.out = out.data_ptr()
    return a, out


def _run(table, base, limit, idx, lane_major):
    """Plain version on the CPU, kernel on the card.  Returns (out,
    launched)."""
    dev = table.device
    if dev.type == "cpu":
        return lookup_plain(table, base, limit, idx, lane_major), False
    if dev.type != "cuda":
        raise ValueError(f"lookup: no kernel for device {dev}")
    args, out = _pack_args(table, base, limit, idx, lane_major)
    cuda_call.launch("lookup", args, dev)
    return out, True


def lookup(table, base, limit, idx):
    """table: [R] f32 flat buffer; base, limit: [M] i32; idx: [N, M] i32.
    Returns [N, M] f32 (see the module docstring)."""
    with spans.span("kernel.lookup"):
        out, launched = _run(table, base, limit, idx, False)
        lookup.launches += launched
        return out


def _slot_args(table3, slot, slot_size):
    if slot_size is None:
        slot_size = SLOT
    if table3.shape[-1] * table3.shape[-2] != slot_size:
        raise ValueError(f"table3 {tuple(table3.shape)} does not hold "
                         f"{slot_size}-sample slots")
    base = (slot.to(I32) * slot_size).contiguous()
    limit = torch.full_like(base, slot_size)
    return table3.reshape(-1), base, limit


def table_lookup_grouped(table3, slot, idx, slot_size=None):
    """Port of ``kernels.table_lookup_grouped``: table3 [S, slot_size//128,
    128] f32; slot: [M] i32 slot per lane; idx: [M, N] i32.  Returns
    [M, N] f32 with out[m, t] = table3.flat[slot[m]·slot_size + idx[m,
    t]] for 0 <= idx < slot_size, else 0."""
    table, base, limit = _slot_args(table3, slot, slot_size)
    out, launched = _run(table, base, limit, idx, True)
    table_lookup_grouped.launches += launched
    return out


def table_lookup_pallas(table3, slot, idx, slot_size=SLOT):
    """Port of ``kernels.table_lookup_pallas`` (the one-lane-per-step TPU
    kernel); the same function as ``table_lookup_grouped``."""
    table, base, limit = _slot_args(table3, slot, slot_size)
    out, launched = _run(table, base, limit, idx, True)
    table_lookup_pallas.launches += launched
    return out


lookup.launches = 0
table_lookup_grouped.launches = 0
table_lookup_pallas.launches = 0
