"""ctypes binding to the native timeline compiler (csrc/skred_host.cpp).

The C++ library implements the host control plane — skode parser, wire
dispatch, engine model, sequencer/defer simulation — and returns segment
parameter tensors identical to the Python compiler's (asserted across the
corpus by tests/test_torch_native.py).  Use it for large batch compiles where
Python's per-block simulation cost dominates; the Python implementation
remains the semantic oracle and the full-featured path.  Scripts using
recorder capture (``<``/``*``) or dynamic wave expansion (``/wex``) are
REFUSED with NotImplementedError (never silently mis-compiled) — compile
those with host.timeline.compile_script.

The library is built at first use from the repository's
``csrc/skred_host.cpp`` with ``csrc/Makefile``'s flags into
``build/host/libskredhost-<hash>.so`` at the repository root; the hash
covers the source and the flags, so an edit of either builds anew.
Port of ``skred_tpu.host.native``: only the imports and the build differ.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from skred_tpu_torch import config as C
from skred_tpu_torch.assets.bank import WaveBank
from skred_tpu_torch.host.timeline import (OPS_FIELDS, PARAM_F32, PARAM_I32,
                                           PARAM_I64_AS_I32, Timeline,
                                           _fused_passes_arrays,
                                           _mod_passes_arrays)

V = C.VOICE_MAX
_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SRC = _ROOT / "csrc" / "skred_host.cpp"
BUILD_DIR = _ROOT / "build" / "host"
# csrc/Makefile's flags: strict FP, the Python compiler is the bit-exact
# oracle
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-ffp-contract=off",
             "-fno-fast-math", "-Wall"]


class _SlotMeta(ctypes.Structure):
    _fields_ = [
        ("valid", ctypes.c_int32), ("size", ctypes.c_int32),
        ("rate", ctypes.c_float),
        ("one_shot", ctypes.c_int32), ("loop_enabled", ctypes.c_int32),
        ("loop_start", ctypes.c_int32), ("loop_end", ctypes.c_int32),
        ("midi_note", ctypes.c_float), ("offset_hz", ctypes.c_float),
        ("table_gen", ctypes.c_int32),
    ]


class _Out(ctypes.Structure):
    _fields_ = [
        ("num_segments", ctypes.c_int32), ("num_blocks", ctypes.c_int32),
        ("f32", ctypes.POINTER(ctypes.c_float)),
        ("i32", ctypes.POINTER(ctypes.c_int32)),
        ("scalars", ctypes.POINTER(ctypes.c_float)),
        ("ops", ctypes.POINTER(ctypes.c_uint8)),
        ("seg_of_block", ctypes.POINTER(ctypes.c_int32)),
        ("seg_is_start", ctypes.POINTER(ctypes.c_uint8)),
        ("num_loads", ctypes.c_int32),
        ("loads", ctypes.POINTER(ctypes.c_int32)),
        ("num_keys", ctypes.c_int32),
        ("bind_gens", ctypes.POINTER(ctypes.c_int32)),
        ("sample_count", ctypes.c_int64),
    ]


_lib = None


def library_path() -> pathlib.Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha1(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libskredhost-{h.hexdigest()[:12]}.so"


def build_library() -> pathlib.Path:
    """Compile ``csrc/skred_host.cpp`` with g++ unless the library for
    its current hash exists; a failed build raises with g++'s output."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a name of this process's own, renamed into place when complete: two
    # processes building at once never load a half-written library
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(["g++", *CXX_FLAGS, "-o",
                          str(tmp), str(_SRC), "-lm"],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {_SRC}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, target)
    return target


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    lib.skc_compile.restype = ctypes.c_int
    lib.skc_ops_bytes.restype = ctypes.c_int
    lib.skc_num_f32.restype = ctypes.c_int
    lib.skc_num_i32.restype = ctypes.c_int
    _lib = lib
    return lib


# ops struct layout mirror (csrc Ops; all offsets 4-aligned, no padding)
_OPS_LAYOUT = [
    ("set_phase", np.uint8, V), ("phase", np.float32, V),
    ("set_finished", np.uint8, V), ("finished", np.int32, V),
    ("set_sample", np.uint8, V), ("sample", np.float32, V),
    ("clear_filter", np.uint8, V), ("set_smoother", np.uint8, V),
    ("smoother", np.float32, V), ("set_pan", np.uint8, V),
    ("pan_left", np.float32, V), ("pan_right", np.float32, V),
    ("copy_hold_from", np.int32, V),
]


def compile_script_native(
    lines: List[str],
    seconds: float,
    bank: Optional[WaveBank] = None,
    script_dir: Optional[pathlib.Path] = None,
    block: int = C.SYNTH_FRAMES_PER_CALLBACK,
    events: Optional[List[Tuple[float, str]]] = None,
) -> Timeline:
    lib = load_library()
    bank = bank.fork() if bank is not None else WaveBank()
    sdir = str(script_dir or pathlib.Path.cwd())

    # table-generation registry: every valid builtin slot gets a gen id
    gen_tables: List[np.ndarray] = []
    metas = (_SlotMeta * C.WAVE_TABLE_MAX)()
    for i, s in enumerate(bank.slots):
        m = metas[i]
        if s.valid:
            m.valid = 1
            m.size = s.size
            m.rate = s.rate
            m.one_shot = s.one_shot
            m.loop_enabled = s.loop_enabled
            m.loop_start = s.loop_start
            m.loop_end = s.loop_end
            m.midi_note = s.midi_note
            m.offset_hz = s.offset_hz
            m.table_gen = len(gen_tables)
            gen_tables.append(s.data)
        else:
            m.valid = 0
            m.table_gen = -1

    carr = (ctypes.c_char_p * len(lines))(
        *[l.encode("utf-8", "replace") for l in lines])
    ev = sorted(events or [])
    ev_t = (ctypes.c_double * max(len(ev), 1))(
        *[float(int(t * C.MAIN_SAMPLE_RATE)) for t, _ in ev])
    ev_s = (ctypes.c_char_p * max(len(ev), 1))(
        *[l.encode() for _, l in ev] if ev else [b""])

    out = _Out()
    rc = lib.skc_compile(carr, len(lines), sdir.encode(),
                         ctypes.c_double(seconds), block,
                         metas, C.WAVE_TABLE_MAX, ev_t, ev_s, len(ev),
                         ctypes.byref(out))
    if rc == 2:
        raise NotImplementedError(
            "script uses recorder capture (< / *) or /wex — compile with "
            "the Python path (host.timeline.compile_script)")
    if rc != 0:
        raise RuntimeError(f"skc_compile failed: {rc}")

    try:
        S = out.num_segments
        nb = out.num_blocks
        nf = lib.skc_num_f32()
        ni = lib.skc_num_i32()
        f32 = np.ctypeslib.as_array(out.f32, shape=(S, nf, V)).copy()
        i32 = np.ctypeslib.as_array(out.i32, shape=(S, ni, V)).copy()
        scalars = np.ctypeslib.as_array(out.scalars, shape=(S,)).copy()
        ops_bytes = lib.skc_ops_bytes()
        ops_raw = np.ctypeslib.as_array(out.ops, shape=(S, ops_bytes)).copy()
        seg_of_block = np.ctypeslib.as_array(out.seg_of_block, shape=(nb,)).copy() \
            if nb else np.zeros(0, np.int32)
        seg_is_start = (np.ctypeslib.as_array(out.seg_is_start, shape=(max(nb, 1),))
                        .copy()[:nb].astype(bool))
        loads = np.ctypeslib.as_array(out.loads,
                                      shape=(max(out.num_loads, 1), 4)).copy() \
            [: out.num_loads]
        bind_gens = np.ctypeslib.as_array(
            out.bind_gens, shape=(max(out.num_keys, 1),)).copy()[: out.num_keys]
    finally:
        lib.skc_free(ctypes.byref(out))

    # replay the :w loads on the bank to materialize the table data
    for which, where, ch, gen in loads:
        ok = bank.load_wav(int(which), int(where), int(ch),
                           search_dir=pathlib.Path(sdir))
        assert gen == len(gen_tables), "load generation mismatch"
        gen_tables.append(bank.slots[int(where)].data
                          if ok else np.zeros(1, np.float32))

    params = {}
    for j, name in enumerate(PARAM_F32):
        params[name] = f32[:, j, :]
    for j, name in enumerate(PARAM_I32 + PARAM_I64_AS_I32):
        params[name] = i32[:, j, :]
    params["volume_final"] = scalars.astype(np.float32)

    ops = {}
    off = 0
    for name, dt, count in _OPS_LAYOUT:
        width = np.dtype(dt).itemsize * count
        # slice per segment at the field's offset
        field = np.stack([
            np.frombuffer(ops_raw[s].tobytes(), dtype=dt, count=count,
                          offset=off)
            for s in range(S)
        ]) if S else np.zeros((0, count), dt)
        if dt == np.uint8 and name.startswith(("set_", "clear_")):
            field = field.astype(bool)
        ops[name] = field
        off += width

    # bound tables, in first-bind order (keys already match Python's)
    table_list = [gen_tables[g] for g in bind_gens]
    offsets = np.zeros(max(len(table_list), 1), dtype=np.int32)
    offn = 0
    for i, t in enumerate(table_list):
        offsets[i] = offn
        offn += t.size
    buffer = (np.concatenate([t.astype(np.float32) for t in table_list])
              if table_list else np.zeros(1, np.float32))

    mod_passes = 1
    fused_passes: Optional[int] = 1
    for s in range(S):
        seg = {name: params[name][s] for name in
               ("freq_mod_osc", "amp_mod_osc", "pan_mod_osc", "cz_mod_osc",
                "freq_mod_depth", "amp_mod_depth", "pan_mod_depth",
                "cz_mod_depth", "cz_mode", "disconnect")}
        mod_passes = max(mod_passes, _mod_passes_arrays(seg))
        fp = _fused_passes_arrays(seg)
        fused_passes = None if (fp is None or fused_passes is None) \
            else max(fused_passes, fp)

    return Timeline(
        num_blocks=nb, block=block,
        seg_of_block=seg_of_block, seg_is_start=seg_is_start,
        params=params, ops=ops,
        table_buffer=buffer, table_offsets=offsets, table_arrays=table_list,
        mod_passes=mod_passes, fused_passes=fused_passes, final_engine=None,
    )
