"""The noise pass's three kernels against the JAX package's.

``phase_walk_plain``, ``lookup_plain`` (through ``table_lookup_grouped``
and ``table_lookup_pallas``) and ``filt_smooth_plain`` must equal
``phase_walk_pallas``, ``table_lookup_grouped``, ``table_lookup_pallas``
and ``filt_smooth_pallas`` run in interpret mode bit for bit, on random
blocks from a numpy seed.  The CUDA kernels are held against the plain
versions on the card by tests/test_torch_noise_cuda.py and
chip_smoke.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skred_tpu.engine import kernels as jk
from skred_tpu_torch.engine.kernels import filt_smooth as fs
from skred_tpu_torch.engine.kernels import lookup as lk
from skred_tpu_torch.engine.kernels import phase_walk as pw
from skred_tpu_torch.engine.kernels.noise_inputs import (
    NOISE64_FS0, NOISE64_FS1, NOISE64_FSN1, NOISE64_WARP1, random_fs_inputs,
    random_lookup_inputs, random_noise_fs_inputs, random_phase_inputs,
    random_warp_inputs)
from skred_tpu_torch.engine.kernels.tier import Fold

torch.set_num_threads(1)

# FsFeat cases (flt, sm, hold, quant, am_self, env, am, alive_arr).  The
# smoother stays off wherever a per-sample gain factor (env, am stream or
# am-self) feeds it: XLA's CPU compiler contracts the interpreted
# kernel's ``amp*env*amod - sg`` into one fma there, while the port (like
# the TPU kernel) rounds the product and the difference separately.
# noise64's tier-1 set is such a case; the whole-render test of
# tests/test_torch_fused.py covers it (about -130 dB).
FS_CASES = {
    "noise64_tier0": NOISE64_FS0,
    "noise64_tier1_without_sm": NOISE64_FS1[:1] + (False,) + NOISE64_FS1[2:],
    "noise64_tier1_without_gain_streams": (True, True, True, True, False,
                                           False, False, True),
    "all_but_sm": (True, False, True, True, True, True, True, True),
}


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, what
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    bad = a != b
    assert not bad.any(), f"{what}: {bad.sum()} of {bad.size} differ"


def _interpret(fn, *args, **kw):
    old = jk.INTERPRET
    jk.INTERPRET = True
    try:
        out = fn(*args, **kw)
        return jax.tree_util.tree_map(np.asarray, out)
    finally:
        jk.INTERPRET = old
        jax.clear_caches()


def _flushed(fn, *args, **kw):
    # XLA's CPU runtime flushes denormals; run the plain version the same
    torch.set_flush_denormal(True)
    try:
        return fn(*args, **kw)
    finally:
        torch.set_flush_denormal(False)


@pytest.mark.parametrize("fm", [False, True])
@pytest.mark.parametrize("finish", [False, True])
def test_phase_walk_plain_matches_pallas_interpret(fm, finish):
    n, m = 64, 1024
    args = random_phase_inputs(fm, finish, n, m, seed=5)
    want = _interpret(jk.phase_walk_pallas, *map(_j, args), fm=fm,
                      finish=finish, n=n)
    got = _flushed(pw.phase_walk_plain, *map(_t, args), fm=fm,
                   finish=finish, n=n)
    if finish:
        assert 0 < want[1].mean() < 1, "no lane died or every lane did"
    for k, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
        else:
            _same(g.numpy(), w, f"output {k}")


@pytest.mark.parametrize("slot_size", [4096, 32768])
def test_lookup_plain_matches_table_lookup_grouped(slot_size):
    table, slot, idx = random_lookup_inputs(128, 96, slot_size, seed=2)
    tab3 = table.reshape(-1, slot_size // 128, 128)
    want = _interpret(jk.table_lookup_grouped, _j(tab3), _j(slot), _j(idx),
                      slot_size=slot_size)
    before = lk.table_lookup_grouped.launches
    got = lk.table_lookup_grouped(_t(tab3), _t(slot), _t(idx), slot_size)
    assert lk.table_lookup_grouped.launches == before
    _same(got.numpy(), want, "out")


@pytest.mark.parametrize("slot_size", [4096, 32768])
def test_lookup_plain_matches_table_lookup_pallas(slot_size):
    # indices past the slot read 0 in both
    table, slot, idx = random_lookup_inputs(128, 16, slot_size, seed=3,
                                            out_of_range=True)
    tab3 = table.reshape(-1, slot_size // 128, 128)
    want = _interpret(jk.table_lookup_pallas, _j(tab3), _j(slot), _j(idx),
                      slot_size=slot_size)
    got = lk.table_lookup_pallas(_t(tab3), _t(slot), _t(idx), slot_size)
    assert (want == 0).any() and (want != 0).mean() > 0.9
    _same(got.numpy(), want, "out")


def test_lookup_pass_form_is_the_flat_gather():
    """``lookup(table, table_off, max(size, 1), idx)`` on time-major
    indices is the XLA branch's ``table_buffer[table_off + idx]``."""
    rng = np.random.default_rng(9)
    table = rng.standard_normal(3 * 32768).astype(np.float32)
    size = rng.choice(np.array([0, 1, 707, 4096, 32768], np.int32), 40)
    off = rng.integers(0, 2, 40).astype(np.int32) * 32768
    idx = (rng.uniform(0, 1, (64, 40)) * np.maximum(size, 1)).astype(
        np.int32)
    got = lk.lookup(_t(table), _t(off), _t(np.maximum(size, 1)), _t(idx))
    _same(got.numpy(), table[off[None, :] + idx], "out")


# lane counts that are no multiple of the kernel's 4-lane quads nor of the
# JAX grouped kernel's 32-lane groups
RAGGED = [(97, 128), (33, 128)]


@pytest.mark.parametrize("slot_size", [4096, 32768])
@pytest.mark.parametrize("m,n", RAGGED)
def test_lookup_plain_matches_table_lookup_pallas_ragged(m, n, slot_size):
    """Indices out of range both ways (below 0, at or past the slot's
    end) read 0 in the JAX kernel and in both lane-major forms here."""
    table, slot, idx = random_lookup_inputs(n, m, slot_size, seed=m,
                                            out_of_range=True, negative=True)
    assert (idx < 0).any() and (idx >= slot_size).any()
    tab3 = table.reshape(-1, slot_size // 128, 128)
    want = _interpret(jk.table_lookup_pallas, _j(tab3), _j(slot), _j(idx),
                      slot_size=slot_size)
    for fn in (lk.table_lookup_pallas, lk.table_lookup_grouped):
        got = fn(_t(tab3), _t(slot), _t(idx), slot_size)
        _same(got.numpy(), want, fn.__name__)


@pytest.mark.parametrize("slot_size", [4096, 32768])
@pytest.mark.parametrize("m,n", RAGGED)
def test_lookup_plain_matches_table_lookup_grouped_ragged(m, n, slot_size):
    """The JAX grouped kernel pads the lanes to its groups.  It takes
    clipped indices only (its docstring): past the slot its interpreted
    sweep reads the slot's last row, below 0 it sweeps 2^25 rows.  So its
    indices stay inside the slot here; out of range, the port's grouped
    form is held to ``table_lookup_pallas`` above."""
    table, slot, idx = random_lookup_inputs(n, m, slot_size, seed=m + 1)
    tab3 = table.reshape(-1, slot_size // 128, 128)
    want = _interpret(jk.table_lookup_grouped, _j(tab3), _j(slot), _j(idx),
                      slot_size=slot_size)
    got = lk.table_lookup_grouped(_t(tab3), _t(slot), _t(idx), slot_size)
    _same(got.numpy(), want, "out")


@pytest.mark.parametrize("m,n", RAGGED + [(40, 7)])
def test_lookup_pass_form_matches_the_xla_gather(m, n):
    """The pass form on time-major indices against the JAX package's XLA
    branch, ``table_buffer[table_off[..., None] + idx]``
    (``skred_tpu/engine/fused.py:573``), on indices clipped to
    ``max(size, 1)`` as the walk clips them, tables of size 0 and 1
    among them."""
    rng = np.random.default_rng(m + n)
    table = rng.standard_normal(3 * 32768).astype(np.float32)
    size = rng.choice(np.array([0, 1, 707, 4096, 32768]), m)
    off = (rng.integers(0, 2, m) * 32768).astype(np.int32)
    lim = np.maximum(size, 1).astype(np.int32)
    idx = (rng.uniform(0, 1, (m, n)) * lim[:, None]).astype(np.int32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(off)[..., None]
                                         + jnp.asarray(idx)])
    got = lk.lookup(_t(table), _t(off), _t(lim),
                    _t(np.ascontiguousarray(idx.T)))
    _same(got.numpy().T, want, "out")


@pytest.mark.parametrize("what", ["table", "idx"])
def test_lookup_refuses_2_31_elements(what):
    """The kernel's index arithmetic is 32-bit: its wrapper refuses a
    table or an index block of 2^31 elements (meta tensors: no memory)."""
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    table = meta((2 ** 31 if what == "table" else 64,), torch.float32)
    idx = meta((2 ** 16, 2 ** 15) if what == "idx" else (4, 8), torch.int32)
    lanes = idx.shape[1]
    with pytest.raises(ValueError, match=r"2\^31"):
        lk._pack_args(table, meta((lanes,), torch.int32),
                      meta((lanes,), torch.int32), idx, False)


@pytest.mark.parametrize("case", sorted(FS_CASES))
def test_filt_smooth_plain_matches_pallas_interpret(case):
    feat = FS_CASES[case]
    n, m = 64, 1024
    args = random_fs_inputs(feat, n, m, seed=7)
    want = _interpret(jk.filt_smooth_pallas, *map(_j, args), exact=True,
                      feat=feat)
    got = _flushed(fs.filt_smooth_plain, *map(_t, args), feat=feat)
    assert (want[0] != 0).mean() > 0.5, "too few live samples to compare"
    for k, (g, w) in enumerate(zip(got, want)):
        _same(g.numpy(), w, f"output {k}")


def test_cpu_tensors_take_the_plain_versions():
    """The noise pass's three wrappers on noise64's tier-1 feature sets:
    a CPU tensor runs the plain version and launches nothing."""
    before = (pw.phase_walk_warp.launches, fs.filt_smooth_noise.launches,
              lk.lookup.launches, lk.table_lookup_pallas.launches)
    n, m, b, w = 16, 256, 8, 4
    bank, prev, vecs, ph0, fin0 = random_warp_inputs(NOISE64_WARP1, n, m,
                                                      b, w, seed=1)
    args = (Fold(_t(bank), _t(prev), w), {k: _t(x) for k, x in vecs.items()},
            _t(ph0), _t(fin0))
    got = pw.phase_walk_warp(*args, feat=NOISE64_WARP1, n=n, b=b)
    want = pw.phase_walk_warp_plain(*args, feat=NOISE64_WARP1, n=n, b=b)
    for g, x in zip(got, want):
        _same(g.numpy(), x.numpy(), "phase_walk_warp")
    f, nz, cnt, cbase, bank, prev, vecs, states = random_noise_fs_inputs(
        NOISE64_FSN1, n, m, b, w, seed=1)
    args = (_t(f), _t(nz), _t(cnt), cbase, Fold(_t(bank), _t(prev), w),
            {k: _t(x) for k, x in vecs.items()},
            {k: _t(x) for k, x in states.items()})
    out, ends = fs.filt_smooth_noise(*args, feat=NOISE64_FSN1, b=b)
    want, want_ends = fs.filt_smooth_noise_plain(*args, feat=NOISE64_FSN1,
                                                 b=b)
    _same(out.numpy(), want.numpy(), "filt_smooth_noise")
    for k, x in ends.items():
        _same(x.numpy(), want_ends[k].numpy(), k)
    table, slot, idx = random_lookup_inputs(16, 64, 4096, seed=1)
    lk.table_lookup_pallas(_t(table).reshape(-1, 32, 128), _t(slot),
                           _t(idx))
    after = (pw.phase_walk_warp.launches, fs.filt_smooth_noise.launches,
             lk.lookup.launches, lk.table_lookup_pallas.launches)
    assert after == before, "a CPU tensor launched a kernel"


def _c_struct_fields(src, name):
    """(field, "int" | "ptr") of a C struct, in order."""
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        if "*" in decl:
            fields += [(f, "ptr") for f in re.findall(r"\*\s*(\w+)", decl)]
        else:
            kind = "int64" if decl.startswith("long long") else "int"
            names = decl.replace("long long", "").split()[1 if kind == "int"
                                                        else 0:]
            fields += [(f.strip(","), kind) for f in names]
    return fields


@pytest.mark.parametrize("kernel,struct,cls", [
    ("lookup", "LookupArgs", lk.LookupArgs),
    ("phase_walk", "PhaseWarpArgs", pw.PhaseWarpArgs),
    ("filt_smooth", "FiltNoiseArgs", fs.FiltNoiseArgs),
])
def test_args_match_cuda_structs(kernel, struct, cls):
    src = open(pw.__file__.rsplit("/", 1)[0]
               + f"/csrc/{kernel}.cu").read()
    kinds = {pw.ctypes.c_void_p: "ptr", pw.ctypes.c_int: "int",
             pw.ctypes.c_longlong: "int64"}
    want = [(k, kinds[t]) for k, t in cls._fields_]
    assert _c_struct_fields(src, struct) == want
