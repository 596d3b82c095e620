"""The general cyclic kernel's waves, on the CPU.

``cyclic_levels`` (``engine/kernels/cyclic.py``) puts each voice of a
frame in a wave: 1 + the highest wave among the voices whose sample of
the same frame it reads.  The general variant of ``csrc/cyclic.cu`` runs
a frame's waves one after another, the voices of a wave at once.  Here:
the schedule of czfb64's packed batch, of a chain of same-frame reads, of
reads that are delayed or of higher voices, and of a batch whose rows
read differently; the ``cyclic.schedule`` span of the engine's set-up.

``csrc/cyclic.cu``'s general variant is also built by g++
(``-ffp-contract=off``) with ``CYC_SHIM`` and a shim that runs a
``std::thread`` a CUDA thread of a block and a ``std::barrier`` for
``__syncthreads``, so that the voices of a wave and the mix warp run at
once between barriers (a barrier the kernel lacks, or a buffer written
while another thread still reads it, can show as a wrong bit).  Its
outputs and end states are held bit for bit to ``cyclic_block_plain``
(two NaNs count as equal), in exact and fast mode, on rows whose last
CUDA block is ragged.  The card tests (``test_torch_cyclic_cuda.py``)
hold the CUDA build to the same.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from benchmark.traffic import variants
from skred_tpu_torch import spans
from skred_tpu_torch.engine import cyclic as tc
from skred_tpu_torch.engine.kernels import build
from skred_tpu_torch.engine.kernels import cyclic as ck
from skred_tpu_torch.engine.kernels import cyclic_inputs as ci

torch.set_num_threads(1)

CONFIGS = pathlib.Path(__file__).resolve().parent.parent / "benchmark" \
    / "configs"
CZFB64 = variants.wire_lines((CONFIGS / "czfb64.sk").read_text())
# 16 voices, each reading the one below by FM in the same frame; v0
# reads v15 a frame late, which closes the cycle
CHAIN16 = ["v0 w1 f110 a5 F15,0.3 c1,0.4"] + [
    f"v{v} w{v % 3} f{50 + 7 * v} a5 F{v - 1},0.3 J1 K3000 Q2 h3"
    for v in range(1, 16)]

SHIM = r"""
// csrc/cyclic.cu's general variant on the CPU: a std::thread a CUDA
// thread of a block, a std::barrier for __syncthreads
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
using std::isfinite;
#define CYC_SHIM
#define __host__
#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
static std::barrier<>* g_bar;
#define __syncthreads() g_bar->arrive_and_wait()
static inline float __fmaf_rn(float a, float b, float c) {
    return std::fmaf(a, b, c);
}
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline int __float_as_int(float x) {
    int i; std::memcpy(&i, &x, 4); return i;
}
static inline float __int_as_float(int i) {
    float x; std::memcpy(&x, &i, 4); return x;
}
#include "cyclic.cu"

extern "C" int cyclic_general_launch(const CyclicArgs* a, void*) {
    const int k = a->k;
    if (a->rows <= 0 || k <= 0) return 0;
    const int R = gen_rows(k), threads = gen_voice_threads(k) + GEN_MIX;
    std::vector<float> smem(gen_smem_bytes(k) / sizeof(float));
    std::barrier<> bar(threads);
    g_bar = &bar;
    for (int bx = 0; bx * R < a->rows; ++bx) {
        std::vector<std::thread> th;
        for (int t = 0; t < threads; ++t)
            th.emplace_back([&, t] {
                cyclic_general_block(*a, smem.data(), bx, t);
            });
        for (auto& x : th) x.join();
    }
    return 0;
}
"""


def _same_frame_edges(reads, k):
    """Every (source, reader) pair of ``reads`` that is a same-frame read
    on some row or segment."""
    edges = set()
    for src, delayed in reads:
        src = np.asarray(src).reshape(-1, k)
        delayed = np.asarray(delayed).reshape(-1, k)
        for row, d in zip(src, delayed):
            edges |= {(int(m), v) for v, m in enumerate(row)
                      if d[v] == 0 and 0 <= m < v}
    return edges


def _drop_reads(vecs, seed, share=0.4):
    """``vecs`` with each modulator read cut (source -1) on a random
    ``share`` of the rows, read by read: rows whose graphs differ."""
    rng = np.random.default_rng(seed)
    vecs = dict(vecs)
    for key in ("fm_osc", "cm_osc", "am_osc", "pm_osc"):
        if key in vecs:
            drop = torch.from_numpy(rng.uniform(size=vecs[key].shape)
                                    < share)
            vecs[key] = torch.where(drop, -1, vecs[key]).contiguous()
    return vecs


def _czfb64_schedule():
    st = ci.packed(CZFB64, 0.02, 3)
    _, r, _ = tc._prep(st, True, "cpu")
    assert r.k == 64
    wave, count = r.schedule
    first = set(range(12)) | set(range(48, 56))
    return wave.numpy(), count, np.array(
        [0 if v in first else 1 for v in range(64)], np.int32), None


def _chain_schedule():
    k = 16
    src = np.arange(-1, k - 1)[None].repeat(3, 0)     # v reads v - 1
    wave = ck.cyclic_levels([(src, np.zeros_like(src))], k)
    return wave, int(wave.max()) + 1, np.arange(k, dtype=np.int32), None


def _late_schedule():
    """Reads of a higher voice, or delayed ones, of a chain: no wave."""
    k = 16
    up = np.arange(1, k + 1)                  # v reads v + 1 (v15: none)
    down = np.arange(-1, k - 1)
    reads = [(up[None], np.zeros((1, k))), (down[None], np.ones((1, k))),
             (np.full((1, k), k + 3), np.zeros((1, k)))]
    wave = ck.cyclic_levels(reads, k)
    return wave, int(wave.max()) + 1, np.zeros(k, np.int32), None


def _rows_differ_schedule():
    """ALL_FEATURES with reads cut on random rows, over two segments (a
    second segment with other cuts): every same-frame read of every row
    and segment goes from a lower wave to a higher one."""
    args = ci.block_inputs(ci.ALL_FEATURES, 64, seed=4, n=8)
    vecs, feat, k = args[4], args[7], args[8]
    segs = [_drop_reads(vecs, seed) for seed in (4, 5)]
    reads = [pair for s in segs for pair in ck.wave_reads(s, feat)]
    wave, count = ck.schedule_of(
        {kk: torch.cat([s[kk] for s in segs], 1) for kk in segs[0]}, feat,
        k, "cpu")
    return wave.numpy(), count, None, (reads, vecs, feat, k)


SCHEDULES = {"czfb64": _czfb64_schedule, "chain16": _chain_schedule,
             "late_reads": _late_schedule,
             "rows_differ": _rows_differ_schedule}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_cyclic_levels(case):
    """czfb64's packed batch: 2 waves, the templates v0-v11 and the LFOs
    v48-v55 first, then the fans (an LFO's cz-mod source 0 is no read:
    its CZ mode is 0).  A chain of k same-frame FM reads: k waves.  A
    delayed read, a read of a higher voice or of none: no wave.  Rows
    whose graphs differ, over two segments: every same-frame read of
    every row and segment from a lower wave to a higher one, and the
    union's chain is as long as the count."""
    wave, count, want, union = SCHEDULES[case]()
    assert wave.dtype == np.int32 and count == int(wave.max()) + 1
    if want is not None:
        assert np.array_equal(wave, want), wave
        return
    reads, vecs, feat, k = union
    edges = _same_frame_edges(reads, k)
    assert edges and all(wave[m] < wave[v] for m, v in edges)
    # the uncut vectors' reads are the union's superset
    assert edges <= _same_frame_edges(ck.wave_reads(vecs, feat), k)
    # every wave but the first is reached by a read from the one below
    assert all(any(wave[m] == w - 1 and wave[v] == w for m, v in edges)
               for w in range(1, count))


def test_prepare_records_the_wave_count():
    """``cyclic.schedule`` inside ``cyclic.prepare``, ``n`` = the batch's
    wave count (czfb64: 2)."""
    last = max((r.id for r in spans.records()), default=0)
    st = ci.packed(CZFB64, 0.02, 2)
    tc._prep(st, True, "cpu")
    recs = [r for r in spans.records() if r.id > last]
    (prep,) = [r for r in recs if r.name == "cyclic.prepare"]
    (sched,) = [r for r in recs if r.name == "cyclic.schedule"]
    assert sched.parent == prep.id and sched.n == 2


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ not found: the port's native compiler needs it "
                    "too")
    where = tmp_path_factory.mktemp("cyclic_shim")
    (where / "inc").mkdir()
    (where / "inc" / "cuda_runtime.h").write_text("")
    (where / "shim.cpp").write_text(SHIM)
    so = where / "libcyclic_shim.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", f"-I{where / 'inc'}", f"-I{build.CSRC}", "-o", str(so),
         str(where / "shim.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return ctypes.CDLL(str(so))


def _bits_equal(a, b):
    a, b = a.contiguous().numpy(), b.contiguous().numpy()
    if a.dtype != np.float32:
        return np.array_equal(a, b)
    return bool(((a.view(np.int32) == b.view(np.int32))
                 | (np.isnan(a) & np.isnan(b))).all())


def _shim_inputs(case):
    """cyclic_block's arguments: each case's rows leave the last CUDA
    block ragged (4, 16 and 16 rows a block)."""
    if case == "czfb64":
        return ci.block_inputs(CZFB64, 5, seed=11, n=12)
    if case == "chain16":
        return ci.block_inputs(CHAIN16, 9, seed=12, n=32)
    args = list(ci.block_inputs(ci.ALL_FEATURES, 19, seed=13, n=48))
    if case == "rows_differ":
        args[4] = _drop_reads(args[4], 13)
    else:
        # the renderer's carry layout: transposed [B, k] states
        args[5] = {kk: (v.T.contiguous().T if v.dim() == 2 else v)
                   for kk, v in args[5].items()}
    return tuple(args)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("case", ["czfb64", "chain16", "all_features",
                                  "rows_differ"])
def test_general_variant_on_the_cpu(case, exact, shim_lib):
    """The general variant's block body, every CUDA thread a thread,
    bit-equal to the plain version: outputs and end states."""
    args = _shim_inputs(case)
    packed, out_l, out_r, ends = ck._pack_args(*args, exact)
    if case in ("czfb64", "chain16"):
        assert packed.n_waves == {"czfb64": 2, "chain16": 16}[case]
    assert shim_lib.cyclic_general_launch(ctypes.byref(packed), None) == 0
    want = ck.cyclic_block_plain(*args, exact=exact)
    assert _bits_equal(out_l, want[0]) and _bits_equal(out_r, want[1])
    assert sorted(ends) == sorted(want[2])
    for kk in want[2]:
        assert _bits_equal(ends[kk], want[2][kk]), kk
        assert ends[kk].stride() == args[5][kk].stride()


def test_the_plain_version_stands_in_for_the_wrapper(monkeypatch):
    """``cyclic_block_plain`` takes the wrapper's arguments, the renderer's
    schedule too: swapped in for it (as ``chip_smoke.py``'s short paths
    do), the render does not change."""
    st = ci.packed((ci.CORPUS / "fb3.sk").read_text().splitlines(),
                   2 * 512 / 44100, 2)
    want = tc.render_cyclic(st, device="cpu")
    monkeypatch.setattr(tc, "cyclic_block", ck.cyclic_block_plain)
    assert np.array_equal(tc.render_cyclic(st, device="cpu"), want)
