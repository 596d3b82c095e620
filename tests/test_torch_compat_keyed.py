"""The keyed compat kernel (``csrc/compat.cu``) on the CPU, and its key.

``csrc/compat.cu`` is built here by g++ (``-ffp-contract=off``) under a
key's ``-D`` defines (``CpuCompat``: a library per key at its first use;
the card-parity and render-batch tests use it too), with one of two
shims: a fiber (ucontext) a voice in one OS thread, ``__syncthreads``
and the warp vote switching through every fiber, so each reaches the
barrier before the first passes it (``FIBERS``: deterministic, fast);
or a ``std::thread`` a voice with a ``std::barrier`` (``THREADS``: the
voices run at the same time between barriers, so a missing barrier or a
shared buffer reused too early can show).  Behind the launch wrapper
(``compat._launch``) each build is held bit for bit to
``compat_block_plain`` (two NaNs count as equal), on 4 blocks of
stress64, noise64, fb1-fb5 (fb4's waits cut so that segments start past
block 1) and a voice copy, at 2 passes: each script alone under its own
narrow key, capture on and off in turn, against its row of the stacked
batch's plain render; the stacked batch under its union key, capture on
and off.  ``tests/test_torch_compat_keyed_passes.py`` takes 1 and 3
passes.  The threaded shim takes the stacked batch under its union key
at 2 passes with capture.  ``compat_key`` itself: which bits each
script turns on, the union over segments, the read marks, and the raise
when a launch needs a feature the library's key lacks.
"""

import ctypes
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from skred_tpu_torch.assets import WaveBank  # noqa: E402
from skred_tpu_torch.engine import render as tr  # noqa: E402
from skred_tpu_torch.engine.kernels import build, cuda_call  # noqa: E402
from skred_tpu_torch.engine.kernels import compat as K  # noqa: E402
from skred_tpu_torch.host.timeline import (compile_script,  # noqa: E402
                                           noise_stream)
from skred_tpu_torch.parallel.batch import stack_timelines  # noqa: E402

torch.set_num_threads(1)

CORPUS = ROOT / "corpus"
FB4_CUT = [ln.replace("~.5", "~.012")
           for ln in (CORPUS / "fb4.sk").read_text().splitlines()]
VOICE_COPY = ["v0 w0 f220 a3 h5 J900 K5000 Q25", "v1 w1 f110 a2 F0,0.5",
              "~.012 v0 >2 v2 f330 a2"]
SCRIPTS = {
    "stress64": (CORPUS / "stress64.sk").read_text().splitlines(),
    "noise64": (ROOT / "skred_tpu_torch" / "scripts"
                / "noise64.sk").read_text().splitlines(),
    **{f"fb{k}": (CORPUS / f"fb{k}.sk").read_text().splitlines()
       for k in (1, 2, 3, 5)},
    "fb4 cut": FB4_CUT, "voice copy": VOICE_COPY}
BLOCKS = 4
SECONDS = BLOCKS * 512 / 44100.0 + 1e-4

# the CUDA names compat.cu uses, for g++; each shim defines threadIdx,
# blockIdx and sync_all() (every voice of the row reaches it before any
# passes it) before this, and runs compat_kernel after it
INTRINSICS = r"""
#define COMPAT_SHIM
#define COMPAT_DEV static inline
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
#define __syncthreads() sync_all()
struct float2 { float x, y; };
static inline float2 make_float2(float a, float b) { return {a, b}; }
static inline float __fmaf_rn(float a, float b, float c) {
    return std::fmaf(a, b, c);
}
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline int __float_as_int(float x) {
    int i; std::memcpy(&i, &x, 4); return i;
}
static inline float __int_as_float(int i) {
    float x; std::memcpy(&x, &i, 4); return x;
}
// the card's conversion saturates and sends NaN to 0; (int) of such an
// operand is undefined in C++
static inline int __float2int_rz(float x) {
    return x != x || x >= 2147483648.0f || x < -2147483648.0f ? 0 : (int)x;
}
// the vote: every voice posts its bit, then reads its warp's
static int g_vote[64];
static inline bool __any_sync(unsigned, bool p) {
    const int t = threadIdx.x;
    g_vote[t] = p;
    sync_all();
    bool any = false;
    for (int u = t & ~31; u < (t & ~31) + 32; ++u) any = any || g_vote[u];
    sync_all();
    return any;
}
#include "compat.cu"
"""

FIBERS = r"""
// csrc/compat.cu on the CPU in one thread: a fiber (ucontext) a voice;
// __syncthreads and the warp vote switch to the next fiber, so every
// fiber reaches a barrier before the first passes it
#include <cmath>
#include <cstring>
#include <ucontext.h>
#include <vector>
using std::isfinite;
struct Idx { int x; };
static Idx threadIdx, blockIdx;
static void sync_all();
""" + INTRINSICS + r"""
static ucontext_t g_ctx[V], g_main;
static const CompatArgs* g_args;
static void sync_all() {
    const int from = threadIdx.x, to = (from + 1) % V;
    threadIdx.x = to;
    swapcontext(&g_ctx[from], &g_ctx[to]);
}

static void fiber() {
    compat_kernel(*g_args);
    const int t = threadIdx.x;
    threadIdx.x = t + 1;
    setcontext(t + 1 < V ? &g_ctx[t + 1] : &g_main);
}

extern "C" int compat_launch(const CompatArgs* a, void*) {
    if (!compat_key_ok(a)) return -1;
    const size_t stack = 1 << 18;
    std::vector<char> mem(V * stack);
    g_args = a;
    for (int b = 0; b < a->rows; ++b) {
        blockIdx.x = b;
        for (int v = 0; v < V; ++v) {
            getcontext(&g_ctx[v]);
            g_ctx[v].uc_stack.ss_sp = mem.data() + v * stack;
            g_ctx[v].uc_stack.ss_size = stack;
            g_ctx[v].uc_link = nullptr;
            makecontext(&g_ctx[v], fiber, 0);
        }
        threadIdx.x = 0;
        swapcontext(&g_main, &g_ctx[0]);
    }
    return 0;
}
"""

THREADS = r"""
// csrc/compat.cu on the CPU with a std::thread a voice and a std::barrier
// for __syncthreads: the voices run at the same time between barriers,
// so a barrier the kernel lacks, or a shared buffer written while
// another voice still reads it, can show as a wrong bit
#include <barrier>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>
using std::isfinite;
struct Idx { int x; };
static thread_local Idx threadIdx, blockIdx;
static std::barrier<>* g_bar;
static void sync_all() { g_bar->arrive_and_wait(); }
""" + INTRINSICS + r"""
extern "C" int compat_launch(const CompatArgs* a, void*) {
    if (!compat_key_ok(a)) return -1;
    std::barrier<> bar(V);
    g_bar = &bar;
    for (int b = 0; b < a->rows; ++b) {
        std::vector<std::thread> th;
        for (int v = 0; v < V; ++v)
            th.emplace_back([a, b, v] {
                blockIdx.x = b;
                threadIdx.x = v;
                compat_kernel(*a);
            });
        for (auto& t : th) t.join();
    }
    return 0;
}
"""
SHIMS = {"fibers": FIBERS, "threads": THREADS}


class CpuCompat:
    """``csrc/compat.cu`` built by g++ (``-ffp-contract=off``) with a
    shim (``SHIMS``: the fibers, or a thread a voice) into ``where``, one
    library per key at its first use (half a second a build); ``load``
    and ``launch`` stand in for ``build.load`` and ``cuda_call.launch``,
    and a launch the library refuses raises as ``cuda_call.launch``
    does."""

    def __init__(self, where: pathlib.Path, shim: str = "fibers"):
        self.gxx = shutil.which("g++")
        if self.gxx is None:
            pytest.fail("g++ not found: the port's native compiler needs "
                        "it too")
        self.where, self.shim = where, shim
        (where / "inc").mkdir(exist_ok=True)
        (where / "inc" / "cuda_runtime.h").write_text("")
        self.src = where / f"{shim}.cpp"
        self.src.write_text(SHIMS[shim])
        self.libs = {}

    def build(self, keys) -> None:
        """Build every key of ``keys`` not built yet, all together."""
        procs = {}
        for key in dict.fromkeys(keys):
            if key in self.libs or key in procs:
                continue
            so = self.where / (f"libcompat_{self.shim}_"
                               f"{len(self.libs) + len(procs)}.so")
            procs[key] = (so, subprocess.Popen(
                [self.gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                 "-fPIC", "-shared", "-pthread", f"-I{self.where / 'inc'}",
                 f"-I{build.CSRC}", *[f"-D{d}" for d in key], "-o", str(so),
                 str(self.src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for key, (so, proc) in procs.items():
            out, _ = proc.communicate()
            assert proc.returncode == 0, out
            self.libs[key] = ctypes.CDLL(str(so))

    def load(self, name, key=(), entry=None):
        assert name == "compat" and entry is None, (name, entry)
        self.build([tuple(key)])
        return self.libs[tuple(key)]

    def launch(self, name, args, device, key=(), entry=None):
        assert (name, device.type, entry) == ("compat", "cpu", None)
        self.launches = getattr(self, "launches", 0) + 1
        if self.load(name, key).compat_launch(ctypes.byref(args), None):
            raise RuntimeError("compat_launch failed: the arguments are "
                               "not the build's key")

    def patch(self, mp) -> None:
        """Route the wrapper's builds and launches here (``mp``: a
        MonkeyPatch)."""
        mp.setattr(build, "load", self.load)
        mp.setattr(cuda_call, "launch", self.launch)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits, two NaNs counting as equal."""
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(a) & torch.isnan(b)
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | nan).all())


def timelines(names):
    bank = WaveBank()
    return [compile_script(SCRIPTS[n], SECONDS, bank=bank,
                           script_dir=CORPUS) for n in names]


def plain_render(st, passes):
    """The stacked batch's plain render over BLOCKS blocks with capture:
    (carry, out, cap)."""
    inp = tr.stacked_inputs(st, "cpu")
    noise = torch.as_tensor(noise_stream(BLOCKS * 512))
    return K.compat_block_plain(inp, K.zero_carry(st.batch, "cpu"), noise,
                                0, BLOCKS, passes, True, True)


def held(got, want, rows, capture, what):
    """The kernel's (carry, out, cap) against rows ``rows`` of the plain
    render's."""
    for g, w, nm in zip(got[0], want[0], ("cf", "ci", "vol_gain")):
        assert bits_equal(g, w[rows]), f"{what}: {nm}"
    assert bits_equal(got[1], want[1][rows]), f"{what}: out"
    if capture:
        assert bits_equal(got[2], want[2][rows]), f"{what}: cap"
    else:
        assert got[2] is None


def kernel_render(inp, passes, capture):
    noise = torch.as_tensor(noise_stream(BLOCKS * 512))
    return K._launch(inp, K.zero_carry(inp.rows, "cpu"), noise, 0, BLOCKS,
                     passes, True, capture)


# ---- compat_key ----

def fields(key) -> dict:
    """{define: int value} of a build key."""
    return {k.split("=")[0]: int(k.split("=")[1], 0) for k in key}


def _need(names):
    st = stack_timelines(timelines(names))
    return tr.stacked_inputs(st, "cpu"), st


def test_key_bits_of_each_script():
    """The flags, curves and reads each script turns on, as the kernel's
    defines name them."""
    want = {
        "stress64": ({"use_fm", "hold_on", "quant", "use_flt", "no_rel",
                      "use_sm", "disc"}, {1, 2, 3, 4, 5, 6, 7},
                     {"fm", "cz"}, 1),
        "fb1": ({"use_fm", "use_flt", "no_rel", "use_sm"}, set(), {"fm"}, 1),
        "fb2": ({"use_fm", "hold_on", "quant", "no_rel", "use_sm", "disc"},
                {1}, {"fm", "cz", "am"}, 1),
        "fb5": ({"use_fm", "osn", "one_shot", "use_env", "env_act",
                 "no_rel", "use_sm"}, set(), {"fm"}, 1)}
    for name, (flags, curves, mods, pow2) in want.items():
        inp, st = _need([name])
        k = fields(K.compat_key(inp, st.mod_passes, False))
        assert {n for b, n in enumerate(K.FLAGS)
                if k["COMPAT_FLAGS"] >> b & 1} == flags, name
        assert {m for m in range(8)
                if k["COMPAT_CZ_MASK"] >> m & 1} == curves, name
        assert {n for b, n in enumerate(K.MODS)
                if k["COMPAT_MODS"] >> b & 1} == mods, name
        assert k["COMPAT_TS_POW2"] == pow2, name
        assert (k["COMPAT_PASSES"], k["COMPAT_CAPTURE"]) == (2, 0), name


def test_key_is_the_union_over_rows_and_segments():
    """A stacked batch's key is the union of its rows' keys; a script
    whose second segment adds a feature has it in its key."""
    names = ["fb1", "fb5", "stress64"]
    inp, st = _need(names)
    u = fields(K.compat_key(inp, 2, True))
    parts = [fields(K.compat_key(_need([n])[0], 2, True))
             for n in names]
    for d in ("COMPAT_FLAGS", "COMPAT_CZ_MASK", "COMPAT_MODS"):
        want = 0
        for p in parts:
            want |= p[d]
        assert u[d] == want, d
    two = ["v0 w1 f220 a3", "~.012 v0 c3,0.4 t10,200,0.3,400 l1"]
    tl = compile_script(two, SECONDS, bank=WaveBank(), script_dir=CORPUS)
    inp2 = tr.stacked_inputs(tr._stacked(tl), "cpu")
    assert inp2.pf.shape[1] == 2
    k = fields(K.compat_key(inp2, 1, False))
    assert k["COMPAT_CZ_MASK"] == 1 << 3
    assert k["COMPAT_FLAGS"] & 1 << K.FLAGS.index("use_env")


def test_read_marks():
    """A voice is marked read where a higher voice reads it: stress64's
    modulators v48-v55 (read by v56-v63) and v0 (every CZ voice's
    modulator index defaults to 0); fb1's v0, read by v1, not v1."""
    inp, _ = _need(["stress64"])
    fl = inp.pi[0, 0, 0]
    read = {v for v in range(64) if int(fl[v]) & K.READ}
    assert read == {0} | set(range(48, 56))
    inp, _ = _need(["fb1"])
    fl = inp.pi[0, 0, 0]
    assert int(fl[0]) & K.READ and not int(fl[1]) & K.READ


def test_launch_raises_on_a_key_that_lacks_a_feature(tmp_path,
                                                     monkeypatch):
    """The library refuses arguments that need a feature outside its key,
    or another pass count (-1), and the launch wrapper raises on that."""
    inp, st = _need(["fb5"])
    narrow = K.compat_key(_need(["fb1"])[0], 2, False)
    wrong = K.compat_key(inp, 3, False)
    noise = torch.as_tensor(noise_stream(BLOCKS * 512))
    cpu = CpuCompat(tmp_path)
    # the outputs stay alive with args: the launch that is taken writes them
    args, *outputs = K._pack_args(inp, K.zero_carry(1, "cpu"), noise, 0,
                                  BLOCKS, 2, False)
    for key in (narrow, wrong):
        assert cpu.load("compat", key).compat_launch(ctypes.byref(args),
                                                     None) == -1
    assert cpu.load("compat", K.compat_key(inp, 2, False)).compat_launch(
        ctypes.byref(args), None) == 0
    cpu.patch(monkeypatch)
    for key in (narrow, wrong):
        monkeypatch.setattr(K, "compat_key", lambda *a, key=key: key)
        with pytest.raises(RuntimeError, match="not the build's key"):
            kernel_render(inp, 2, False)


# ---- the keyed source against the plain version ----

@pytest.fixture(scope="module")
def stacked():
    names = list(SCRIPTS)
    st = stack_timelines(timelines(names))
    assert st.mod_passes == 2
    assert np.asarray(st.seg_is_start)[:, 2:].any()
    return names, st


@pytest.fixture(scope="module")
def plain2(stacked):
    return plain_render(stacked[1], 2)


def test_each_script_under_its_own_key(stacked, plain2, tmp_path,
                                       monkeypatch):
    """Every script alone, under its own narrow key, at 2 passes (capture
    on and off in turn) = its row of the stacked plain render."""
    names, st = stacked
    runs = []
    for r, name in enumerate(names):
        tl = timelines([name])[0]
        inp = tr.stacked_inputs(tr._stacked(tl), "cpu")
        runs.append((r, name, inp, r % 2 == 0))
    keys = {name: K.compat_key(inp, 2, cap) for _, name, inp, cap in runs}
    assert len(set(keys.values())) == len(keys)
    cpu = CpuCompat(tmp_path)
    cpu.build(keys.values())
    cpu.patch(monkeypatch)
    monkeypatch.setattr(K, "compat_block_plain", None)
    for r, name, inp, cap in runs:
        before = K.compat_block.launches
        got = kernel_render(inp, 2, cap)
        assert K.compat_block.launches == before + 1
        held(got, plain2, [r], cap, name)


def test_stacked_batch_under_its_union_key(stacked, plain2, tmp_path,
                                           monkeypatch):
    """The stacked batch under its union key, capture on and off, at 2
    passes."""
    _, st = stacked
    inp = tr.stacked_inputs(st, "cpu")
    keys = [K.compat_key(inp, 2, cap) for cap in (True, False)]
    cpu = CpuCompat(tmp_path)
    cpu.build(keys)
    cpu.patch(monkeypatch)
    rows = list(range(st.batch))
    for cap in (True, False):
        held(kernel_render(inp, 2, cap), plain2, rows, cap,
             f"union key, capture={cap}")


def test_stacked_batch_under_its_union_key_threaded(stacked, plain2,
                                                    tmp_path, monkeypatch):
    """The stacked batch under its union key at 2 passes with capture,
    compat.cu under the threaded shim (voices at the same time between
    barriers)."""
    _, st = stacked
    inp = tr.stacked_inputs(st, "cpu")
    cpu = CpuCompat(tmp_path, "threads")
    cpu.patch(monkeypatch)
    held(kernel_render(inp, 2, True), plain2, list(range(st.batch)),
         True, "union key, capture, threads")


# ---- the measurement tools ----

@pytest.mark.parametrize("argv", [
    ["compat_stamps"], ["compat_turns", "--keys"],
    ["compat_turns", "--other", "."], ["compat_turns", "--walls", "--other",
                                       "."]], ids=" ".join)
def test_measurement_tools_need_the_card(monkeypatch, capsys, argv):
    """Without a card each of them prints an error line and exits 2."""
    import importlib

    tool = importlib.import_module(f"skred_tpu_torch.tools.{argv[0]}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as ex:
        tool.main(argv[1:])
    assert ex.value.code == 2
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err


def test_widened_keys_take_what_the_own_key_takes():
    """compat_turns --keys: each widened key keeps the own key's pass
    count and capture, sets only its part, and is a superset the library
    takes (compat_key_ok's rule)."""
    from skred_tpu_torch.tools.compat_turns import WIDE, widened

    inp, st = _need(["fb1"])
    own = K.compat_key(inp, st.mod_passes, True)
    assert widened(own, ()) == own
    for part, (define, value) in WIDE.items():
        got = fields(widened(own, (part,)))
        want = fields(own) | {define: int(value, 0)}
        assert got == want, part
    full = fields(widened(own, tuple(WIDE)))
    assert (full["COMPAT_PASSES"], full["COMPAT_CAPTURE"]) == (2, 1)
    assert full["COMPAT_FLAGS"] == K.KEY_FLAGS
    assert full["COMPAT_MODS"] == (1 << len(K.MODS)) - 1
    assert (full["COMPAT_CZ_MASK"], full["COMPAT_TS_POW2"]) == (0xff, 0)
