"""The master-volume kernel (``engine/kernels/volume.py``,
``csrc/volume.cu``) and its plain version.

On the CPU: ``volume_plain`` is the fused block step's volume step as it
was written before the kernel (frozen below) bit for bit, over volumes
with zeros and random start gains, and stays near a float64 serial
recurrence; ``csrc/volume.cu``'s thread body, built by g++
(``-ffp-contract=off``) with ``VOL_SHIM`` and run thread by thread, is
``volume_plain`` bit for bit, up to the kernel's largest ``n``; the
wrapper runs the plain version for a CPU tensor, records its span and
refuses a tensor of another device, type or shape, a non-contiguous one
and an ``n`` out of range; the fused renders hand it inputs its checks
take.  On the card (skipped without one; no JAX is imported, so it runs
on a machine with the port's dependencies alone):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_volume.py

the kernel against ``volume_plain`` over the same grid, and stress64 and
noise64 (8 rows x 4 blocks) rendered on the card bit-equal to the CPU
render, one volume launch a block.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from skred_tpu_torch import spans
from skred_tpu_torch.assets import WaveBank
from skred_tpu_torch.engine import fused
from skred_tpu_torch.engine.kernels import build
from skred_tpu_torch.engine.kernels import volume as vk
from skred_tpu_torch.host import timeline
from skred_tpu_torch.parallel import batch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
STRESS64 = ROOT / "corpus" / "stress64.sk"
NOISE64 = ROOT / "skred_tpu_torch" / "scripts" / "noise64.sk"
NS = (1, 2, 3, 7, 512)
ROWS = (1, 33, 1024)
GRID = [(n, b) for n in NS for b in ROWS]


def _inputs(n, b, seed=0, device="cpu"):
    """Random stereo mix, volumes (every fifth 0) and start gains (every
    seventh 0)."""
    rng = np.random.default_rng(seed + 1000 * n + b)
    vf = rng.uniform(0.0, 1.5, b).astype(np.float32)
    vf[::5] = 0.0
    vg = rng.uniform(0.0, 1.5, b).astype(np.float32)
    vg[3::7] = 0.0
    mix = rng.normal(0.0, 0.3, (2, n, b)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (mix[0], mix[1], vf, vg))


# ---- the volume step as fused.py had it before the kernel (frozen) ----

def _scan_before(combine, elems):
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = combine([e[0:n - 1:2] for e in elems],
                      [e[1::2] for e in elems])
    odd = _scan_before(combine, reduced)
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


def _volume_before(mix_l, mix_r, vf, vol_gain, n):
    b = vf.shape[0]
    a = float(np.float32(1.0) - np.float32(0.002))
    aa = torch.full_like(vf, a)[None].expand(n, b)
    bb = (float(np.float32(0.002)) * vf)[None].expand(n, b)
    bb = torch.cat([(bb[0] + aa[0] * vol_gain)[None], bb[1:]], dim=0)
    vg = _scan_before(lambda l, r: [l[0] * r[0], l[1] * r[0] + r[1]],
                      [aa, bb])[1]
    return torch.stack([mix_l * vg, mix_r * vg], dim=-1), vg[-1]


def _bits_equal(a, b):
    a, b = a.contiguous().numpy(), b.contiguous().numpy()
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        ((a.view(np.int32) == b.view(np.int32))
         | (np.isnan(a) & np.isnan(b))).all())


@pytest.mark.parametrize("n,b", GRID)
def test_plain_is_the_volume_step_before(n, b):
    a = _inputs(n, b)
    got = vk.volume_plain(*a, n=n)
    want = _volume_before(*a, n)
    assert got[0].shape == (n, b, 2) and got[1].shape == (b,)
    assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])


@pytest.mark.parametrize("n", NS)
def test_plain_near_a_float64_recurrence(n):
    """Within 1e-6 relative of the serial recurrence in float64 (a and
    0.002 as the float32 values the step uses), beyond what the tree's
    squarings of a already carry: its level-k nodes hold a^(2^k) rounded
    k times, 2.2e-6 off at k = 9 (n = 512)."""
    b = 1024
    a32 = np.float32(1.0) - np.float32(0.002)
    mix_l, mix_r, vf, vg0 = _inputs(n, b, seed=1)
    ones = torch.ones_like(mix_l)
    vg = vk.volume_plain(ones, ones, vf, vg0, n=n)[0][..., 0].double().numpy()
    want = np.empty((n, b))
    x = vg0.double().numpy()
    c = np.float64(np.float32(0.002)) * vf.double().numpy()
    for t in range(n):
        x = np.float64(a32) * x + c
        want[t] = x
    pw, ak = np.float32(a32), 0.0
    for k in range(1, n.bit_length()):
        pw = np.float32(pw * pw)
        ak = max(ak, abs(float(pw) / float(a32) ** (2 ** k) - 1.0))
    nz = want != 0.0
    assert (vg[~nz] == 0.0).all()
    rel = np.abs(vg[nz] - want[nz]) / want[nz]
    assert rel.max() <= 1e-6 + ak, (rel.max(), ak)


# ---- csrc/volume.cu's thread body on the CPU ----

SHIM = r"""
// csrc/volume.cu's thread body on the CPU, one CUDA thread after another
#include <cstddef>
#define VOL_SHIM
#define __device__
#define __forceinline__ inline
struct float2 { float x, y; };
static inline float2 make_float2(float x, float y) { return {x, y}; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline int __clz(int x) {
    return x ? __builtin_clz((unsigned)x) : 32;
}
template <class T> static inline T __ldg(const T* p) { return *p; }
#include "volume.cu"

extern "C" int volume_launch(const VolumeArgs* a, void*) {
    if (a->n < 1 || a->n > VOL_MAX_N || a->b < 0) return 1;
    for (int by = 0; by * SPAN < a->n; ++by)
        for (int bx = 0; bx * ROWS < a->b; ++bx)
            for (int ty = 0; ty < WARPS; ++ty)
                for (int tx = 0; tx < ROWS; ++tx)
                    volume_thread(*a, bx * ROWS + tx, by * SPAN, ty);
    return 0;
}
"""


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ not found: the port's native compiler needs it "
                    "too")
    where = tmp_path_factory.mktemp("volume_shim")
    (where / "shim.cpp").write_text(SHIM)
    so = where / "libvolume_shim.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
         f"-I{build.CSRC}", "-o", str(so), str(where / "shim.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.volume_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.volume_max_n.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("n,b", GRID + [(64, 31), (65, 40), (4095, 3),
                                        (vk.MAX_N, 5)])
def test_kernel_source_on_the_cpu(n, b, shim_lib):
    """Every thread of the grid the launch makes, ragged row and sample
    blocks too, up to the largest ``n``: bit-equal to the plain version,
    output and end gain."""
    assert shim_lib.volume_max_n() == vk.MAX_N
    a = _inputs(n, b, seed=2)
    args, out, gain = vk._pack(*a, n)
    assert shim_lib.volume_launch(ctypes.byref(args), None) == 0
    want = vk.volume_plain(*a, n=n)
    assert _bits_equal(out, want[0]) and _bits_equal(gain, want[1])


# ---- the wrapper ----

def test_the_cpu_runs_the_plain_version():
    a = _inputs(512, 33)
    before = vk.volume.launches
    last = max((r.id for r in spans.records()), default=0)
    got = vk.volume(*a, n=512)
    assert vk.volume.launches == before, "a CPU tensor launched"
    want = vk.volume_plain(*a, n=512)
    assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])
    (rec,) = [r for r in spans.records()
              if r.id > last and r.name == "kernel.volume"]
    assert rec.n == 33


def _bad(case):
    """The wrapper's arguments with one fault: (args, n)."""
    mix_l, mix_r, vf, vg = _inputs(16, 8)
    if case == "dtype":
        vf = vf.double()
    elif case == "device":
        vg = torch.empty(8, device="meta")
    elif case == "mix_shape":
        mix_r = mix_r[:8]
    elif case == "rows":
        vg = vg[:7]
    elif case == "vf_dims":
        vf = vf[None]
    elif case == "contiguous":
        mix_l = mix_l.T.contiguous().T
    elif case == "strided":
        vf = torch.stack([vf, vf], 1)[:, 0]
    return (mix_l, mix_r, vf, vg), {"n_0": 0, "n_big": vk.MAX_N + 1}.get(
        case, 16)


@pytest.mark.parametrize("case", ["dtype", "device", "mix_shape", "rows",
                                  "vf_dims", "contiguous", "strided", "n_0",
                                  "n_big"])
def test_the_checks_refuse(case):
    """The checks a CUDA tensor's launch takes, on CPU tensors: another
    device, type or shape, a non-contiguous input or an ``n`` out of
    range raises."""
    a, n = _bad(case)
    with pytest.raises((TypeError, ValueError)):
        vk._pack(*a, n)


def test_the_bytes_bound():
    """``parallel/roofline.py``'s count at the main path's shape: the
    mix read and the stereo pair written, 16 bytes a row-sample, and 12
    a row; bound by bytes on an H100."""
    from skred_tpu_torch.parallel import roofline

    a = _inputs(512, 1024)
    read, write, ops = roofline.volume_counts(a, dict(n=512))
    assert read + write == 16 * 512 * 1024 + 12 * 1024
    assert ops == 4 * 512 * 1024
    ms, by = roofline.volume_bound(a, dict(n=512),
                                   roofline.peaks_for("NVIDIA H100 80GB HBM3"))
    assert by == "bytes" and ms == pytest.approx((read + write) / 3.35e9)


def test_no_kernel_for_another_device():
    a = tuple(torch.empty(x.shape, device="meta") for x in _inputs(4, 2))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        vk.volume(*a, n=4)


def _batch(path, rows, blocks):
    """``rows`` variants of a script (its first voice's amplitude
    stepped), ``blocks`` blocks long, packed."""
    lines = path.read_text().splitlines()
    bank = WaveBank()
    tls = [timeline.compile_script(lines + [f"v0 a{1 + i / 4}"],
                                   blocks * 512 / 44100, bank=bank,
                                   script_dir=path.parent)
           for i in range(min(rows, 4))]
    return batch.pack_stacked(batch.stack_timelines(
        [tls[i % len(tls)] for i in range(rows)]))


@pytest.mark.parametrize("script,capture", [(STRESS64, False),
                                            (NOISE64, False),
                                            (STRESS64, True)])
def test_renders_hand_the_kernel_what_it_takes(script, capture, monkeypatch):
    """Every block of a CPU render hands the wrapper inputs that pass the
    launch's checks (contiguous f32 of the block's shapes), the capture
    path's too; the render does not change."""
    st = _batch(script, 3, 2)
    want = fused.render_fused(st, device="cpu", capture=capture)
    calls = []

    def checked(mix_l, mix_r, vf, vol_gain, *, n):
        vk._pack(mix_l, mix_r, vf, vol_gain, n)
        calls.append(n)
        return vk.volume(mix_l, mix_r, vf, vol_gain, n=n)

    monkeypatch.setattr(fused, "volume", checked)
    got = fused.render_fused(st, device="cpu", capture=capture)
    assert calls == [512] * st.num_blocks
    for g, w in zip(*((got, want) if capture else ((got,), (want,)))):
        assert np.array_equal(g, w)


# ---- on the card ----

@pytest.fixture(scope="session")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    build.build_all(["volume"])
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", GRID)
def test_kernel_equals_plain_on_the_card(n, b, cuda_device):
    a = _inputs(n, b, seed=3, device=cuda_device)
    before = vk.volume.launches
    got = vk.volume(*a, n=n)
    torch.cuda.synchronize()
    assert vk.volume.launches == before + 1
    want = vk.volume_plain(*a, n=n)
    assert _bits_equal(got[0].cpu(), want[0].cpu())
    assert _bits_equal(got[1].cpu(), want[1].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("script", [STRESS64, NOISE64])
def test_card_render_is_the_cpu_render(script, cuda_device):
    """8 rows x 4 blocks on the card: bit-equal to the CPU render, one
    volume launch a block."""
    st = _batch(script, 8, 4)
    assert st.num_blocks == 4
    want = fused.render_fused(st, device="cpu")
    before = vk.volume.launches
    got = fused.render_fused(st, device=cuda_device)
    assert vk.volume.launches == before + st.num_blocks
    assert np.abs(want).max() > 0.01
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
