"""The CUDA cyclic kernel against its plain version, on the card.

Both variants of csrc/cyclic.cu: the keyed one (voice count and features
compiled in, one build per key at first use) and the general one.
Needs an NVIDIA card and nvcc; skips elsewhere.  Imports nothing of JAX,
so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cyclic_cuda.py
"""

import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from benchmark.traffic import variants
from skred_tpu_torch.engine import cyclic as tc
from skred_tpu_torch.engine.kernels import build
from skred_tpu_torch.engine.kernels import cyclic as ck
from skred_tpu_torch.engine.kernels import cyclic_inputs as ci

SCRIPTS = ("fb1", "fb2", "fb3", "fb5", "all_features")
CZFB64 = variants.wire_lines((pathlib.Path(__file__).resolve().parent.parent
                              / "benchmark" / "configs" / "czfb64.sk")
                             .read_text())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _lines(name):
    if name == "all_features":
        return ci.ALL_FEATURES
    return (ci.CORPUS / f"{name}.sk").read_text().splitlines()


def _same(a, b, what):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    assert np.array_equal(a, b), f"{what}: {(a != b).sum()} differ"


def _counts():
    return (ck.cyclic_block.launches, ck.cyclic_fixed.launches,
            ck.cyclic_general.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fixed", "general"])
@pytest.mark.parametrize("layout", ["kb", "bk"])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name", SCRIPTS)
def test_cyclic_cuda_matches_plain_on_card(name, exact, layout, variant,
                                           cuda_device):
    """One block at 1000 rows (a ragged last warp) and 128 frames; ``bk``
    hands the states over as transposed ``[B, k]`` tensors, as the
    renderer does.  Each variant, named."""
    args = list(ci.on_device(ci.block_inputs(_lines(name), 1000, seed=7,
                                             n=128), cuda_device))
    if layout == "bk":
        args[5] = {kk: (v.T.contiguous().T if v.dim() == 2 else v)
                   for kk, v in args[5].items()}
    before = _counts()
    got = ck.cyclic_block(*args, exact=exact, variant=variant)
    torch.cuda.synchronize()
    fixed = variant == "fixed"
    assert _counts() == (before[0] + 1, before[1] + fixed,
                         before[2] + (not fixed))
    want = ck.cyclic_block_plain(*args, exact=exact)
    assert sorted(got[2]) == sorted(want[2])
    for kk in want[2]:
        _same(got[2][kk], want[2][kk], f"{name} state {kk}")
        assert got[2][kk].stride() == args[5][kk].stride()
    _same(got[0], want[0], f"{name} out_l")
    _same(got[1], want[1], f"{name} out_r")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fixed", "general"])
def test_cyclic_cuda_rows_that_differ_in_their_stages(variant, cuda_device):
    """The all-features script with each per-voice stage switched off on
    a random 30% of the rows: warps hold rows with a stage on beside rows
    with it off."""
    table, off, cbase, nz, vecs, states, vf, feat, k, n = ci.block_inputs(
        ci.ALL_FEATURES, 1000, seed=9, n=64)
    rng = np.random.default_rng(9)
    stage_off = {"use_fm": 0, "dirneg": 0, "cz_mode": 0, "is_noise": 0,
                 "hold_on": 0, "quant_on": 0, "use_flt": 0, "use_env": 0,
                 "am_osc": -1, "pm_osc": -1, "use_sm": 0}
    vecs = dict(vecs)
    for key, val in stage_off.items():
        drop = torch.from_numpy(rng.uniform(size=vecs[key].shape) < 0.3)
        vecs[key] = torch.where(drop, torch.tensor(val, dtype=vecs[key].dtype),
                                vecs[key]).contiguous()
    args = ci.on_device((table, off, cbase, nz, vecs, states, vf, feat, k,
                         n), cuda_device)
    got = ck.cyclic_block(*args, variant=variant)
    torch.cuda.synchronize()
    want = ck.cyclic_block_plain(*args)
    _same(got[0], want[0], "out_l")
    _same(got[1], want[1], "out_r")
    for kk in want[2]:
        _same(got[2][kk], want[2][kk], kk)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fixed", "general"])
@pytest.mark.parametrize("name", ["fb2", "fb3", "fb5", "all_features"])
def test_cyclic_cuda_operands_outside_the_fast_range(name, variant,
                                                     cuda_device):
    """Huge increments, NaN and infinite phases, denormal CZ table sizes
    (``cyclic_inputs.out_of_range``): the keyed variant's rows that meet
    them render again with the exact wrap and divide."""
    args = ci.on_device(ci.out_of_range(ci.block_inputs(
        _lines(name), 1000, seed=3, n=64), seed=3), cuda_device)
    got = ck.cyclic_block(*args, variant=variant)
    torch.cuda.synchronize()
    want = ck.cyclic_block_plain(*args)
    _same(got[0], want[0], f"{name} out_l")
    _same(got[1], want[1], f"{name} out_r")
    for kk in want[2]:
        _same(got[2][kk], want[2][kk], f"{name} state {kk}")


@pytest.mark.cuda
def test_cyclic_cuda_at_the_voice_limit(cuda_device):
    """64 voices in a ring, the general variant's voice cap: one read a
    frame of the same frame (v63 of v0), so 2 waves."""
    lines = [f"v{v} w{v % 3} f{50 + 7 * v} a5 F{(v + 1) % 64},0.3 "
             f"J1 K3000 Q2 h3 c1,0.4" for v in range(64)]
    args = ci.on_device(ci.block_inputs(lines, 64, seed=8, n=32),
                        cuda_device)
    assert args[8] == 64 > ck.FIXED_K_MAX
    before = _counts()
    got = ck.cyclic_block(*args)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1], before[2] + 1)
    want = ck.cyclic_block_plain(*args)
    _same(got[0], want[0], "out_l")
    for kk in want[2]:
        _same(got[2][kk], want[2][kk], kk)


def _waves_inputs(case):
    """(the first block's arguments, blocks): czfb64 at 7 rows (4 rows a
    CUDA block, the last ragged), a chain of 16 same-frame FM reads, the
    all-features script with each read cut on a random 40% of its rows.
    Blocks of 48 frames: the plain version walks a frame of 64 voices in
    ~0.3 s."""
    if case == "czfb64":
        return ci.block_inputs(CZFB64, 7, seed=21, n=48), 2
    if case == "chain16":
        lines = ["v0 w1 f110 a5 F15,0.3 c1,0.4"] + [
            f"v{v} w{v % 3} f{50 + 7 * v} a5 F{v - 1},0.3 J1 K3000 Q2 h3"
            for v in range(1, 16)]
        return ci.block_inputs(lines, 37, seed=22, n=128), 1
    args = list(ci.block_inputs(ci.ALL_FEATURES, 100, seed=23, n=128))
    rng = np.random.default_rng(23)
    for key in ("fm_osc", "cm_osc", "am_osc", "pm_osc"):
        if key in args[4]:
            drop = torch.from_numpy(rng.uniform(size=args[4][key].shape)
                                    < 0.4)
            args[4] = dict(args[4], **{key: torch.where(
                drop, -1, args[4][key]).contiguous()})
    return tuple(args), 1


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("case", ["czfb64", "chain16", "rows_differ"])
def test_cyclic_general_waves_match_plain_on_card(case, exact, cuda_device):
    """The general variant, a frame's voices in waves, bit-equal to the
    plain version in outputs and end states: czfb64 at 64 voices (2
    waves) over 2 blocks, the second from the first's end states; a
    16-voice chain (16 waves); rows whose graphs differ, on the schedule
    derived from the vectors (their union)."""
    args, blocks = _waves_inputs(case)
    args = list(ci.on_device(args, cuda_device))
    want_waves = {"czfb64": 2, "chain16": 16}.get(case)
    for blk in range(blocks):
        schedule = ck.schedule_of(args[4], args[7], args[8], cuda_device)
        if want_waves is not None:
            assert schedule[1] == want_waves
        before = _counts()
        got = ck.cyclic_block(*args, exact=exact, variant="general",
                              schedule=schedule)
        torch.cuda.synchronize()
        assert _counts() == (before[0] + 1, before[1], before[2] + 1)
        want = ck.cyclic_block_plain(*args, exact=exact)
        _same(got[0], want[0], f"{case} block {blk} out_l")
        _same(got[1], want[1], f"{case} block {blk} out_r")
        for kk in want[2]:
            _same(got[2][kk], want[2][kk], f"{case} block {blk} state {kk}")
        args[2] += args[9]
        args[5] = got[2]


@pytest.mark.cuda
def test_render_cyclic_on_card_matches_the_cpu_render(cuda_device):
    st = ci.packed(_lines("fb4"), 0.05, 4)
    before = _counts()
    a = tc.render_cyclic(st, device=cuda_device)
    blocks = st.num_blocks
    assert _counts() == (before[0] + blocks, before[1] + blocks, before[2])
    b = tc.render_cyclic(st, device="cpu")
    peak = float(np.abs(b).max())
    db = 20 * np.log10(max(float(np.abs(a - b).max()), 1e-30) / peak)
    assert db <= -100.0, f"{db:.1f} dB"


@pytest.mark.cuda
def test_cyclic_kernel_rejects_bad_inputs(cuda_device):
    args = list(ci.on_device(ci.block_inputs(_lines("fb1"), 8, seed=1, n=8),
                             cuda_device))
    bad = list(args)
    bad[4] = dict(args[4], amp=args[4]["amp"].double())
    with pytest.raises(TypeError):
        ck.cyclic_block(*bad)
    bad = list(args)
    bad[5] = dict(args[5], phase=args[5]["phase"][:, :4])
    with pytest.raises(ValueError):
        ck.cyclic_block(*bad)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError):
        ck.cyclic_block(*bad)
    bad = list(args)
    bad[4] = {kk: v for kk, v in args[4].items() if kk != "mis"}
    with pytest.raises(KeyError):
        ck.cyclic_block(*bad)


@pytest.mark.cuda
def test_cyclic_keyed_variant_refuses_another_key(cuda_device):
    """The keyed library checks the arguments against the key it was
    built for, and a key that does not build raises: neither falls back
    to another variant."""
    args = ci.on_device(ci.block_inputs(_lines("fb1"), 8, seed=1, n=8),
                        cuda_device)
    packed = ck._pack_args(*args, True)[0]
    other = ck.fixed_key(args[7], args[8] + 1)
    before = _counts()
    with pytest.raises(RuntimeError, match="not the build's key"):
        ck.cyclic_fixed(packed, other, cuda_device)
    broken = tuple("CYC_K=not_a_count" if d.startswith("CYC_K=") else d
                   for d in other)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ck.cyclic_fixed(packed, broken, cuda_device)
    assert _counts() == before
    with pytest.raises(ValueError, match="keyed variant takes"):
        big = ci.on_device(ci.block_inputs(
            [f"v{v} w0 f{50 + v} a5 F{(v + 1) % 9},0.3" for v in range(9)],
            8, seed=1, n=8), cuda_device)
        ck.cyclic_block(*big, variant="fixed")


def _spills_in_loops(lib):
    """The spill instructions (STL, LDL) that lie inside a loop of the
    library's SASS, between a backward branch and its target, and the
    number of loops found."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    inside, n_loops = [], 0
    for fn in sass.split("Function : ")[1:]:
        ins = [(int(a, 16), t.strip()) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
        loops = [(int(m.group(1), 16), a) for a, t in ins
                 if (m := re.search(r"\bBRA\b.*0x([0-9a-f]+)", t))
                 and int(m.group(1), 16) < a]
        n_loops += len(loops)
        inside += [t for a, t in ins if re.search(r"\b(STL|LDL)\b", t)
                   and any(lo <= a <= hi for lo, hi in loops)]
    return inside, n_loops


@pytest.mark.cuda
def test_cyclic_keyed_builds_up_to_the_cap_spill_nothing_in_the_loop(
        cuda_device):
    """The cap's rule, from ptxas's report (kept beside each library, so
    a cached build is checked too) and the SASS: the all-features feature
    set at every voice count up to the cap stays clear of the
    255-register ceiling (below 248) and spills nothing inside its frame
    loops (ptxas may spill a few bytes in the once-per-block prologue);
    fb1-fb5's keys spill nothing at all."""
    feat = ci.block_inputs(ci.ALL_FEATURES, 2, seed=1, n=8)[7]
    keys = {f"all-features k={k}": ck.fixed_key(feat, k)
            for k in range(1, ck.FIXED_K_MAX + 1)}
    for name in ("fb1", "fb2", "fb3", "fb4", "fb5"):
        a = ci.block_inputs(_lines(name), 2, seed=1, n=8)
        keys[name] = ck.fixed_key(a[7], a[8])
    build.build_all([("cyclic", key) for key in keys.values()])
    bad = {}
    for what, key in keys.items():
        text = build.report("cyclic", key)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [ln.strip() for ln in text.splitlines() if "spill" in ln]
        inside, n_loops = _spills_in_loops(build._target("cyclic", key))
        if not regs or max(regs) >= 248 or n_loops < 2 or inside:
            bad[what] = (regs, n_loops, inside[:4])
        if what.startswith("fb") and not (spills and all(
                " 0 bytes spill stores" in ln and " 0 bytes spill loads" in ln
                for ln in spills)):
            bad[what] = spills
    assert not bad, bad
