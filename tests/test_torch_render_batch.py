"""The compat engine's batch entry points on the CPU, and its kernel's
build and launch wrapper without a card.

``render_stacked`` renders one row a script, each row bit-equal to the
script's own ``render_timeline``, and its fast mode equals its exact
mode and stays within -60 dB of the JAX package's ``render_stacked``; ``render_batch(engine="compat")``
is ``render_stacked``; a cyclic script that the cyclic kernel's gate
refuses falls back to the compat engine with a warning on stderr.

The kernel: its argument struct and field layout against compat.py's,
its build under a key through a stand-in for nvcc, and its launch
wrapper with ``csrc/compat.cu`` itself built for the CPU by g++ under
the batch's key (a thread a voice, a ``std::barrier`` for
``__syncthreads``: ``tests/test_torch_compat_keyed.py``'s ``THREADS``)
standing in for the card's library: the wrapper's pointers and counts
reach the kernel, it never runs the plain version, and the kernel's
arithmetic equals the plain version's bit for bit.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from skred_tpu.host import timeline as jt
from skred_tpu.parallel import batch as jb
from skred_tpu_torch.assets import WaveBank
from skred_tpu_torch.engine import cyclic, render_timeline
from skred_tpu_torch.engine import render as tr
from skred_tpu_torch.engine.kernels import build
from skred_tpu_torch.engine.kernels import compat as K
from skred_tpu_torch.host.timeline import compile_script, noise_stream
from skred_tpu_torch.parallel import batch as tb
from tests.test_torch_compat_keyed import CpuCompat
from tests.test_torch_render import CORPUS, db, lines_of
from tests.test_torch_render_feedback import FB4_CUT, VOICE_COPY

torch.set_num_threads(1)

ONE_BLOCK = 0.0116
FB1, STRESS64 = CORPUS / "fb1.sk", CORPUS / "stress64.sk"


def _tls(scripts, seconds):
    bank = WaveBank()
    return [compile_script(lines, seconds, bank=bank, script_dir=CORPUS)
            for lines in scripts]


def _flushed(fn, *a, **kw):
    # XLA's CPU runtime flushes denormals; render the port the same way
    torch.set_flush_denormal(True)
    try:
        return fn(*a, **kw)
    finally:
        torch.set_flush_denormal(False)


# v0 reads v1 through FM, a one-sample delay by the serial order: one pass
ONE_PASS = ["v0 w0 f440 a3 F1,0.3 Q40", "v1 w2 f3 a1 c2,0.4"]
THREE = [lines_of("fb1"), VOICE_COPY, ONE_PASS]


def test_render_stacked_rows_equal_their_own_renders():
    """Three scripts of 2, 2 and 1 passes and 1, 2 and 1 segments share
    a table buffer, the noise stream and the batch's pass count."""
    tls = _tls(THREE, 2 * ONE_BLOCK)
    st = tb.stack_timelines(tls)
    assert st.mod_passes == 2 and [t.mod_passes for t in tls] == [2, 2, 1]
    assert [t.num_segments for t in tls] == [1, 2, 1]
    got = tb.render_stacked(st, exact=True, device="cpu")
    assert got.shape == (3, 2 * 512, 2) and got.dtype == np.float32
    for row, tl in enumerate(tls):
        want = render_timeline(tl, device="cpu")
        assert np.abs(want).max() > 0.01
        assert np.array_equal(got[row], want), row


# Measured: -145.0 dB of the batch's peak (-82.8 dB while fast mode
# rounded the product of each multiply-add apart: fb1's feedback carried
# the last bit on; tests/test_torch_fast_mode.py renders five blocks).
def test_render_stacked_fast_mode_within_60_db_of_jax():
    from skred_tpu import assets as ja

    jtls = [jt.compile_script(lines, ONE_BLOCK, bank=ja.WaveBank(),
                              script_dir=CORPUS) for lines in THREE]
    want = np.asarray(jb.render_stacked(jb.stack_timelines(jtls)))
    st = tb.stack_timelines(_tls(THREE, ONE_BLOCK))
    got = _flushed(tb.render_stacked, st, device="cpu")
    assert got.shape == want.shape == (3, 512, 2)
    assert db(want, got) <= -60.0
    exact = tb.render_stacked(st, exact=True, device="cpu")
    # one arithmetic in both modes, as the JAX package's on the CPU
    assert np.array_equal(exact, got), "fast mode is not exact mode"


def test_render_batch_compat_is_render_stacked(tmp_path):
    copy = tmp_path / "copy.sk"
    copy.write_text("\n".join(VOICE_COPY) + "\n")
    scripts = [FB1, STRESS64, copy]
    got = tb.render_batch(scripts, ONE_BLOCK, engine="compat", device="cpu")
    bank = WaveBank()
    tls = [compile_script(p.read_text().splitlines(), ONE_BLOCK, bank=bank,
                          script_dir=p.parent) for p in scripts]
    want = tb.render_stacked(tb.stack_timelines(tls), device="cpu")
    assert got.shape == (3, 512, 2) and np.array_equal(got, want)


def test_refused_cyclic_script_falls_back_to_compat(monkeypatch, capsys):
    monkeypatch.setattr(cyclic, "cyclic_gate", lambda st: "forced refusal")
    before = K.compat_block.launches
    got = tb.render_batch([FB1, STRESS64], ONE_BLOCK, device="cpu")
    err = capsys.readouterr().err
    assert "WARNING" in err and "forced refusal" in err
    assert "falling back to the compat scan engine" in err
    assert K.compat_block.launches == before, "a CPU render launched"
    (fb1,) = _tls([lines_of("fb1")], ONE_BLOCK)
    want = tb.render_stacked(tb.stack_timelines([fb1]), device="cpu")[0]
    assert np.array_equal(got[0], want)
    assert np.abs(got[1]).max() > 0.01 and not np.array_equal(got[1], want)


# ---- the kernel without a card ----

def _c_struct_fields(src, name):
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        kind = "ptr" if "*" in decl else "int"
        for part in decl.replace("const", "").split(","):
            name_ = part.replace("float", "").replace("int", "").strip(" *")
            fields.append((name_.split()[-1], kind))
    return fields


def test_args_match_cuda_struct():
    src = (build.CSRC / "compat.cu").read_text()
    assert re.findall(r"^struct (\w+Args) \{", src, re.M) == ["CompatArgs"]
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int"}
    want = [(k, kinds[t]) for k, t in K.CompatArgs._fields_]
    assert _c_struct_fields(src, "CompatArgs") == want


def _enum(src, first):
    body = re.search(r"enum \{ %s\b(.*?)\};" % first, src, re.S).group(1)
    return [first] + [w.split("=")[0].strip()
                      for w in body.split(",") if w.strip()]


def test_field_layout_matches_the_kernel():
    """compat.py's field tuples and flag bits in csrc/compat.cu's enum
    order (the wrapper also asks the built library for its counts)."""
    src = (build.CSRC / "compat.cu").read_text()
    up = lambda names, pre: [pre + n.upper() for n in names]
    assert _enum(src, "P_PINC") == up(K.PF, "P_") + ["NPF"]
    assert _enum(src, "Q_FLAGS") == up(K.PI, "Q_") + ["NPI"]
    assert _enum(src, "O_PHASE") == ["O_PHASE", "O_SAMPLE", "O_SMOOTHER",
                                     "O_PAN_L", "O_PAN_R", "NOF"]
    assert len(K.OF) == 5
    assert _enum(src, "OI_FLAGS") == up(K.OI, "OI_")[:2] \
        + ["OI_COPY_HOLD", "NOI"]
    assert _enum(src, "C_PHASE") == up(K.CF, "C_") + ["NCF"]
    assert _enum(src, "CI_FINISHED") == up(K.CI, "CI_") + ["NCI"]
    bits = re.findall(r"F_(\w+) = 1 << (\d+)", src)
    assert [(n.lower(), int(b)) for n, b in bits] == [
        (n, i) for i, n in enumerate(K.FLAGS)]


def test_build_with_a_stand_in_nvcc(tmp_path, monkeypatch):
    """compat.cu builds under a key with the repository's flags and the
    key's defines, and keeps nvcc's report beside the library."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "for a; do [ \"$prev\" = -o ] && out=$a; prev=$a; done\n"
        "echo \"$*\" > \"$out.args\"\n"
        "echo 'ptxas info    : Used 72 registers'\n"
        "echo lib > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "LOG", {})
    st = tb.stack_timelines(_tls([lines_of("fb1")], ONE_BLOCK))
    key = K.compat_key(tr.stacked_inputs(st, "cpu"), st.mod_passes, False)
    item = ("compat", key)
    assert list(build.build_all([item])) == [build.label(*item)]
    lib = build._target(*item)
    args = lib.with_suffix(".tmp.so.args").read_text().split()
    for flag in ("-fmad=false", "-prec-div=true", "-ftz=false",
                 "arch=compute_90a,code=sm_90a"):
        assert flag in args
    assert [a for a in args if a.startswith("-DCOMPAT_")] == [
        "-D" + d for d in key]
    assert args[-1].endswith("csrc/compat.cu")
    assert "Used 72 registers" in build.report(*item)
    assert build.build_all([item]) == {}


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    """csrc/compat.cu built for the CPU by g++ with -ffp-contract=off,
    a thread a voice, a library per key."""
    return CpuCompat(tmp_path_factory.mktemp("compat_cpu"), "threads")


@pytest.mark.parametrize("script,exact,capture", [
    ("voice copy", True, True), ("fb4 cut", False, False)])
def test_launch_wrapper_runs_the_kernel(cpu_kernel, monkeypatch, script,
                                        exact, capture):
    """The voice copy (a hold-state copy at block 1) and fb4 cut (a new
    segment at block 1) at 2 blocks, 2 passes: the wrapper's launch,
    given the CPU build of the kernel, equals the plain version bit for
    bit, counts one launch, and never calls the plain version."""
    lines = VOICE_COPY if script == "voice copy" else FB4_CUT
    st = tb.stack_timelines(_tls([lines], 2 * ONE_BLOCK))
    inp = tr.stacked_inputs(st, "cpu")
    assert (inp.start[:, 1] == 1).all()
    noise = torch.as_tensor(noise_stream(2 * 512))
    carry = K.zero_carry(1, "cpu")
    want = K.compat_block_plain(inp, carry, noise, 0, 2, 2, exact, capture)

    def plain(*a, **kw):
        raise AssertionError("the kernel path ran the plain version")

    cpu_kernel.patch(monkeypatch)
    monkeypatch.setattr(K, "compat_block_plain", plain)
    before = K.compat_block.launches
    got = K._launch(inp, carry, noise, 0, 2, 2, exact, capture)
    assert K.compat_block.launches == before + 1
    bits = lambda x: x.contiguous().view(torch.int32)
    for g, w in zip(got[0], want[0]):
        assert torch.equal(bits(g), bits(w))
    assert torch.equal(bits(got[1]), bits(want[1]))
    assert (got[2] is None) == (not capture)
    if capture:
        assert torch.equal(bits(got[2]), bits(want[2]))
    with pytest.raises(ValueError, match="passes"):
        K._launch(inp, carry, noise, 0, 2, 0, exact, capture)
    with pytest.raises(ValueError, match="outside"):
        K._launch(inp, carry, noise, 1, 2, 2, exact, capture)
