"""The port's native host compiler (``skred_tpu_torch/host/native.py``)
against the JAX package's Python compiler, on the CPU.

The C++ library compiles from ``csrc/skred_host.cpp`` into the
repository's ``build/`` (or a test's temporary directory), never into the
JAX package.  Its output, and the port's own ``compile_script``'s, must
equal ``skred_tpu.host.timeline.compile_script``'s array for array on
every in-repo script at 10 s; scripts it cannot compile (recorder
capture ``<`` / ``*``, ``/wex``) raise NotImplementedError, and the
bench's compile falls back to Python on that error only.
"""

import hashlib
import pathlib

import numpy as np
import pytest

from skred_tpu.assets import WaveBank as JBank
from skred_tpu.host import timeline as jt
from skred_tpu_torch.assets import WaveBank
from skred_tpu_torch.host import native
from skred_tpu_torch.host.timeline import compile_script
from skred_tpu_torch.parallel import buckets

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_LIB = ROOT / "skred_tpu" / "host" / "libskredhost.so"
SCRIPTS = [p.relative_to(ROOT).as_posix() for p in buckets.SCRIPTS]
REFUSED = ["v0 w0 f440 a5 <1", "v0 w0 f440 a5 *1", "v0 w0 f440 a5 /wex1,2"]


def _fingerprint(path):
    if not path.exists():
        return None
    return hashlib.sha1(path.read_bytes()).hexdigest(), path.stat().st_mtime_ns


def test_scripts_are_the_in_repo_seven():
    assert sorted(pathlib.Path(s).name for s in SCRIPTS) == [
        "fb1.sk", "fb2.sk", "fb3.sk", "fb4.sk", "fb5.sk", "noise64.sk",
        "stress64.sk"]


def _assert_same_timeline(want, got):
    assert want.num_blocks == got.num_blocks and want.block == got.block
    assert np.array_equal(want.seg_of_block, got.seg_of_block)
    assert np.array_equal(want.seg_is_start, got.seg_is_start)
    assert sorted(want.params) == sorted(got.params)
    for k in want.params:
        a, b = np.asarray(want.params[k]), np.asarray(got.params[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert sorted(want.ops) == sorted(got.ops)
    for k in want.ops:
        assert np.array_equal(np.asarray(want.ops[k]).astype(np.int64),
                              np.asarray(got.ops[k]).astype(np.int64)), k
    assert np.array_equal(want.table_buffer, got.table_buffer)
    assert np.array_equal(want.table_offsets, got.table_offsets)
    assert want.mod_passes == got.mod_passes
    assert want.fused_passes == got.fused_passes


@pytest.mark.parametrize("script", SCRIPTS)
def test_native_compile_equals_python(script):
    """The JAX package's Python compiler is the reference: the native
    compiler and the port's Python one both equal it."""
    path = ROOT / script
    lines = path.read_text().splitlines()
    want = jt.compile_script(lines, 10.0, bank=JBank(),
                             script_dir=path.parent)
    tn = native.compile_script_native(lines, 10.0, bank=WaveBank(),
                                      script_dir=path.parent)
    _assert_same_timeline(want, tn)
    tp = compile_script(lines, 10.0, bank=WaveBank(),
                        script_dir=path.parent)
    _assert_same_timeline(want, tp)
    assert tn.num_blocks == 862
    assert tn.fused_passes == (
        None if pathlib.Path(script).stem.startswith("fb") else 2)


@pytest.mark.parametrize("line", REFUSED)
def test_native_refuses_capture_and_wex(line):
    with pytest.raises(NotImplementedError):
        native.compile_script_native([line], 0.05)


@pytest.mark.parametrize("line", REFUSED)
def test_bench_compile_falls_back_on_refusal_only(tmp_path, monkeypatch,
                                                  line):
    path = tmp_path / "refused.sk"
    path.write_text(line + "\n")
    tl, how = buckets.compile_one(path, 0.05, WaveBank())
    assert how == "python" and tl.num_blocks == 5

    def broken(*a, **kw):
        raise RuntimeError("skc_compile failed: 1")

    monkeypatch.setattr(native, "compile_script_native", broken)
    with pytest.raises(RuntimeError):
        buckets.compile_one(ROOT / "corpus" / "fb1.sk", 0.05, WaveBank())


def test_library_builds_outside_the_jax_package(tmp_path, monkeypatch):
    before = _fingerprint(JAX_LIB)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(native, "_lib", None)
    lib = native.build_library()
    assert lib.parent == tmp_path / "host" and lib.exists()
    assert lib.name.startswith("libskredhost-")
    assert native.build_library() == lib          # built once per hash
    loaded = native.load_library()
    assert pathlib.Path(loaded._name) == lib
    assert [p.name for p in (tmp_path / "host").iterdir()] == [lib.name]
    assert _fingerprint(JAX_LIB) == before
    # the repository's own build goes under build/, which git ignores
    monkeypatch.undo()
    assert native.library_path().parent == ROOT / "build" / "host"
    assert "build/" in (ROOT / ".gitignore").read_text().splitlines()
