"""The cyclic kernel's plain version against the JAX package's kernel.

``cyclic_block_plain`` must equal ``cyclic_block_pallas`` run in
interpret mode bit for bit, outputs and end states, on one block at 1024
rows: the per-voice vectors of the packed corpus/fb1, fb2, fb3 and
fb5.sk and of an inline feedback script that holds every other stage
(noise, envelope, smoother, pan-mod, one-shot, reversed and disconnected
voices), with random in-range states from a numpy seed.  Also the gate,
the chunked stream against the one-shot render, and the argument struct.  The CUDA kernel is held against the plain
version on the card by tests/test_torch_cyclic_cuda.py and chip_smoke.py.
The kernel's wrap helper against ``torch.fmod``, the keyed variant's build
key, the compiler report kept beside each build and the rule that picks a
variant.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skred_tpu.assets import WaveBank as JBank
from skred_tpu.engine import cyclic as jc
from skred_tpu.engine import kernels as jk
from skred_tpu.host import timeline as jt
from skred_tpu.parallel import batch as jb
from skred_tpu_torch.engine import cyclic as tc
from skred_tpu_torch.engine.kernels import build
from skred_tpu_torch.engine.kernels import cyclic as ck
from skred_tpu_torch.engine.kernels import cyclic_inputs as ci
from skred_tpu_torch.engine.numerics import wrap_fmod

torch.set_num_threads(1)

ROWS, N = 1024, 128

SCRIPTS = {name: (ci.CORPUS / f"{name}.sk").read_text().splitlines()
           for name in ("fb1", "fb2", "fb3", "fb5")}
SCRIPTS["all_features"] = ci.ALL_FEATURES
# Left out of the bitwise comparison: the amp smoother of a voice whose
# gain has an envelope or amp-mod factor.  XLA's CPU compiler builds the
# interpreted kernel's smoother twice: for the carried state it contracts
# ``amp*env*ampmod - sg`` into one fma, for the sample it does not (a
# scratch plain version with that fma matched every smoother state and
# no more samples).  The port, like the TPU kernel, rounds the product
# and the difference separately in both.  fb2's amp-modulated v1 gets
# ``s0`` here, as ALL_FEATURES' such voices have; the whole-render tests
# cover the combination.
BITWISE = dict(SCRIPTS)
BITWISE["fb2"] = [ln + " s0" if ln.startswith("v1 ") else ln
                  for ln in SCRIPTS["fb2"]]


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    bad = a != b
    assert not bad.any(), f"{what}: {bad.sum()} of {bad.size} differ"


def _pallas_block(table, table_off, cbase, noise_blk, vecs, states, vf, feat,
                  k, n):
    """The same block through cyclic_block_pallas (interpret mode), with
    the table windows its TPU memory plan wants."""
    tab = table.numpy()
    tsize_max = int(vecs["clip_i"].max()) + 1
    rows = -(-(tsize_max + 128) // 128)
    win_rows = max(-(-rows // 8) * 8, jc.SLOT_ROWS)
    pad = (-tab.size) % 32768
    tab = np.concatenate([tab, np.zeros(pad, np.float32)])
    rtot = tab.size // 128
    off = table_off.numpy().astype(np.int32)
    row0 = np.clip(off // 128, 0, rtot - win_rows).astype(np.int32)
    dloc = (off - row0 * 128).astype(np.int32)
    j = lambda a: jnp.asarray(a.numpy())
    old = jk.INTERPRET
    jk.INTERPRET = True
    try:
        out = jc.cyclic_block_pallas(
            jnp.asarray(tab.reshape(rtot, 128)), jnp.asarray(row0),
            jnp.asarray(dloc), jnp.asarray([cbase], jnp.int32),
            None if noise_blk is None else j(noise_blk),
            {kk: j(v) for kk, v in vecs.items()},
            {kk: j(v) for kk, v in states.items()}, j(vf), feat, k, n, True,
            win_rows)
        return jax.tree_util.tree_map(np.asarray, out)
    finally:
        jk.INTERPRET = old
        jax.clear_caches()


@pytest.mark.parametrize("name", sorted(BITWISE))
def test_cyclic_block_plain_matches_pallas_interpret(name):
    args = ci.block_inputs(BITWISE[name], ROWS, seed=3, n=N)
    feat = args[7]
    if name == "all_features":
        on = feat._asdict()
        assert all(on[f] for f in ck._FLAG_NAMES), on
    want_l, want_r, want_s = _pallas_block(*args)
    # XLA's CPU runtime flushes denormals; run the plain version the same
    torch.set_flush_denormal(True)
    try:
        got_l, got_r, got_s = ck.cyclic_block_plain(*args, exact=True)
    finally:
        torch.set_flush_denormal(False)
    assert (want_l != 0).mean() > 0.5, "too few live samples to compare"
    assert sorted(got_s) == sorted(want_s)
    for kk in sorted(want_s):
        _same(got_s[kk].numpy(), want_s[kk], f"{name} state {kk}")
    _same(got_l.numpy(), want_l, f"{name} out_l")
    _same(got_r.numpy(), want_r, f"{name} out_r")
    if feat.finish:
        fin0 = args[5]["finished"].numpy()
        assert (want_s["finished"] != fin0).any(), "no voice finished"


def test_cpu_tensors_take_the_plain_version():
    args = ci.block_inputs(SCRIPTS["fb1"], 4, seed=1, n=8)
    before = ck.cyclic_block.launches
    got = ck.cyclic_block(*args)
    want = ck.cyclic_block_plain(*args)
    assert ck.cyclic_block.launches == before, "a CPU tensor launched"
    _same(got[0].numpy(), want[0].numpy(), "out_l")
    for kk in want[2]:
        _same(got[2][kk].numpy(), want[2][kk].numpy(), kk)


def test_transposed_states_are_taken_as_they_are():
    """The renderer hands the carry's ``[B, k]`` tensors over as
    transposed views; the result is the same as from ``[k, B]`` copies,
    and the launch's layout check reads the strides."""
    table, off, cbase, nz, vecs, states, vf, feat, k, n = ci.block_inputs(
        ci.ALL_FEATURES, 4, seed=2, n=8)
    want = ck.cyclic_block_plain(table, off, cbase, nz, vecs, states, vf,
                                 feat, k, n)
    tr = {kk: (v.T.contiguous().T if v.dim() == 2 else v)
          for kk, v in states.items()}
    got = ck.cyclic_block_plain(table, off, cbase, nz, vecs, tr, vf, feat,
                                k, n)
    _same(got[0].numpy(), want[0].numpy(), "out_l")
    for kk in want[2]:
        _same(got[2][kk].numpy(), want[2][kk].numpy(), kk)
    dev = vf.device
    kb = lambda d: [(kk, v, v.dtype) for kk, v in d.items() if v.dim() == 2]
    assert ck._check_states(kb(states), dev, k, 4)[1] == (4, 1)
    assert ck._check_states(kb(tr), dev, k, 4)[1] == (1, k)
    mixed = dict(tr, phase=states["phase"])
    with pytest.raises(ValueError, match="layouts"):
        ck._check_states(kb(mixed), dev, k, 4)


def test_gate_reasons():
    """None on a replicated script; a reason when rows bind different
    tables; a table past the buffer is a ValueError of the renderer."""
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines

    for name in ("fb1", "fb5"):
        st = ci.packed(SCRIPTS[name], 0.05, 2)
        assert st.fused_passes is None
        assert tc.cyclic_gate(st) is None
    bank = WaveBank()
    tl = compile_script(SCRIPTS["fb1"], 0.05, bank=bank, script_dir=ci.CORPUS)
    lines2 = ["v0 w33 f110 a100 F1,0.8 J200 K4000 Q30",
              "v1 w2 f55 a80 F0,0.5 r1",
              "v2 w0 f220 a40 F2,1"]
    tl2 = compile_script(lines2, 0.05, bank=bank, script_dir=ci.CORPUS)
    st2 = pack_stacked(stack_timelines([tl, tl2]), cyclic=True)
    assert "differ across rows" in (tc.cyclic_gate(st2) or "")
    with pytest.raises(ValueError, match="differ across rows"):
        tc.render_cyclic(st2, device="cpu")
    st = ci.packed(SCRIPTS["fb1"], 0.05, 2)
    st.params["table_size"] = st.params["table_size"] * 0 \
        + np.int32(st.table_buffer.size + 1)
    assert tc.cyclic_gate(st) is None
    with pytest.raises(ValueError, match="past the table buffer"):
        tc.render_cyclic(st, device="cpu")


def _jax_timeline(lines, seconds):
    return jt.compile_script(lines, seconds, bank=JBank(),
                             script_dir=ci.CORPUS)


def test_stream_chunks_equal_the_one_shot_render():
    """The carry (feedback taps too) goes from chunk to chunk bit for bit;
    keep_rows cuts the download."""
    tl = _jax_timeline(SCRIPTS["fb5"], 0.08)
    st = jb.pack_stacked(jb.stack_timelines([tl] * 3), cyclic=True)
    full = tc.render_cyclic(st, device="cpu")
    chunks = list(tc.render_cyclic_stream(st, chunk_blocks=5, keep_rows=2,
                                          device="cpu"))
    assert [c.shape[1] for c in chunks] == [5 * 512, 2 * 512]
    got = np.concatenate(chunks, axis=1)
    assert got.shape == (2, full.shape[1], 2)
    assert np.array_equal(got, full[:2])
    # the device checksum is the last whole chunk's |out| sum
    cs = tc.render_cyclic_stream_device(st, chunk_blocks=3, device="cpu")
    want = np.abs(full[:, 3 * 512:6 * 512]).astype(np.float64).sum()
    assert cs == pytest.approx(want, rel=1e-12)


def test_a_noise_voice_takes_the_given_stream():
    """``noise=`` replaces the engine's stream (one value per frame for
    every noise voice and row)."""
    tl = _jax_timeline(["v0 w6 f3 a20 h40 F1,0.3", "v1 w0 f220 a20 F0,0.5"],
                       0.03)
    st = jb.pack_stacked(jb.stack_timelines([tl] * 2), cyclic=True)
    total = tl.num_blocks * tl.block
    own = tc.render_cyclic(st, device="cpu")
    assert np.array_equal(
        own, tc.render_cyclic(st, noise=jt.noise_stream(total),
                              device="cpu"))
    other = np.random.default_rng(0).uniform(-1, 1, total).astype(np.float32)
    assert not np.array_equal(own, tc.render_cyclic(st, noise=other,
                                                    device="cpu"))


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
            fields += [(f.strip(","), "int") for f in decl.split()[1:]]
    return fields


def test_args_match_cuda_struct():
    """Every argument struct of csrc/cyclic.cu (both variants take
    CyclicArgs) against its ctypes mirror."""
    src = (build.CSRC / "cyclic.cu").read_text()
    names = re.findall(r"^struct (\w+Args) \{", src, re.M)
    assert names == ["CyclicArgs"]
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int"}
    for name in names:
        want = [(k, kinds[t]) for k, t in getattr(ck, name)._fields_]
        assert _c_struct_fields(src, name) == want


def _bits(x):
    return x.numpy().view(np.int32)


def test_wrap_fmod_is_fmod_bit_for_bit():
    """The cyclic kernel's wrap (one subtraction for L <= x < 2L, x for
    |x| < L, fmodf elsewhere) against torch.fmod: its edges, then 10^6
    random operands (in-range phases, wide magnitudes, raw bit
    patterns)."""
    f = np.float32
    Ls = [f(1.0), f(4096.0), f(60406.0), f(3.5), f(1e-40), f(2e38),
          f(np.inf), f(np.nan), f(0.0), f(-2.0)]
    xs, ls = [], []
    with np.errstate(over="ignore", invalid="ignore"):
        for L in Ls:
            two = f(2) * L
            edge = [L, two, np.nextafter(two, f(0)), -L, f(0.0), f(-0.0),
                    f(1e-45), f(-1e-45), f(np.inf), f(-np.inf), f(np.nan),
                    L * f(1.5), -L * f(0.5), L * f(0.999), f(3) * L,
                    f(-3) * L, np.nextafter(L, f(0)),
                    np.nextafter(L, f(np.inf))]
            xs += edge
            ls += [L] * len(edge)
    x, L = torch.tensor(np.array(xs, f)), torch.tensor(np.array(ls, f))
    assert np.array_equal(_bits(wrap_fmod(x, L)), _bits(torch.fmod(x, L)))

    rng = np.random.default_rng(5)
    n = 1_000_000
    L = np.exp(rng.uniform(-8, 12, n)).astype(f)
    parts = [
        (L * rng.uniform(-1.2, 2.2, n)).astype(f),
        (L * rng.uniform(-50, 50, n)).astype(f),
        rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
        .view(f),
    ]
    for x in parts:
        xt, Lt = torch.from_numpy(x), torch.from_numpy(L)
        assert np.array_equal(_bits(wrap_fmod(xt, Lt)),
                              _bits(torch.fmod(xt, Lt)))
    # the shortcuts were taken, both of them, on the in-range phases
    x = parts[0]
    assert ((x >= L) & (x < 2 * L)).mean() > 0.2
    assert (np.abs(x) < L).mean() > 0.3


def _script(name):
    return ci.ALL_FEATURES if name == "all_features" else SCRIPTS.get(
        name) or (ci.CORPUS / f"{name}.sk").read_text().splitlines()


def test_fixed_key_is_deterministic_and_per_feature_set():
    """fb1-fb5's keys: the same from a fresh pack, different from each
    other and from the all-features key; the mode and the voice count
    are part of it, and the library path follows the key."""
    names = ("fb1", "fb2", "fb3", "fb4", "fb5", "all_features")
    keys = {}
    for name in names:
        a = ci.block_inputs(_script(name), 2, seed=1, n=8)
        b = ci.block_inputs(_script(name), 3, seed=2, n=8)
        keys[name] = ck.fixed_key(a[7], a[8])
        assert ck.fixed_key(b[7], b[8]) == keys[name]
        assert ck.fixed_key(a[7], a[8], exact=False) != keys[name]
        assert ck.fixed_key(a[7], a[8] + 1) != keys[name]
        assert f"CYC_K={a[8]}" in keys[name]
    assert len(set(keys.values())) == len(names)
    paths = {build._target("cyclic", key) for key in keys.values()}
    assert len(paths) == len(names)
    assert build._target("cyclic", keys["fb2"]) \
        == build._target("cyclic", tuple(keys["fb2"]))
    assert build._target("cyclic") not in paths


def test_variant_rule_and_cap():
    """The keyed variant up to the cap (at least 8 voices: fb1-fb5 and
    the all-features script), the general one above it."""
    assert ck.FIXED_K_MAX >= 8
    for k in range(1, ck.FIXED_K_MAX + 1):
        assert ck.variant_for(k) == "fixed"
    for k in (0, ck.FIXED_K_MAX + 1, 64):
        assert ck.variant_for(k) == "general"
    ring = [f"v{v} w0 f{50 + v} a5 F{(v + 1) % 64},0.3" for v in range(64)]
    assert ck.variant_for(ci.block_inputs(ring, 2, seed=1, n=8)[8]) \
        == "general"
    for name in ("fb1", "fb2", "fb3", "fb4", "fb5", "all_features"):
        k = ci.block_inputs(_script(name), 2, seed=1, n=8)[8]
        assert ck.variant_for(k) == "fixed", name


def test_build_keeps_the_compiler_report_beside_each_library(
        tmp_path, monkeypatch):
    """nvcc's output is kept beside the library it built, so ``report``
    gives ptxas's registers and spills for a cached build as for a fresh
    one; a library without its report builds again, and a key that fails
    leaves neither behind.  A stand-in for nvcc writes the library."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "for a; do [ \"$prev\" = -o ] && out=$a; prev=$a; done\n"
        "case \"$*\" in *CYC_K=bad*) echo 'error: bad key'; exit 1;; esac\n"
        "echo 'ptxas info    : Used 7 registers'\n"
        "echo '    0 bytes stack frame, 0 bytes spill stores, "
        "0 bytes spill loads'\n"
        "echo lib > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "LOG", {})
    key = ck.fixed_key(ci.block_inputs(_script("fb2"), 2, seed=1, n=8)[7], 5)
    assert list(build.build_all([("cyclic", key)])) \
        == [build.label("cyclic", key)]
    lib = build._target("cyclic", key)
    assert lib.read_text() == "lib\n"
    want = build.LOG[build.label("cyclic", key)][1]
    assert "Used 7 registers" in want and " 0 bytes spill stores" in want
    build.LOG.clear()
    assert build.build_all([("cyclic", key)]) == {}
    assert build.report("cyclic", key) == want
    lib.with_suffix(".txt").unlink()
    assert list(build.build_all([("cyclic", key)])) \
        == [build.label("cyclic", key)]
    assert build.report("cyclic", key) == want
    bad = tuple("CYC_K=bad" if d.startswith("CYC_K=") else d for d in key)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.report("cyclic", bad)
    assert not build._target("cyclic", bad).exists()
    assert not build._target("cyclic", bad).with_suffix(".txt").exists()
