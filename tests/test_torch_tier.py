"""The port's tier kernel against the JAX package's tier_pallas.

``tier_plain`` (the kernel's arithmetic in torch ops) must equal
``skred_tpu.engine.kernels.tier_pallas`` run in interpret mode bit for
bit, on random blocks of stress64's two tier feature sets and on wider
feature sets.  The CUDA kernel itself is held against ``tier_plain`` on
the card by tests/test_torch_tier_cuda.py and chip_smoke.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skred_tpu.engine import kernels as jk
from skred_tpu_torch.engine.kernels import tier as tt
from skred_tpu_torch.engine.kernels.tier_inputs import (STRESS64_TIER0,
                                                        STRESS64_TIER1,
                                                        random_tier_inputs)

torch.set_num_threads(1)

# env + hoisted am stream, finish, pow2 tables
ENV_AM = (True, True, False, True, True, True, True, True, True, False,
          True, False, (1, 2, 5, 7), True)
# every stage but the smoother: am_self, czm, finish, direction, non-pow2
# tables.  The smoother stays off here because XLA's CPU compiler
# contracts the interpreted kernel's ``base_gain * amod - sg`` into one
# fma when a per-sample amp-mod feeds the smoother; the port (like the
# TPU kernel) rounds the product and the difference separately.
ALL_BUT_SM = (True, True, True, True, True, False, True, True, True, True,
              True, True, (1, 2, 3, 4, 5, 6, 7), False)

CASES = {"stress64_tier0": STRESS64_TIER0, "stress64_tier1": STRESS64_TIER1,
         "env_am": ENV_AM, "all_but_sm": ALL_BUT_SM}


def _torch(a, device="cpu"):
    return None if a is None else torch.from_numpy(a).to(device)


def _plain(args, feat, n, device="cpu"):
    table, cbase, inc, dm, amod, vecs, states = args
    return tt.tier_plain(
        _torch(table, device), cbase, _torch(inc, device),
        _torch(dm, device), _torch(amod, device),
        {k: _torch(v, device) for k, v in vecs.items()},
        {k: _torch(v, device) for k, v in states.items()},
        feat=feat, exact=True, n=n)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    bad = a != b
    assert not bad.any(), f"{what}: {bad.sum()} of {bad.size} differ"


@pytest.mark.parametrize("case", sorted(CASES))
def test_tier_plain_matches_tier_pallas_interpret(case):
    feat = CASES[case]
    n, m = 64, 1024
    args = random_tier_inputs(feat, n, m, seed=3)
    table, cbase, inc, dm, amod, vecs, states = args
    j = lambda a: None if a is None else jnp.asarray(a)
    old = jk.INTERPRET
    jk.INTERPRET = True
    try:
        out, res = jk.tier_pallas(
            j(table.reshape(-1, 128)), j(vecs["base_off"] // 32768),
            j(np.array([cbase], np.int32)), j(inc), j(dm), j(amod),
            {k: j(v) for k, v in vecs.items()},
            {k: j(v) for k, v in states.items()},
            feat=feat, exact=True, n=n)
        out = np.asarray(out)
        res = {k: np.asarray(v) for k, v in res.items()}
    finally:
        jk.INTERPRET = old
        jax.clear_caches()
    # XLA's CPU runtime flushes denormals; run the plain version the same
    torch.set_flush_denormal(True)
    try:
        got, got_res = _plain(args, feat, n)
    finally:
        torch.set_flush_denormal(False)
    assert (out != 0).mean() > 0.5, "too few live samples to compare"
    _same(got.numpy(), out, "out")
    assert sorted(got_res) == sorted(res)
    for k in res:
        _same(got_res[k].numpy(), res[k], k)


def test_tier_args_match_cuda_struct():
    """The ctypes struct the wrapper fills has the C struct's fields, in
    order and of the same kinds (int, pointer)."""
    src = (tt.__file__.rsplit("/", 1)[0] + "/csrc/tier.cu")
    body = re.search(r"struct TierArgs \{(.*?)\};", open(src).read(),
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        kind = "ptr" if "*" in decl else "int"
        for name in decl.replace("*", " ").split()[1:] if kind == "int" \
                else re.findall(r"\*\s*(\w+)", decl):
            fields.append((name.strip(","), kind))
    want = [(k, "ptr" if t is tt.ctypes.c_void_p else "int")
            for k, t in tt.TierArgs._fields_]
    assert fields == want
    # the mix's and the fold's arguments are part of the struct
    names = {k for k, _ in fields}
    assert {"b", "out_stride", "has_mix", "acc_add", "fold_fm", "fold_cz",
            "fold_am", "bank_w", "bank_stride", "bank", "prev", "fm_src",
            "fm_del", "cz_src", "cz_del", "am_src", "am_del", "wl", "wr",
            "acc_l", "acc_r", "out_last"} <= names
    # and its natural layout is what ctypes builds: ints, then pointers
    n_int = sum(1 for _, kind in fields if kind == "int")
    assert [kind for _, kind in fields] == \
        ["int"] * n_int + ["ptr"] * (len(fields) - n_int)
    assert tt.ctypes.sizeof(tt.TierArgs) == \
        (n_int * 4 + 7) // 8 * 8 + 8 * (len(fields) - n_int)


def test_tier_cpu_tensor_takes_plain_version():
    feat = STRESS64_TIER0
    args = random_tier_inputs(feat, 16, 256, seed=1)
    before = tt.tier.launches
    table, cbase, inc, dm, amod, vecs, states = args
    out, res = tt.tier(_torch(table), cbase, _torch(inc), _torch(dm),
                       _torch(amod),
                       {k: _torch(v) for k, v in vecs.items()},
                       {k: _torch(v) for k, v in states.items()},
                       feat=feat, n=16)
    want, want_res = _plain(args, feat, 16)
    assert tt.tier.launches == before, "a CPU tensor launched the kernel"
    _same(out.numpy(), want.numpy(), "out")
    for k in want_res:
        _same(res[k].numpy(), want_res[k].numpy(), k)


def test_tier_cpu_tensor_runs_plain_in_either_variant():
    """A CPU tensor runs the plain version and counts no launch of the
    kernel, keyed or not."""
    feat = STRESS64_TIER1
    args = random_tier_inputs(feat, 16, 256, seed=2)
    table, cbase, inc, dm, amod, vecs, states = args
    counts = (tt.tier.launches, tt.tier_keyed.launches)
    want, want_res = _plain(args, feat, 16)
    out, res = tt.tier(_torch(table), cbase, _torch(inc), _torch(dm),
                       _torch(amod),
                       {k: _torch(v) for k, v in vecs.items()},
                       {k: _torch(v) for k, v in states.items()},
                       feat=feat, n=16)
    _same(out.numpy(), want.numpy(), "out")
    for k in want_res:
        _same(res[k].numpy(), want_res[k].numpy(), k)
    assert (tt.tier.launches, tt.tier_keyed.launches) == counts


# ---- the keyed variant's build keys ----

ALL_FLAGS = (True,) * 12 + ((1, 2, 3, 4, 5, 6, 7), True)


def test_tier_key_is_deterministic_and_per_feature_set():
    """One key per (features, mode, mix, folded streams): the same from
    equal arguments, changed by each flag, the CZ mode mask, ts_pow2, the
    mode, the mix and each folded stream; stress64's two tiers give two
    keys, and each key its own library."""
    from skred_tpu_torch.engine.kernels import build

    base = tt.tier_key(ALL_FLAGS, True, False, ())
    assert tt.tier_key(tuple(ALL_FLAGS), True, False, ()) == base
    assert all(d.startswith("TIER_") for d in base)
    seen = {base}
    for i in range(12):
        feat = list(ALL_FLAGS)
        feat[i] = False
        key = tt.tier_key(tuple(feat), True, False, ())
        assert key != base, tt._FEAT_NAMES[i]
        seen.add(key)
    for feat in (ALL_FLAGS[:12] + ((1, 2, 3), True),
                 ALL_FLAGS[:13] + (False,)):
        seen.add(tt.tier_key(feat, True, False, ()))
    seen.add(tt.tier_key(ALL_FLAGS, False, False, ()))
    seen.add(tt.tier_key(ALL_FLAGS, True, True, ()))
    for k in ("fm", "cz", "am"):
        seen.add(tt.tier_key(ALL_FLAGS, True, False, (k,)))
    assert len(seen) == 12 + 1 + 2 + 2 + 3
    # the CZ mask counts only where CZ is on, a fold only where the
    # stream exists
    no_cz = (False,) * 12 + ((1, 2), True)
    assert tt.tier_key(no_cz, True, False, ()) \
        == tt.tier_key(no_cz[:12] + ((4,), True), True, False, ())
    assert tt.tier_key(STRESS64_TIER1, True, True, ("fm", "cz", "am")) \
        == tt.tier_key(STRESS64_TIER1, True, True, ("fm",))
    k0 = tt.tier_key(STRESS64_TIER0, True, True, ())
    k1 = tt.tier_key(STRESS64_TIER1, True, True, ("fm",))
    assert k0 != k1
    paths = {build._target("tier", k) for k in seen | {k0, k1}}
    assert len(paths) == len(seen | {k0, k1})
    # no build without a key: build_all() with no items leaves it out
    assert "tier" in build.KEY_ONLY
    with pytest.raises(ValueError, match="unknown folded stream"):
        tt.tier_key(ALL_FLAGS, True, False, ("pm",))


ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent
# a delayed fm edge, an am edge and a cz-mod edge on one tier-0 LFO: two
# tiers, the second folded
THREE_STREAMS = ["v0 w0 f330 a3 F1,0.5", "v1 w2 f2 a2",
                 "v2 w0 f220 a3 A1,0.4 p-0.4",
                 "v3 w4 f110 a3 c1,0.5 C1,0.3 P1 Q0.7"]
# each segment's graph is acyclic, their union is not: no tiers, an
# estimate pass before the final one
UNION_CYCLE = ["v0 w0 f330 a3 F1,0.5", "v1 w2 f2 a2", "v2 w0 f220 a2 p0.3 "
               "~.02 v0 F1,0 v1 F0,0.4"]
# noise in tier 0 (no tier kernel), the tier kernel (folded) in tier 1
NOISE_MIXED = ["v1 w6 f3 a1 h40", "v0 w0 f220 a3 F1,0.5"]
# script, keys its render builds (noise_mixed: one tier key and its noise
# tier's keyed phase walk and filter/smoother)
RENDERS = {"three_streams": (THREE_STREAMS, 2),
           "union_cycle": (UNION_CYCLE, 2), "noise_mixed": (NOISE_MIXED, 3)}


def _port_batch(lines, rows=2, seconds=0.03):
    from skred_tpu_torch.assets import WaveBank
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines

    tl = compile_script(lines, seconds, bank=WaveBank(),
                        script_dir=ROOT / "corpus")
    return pack_stacked(stack_timelines([tl] * rows))


def _stand_in_nvcc(tmp_path):
    """An nvcc that writes a library and a clean ptxas report, and logs
    each invocation's -D defines, one line per process."""
    log = tmp_path / "nvcc_calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "for a; do [ \"$prev\" = -o ] && out=$a; prev=$a; done\n"
        f"echo \"$*\" >> {log}\n"
        "echo 'ptxas info    : Used 40 registers'\n"
        "echo lib > \"$out\"\n")
    nvcc.chmod(0o755)
    return nvcc, log


@pytest.mark.parametrize("script", sorted(RENDERS))
def test_render_builds_its_tier_keys_together_before_the_first_block(
        script, tmp_path, monkeypatch):
    """A render on the card builds the keys of all its tier-kernel calls
    and keyed noise-kernel calls, and the volume kernel, in one parallel
    build before its first block, and launches no other key.  The render runs on the CPU (the
    plain version) with the build switched on and a stand-in for nvcc."""
    from skred_tpu_torch.engine import fused as tf
    from skred_tpu_torch.engine.kernels import build
    from skred_tpu_torch.engine.kernels import filt_smooth as tfs
    from skred_tpu_torch.engine.kernels import phase_walk as tpw

    lines, n_keys = RENDERS[script]
    nvcc, log = _stand_in_nvcc(tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "LOG", {})
    monkeypatch.setattr(tf, "_builds_kernels", lambda device: True)
    events = []
    real_build_all, real_tier = build.build_all, tf.tier

    def build_all(items=None):
        events.append(("build", tuple(items)))
        return real_build_all(items)

    def tier(*a, **kw):
        folded = tt._folded(tt._flags(kw["feat"]), kw["fold"])
        events.append(("tier", tt.tier_key(kw["feat"], kw["exact"],
                                           kw["mixw"] is not None, folded)))
        return real_tier(*a, **kw)

    def keyed(name, real, key):
        def call(*a, **kw):
            events.append(("noise", (name, key(kw.get("feat")))))
            return real(*a, **kw)
        return call

    monkeypatch.setattr(build, "build_all", build_all)
    monkeypatch.setattr(tf, "tier", tier)
    monkeypatch.setattr(tf, "phase_walk_warp", keyed(
        "phase_walk", tf.phase_walk_warp, tpw.phase_walk_key))
    monkeypatch.setattr(tf, "filt_smooth_noise", keyed(
        "filt_smooth", tf.filt_smooth_noise, tfs.filt_smooth_key))
    monkeypatch.setattr(tf, "volume", keyed("volume", tf.volume,
                                            lambda feat: ()))
    st = _port_batch(lines)
    assert (st.tiers is None) == (script == "union_cycle")
    out = tf.render_fused(st, device="cpu")
    assert np.isfinite(out).all() and np.abs(out).max() > 0.01
    builds = [e for e in events if e[0] == "build"]
    assert len(builds) == 1 and events[0][0] == "build"
    built = {build._spec(item) for item in builds[0][1]}
    launched = {("tier", key) if kind == "tier" else key
                for kind, key in events if kind != "build"}
    assert launched == built and len(built) == n_keys + 1
    assert any(name == "tier" for name, _ in built)
    assert ("volume", ()) in built
    assert len(log.read_text().splitlines()) == n_keys + 1
    for name, key in built:
        assert build._target(name, key).exists()


def test_cpu_render_builds_and_launches_nothing(monkeypatch):
    """On the CPU a render neither builds nor launches a kernel."""
    from skred_tpu_torch.engine import fused as tf
    from skred_tpu_torch.engine.kernels import build

    def refuse(*a, **kw):
        raise AssertionError("a CPU render built a kernel")

    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "load", refuse)
    counts = (tt.tier.launches, tt.tier_keyed.launches)
    out = tf.render_fused(_port_batch(THREE_STREAMS), device="cpu")
    assert np.isfinite(out).all()
    assert (tt.tier.launches, tt.tier_keyed.launches) == counts
