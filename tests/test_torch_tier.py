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
