"""The timing-ablation switches of the keyed tier and cyclic kernels
(``SKRED_MEGA_ABLATE``, ``SKRED_CYC_ABLATE``): the build keys, the
refusals that keep an ablated render out of every headline, and
``tools/mega_ablate.py``'s configurations.

With the empty set every key is the tuple of the kernels' own defines,
with no stub (literals of stress64's two tier keys and fb2's cyclic
key).  Each phase adds exactly its one define, in a fixed order; an
unknown name raises, also from the environment at import.  The plain
versions (CPU tensors) and the general cyclic variant have no stubs and
refuse a nonempty set; under either variable ``bench_torch.py``,
``card_parity`` and ``endurance`` refuse to start, and a CPU render
raises.  The stubs themselves run only on the card (chip_smoke.py's
ablate phase).
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from skred_tpu_torch.engine import fused
from skred_tpu_torch.engine.fused import compute_feat
from skred_tpu_torch.engine.kernels import cyclic as ck
from skred_tpu_torch.engine.kernels import cyclic_inputs as ci
from skred_tpu_torch.engine.kernels import tier as tk
from skred_tpu_torch.engine.kernels.tier_inputs import random_tier_inputs
from skred_tpu_torch.parallel.buckets import make_buckets
from skred_tpu_torch.tools import card, mega_ablate
from tests.test_torch_card_parity import ROOT, STRESS64

ONE_BLOCK = 0.0116
FB2 = ROOT / "corpus" / "fb2.sk"
ALL_FLAGS = (True,) * 12 + ((1, 2, 3, 4, 5, 6, 7), True)

# the keys without a stub (stress64's tier 0 and tier 1 as the main path
# renders them, mix and fold on; fb2's keyed cyclic call)
STRESS64_KEYS = (
    ("TIER_EXACT=1", "TIER_CZ_MASK=0", "TIER_TS_POW2=1", "TIER_MIX=1",
     "TIER_FOLD_FM=0", "TIER_FOLD_CZ=0", "TIER_FOLD_AM=0",
     "TIER_HAS_FM=0", "TIER_HAS_CZ=0", "TIER_HAS_CZM=0", "TIER_HAS_ENV=0",
     "TIER_HAS_FLT=0", "TIER_HAS_SM=1", "TIER_HAS_HOLD=0",
     "TIER_HAS_QUANT=0", "TIER_HAS_AM=0", "TIER_HAS_AM_SELF=0",
     "TIER_HAS_FINISH=0", "TIER_HAS_DIRECTION=0"),
    ("TIER_EXACT=1", "TIER_CZ_MASK=254", "TIER_TS_POW2=1", "TIER_MIX=1",
     "TIER_FOLD_FM=1", "TIER_FOLD_CZ=0", "TIER_FOLD_AM=0",
     "TIER_HAS_FM=1", "TIER_HAS_CZ=1", "TIER_HAS_CZM=0", "TIER_HAS_ENV=0",
     "TIER_HAS_FLT=1", "TIER_HAS_SM=1", "TIER_HAS_HOLD=1",
     "TIER_HAS_QUANT=1", "TIER_HAS_AM=0", "TIER_HAS_AM_SELF=0",
     "TIER_HAS_FINISH=0", "TIER_HAS_DIRECTION=0"))
FB2_KEY = ("CYC_K=5", "CYC_EXACT=1", "CYC_CZ_MASK=2", "CYC_HAS_FM=1",
           "CYC_HAS_CZ=1", "CYC_HAS_CZM=0", "CYC_HAS_AM=1",
           "CYC_HAS_AM_SELF=0", "CYC_HAS_PM=0", "CYC_HAS_PM_SELF=0",
           "CYC_HAS_ENV=0", "CYC_HAS_FLT=0", "CYC_HAS_SM=1",
           "CYC_HAS_HOLD=1", "CYC_HAS_QUANT=1", "CYC_HAS_NOISE=0",
           "CYC_HAS_FINISH=0", "CYC_HAS_DIRECTION=0", "CYC_HAS_DISC=1")


def _stress64_keys():
    (bk,) = make_buckets([STRESS64], ONE_BLOCK, 4, 2)
    _, r, _ = fused._prepare(bk.st, True, "cpu")
    return fused._tier_keys(r)


def _fb2_feat():
    (bk,) = make_buckets([FB2], ONE_BLOCK, 4, 2)
    return compute_feat(bk.st), bk.voices


def test_no_switch_keeps_every_key():
    assert tk.MEGA_ABLATE == frozenset() and ck.CYC_ABLATE == frozenset()
    assert _stress64_keys() == STRESS64_KEYS
    feat, k = _fb2_feat()
    assert ck.fixed_key(feat, k) == FB2_KEY
    assert ck.fixed_key(feat, k, True, ()) == FB2_KEY
    for key in STRESS64_KEYS:
        assert not any("ABLATE" in d for d in key)


def test_each_tier_phase_adds_its_define_in_order():
    base = tk.tier_key(ALL_FLAGS, True, True, ())
    assert tk.tier_phases(ALL_FLAGS, True) == tk.MEGA_PHASES
    for p in tk.MEGA_PHASES:
        assert tk.tier_key(ALL_FLAGS, True, True, (), frozenset({p})) \
            == base + (f"TIER_ABLATE_{p.upper()}=1",)
    every = tk.tier_key(ALL_FLAGS, True, True, (),
                        tuple(reversed(tk.MEGA_PHASES)))
    assert every == base + tuple(f"TIER_ABLATE_{p.upper()}=1"
                                 for p in tk.MEGA_PHASES)
    assert tk.tier_key(ALL_FLAGS, True, True, (), "mix,phase1") \
        == base + ("TIER_ABLATE_PHASE1=1", "TIER_ABLATE_MIX=1")
    # a phase the key does not compile in adds nothing: stress64's tiers
    # have no envelope and no am stream, tier calls without the mix none
    t0 = STRESS64_KEYS[0]
    feat0 = (False,) * 5 + (True,) + (False,) * 6 + ((), True)
    assert tk.tier_key(feat0, True, True, (), frozenset({"gain"})) == t0
    assert tk.tier_key(feat0, True, False, (), "mix") \
        == tk.tier_key(feat0, True, False, ())


def test_each_cyclic_phase_adds_its_define_in_order():
    a = ci.block_inputs(ci.ALL_FEATURES, 2, seed=17, n=8)
    feat, k = a[7], a[8]
    base = ck.fixed_key(feat, k)
    assert ck.cyclic_phases(feat) == ck.CYC_PHASES
    for p in ck.CYC_PHASES:
        assert ck.fixed_key(feat, k, True, {p}) \
            == base + (f"CYC_ABLATE_{p.upper()}=1",)
    assert ck.fixed_key(feat, k, True, "all,reads,pan") == base + (
        "CYC_ABLATE_READS=1", "CYC_ABLATE_PAN=1", "CYC_ABLATE_ALL=1")
    fb2, kk = _fb2_feat()
    assert ck.fixed_key(fb2, kk, True, {"pan"}) == FB2_KEY   # no pan-mod
    # "reads" is the fm read alone: the cz-mod, am and pan-mod reads
    # belong to cz, dsp and pan, so without fm the key has no reads phase
    no_fm = feat._replace(fm=False)
    assert ck.cyclic_phases(no_fm) == tuple(p for p in ck.CYC_PHASES
                                            if p != "reads")
    assert ck.fixed_key(no_fm, k, True, "reads") == ck.fixed_key(no_fm, k)


def test_unknown_phase_raises():
    with pytest.raises(ValueError, match="phase1, phase2, lookup, gain, "
                                         "phase4, mix"):
        tk.tier_key(ALL_FLAGS, True, True, (), frozenset({"phase3"}))
    feat, k = _fb2_feat()
    with pytest.raises(ValueError, match="reads, lookup, cz, dsp, pan, "
                                         "all"):
        ck.fixed_key(feat, k, True, {"phase1"})
    for var, module in (("SKRED_MEGA_ABLATE", "tier"),
                        ("SKRED_CYC_ABLATE", "cyclic")):
        res = subprocess.run(
            [sys.executable, "-c",
             f"import skred_tpu_torch.engine.kernels.{module}"],
            cwd=ROOT, env=dict(os.environ, **{var: "walk"}),
            capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert f"{var}: no phase walk" in res.stderr


def test_plain_versions_and_general_variants_refuse(monkeypatch):
    n, m = 16, 32
    table, cbase, inc, dm, amod, vecs, states = random_tier_inputs(
        ALL_FLAGS, n, m, seed=3)
    t = lambda x: None if x is None else torch.from_numpy(x)
    args = (t(table), cbase, t(inc), t(dm), t(amod),
            {k: t(v) for k, v in vecs.items()},
            {k: t(v) for k, v in states.items()})
    # no set: the plain version runs
    out, _ = tk.tier(*args, feat=ALL_FLAGS, n=n)
    assert out.shape == (n, m)
    monkeypatch.setattr(tk, "MEGA_ABLATE", frozenset({"phase4"}))
    with pytest.raises(ValueError, match="plain version"):
        tk.tier(*args, feat=ALL_FLAGS, n=n)

    a = list(ci.block_inputs(ci.ALL_FEATURES, 2, seed=17, n=8))
    monkeypatch.setattr(ck, "CYC_ABLATE", frozenset({"dsp"}))
    with pytest.raises(ValueError, match="plain version"):
        ck.cyclic_block(*a)
    a[6] = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="general variant"):
        ck.cyclic_block(*a, variant="general")


@pytest.mark.parametrize("var,value,engine", [
    ("SKRED_MEGA_ABLATE", "phase4", "fused"),
    ("SKRED_CYC_ABLATE", "dsp", "cyclic")])
def test_cpu_render_refuses_a_set(var, value, engine):
    script = STRESS64 if engine == "fused" else FB2
    code = (
        "from skred_tpu_torch.parallel.buckets import make_buckets\n"
        "from skred_tpu_torch.engine import cyclic, fused\n"
        f"(bk,) = make_buckets([{str(script)!r}], {ONE_BLOCK}, 4, 2)\n"
        + ("fused.render_fused(bk.st, device='cpu')\n" if engine == "fused"
           else "cyclic.render_cyclic(bk.st, device='cpu')\n"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, **{var: value}),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "has no stubs" in res.stderr


@pytest.mark.parametrize("var", ["SKRED_MEGA_ABLATE", "SKRED_CYC_ABLATE"])
@pytest.mark.parametrize("cmd", [
    ["bench_torch.py", "0.05"],
    ["-m", "skred_tpu_torch.tools.card_parity", "1", "--device", "cpu"],
    ["-m", "skred_tpu_torch.tools.endurance", "run", "--device", "cpu"]],
    ids=["bench_torch", "card_parity", "endurance"])
def test_headline_tools_refuse_to_start(var, cmd):
    value = "mix" if var == "SKRED_MEGA_ABLATE" else "pan"
    res = subprocess.run([sys.executable, *cmd], cwd=ROOT,
                         env=dict(os.environ, **{var: value}),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2
    assert (f"refusing to run under timing ablation ({var}={value})"
            in res.stdout + res.stderr)


def test_ablated_tag(monkeypatch):
    assert card.ablated_tag() == "" and card.ablated() == {}
    monkeypatch.setattr(tk, "MEGA_ABLATE", frozenset({"phase4", "mix"}))
    monkeypatch.setattr(ck, "CYC_ABLATE", frozenset({"dsp"}))
    assert card.ablated_tag() == ("ABLATED SKRED_MEGA_ABLATE=mix,phase4 "
                                  "SKRED_CYC_ABLATE=dsp")
    with pytest.raises(SystemExit) as ex:
        card.refuse_ablated("x")
    assert ex.value.code == 2


def test_mega_ablate_configs_are_the_originals():
    """The port's labels and sets equal ``tools/mega_ablate.py``'s
    ``CONFIGS``, read as text (the JAX tool is not imported)."""
    tree = ast.parse((ROOT / "tools" / "mega_ablate.py").read_text())
    (node,) = [n for n in tree.body if isinstance(n, ast.Assign)
               and [t.id for t in n.targets] == ["CONFIGS"]]
    assert mega_ablate.CONFIGS == ast.literal_eval(node.value)
    assert [lab for lab, _ in mega_ablate.CYC_CONFIGS][0] == "full"
    for _, ab in mega_ablate.CYC_CONFIGS:
        assert set(filter(None, ab.split(","))) <= set(ck.CYC_PHASES)
