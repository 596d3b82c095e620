"""The one-bucket and glue tools (``skred_tpu_torch/tools/one_bucket.py``,
``gluebench.py``) on the CPU, and what every new tool must do: import
with JAX and the JAX package blocked, and stop with an error line when
there is no card and no ``--device cpu``.

``one_bucket`` times fb2's cyclic bucket cut to 2 rows and 1-block
chunks in both modes.  Each gluebench stub, given the arguments a real
call got on one block of noise64 and of stress64, returns what the real
plain call returns: the same shapes, dtypes and end-state keys.  A
gluebench run attributes the full run less each stubbed run to the
kernel and puts the real kernels back afterwards, also when a run
raises.
"""

import subprocess
import sys

import pytest
import torch

from skred_tpu_torch.engine import fused as tf
from skred_tpu_torch.parallel import buckets
from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines
from skred_tpu_torch.tools import card_parity, endurance, gluebench
from skred_tpu_torch.tools import one_bucket as ob
from tests.test_torch_card_parity import NOISE64, ROOT, STRESS64

torch.set_num_threads(1)

ONE_BLOCK = 0.0116


def test_one_bucket_on_fb2(monkeypatch, capsys):
    monkeypatch.setattr(ob, "CHUNK", 1)
    monkeypatch.setattr(buckets, "CYCLIC_ROWS", 2)
    assert ob.main(["fb2.sk", str(2 * ONE_BLOCK), "exact,fast",
                    "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["fb2.sk exact",
                                                  "fb2.sk fast"]
    assert all("cyclic batch 2 tiers [] build" in ln and "x_rt" in ln
               and ln.endswith("on cpu (power limit None)") for ln in lines)
    recs = ob.one_bucket("fb2.sk", 2 * ONE_BLOCK, ["exact"], "cpu",
                         max_rows=2)
    (rec,) = recs
    assert (rec["kind"], rec["batch"], rec["blocks"]) == ("cyclic", 2, 2)
    assert rec["build_s"] > 0 and rec["wall_s"] > 0
    assert rec["x_rt"] == pytest.approx(2 * 2 * 512 / 44100 / rec["wall_s"])


def _calls(path, monkeypatch):
    """The real plain calls of one block of ``path`` at 2 rows: [(name,
    args, kwargs, result)]."""
    tl = buckets.compile_one(path, ONE_BLOCK, buckets.WaveBank())[0]
    st = pack_stacked(stack_timelines([tl] * 2))
    calls = []
    for name in gluebench.KERNELS:
        real = getattr(tf, name)

        def rec(*a, _name=name, _real=real, **kw):
            res = _real(*a, **kw)
            calls.append((_name, a, kw, res))
            return res
        monkeypatch.setattr(tf, name, rec)
    tf.render_fused(st, device="cpu")
    return calls


def _like(a, b):
    """The same structure, shapes and dtypes (dicts: the same keys)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_like(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_like, a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape \
            and a.dtype == b.dtype
    return a is None and b is None


@pytest.mark.parametrize("path", [STRESS64, NOISE64], ids=lambda p: p.stem)
def test_stubs_return_what_the_kernels_return(monkeypatch, path):
    calls = _calls(path, monkeypatch)
    names = sorted({c[0] for c in calls})
    assert names == (["tier"] if path == STRESS64 else
                     ["filt_smooth_noise", "lookup", "phase_walk_warp"])
    stubs = gluebench.Stubs()
    for name, a, kw, real in calls:
        got = getattr(stubs, name)(*a, **kw)
        assert _like(real, got), name
        if kw.get("out") is not None:
            assert got[0] is kw["out"]


def test_gluebench_attributes_and_restores(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(gluebench, "CHUNK", 1)
    real = {nm: getattr(tf, nm) for nm in gluebench.KERNELS}
    rec = gluebench.gluebench(["stress64.sk"], 2 * ONE_BLOCK, "cpu",
                              max_rows=2, record=tmp_path / "g.json",
                              passes=2)
    s = rec["scripts"]["stress64.sk"]
    assert set(s["wall_s"]) == {"full", "tier stubbed", "all stubbed"}
    assert all(len(w) == 2 and min(w) == s["wall_s"][k]
               for k, w in s["pass_walls_s"].items())
    assert s["glue_ms_per_block"] == s["ms_per_block"]["tier stubbed"]
    assert s["kernel_ms_per_block"]["tier"] == pytest.approx(
        s["ms_per_block"]["full"] - s["ms_per_block"]["tier stubbed"])
    # the plain tier loops over the block's samples: its stub is faster
    assert s["kernel_ms_per_block"]["tier"] > 0
    assert "attribution, ms a block: tier" in capsys.readouterr().out
    assert {nm: getattr(tf, nm) for nm in gluebench.KERNELS} == real
    # a run that raises: the real kernels are back all the same
    st = buckets.make_buckets([NOISE64], 2 * ONE_BLOCK, 1, 2)[0].st
    seen = []

    def boom(*a, **kw):
        seen.append({nm: getattr(tf, nm) for nm in gluebench.KERNELS})
        if len(seen) == 3:                 # in the phase walk's stub run
            raise RuntimeError("boom")
        return 0.0

    monkeypatch.setattr(tf, "render_fused_stream_device", boom)
    with pytest.raises(RuntimeError, match="boom"):
        gluebench.time_runs(st, "cpu")
    assert seen[0] == seen[1] == real             # the warm and full runs
    assert seen[2]["phase_walk_warp"] != real["phase_walk_warp"]
    assert {nm: getattr(tf, nm) for nm in gluebench.KERNELS} == real


TOOLS = [card_parity, endurance, gluebench, ob]
ARGS = {card_parity: ["1"], endurance: ["run"], gluebench: [],
        ob: ["fb2.sk", "4"]}


@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__)
def test_no_card_is_an_error(monkeypatch, capsys, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as ex:
        tool.main(ARGS[tool])
    assert ex.value.code == 2
    err = capsys.readouterr().err
    assert "torch.cuda.is_available() is false" in err


@pytest.mark.parametrize("module", [
    "skred_tpu_torch.tools.card", "skred_tpu_torch.tools.endurance",
    "skred_tpu_torch.tools.gluebench", "skred_tpu_torch.tools.one_bucket",
    "bench_torch", "chip_smoke"])
def test_imports_without_jax(module):
    """With JAX and the JAX package unimportable, each tool, the bench and
    chip_smoke.py still import."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['skred_tpu'] = None; "
            f"import {module}")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
