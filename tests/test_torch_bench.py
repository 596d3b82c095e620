"""The port's bench (``bench_torch.py``) and ``render_fused_device``
on the CPU, at a tiny size.

``render_fused_device`` must equal ``render_fused`` bit for bit (its
``[num_blocks, B, block, 2]`` layout aside), match the JAX package's
``render_fused_device(use_pallas=False)`` on the same packed batch to
-100 dB, as the port's other render tests do, and refuse a cyclic batch.
``bench_torch.main(device="cpu")`` must build the seven in-repo buckets
(two fused, five cyclic), print one partial headline per bucket and then
a final one, give each bucket's timed passes the same checksum, and
render a cyclic script the kernel's gate refuses in the compat-scan
bucket, counted into the headline.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import bench_torch
from skred_tpu.assets import WaveBank as JBank
from skred_tpu.engine import fused as jf
from skred_tpu.host import timeline as jt
from skred_tpu.parallel import batch as jb
from skred_tpu_torch.assets import WaveBank
from skred_tpu_torch.engine import cyclic as tc
from skred_tpu_torch.engine import fused as tf
from skred_tpu_torch.host.timeline import compile_script
from skred_tpu_torch.parallel import buckets
from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ONE_BLOCK = 0.0116            # 511.6 samples: one block


def _batch(path, rows, blocks, cyclic=False):
    tl = compile_script(path.read_text().splitlines(),
                        blocks * 512 / 44100.0, bank=WaveBank(),
                        script_dir=path.parent)
    return pack_stacked(stack_timelines([tl] * rows), cyclic=cyclic)


@pytest.mark.parametrize("script", ["corpus/stress64.sk",
                                    "skred_tpu_torch/scripts/noise64.sk"])
def test_render_fused_device_equals_render_fused(script):
    st = _batch(ROOT / script, 8, 4)
    out = tf.render_fused_device(st, device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.shape == (4, 8, 512, 2) and out.dtype == torch.float32
    want = tf.render_fused(st, device="cpu")                 # [B, T, 2]
    got = out.permute(1, 0, 2, 3).reshape(8, 4 * 512, 2).numpy()
    assert np.array_equal(got, want)
    assert np.abs(want).max() > 0.01


@pytest.mark.parametrize("script", ["corpus/stress64.sk",
                                    "skred_tpu_torch/scripts/noise64.sk"])
def test_render_fused_device_matches_jax_package(script):
    """The JAX package's packed batch through both packages'
    ``render_fused_device``: not bit for bit, for the reason
    ``test_torch_fused.test_render_fused_matches_jax_package`` gives (XLA
    contracts some multiply-adds of the final sums into fmas), so at
    -100 dB against the peak."""
    path = ROOT / script
    tl = jt.compile_script(path.read_text().splitlines(), 4 * 512 / 44100.0,
                           bank=JBank(), script_dir=path.parent)
    st = jb.pack_stacked(jb.stack_timelines([tl] * 8))
    assert st.num_blocks == 4
    want = np.asarray(jf.render_fused_device(st, use_pallas=False))
    # XLA's CPU runtime flushes denormals; render the port the same way
    torch.set_flush_denormal(True)
    try:
        got = tf.render_fused_device(st, device="cpu").numpy()
    finally:
        torch.set_flush_denormal(False)
    assert got.shape == want.shape == (4, 8, 512, 2)
    peak = float(np.abs(want).max())
    assert peak > 0.01, "silent render compares nothing"
    err = float(np.abs(got - want).max())
    db = 20 * np.log10(max(err, 1e-30) / peak)
    assert db <= -100.0, f"{script}: {db:.1f} dB (max |diff| {err})"


def test_render_fused_device_refuses_a_cyclic_batch():
    st = _batch(ROOT / "corpus" / "fb2.sk", 2, 1, cyclic=True)
    with pytest.raises(ValueError, match="cyclic"):
        tf.render_fused_device(st, device="cpu")


def _lines(out):
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def test_bench_main_on_the_cpu(capsys):
    res = bench_torch.main(seconds=ONE_BLOCK, replicas=1, chunk=1,
                           device="cpu", max_rows=1)
    lines = _lines(capsys.readouterr().out)
    assert len(lines) == 8
    assert all(x.get("partial") and x["buckets"] == i + 1
               and x["buckets_total"] == 7 for i, x in enumerate(lines[:7]))
    final = lines[-1]
    assert "partial" not in final and final["buckets"] == 7
    assert final["card"] == {"name": "cpu", "power_limit": None}
    for key in ("metric", "value", "unit", "vs_baseline",
                "slowest_bucket_x_rt", "distinct_scripts", "total_audio_s",
                "total_wall_s", "arith"):
        assert key in final, key
    assert final["distinct_scripts"] == 7
    assert res["buckets"] == json.loads(
        bench_torch.DETAIL.read_text())["buckets"]
    kinds = [str(b["voices"]).startswith("cyclic") for b in res["buckets"]]
    assert kinds == [False] * 2 + [True] * 5
    names = sorted(s for b in res["buckets"] for s in b["scripts"])
    assert names == sorted(p.name for p in buckets.SCRIPTS)
    for b in res["buckets"]:
        assert b["rows"] == 1 and b["blocks"] == 1 and b["timed_passes"] == 2
        assert len(b["checksums"]) == 2 and len(set(b["checksums"])) == 1
        assert b["checksums"][0] > 0 and np.isfinite(b["checksums"][0])
        assert set(b["compiler"].values()) == {"native"}
        # on the CPU the wrappers run their plain versions: no launch
        assert b["launches"] == {}
        assert b["setup_s"] >= 0 and b["wall_s"] > 0
        roof = b["roofline"]
        assert roof["card"] == "cpu" and roof["bound"] is None
        assert roof["model_bytes_per_block"] > 0


@pytest.mark.parametrize("budget", [None, 0.0])
def test_bench_gate_refusal_takes_a_compat_bucket(capsys, monkeypatch,
                                                  budget):
    """A cyclic script the kernel's gate refuses renders, ``replicas``
    times, in the compat-scan bucket after the other buckets, and the
    headline counts it; ``main`` returns normally.  With the budget at 0
    the warm pass is over it: its wall is credited (``timed_cold``)."""
    monkeypatch.setattr(tc, "cyclic_gate",
                        lambda st: "per-voice table bindings differ across "
                                   "rows")
    if budget is not None:
        monkeypatch.setattr(bench_torch, "COMPAT_BUDGET_S", budget)
    res = bench_torch.main(seconds=ONE_BLOCK, replicas=2, chunk=1,
                           device="cpu", max_rows=2,
                           scripts=[ROOT / "corpus" / "fb1.sk",
                                    ROOT / "corpus" / "stress64.sk"])
    lines = _lines(capsys.readouterr().out)
    assert [x.get("partial") for x in lines] == [True, True, None]
    final = lines[-1]
    assert final["buckets"] == 2 and "error" not in final
    fused_b, compat = res["buckets"]
    assert fused_b["scripts"] == ["stress64.sk"]
    assert compat["voices"] == "compat-scan" and compat["rows"] == 2
    assert compat["scripts"] == ["fb1.sk"] and compat["distinct_scripts"] == 1
    assert compat["compiler"] == {"fb1.sk": "native"}
    assert compat["timed_cold"] is (budget == 0.0)
    # the timed pass (none when cold) gave the warm pass's checksum
    assert compat["checksums"] == compat["checksums"][:1] * (
        1 if budget == 0.0 else 2)
    assert compat["wall_s"] > 0 and compat["launches"] == {}
    audio = 2 * compat["blocks"] * 512 / 44100.0
    assert compat["x_rt"] == round(audio / compat["wall_s"], 1)
    assert final["total_audio_s"] == round(
        audio + 2 * fused_b["blocks"] * 512 / 44100.0, 1)
    assert final["total_wall_s"] == pytest.approx(
        fused_b["wall_s"] + compat["wall_s"], abs=2e-3)
    assert final["slowest_bucket_x_rt"] == min(fused_b["x_rt"],
                                               compat["x_rt"])


def test_bench_refuses_to_run_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as ex:
        bench_torch.main(seconds=ONE_BLOCK)
    assert ex.value.code == 2
    assert "error" in _lines(capsys.readouterr().out)[0]


@pytest.mark.parametrize("fault", ["a build", "a checksum"])
def test_bench_fails_a_bucket_whose_timed_pass_misbehaves(capsys,
                                                          monkeypatch, fault):
    """A timed pass that builds a kernel, or whose checksum differs from
    the other pass's, ends the run in an error line and exit 1."""
    from skred_tpu_torch.engine.kernels import build

    passes = []

    def render(st, chunk, exact=None, warmup_only=False, device="cuda"):
        if warmup_only:
            return 0.0
        passes.append(1)
        if fault == "a build":
            build.LOG[f"tier[{len(passes)}]"] = (1.0, "")
            return 1.0
        return float(len(passes))

    monkeypatch.setattr(build, "LOG", {})
    monkeypatch.setattr(tf, "render_fused_stream_device", render)
    with pytest.raises(SystemExit) as ex:
        bench_torch.main(seconds=ONE_BLOCK, replicas=1, chunk=1,
                         device="cpu", max_rows=1,
                         scripts=[ROOT / "corpus" / "stress64.sk"])
    assert ex.value.code == 1 and len(passes) == 2
    err = _lines(capsys.readouterr().out)[-1]["error"]
    assert ("built ['tier[1]', 'tier[2]']" if fault == "a build"
            else "nondeterministic") in err


@pytest.mark.parametrize("fault", ["a build", "a checksum"])
def test_bench_fails_a_compat_bucket_whose_timed_pass_misbehaves(
        capsys, monkeypatch, fault):
    """The compat-scan bucket's timed pass goes through the same checks:
    a build inside it, or a checksum other than the warm pass's, ends the
    run in an error line and exit 1."""
    from skred_tpu_torch.engine.kernels import build
    from skred_tpu_torch.parallel import batch

    passes = []

    def render(st, noise=None, device="cuda"):
        passes.append(1)
        if fault == "a build" and len(passes) == 2:
            build.LOG["compat"] = (1.0, "")
        scale = 2.0 if fault == "a checksum" and len(passes) == 2 else 1.0
        return np.full((st.batch, 4, 2), scale, np.float32)

    monkeypatch.setattr(build, "LOG", {})
    monkeypatch.setattr(batch, "render_stacked", render)
    monkeypatch.setattr(tc, "cyclic_gate",
                        lambda st: "per-voice table bindings differ across "
                                   "rows")
    with pytest.raises(SystemExit) as ex:
        bench_torch.main(seconds=ONE_BLOCK, replicas=1, chunk=1,
                         device="cpu", max_rows=1,
                         scripts=[ROOT / "corpus" / "fb1.sk"])
    assert ex.value.code == 1 and len(passes) == 2
    err = _lines(capsys.readouterr().out)[-1]["error"]
    assert ("compat bucket fb1.sk: a timed pass built ['compat']"
            if fault == "a build" else "nondeterministic") in err


def _sleepy_render(monkeypatch, sleeps):
    """The fused stream render replaced by one that sleeps ``sleeps[i]``
    seconds in its i-th timed pass and returns one checksum."""
    import time

    passes = []

    def render(st, chunk, exact=None, warmup_only=False, device="cuda"):
        if not warmup_only:
            time.sleep(sleeps[len(passes)])
            passes.append(1)
        return 1.0

    monkeypatch.setattr(tf, "render_fused_stream_device", render)
    return passes


@pytest.mark.parametrize("case", ["reproduced", "not reproduced",
                                  "other seconds"])
def test_bench_regression_gate(capsys, monkeypatch, tmp_path, case):
    """A baseline ten times faster than the first two passes: the bucket
    is timed three more times and listed as a regression only if the
    best of all five passes still shows the drop; a baseline from a run
    at other seconds gates nothing."""
    audio = 512 / 44100.0                       # one row, one block
    slow = 0.03
    base = {"seconds_each": ONE_BLOCK, "chunk_blocks": 1, "arith": "exact",
            "buckets": [{"voices": 64, "passes": 2, "rows": 1,
                         "feat": None, "x_rt": round(audio / (slow / 10),
                                                     1)}]}
    if case == "other seconds":
        base["seconds_each"] = 10.0
    quick = slow if case == "reproduced" else 0.0
    passes = _sleepy_render(monkeypatch, [slow, slow, quick, quick, quick])
    stress = ROOT / "corpus" / "stress64.sk"
    bk = buckets.make_buckets([stress], ONE_BLOCK, 1, 1)[0]
    base["buckets"][0]["feat"] = bk.feat
    path = tmp_path / "bench_baseline_torch.json"
    path.write_text(json.dumps(base))
    monkeypatch.setattr(bench_torch, "BASELINE", path)
    res = bench_torch.main(seconds=ONE_BLOCK, replicas=1, chunk=1,
                           device="cpu", max_rows=1, scripts=[stress])
    final = _lines(capsys.readouterr().out)[-1]
    (entry,) = res["buckets"]
    if case == "other seconds":
        assert len(passes) == 2 and entry["timed_passes"] == 2
        assert "x_rt_prev" not in entry and not res["regression_list"]
        assert "regressions" not in final
        return
    assert len(passes) == 5 and entry["timed_passes"] == 5
    assert entry["x_rt_prev"] == base["buckets"][0]["x_rt"]
    assert entry["wall_s"] == entry["wall_spread"][0]     # the best pass
    if case == "reproduced":
        assert entry["delta_vs_baseline"] < -0.10
        (reg,) = res["regression_list"]
        assert reg["bucket"] == list(bk.key)
        assert reg["reproduced_over_passes"] == 5
        assert final["regressions"] == 1
    else:
        assert entry["delta_vs_baseline"] > 0
        assert not res["regression_list"] and "regressions" not in final
