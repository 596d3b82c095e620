"""The root tools of the port that had no counterpart before
(``skred_tpu_torch/tools/``): profile_bucket, ablate_feat and
bench_subset on the CPU, one row per configuration; ablate_feat puts the
real ``compute_feat`` back, also when a render raises; the three copies
give the originals' output (corpus_features over ``corpus/``, wav2data
on a seeded WAV, gen_pcm_substitute's generator on the same map rows);
every new tool stops with exit 2 without a card, and imports with JAX
and the JAX package blocked.

The timed tools run at 8 rows and one block (0.0116 s): the plain
versions take ~0.6 s a block of stress64 on one CPU thread, and
ablate_feat renders nine configurations three times each.
"""

import importlib.util
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from skred_tpu_torch.engine import fused
from skred_tpu_torch.tools import (ablate_feat, bench_subset,
                                   corpus_features, fma_probe,
                                   gen_pcm_substitute, mega_ablate,
                                   op_census, profile_bucket, wav2data)
from tests.test_torch_card_parity import ROOT

torch.set_num_threads(1)

ONE_BLOCK = 0.0116


def _original(name, monkeypatch):
    """``tools/<name>.py`` of the JAX package, loaded as a module with an
    empty command line (the originals read it at import)."""
    monkeypatch.setattr(sys, "argv", [name])
    spec = importlib.util.spec_from_file_location(
        f"original_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profile_bucket_rows(capsys):
    assert profile_bucket.main(["64", "2", "8", str(ONE_BLOCK),
                                "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "bucket (64,2): ['stress64.sk', 'noise64.sk']"
    rows = [ln for ln in out if "x_rt=" in ln]
    assert [ln.split(" wall=")[0].strip() for ln in rows] \
        == [label for label, _ in profile_bucket.ROWS]
    assert profile_bucket.profile_bucket(7, 1, 8, ONE_BLOCK, "cpu") is None


def test_ablate_feat_rows_and_restore(capsys):
    real = fused.compute_feat
    walls = ablate_feat.ablate_feat("stress64.sk", 8, ONE_BLOCK, "cpu")
    assert fused.compute_feat is real
    on = [f for f in ablate_feat.FLAGS
          if getattr(_feat("stress64.sk"), f)]
    assert list(walls) == ["baseline"] + [f"-{f}" for f in on] \
        + ["passes=1"]
    out = capsys.readouterr().out
    for f in on:
        assert f"    {f} costs ~" in out


def _feat(script):
    from skred_tpu_torch.parallel.buckets import make_buckets

    (bk,) = make_buckets([ROOT / "corpus" / script], ONE_BLOCK, 4, 2)
    return fused.compute_feat(bk.st)


def test_ablate_feat_restores_on_a_raise(monkeypatch):
    real = fused.compute_feat
    calls = []

    def boom(*a, **kw):
        calls.append(fused.compute_feat)
        raise RuntimeError("render failed")

    monkeypatch.setattr(fused, "render_fused_stream_device", boom)
    with pytest.raises(RuntimeError, match="render failed"):
        ablate_feat.ablate_feat("stress64.sk", 2, ONE_BLOCK, "cpu")
    assert calls and calls[0] is not real
    assert fused.compute_feat is real


def test_bench_subset_rows(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(bench_subset, "RECORD", tmp_path / "subset.json")
    assert bench_subset.main([str(ONE_BLOCK), "1", "--rows", "8",
                              "--chunk", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = [ln for ln in out if ln.startswith('{"voices"')]
    assert len(rows) == 2 and out[-1].startswith("# subset total: ")
    import json

    got = [json.loads(ln) for ln in rows]
    assert [r["scripts"] for r in got] == [["stress64.sk"],
                                           ["noise64.sk"]]
    assert all(r["passes"] == 2 and "flt" in r["feat"].split(",")
               for r in got)
    assert json.loads((tmp_path / "subset.json").read_text())["buckets"]


def test_corpus_features_is_the_originals(monkeypatch, capsys):
    orig = _original("corpus_features", monkeypatch)
    monkeypatch.setattr(orig, "REF", ROOT / "corpus")
    orig.main()
    want = capsys.readouterr().out
    corpus_features.main(dirs=[ROOT / "corpus"])
    assert capsys.readouterr().out == want
    assert len(want.splitlines()) == 6


def test_wav2data_is_the_originals(monkeypatch, tmp_path):
    rng = np.random.default_rng(11)
    pcm = (rng.uniform(-1, 1, (301, 2)) * 30000).astype(np.int16)
    path = tmp_path / "two.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(pcm.tobytes())
    orig = _original("wav2data", monkeypatch)
    for ch in (-1, 0, 1):
        text = wav2data.wav_to_data(path, ch)
        assert text == orig.wav_to_data(path, ch)
        assert text.startswith("D301\n( ")


def test_gen_pcm_substitute_is_the_originals(monkeypatch, tmp_path):
    rng = np.random.default_rng(5)
    offs = np.sort(rng.choice(gen_pcm_substitute.PCM_LENGTH - 5000, 67,
                              replace=False))
    lines = [f"{{{o}, {int(n)}, 0, {int(n) - 1}, /* x */ {int(m)}}},"
             for o, n, m in zip(offs, rng.integers(100, 4000, 67),
                                 rng.integers(30, 90, 67))]
    head = tmp_path / "ref" / "notamy" / "pcm_large.h"
    head.parent.mkdir(parents=True)
    head.write_text("pcm_map[] = {\n" + "\n".join(lines) + "\n};\n")
    orig = _original("gen_pcm_substitute", monkeypatch)
    monkeypatch.setattr(orig, "REFERENCE", tmp_path / "ref")
    want = orig.generate()
    rows = gen_pcm_substitute.parse_pcm_map(head.read_text())
    assert rows == orig.parse_pcm_map(head.read_text())
    got = gen_pcm_substitute.generate(rows)
    assert got.dtype == np.int16 and np.array_equal(got, want)
    golden = sorted(p.name for p in (ROOT / "golden").rglob("*"))
    gen_pcm_substitute.main(["--reference", str(tmp_path / "ref"),
                             "--out", str(tmp_path / "out")])
    saved = np.load(tmp_path / "out" / "pcm_substitute.npz")["pcm"]
    assert np.array_equal(saved, want)
    assert sorted(p.name for p in (ROOT / "golden").rglob("*")) == golden
    with pytest.raises(ValueError, match="expected 67 pcm_map rows"):
        gen_pcm_substitute.parse_pcm_map("\n".join(lines[:3]))


NEW_TOOLS = {mega_ablate: [], op_census: [], fma_probe: [],
             profile_bucket: [], ablate_feat: [], bench_subset: []}


@pytest.mark.parametrize("tool", list(NEW_TOOLS), ids=lambda m: m.__name__)
def test_no_card_is_an_error(monkeypatch, capsys, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as ex:
        tool.main(NEW_TOOLS[tool])
    assert ex.value.code == 2
    cap = capsys.readouterr()
    assert "torch.cuda.is_available() is false" in cap.err + cap.out


@pytest.mark.parametrize("module", [
    f"skred_tpu_torch.tools.{m}" for m in (
        "mega_ablate", "op_census", "fma_probe", "profile_bucket",
        "ablate_feat", "bench_subset", "corpus_features", "wav2data",
        "gen_pcm_substitute")])
def test_imports_without_jax(module):
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['skred_tpu'] = None; "
            f"import {module}")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
