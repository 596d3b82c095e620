"""Several devices on the CPU: a batch's rows split over a mesh of
devices (``["cpu"] * 8`` stands for the JAX package's eight virtual CPU
devices, tests/conftest.py) must change nothing about the audio, bit for
bit: scripts are independent, and every shard renders by the whole
batch's pack and plan.  Mirrors tests/test_mesh.py on in-repo scripts.
"""

import pathlib

import numpy as np
import pytest
import torch

from skred_tpu_torch.assets import WaveBank
from skred_tpu_torch.engine import fused as tf
from skred_tpu_torch.engine import render as tr
from skred_tpu_torch.host.timeline import compile_script
from skred_tpu_torch.parallel import batch as tb

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CORPUS = ROOT / "corpus"
NOISE64 = ROOT / "skred_tpu_torch" / "scripts" / "noise64.sk"
CPU8 = ["cpu"] * 8

# the JAX package's dry-run script, and a pan-modulated one
FM_PAIR = ["v0 w0 f440 a4 F1,10", "v1 w0 f1 a50 m1"]
PAN_MOD = ["v0 w2 f2 a2", "v1 w0 f330 a3 p-0.4",
           "v2 w0 f220 a3 p0.3 P0 Q0.9", "v3 w5 f110 a2 x1"]


def _sources():
    return [FM_PAIR, (CORPUS / "stress64.sk").read_text().splitlines(),
            NOISE64.read_text().splitlines(), PAN_MOD]


@pytest.fixture(scope="module")
def small_batch():
    """Four scripts of other voice counts, tiers and features, twice:
    a shard of one row has another plan than the whole batch's."""
    bank = WaveBank()
    tls = [compile_script(lines, 0.03, bank=bank, script_dir=CORPUS,
                          block=128) for lines in _sources()]
    return tb.stack_timelines(tls * 2)


@pytest.fixture(scope="module")
def unsharded(small_batch):
    return tf.render_fused(small_batch, device="cpu")


def test_make_mesh(monkeypatch):
    assert tb.make_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    assert tb.make_mesh(device="cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tb.make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for d in tb.make_mesh(3)] == ["cuda:0", "cuda:1",
                                                 "cuda:0"]
    assert [str(d) for d in tb.make_mesh()] == ["cuda:0", "cuda:1"]


def test_shard_rows_and_take_rows(small_batch):
    shards = tb.shard_rows(5, ["cpu", "cpu", "cpu"])
    assert [list(r) for _, r in shards] == [[0, 1], [2, 3], [4]]
    assert len(tb.shard_rows(2, CPU8)) == 2
    assert tb.take_rows(small_batch, range(8)) is small_batch
    part = tb.take_rows(small_batch, [2, 3])
    assert part.batch == 2 and part.table_buffer is small_batch.table_buffer
    assert np.array_equal(part.params["amp"], small_batch.params["amp"][2:4])
    assert np.array_equal(part.seg_of_block, small_batch.seg_of_block[2:4])
    with pytest.raises(ValueError, match="empty mesh"):
        tb.shard_rows(2, [])


def test_fused_mesh_matches_unsharded(small_batch, unsharded):
    got = tf.render_fused(small_batch, mesh=tb.make_mesh(8, device="cpu"))
    assert np.abs(unsharded).max() > 0.01
    assert np.array_equal(got, unsharded), "the split changed the audio"


@pytest.mark.parametrize("n", [4, 3])
def test_mesh_subset(small_batch, unsharded, n):
    """Two rows a device, and an uneven split (3, 3, 2)."""
    got = tf.render_fused(small_batch, mesh=["cpu"] * n)
    assert np.array_equal(got, unsharded)


def test_fused_capture_under_a_mesh(small_batch):
    st = tb.take_rows(tb.pack_stacked(small_batch), [0, 3, 4])
    want_out, want_cap = tf.render_fused(st, capture=True, device="cpu")
    out, cap = tf.render_fused(st, mesh=["cpu"] * 2, capture=True)
    assert np.array_equal(out, want_out) and np.array_equal(cap, want_cap)


def test_compat_mesh_matches_unsharded():
    """Three rows of other pass counts over eight entries (three shards)
    and over two; with capture too."""
    bank = WaveBank()
    tls = [compile_script(lines, 0.006, bank=bank, script_dir=CORPUS,
                          block=128) for lines in _sources()[1:]]
    st = tb.stack_timelines(tls + [tls[0]])
    want = tb.render_stacked(st, device="cpu")
    assert np.abs(want).max() > 0.01
    assert np.array_equal(tb.render_stacked(st, mesh=CPU8), want)
    out, cap = tr.render_rows(st, capture=True, device="cpu")
    got_out, got_cap = tr.render_rows(st, capture=True, mesh=["cpu"] * 2)
    assert np.array_equal(got_out, out) and np.array_equal(got_cap, cap)


@pytest.mark.parametrize("engine", ["auto", "compat"])
def test_render_batch_mesh_odd_sizes(tmp_path, engine):
    """Three scripts over eight devices: each fused bucket and the compat
    group pad to a multiple of the device count, the cyclic script takes
    a device of its own; every row is the render without a mesh."""
    inline = tmp_path / "pan.sk"
    inline.write_text("\n".join(PAN_MOD) + "\n")
    ps = [CORPUS / "fb1.sk", CORPUS / "stress64.sk", inline]
    want = tb.render_batch(ps, 0.0116, engine=engine, device="cpu")
    got = tb.render_batch(ps, 0.0116, mesh=CPU8, engine=engine)
    assert got.shape == want.shape == (3, 512, 2)
    assert all(np.abs(w).max() > 0.01 for w in want)
    assert np.array_equal(got, want)


def test_weak_scaling_is_flat():
    """Four rows a device over meshes of 1-8 devices: one shard's f32
    operations a block stay as they are."""
    bank = WaveBank()
    tls = [compile_script(lines, 0.03, bank=bank, script_dir=CORPUS,
                          block=128) for lines in _sources()]
    curve = [tb.fused_cost_per_device(tb.stack_timelines(tls * d),
                                      ["cpu"] * d) for d in (1, 2, 4, 8)]
    assert curve[0] > 0
    rel = [c / curve[0] for c in curve]
    assert max(rel) <= 1.25, rel
    assert rel == [1.0] * 4
