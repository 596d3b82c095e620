"""``render_batch``'s cyclic groups, ``render_cyclic``'s chunked
download and its split over a mesh, on the CPU.

Scripts with a cyclic modulation graph that share a
``cyclic_group_key`` (packed voice count, feature set, table bindings)
render as one batch through ``render_cyclic``; each row equals its
script rendered alone, bit for bit.  ``render_cyclic`` hands its blocks
to ``engine/download.py`` and equals ``render_cyclic_stream``'s chunks;
over a mesh its rows split as ``render_fused``'s do, every shard by the
whole batch's schedule, and the audio is the unsplit render's.
"""

import ast

import numpy as np
import pytest
import torch

from skred_tpu_torch import spans
from skred_tpu_torch.assets import WaveBank
from skred_tpu_torch.engine import cyclic, download, fused
from skred_tpu_torch.engine.kernels import cyclic as ck
from skred_tpu_torch.host.timeline import compile_script
from skred_tpu_torch.parallel import batch

torch.set_num_threads(1)

ONE_BLOCK = 512 / 44100
# corpus/fb3.sk's patch: a CZ self edge on v0, v1 reading v0 by FM
FB3 = ["v0 w1 f{f} a90 c1,0.3 C0,0.6", "v1 w2 f220 a40 F0,0.2"]


def _write(tmp_path, name, lines):
    p = tmp_path / f"{name}.sk"
    p.write_text("\n".join(lines) + "\n")
    return p


def _alone(path, seconds):
    tl = compile_script(path.read_text().splitlines(), seconds,
                        bank=WaveBank(), script_dir=path.parent)
    st = batch.pack_stacked(batch.stack_timelines([tl]), cyclic=True)
    return cyclic.render_cyclic(st, device="cpu")[0]


def _recorded(fn):
    last = max((r.id for r in spans.records()), default=0)
    out = fn()
    return out, [r for r in spans.records() if r.id > last]


def test_cyclic_scripts_render_in_groups(tmp_path):
    """Three variants of one patch make one group; the same patch on
    another wave table makes a second: two batches, each row its
    script's own render bit for bit."""
    paths = [_write(tmp_path, f"v{i}", [ln.format(f=f) for ln in FB3])
             for i, f in enumerate((110, 146.5, 97.25))]
    other = [FB3[0].format(f=130), FB3[1].replace("w2", "w3")]
    paths.insert(2, _write(tmp_path, "other", other))
    bank = WaveBank()
    keys = [batch.cyclic_group_key(compile_script(
        p.read_text().splitlines(), ONE_BLOCK, bank=bank)) for p in paths]
    assert keys[0] == keys[1] == keys[3] != keys[2]
    out, recs = _recorded(
        lambda: batch.render_batch(paths, ONE_BLOCK, device="cpu"))
    groups = [r.n for r in recs if r.name == "batch.cyclic_group"]
    assert sorted(groups) == [1, 3]
    assert len([r for r in recs if r.name == "cyclic.render"]) == 2
    for row, p in enumerate(paths):
        assert np.abs(out[row]).max() > 0.01, p.name
        assert np.array_equal(out[row], _alone(p, ONE_BLOCK)), p.name
    assert not np.array_equal(out[0], out[1])


def test_groups_key_the_tables_by_lane(tmp_path, capsys):
    """Two scripts bind the same table to each voice and pack two voices
    each, but not the same two (v1 sounds in one, v2 in the other): lane
    1 binds another table in each, so the gate refuses them together.
    They take two groups, neither falls back to the compat engine, and
    each row is its script's own render bit for bit."""
    lines = lambda a1, a2: [FB3[0].format(f=110),
                            f"v1 w2 f220 a{a1} F0,0.2",
                            f"v2 w3 f330 a{a2} F0,0.2"]
    paths = [_write(tmp_path, "v1", lines(40, 0)),
             _write(tmp_path, "v2", lines(0, 40))]
    bank = WaveBank()
    tls = [compile_script(p.read_text().splitlines(), ONE_BLOCK, bank=bank)
           for p in paths]
    assert batch._table_sig(tls[0]) == batch._table_sig(tls[1])
    st = batch.pack_stacked(batch.stack_timelines(tls), cyclic=True)
    assert st.params["amp"].shape[-1] == 2
    assert cyclic.cyclic_gate(st) is not None
    keys = [batch.cyclic_group_key(tl) for tl in tls]
    assert keys[0][:2] == keys[1][:2] and keys[0] != keys[1]
    out, recs = _recorded(
        lambda: batch.render_batch(paths, ONE_BLOCK, device="cpu"))
    assert "WARNING" not in capsys.readouterr().err
    assert [r.n for r in recs if r.name == "batch.cyclic_group"] == [1, 1]
    for row, p in enumerate(paths):
        assert np.abs(out[row]).max() > 0.01, p.name
        assert np.array_equal(out[row], _alone(p, ONE_BLOCK)), p.name


def test_render_cyclic_downloads_in_chunks(monkeypatch):
    """One block a chunk: the result equals render_cyclic_stream's chunks
    joined, bit for bit, and every block is in it when the loop closes
    (on the CPU a chunk is written at once)."""
    bank = WaveBank()
    tls = [compile_script([ln.format(f=f) for ln in FB3], 3 * ONE_BLOCK,
                          bank=bank) for f in (110, 150)]
    st = batch.pack_stacked(batch.stack_timelines(tls), cyclic=True)
    want = np.concatenate(list(cyclic.render_cyclic_stream(
        st, chunk_blocks=1, device="cpu")), axis=1)
    monkeypatch.setattr(download, "CHUNK_BYTES",
                        st.block * st.batch * 2 * 4)
    got, recs = _recorded(lambda: cyclic.render_cyclic(st, device="cpu"))
    assert got.shape == (2, 3 * st.block, 2)
    assert np.array_equal(got, want)
    tail = [r for r in recs if r.name == "cyclic.download_tail"]
    assert [r.n for r in tail] == [0]


def test_render_cyclic_records_its_tree():
    bank = WaveBank()
    tls = [compile_script([ln.format(f=110) for ln in FB3], 2 * ONE_BLOCK,
                          bank=bank)]
    st = batch.pack_stacked(batch.stack_timelines(tls), cyclic=True)
    out, recs = _recorded(lambda: cyclic.render_cyclic(st, device="cpu"))
    top = [r for r in recs if r.parent is None]
    assert [r.name for r in top] == ["cyclic.render"]
    kids = lambda p: [r for r in recs if r.parent == p.id]
    one = lambda name: next(r for r in recs if r.name == name)
    assert [r.name for r in kids(top[0])] == [
        "cyclic.prepare", "cyclic.block_loop", "cyclic.download"]
    loop = one("cyclic.block_loop")
    assert loop.n == st.num_blocks == 2
    blocks = kids(loop)
    assert [b.name for b in blocks] == ["cyclic.block"] * 2
    for b in blocks:
        (k,) = kids(b)
        assert k.name == "kernel.cyclic" and k.n == st.params["amp"].shape[-1]
    (tail,) = kids(one("cyclic.download"))
    assert tail.name == "cyclic.download_tail"
    assert 0 <= tail.n <= st.num_blocks
    assert out.shape == (1, 2 * st.block, 2)
    for r in recs:
        assert r.dur_ns >= 0 and not r.profiled
        if r.parent is not None:
            p = next(q for q in recs if q.id == r.parent)
            assert p.start_ns <= r.start_ns
            assert r.start_ns + r.dur_ns <= p.start_ns + p.dur_ns


@pytest.mark.parametrize("entry", ["stream", "mesh"])
def test_other_entry_points_record_blocks(entry):
    """render_cyclic_stream and render_cyclic over a one-device mesh
    keep their outputs; their blocks are cyclic.blocks under
    cyclic.prepare's set-up."""
    tls = [compile_script([ln.format(f=110) for ln in FB3], ONE_BLOCK,
                          bank=WaveBank())]
    st = batch.pack_stacked(batch.stack_timelines(tls), cyclic=True)
    want = cyclic.render_cyclic(st, device="cpu")
    if entry == "stream":
        fn = lambda: np.concatenate(
            list(cyclic.render_cyclic_stream(st, device="cpu")), axis=1)
    else:
        fn = lambda: cyclic.render_cyclic(st, mesh=["cpu"], device="cpu")
    got, recs = _recorded(fn)
    assert np.array_equal(got, want)
    names = [r.name for r in recs]
    assert names.count("cyclic.prepare") == 1
    assert names.count("cyclic.block") == st.num_blocks
    assert names.count("kernel.cyclic") == st.num_blocks


def _fb3_batch(freqs, blocks):
    bank = WaveBank()
    tls = [compile_script([ln.format(f=f) for ln in FB3],
                          blocks * ONE_BLOCK, bank=bank) for f in freqs]
    return batch.pack_stacked(batch.stack_timelines(tls), cyclic=True)


@pytest.mark.parametrize("devices", [2, 3])
def test_render_cyclic_over_a_mesh_is_the_unsplit_render(devices):
    """Five rows over two or three CPU entries (shards of 3 + 2 and 2 +
    2 + 1 rows): the audio is the render without a mesh, bit for bit;
    one set-up, every shard's blocks in the loop."""
    st = _fb3_batch((110, 146.5, 97.25, 130, 180), 2)
    want = cyclic.render_cyclic(st, device="cpu")
    got, recs = _recorded(lambda: cyclic.render_cyclic(
        st, mesh=["cpu"] * devices, device="cpu"))
    assert np.array_equal(got, want)
    assert len({out.tobytes() for out in got}) == st.batch
    names = [r.name for r in recs]
    assert names.count("cyclic.prepare") == names.count("cyclic.schedule") \
        == 1
    assert names.count("cyclic.block") == st.num_blocks * devices
    loop = next(r for r in recs if r.name == "cyclic.block_loop")
    assert loop.n == st.num_blocks


def test_every_shard_carries_the_whole_batch_schedule():
    """Ten voices (above the keyed variant's cap, so the general kernel
    and its waves): in row 0 each voice reads the one below it in the
    same frame (ten waves), in row 1 none does (one wave).  Split over
    two entries, each shard carries the whole batch's ten waves, though
    row 1 alone would schedule one."""
    k = 10
    assert k > ck.FIXED_K_MAX
    chain = ["v0 w1 f110 a30 c1,0.3 C0,0.6"] + [
        f"v{i} w2 f{110 + 20 * i} a20 F{i - 1},0.2" for i in range(1, k)]
    flat = [ln.rsplit(" F", 1)[0] for ln in chain]
    bank = WaveBank()
    tls = [compile_script(lines, ONE_BLOCK, bank=bank)
           for lines in (chain, flat)]
    st = batch.pack_stacked(batch.stack_timelines(tls), cyclic=True)
    assert st.params["amp"].shape[-1] == k
    feat = fused.compute_feat(st)
    whole = cyclic._schedule(st, feat, k, "cpu")
    alone = cyclic._schedule(batch.take_rows(st, [1]), feat, k, "cpu")
    assert whole[1] == k and alone[1] == 1
    _, shards = cyclic._prep_shards(st, True,
                                    batch.shard_rows(st.batch, ["cpu"] * 2))
    assert [r.B for r, _ in shards] == [1, 1]
    for r, _ in shards:
        assert r.schedule[1] == whole[1]
        assert torch.equal(r.schedule[0], whole[0])


def test_render_batch_splits_cyclic_groups_over_a_mesh(tmp_path):
    """Two cyclic groups (three rows and one) on a two-entry CPU mesh,
    each padded to it and split by rows: the audio is render_batch's
    without a mesh, bit for bit."""
    paths = [_write(tmp_path, f"v{i}", [ln.format(f=f) for ln in FB3])
             for i, f in enumerate((110, 146.5, 97.25))]
    paths.append(_write(tmp_path, "other",
                        [FB3[0].format(f=130), FB3[1].replace("w2", "w3")]))
    want = batch.render_batch(paths, ONE_BLOCK, device="cpu")
    got, recs = _recorded(lambda: batch.render_batch(
        paths, ONE_BLOCK, mesh=["cpu"] * 2, device="cpu"))
    assert np.array_equal(got, want)
    assert sorted(r.n for r in recs if r.name == "batch.cyclic_group") \
        == [1, 3]
    renders = [r for r in recs if r.name == "cyclic.render"]
    assert len(renders) == 2
    blocks = [r for r in recs if r.name == "cyclic.block"]
    assert len(blocks) == 2 * 2 * got.shape[1] // 512


def test_cyclic_takes_the_download_from_its_own_module():
    """The download lives in ``engine/download.py``: neither engine
    defines it, and cyclic.py imports nothing private of it from
    fused."""
    assert hasattr(download, "_Download")
    assert not hasattr(fused, "_Download") and not hasattr(cyclic,
                                                           "_Download")
    tree = ast.parse(open(cyclic.__file__).read())
    from_fused = {a.name for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom)
                  and node.module == "skred_tpu_torch.engine.fused"
                  for a in node.names}
    assert "_Download" not in from_fused
    assert not {"_chunks", "_Shard", "CHUNK_BYTES"} & from_fused
