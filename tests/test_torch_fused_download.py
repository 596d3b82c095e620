"""``render_fused``'s download: the audio copied into the caller's array
chunk by chunk while the block loop runs (``engine/fused.py``'s
``_Download``).

On the CPU: the result equals ``render_fused_device``'s blocks laid out
``[B, T, 2]`` bit for bit, whole and over a mesh of uneven shards, with
chunks that do not divide the render; the chunk rule covers every block
once, in order; two calls share no memory; an error in the loop
surfaces and leaves no thread behind; the download's counter has its
reader.  On the card (skipped without one; no JAX is imported, so it
runs on a machine with the port's dependencies alone):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_fused_download.py

stress64 and noise64 at 64 rows through the side stream, the pinned
staging ring and the worker thread, whole and on a ``["cuda:0",
"cuda:0"]`` mesh, against ``render_fused_device``.
"""

import collections
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from skred_tpu_torch import spans
from skred_tpu_torch.assets import WaveBank
from skred_tpu_torch.engine import fused
from skred_tpu_torch.host import timeline
from skred_tpu_torch.parallel import batch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
STRESS64 = ROOT / "corpus" / "stress64.sk"
NOISE64 = ROOT / "skred_tpu_torch" / "scripts" / "noise64.sk"
BLOCK = 512


def _batch(path, rows, blocks):
    """``rows`` variants of a script (its first voice's amplitude
    stepped), ``blocks`` blocks long, packed."""
    lines = path.read_text().splitlines()
    bank = WaveBank()
    tls = [timeline.compile_script(lines + [f"v0 a{1 + i / 4}"],
                                   blocks * BLOCK / 44100, bank=bank,
                                   script_dir=path.parent)
           for i in range(min(rows, 4))]
    st = batch.pack_stacked(batch.stack_timelines(
        [tls[i % len(tls)] for i in range(rows)]))
    assert st.num_blocks == blocks
    return st


def _laid_out(blocks: torch.Tensor) -> np.ndarray:
    """``render_fused_device``'s ``[num_blocks, B, N, 2]`` as ``[B, T,
    2]``."""
    nb, b, n, _ = blocks.shape
    return blocks.cpu().permute(1, 0, 2, 3).reshape(b, nb * n, 2).numpy()


def _same_bits(a, b):
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert np.array_equal(a.view(np.int32), b.view(np.int32))


# ---- on the CPU ----

@pytest.fixture(scope="module")
def small():
    """stress64 at 5 rows and 5 blocks, and its render kept on the
    device."""
    torch.set_num_threads(1)
    st = _batch(STRESS64, 5, 5)
    return st, _laid_out(fused.render_fused_device(st, device="cpu"))


# (mesh, blocks a chunk holds at the first shard's rows)
@pytest.mark.parametrize("mesh,chunk", [(None, 2), (["cpu"] * 3, 3)],
                         ids=["whole", "mesh3"])
def test_result_is_the_device_render_bit_for_bit(small, monkeypatch, mesh,
                                                 chunk):
    st, want = small
    rows = len(np.array_split(np.arange(st.batch), len(mesh or [0]))[0])
    monkeypatch.setattr(fused, "CHUNK_BYTES", chunk * BLOCK * rows * 2 * 4)
    chunks = fused._chunks(st.num_blocks, BLOCK, rows)
    assert chunks[0] == (0, chunk) and st.num_blocks % chunk
    got = fused.render_fused(st, mesh=mesh, device="cpu")
    _same_bits(got, want)
    assert got.flags.c_contiguous and got.flags.owndata


@pytest.mark.parametrize("rows,blocks,chunk", [
    (1, 345, 345), (1024, 345, 16), (1024, 1, 1), (64, 345, 256),
    (1, 1, 1)])
def test_chunks_cover_every_block_once_in_order(rows, blocks, chunk):
    got = fused._chunks(blocks, BLOCK, rows)
    assert [k for k0, k1 in got for k in range(k0, k1)] == list(range(blocks))
    assert max(k1 - k0 for k0, k1 in got) == chunk
    assert all(k1 - k0 == chunk for k0, k1 in got[:-1])


def test_two_calls_share_no_memory(small):
    st, _ = small
    a = fused.render_fused(st, device="cpu")
    b = fused.render_fused(st, device="cpu")
    assert not np.shares_memory(a, b)
    _same_bits(a, b)


def test_error_in_the_loop_surfaces_and_leaves_no_thread(small,
                                                         monkeypatch):
    st, _ = small
    step = fused._block_step

    def failing(r, carry, k_glob, caps=None):
        if k_glob == 3:
            raise RuntimeError("block 3 failed")
        return step(r, carry, k_glob, caps=caps)

    monkeypatch.setattr(fused, "CHUNK_BYTES", 2 * BLOCK * st.batch * 2 * 4)
    monkeypatch.setattr(fused, "_block_step", failing)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="block 3 failed"):
        fused.render_fused(st, device="cpu")
    assert threading.active_count() == before


def _record(name, n, profiled=False):
    r = spans.span(name, n)
    r.id, r.parent, r.start_ns, r.dur_ns, r.profiled = 1, None, 0, 1, \
        profiled
    return r


def test_exposed_blocks_reader_takes_the_unprofiled_median(monkeypatch):
    from benchmark import harness

    ring = collections.deque(maxlen=spans.RING)
    monkeypatch.setattr(spans, "_ring", ring)
    read = harness.reader("download_exposed_blocks.sweep")
    assert read(None) is None
    ring.extend([_record("fused.download_tail", 300, profiled=True),
                 _record("fused.download", 7)])
    assert read(None) is None
    ring.extend([_record("fused.download_tail", n) for n in (9, 25, 16)])
    assert read(None) == 16


# ---- on the card ----

@pytest.fixture(scope="module")
def card_batches():
    """stress64 and noise64 at 64 rows, 345 blocks (4 s): chunks of 256
    and 89 blocks, every kernel key built."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the download's side stream and "
                    "pinned staging exist only there")
    return {p.stem: _batch(p, 64, 345) for p in (STRESS64, NOISE64)}


@pytest.mark.cuda
@pytest.mark.parametrize("script", ["stress64", "noise64"])
@pytest.mark.parametrize("mesh", [None, ["cuda:0", "cuda:0"]],
                         ids=["whole", "mesh2"])
@pytest.mark.parametrize("chunk_bytes", [None, 16 * BLOCK * 64 * 2 * 4],
                         ids=["chunk256", "chunk16"])
def test_card_result_is_the_device_render_bit_for_bit(
        card_batches, monkeypatch, script, mesh, chunk_bytes):
    """``chunk16``: 22 chunks of 16 blocks at 64 rows, so the three
    staging slots are each reused."""
    if chunk_bytes is not None:
        monkeypatch.setattr(fused, "CHUNK_BYTES", chunk_bytes)
    st = card_batches[script]
    before = threading.active_count()
    got = fused.render_fused(st, mesh=mesh)
    want = _laid_out(fused.render_fused_device(st))
    _same_bits(got, want)
    assert threading.active_count() == before
    again = fused.render_fused(st, mesh=mesh)
    assert not np.shares_memory(got, again)
    _same_bits(again, want)


@pytest.mark.cuda
def test_card_error_in_the_loop_joins_the_worker(card_batches, monkeypatch):
    st = card_batches["stress64"]
    step = fused._block_step

    def failing(r, carry, k_glob, caps=None):
        if k_glob == 300:
            raise RuntimeError("block 300 failed")
        return step(r, carry, k_glob, caps=caps)

    monkeypatch.setattr(fused, "CHUNK_BYTES", 16 * BLOCK * 64 * 2 * 4)
    monkeypatch.setattr(fused, "_block_step", failing)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="block 300 failed"):
        fused.render_fused(st)
    assert threading.active_count() == before
