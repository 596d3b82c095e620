"""The block-loop engines' download: their audio leaves the card in
chunks while the block loop runs and lands in one array of the caller's
own, ``[B, T, 2]``.

``run`` is the loop both ``engine/fused.py`` (``render_fused``) and
``engine/cyclic.py`` (``render_cyclic``) drive: it builds the download
for a split of the batch's rows over devices (``parallel.batch.
shard_rows``), lets the caller set the shards up, hands each step's
blocks to the download, and returns the result.

Spans (``spans.py``), under the caller's ``prefix``: ``<prefix>.
block_loop`` (``n`` = blocks) around the loop, then ``<prefix>.download``
and inside it ``<prefix>.download_tail`` (``n`` = blocks not yet in the
result when the loop closed).
"""

from __future__ import annotations

import mmap
import queue
import threading

import numpy as np
import torch

from skred_tpu_torch import spans

F32 = torch.float32

CHUNK_BYTES = 64 << 20      # a chunk of the download: 16 blocks at 1024 rows
STAGING_SLOTS = 3           # pinned host buffers a card shard cycles through


def _chunks(num_blocks: int, block: int, rows: int) -> list:
    """The download's chunks of a ``rows``-row shard, ``(k0, k1)`` block
    ranges in order: as many float32 stereo blocks as fit in
    ``CHUNK_BYTES``, at least one; the last chunk takes what is left."""
    c = max(1, CHUNK_BYTES // (block * rows * 2 * 4))
    return [(k0, min(k0 + c, num_blocks)) for k0 in range(0, num_blocks, c)]


class _Shard:
    """One shard's side of the download: its rows of the result, its
    chunks, the current chunk's blocks, and on a card its side stream and
    its ring of pinned staging slots (free ones in ``free``)."""

    def __init__(self, dev, rows, num_blocks, block):
        self.r0, self.r1 = int(rows[0]), int(rows[-1]) + 1
        self.chunks = _chunks(num_blocks, block, len(rows))
        self.outs = []
        self.written = 0                 # blocks in the result
        self.side = self.free = None
        if dev.type == "cuda":
            self.side = torch.cuda.Stream(device=dev)
            k0, k1 = self.chunks[0]
            size = len(rows) * (k1 - k0) * block * 2
            self.free = queue.SimpleQueue()
            for _ in range(min(STAGING_SLOTS, len(self.chunks))):
                self.free.put(torch.empty(size, dtype=F32, pin_memory=True))


class _Download:
    """The copy of the audio into the caller's array ``out`` ``[B, T,
    2]``, chunk by chunk while the block loop runs.

    ``add`` takes each shard's next block.  When a shard's chunk is
    full, one permuting copy on the device lays it out rows first
    (``[B_s, c*N, 2]``).  On the CPU that is written into ``out`` at
    once.  On a card a side stream waits for the chunk, copies it into a
    free pinned staging slot and records an event; one worker thread
    waits for each event in turn (the wait releases the interpreter
    lock), copies the slot into the shard's rows of ``out`` and frees the
    slot.  Before the first chunk the worker touches every page of the
    card shards' rows: every chunk writes into every row, so the first
    copy would otherwise fault them all in while the loop waits for its
    slot.  ``finish`` joins the worker and returns ``out``; ``close``
    joins it whatever happened."""

    def __init__(self, shards, num_blocks, block):
        rows = sum(len(r) for _, r in shards)
        self.out = np.empty((rows, num_blocks * block, 2), np.float32)
        self.num_blocks, self.block = num_blocks, block
        self.shards = [_Shard(dev, r, num_blocks, block) for dev, r in shards]
        self.error = None
        self.work = self.thread = None
        if any(s.side is not None for s in self.shards):
            self.work = queue.SimpleQueue()
            self.thread = threading.Thread(target=self._drain, daemon=True,
                                           name="fused.download")
            self.thread.start()

    def add(self, outs):
        """One block of each shard, ``[N, B_s, 2]`` each, in shard order."""
        for s, o in zip(self.shards, outs):
            s.outs.append(o)
            k0, k1 = s.chunks[0]
            if len(s.outs) == k1 - k0:
                del s.chunks[0]
                self._flush(s, k0 * self.block, k1 * self.block)

    def _flush(self, s: _Shard, t0, t1):
        chunk = torch.stack(s.outs).permute(2, 0, 1, 3) \
            .reshape(s.r1 - s.r0, t1 - t0, 2)
        s.outs = []
        if s.side is None:
            self.out[s.r0:s.r1, t0:t1] = chunk.numpy()
            s.written += (t1 - t0) // self.block
            return
        slot = s.free.get()
        s.side.wait_stream(torch.cuda.current_stream(chunk.device))
        with torch.cuda.stream(s.side):
            staged = slot[:chunk.numel()].view(chunk.shape)
            staged.copy_(chunk, non_blocking=True)
            done = torch.cuda.Event(blocking=True)
            done.record(s.side)
        chunk.record_stream(s.side)      # alive until the copy has run
        self.work.put((s, slot, staged, done, t0, t1))

    def _drain(self):
        try:
            for s in self.shards:
                if s.side is not None:
                    self.out[s.r0:s.r1].reshape(-1)[::mmap.PAGESIZE // 4] = 0
        except Exception as e:           # raised by finish, in the caller
            self.error = e
        while (item := self.work.get()) is not None:
            s, slot, staged, done, t0, t1 = item
            try:
                if self.error is None:
                    done.synchronize()
                    self.out[s.r0:s.r1, t0:t1] = staged.numpy()
                    s.written += (t1 - t0) // self.block
            except Exception as e:       # raised by finish, in the caller
                self.error = e
            s.free.put(slot)

    def pending(self) -> int:
        """Blocks not yet in ``out``, of the shard furthest behind."""
        return self.num_blocks - min(s.written for s in self.shards)

    def close(self):
        if self.thread is not None:
            self.work.put(None)
            self.thread.join()
            self.thread = None

    def finish(self) -> np.ndarray:
        self.close()
        if self.error is not None:
            raise self.error
        return self.out


def run(prefix: str, split, num_blocks: int, block: int, start):
    """Render through a download: ``split`` is the shards' ``(device,
    rows)`` pairs in row order; ``start()`` sets the shards up and
    returns an iterable over the blocks, each item one ``[N, B_s, 2]``
    block of every shard in ``split``'s order.  The download is built
    before ``start`` runs, so that its worker touches the result's pages
    during the set-up.  Returns the result, ``[B, num_blocks * block,
    2]``."""
    down = _Download(split, num_blocks, block)
    try:
        steps = start()
        with spans.span(f"{prefix}.block_loop", num_blocks), \
                torch.no_grad():
            for outs in steps:
                down.add(outs)
        with spans.span(f"{prefix}.download"):
            with spans.span(f"{prefix}.download_tail", down.pending()):
                return down.finish()
    finally:
        down.close()
