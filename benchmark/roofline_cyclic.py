"""The yardstick of the cyclic kernel's roofline share: the least time a
card could take for a block of a workload whose modulation graph has a
cycle, from the workload alone.

``roofline.py``'s count (its ``OPS`` per voice and sample, its bytes,
its ``PEAKS``) over the plain reference for feedback loops
(``reference/synth_cyclic.py``), whose segment takes a cyclic graph
where ``synth.py``'s refuses it; plus the CZ warp's modulator read,
which ``roofline.OPS`` leaves out: ``read * depth`` and its add to the
distortion, 2 operations a sample of each voice that reads a CZ
modulator.  ``roofline.least_seconds`` turns the count into seconds.
"""

from __future__ import annotations

import numpy as np

from benchmark import roofline

CZ_MOD = 2          # read * depth; distortion + that


def workload(tls, rows: int) -> dict:
    """Operations and bytes a block of a batch of ``rows`` rows like the
    compiled scripts ``tls`` (the reference's compile of the rows it
    stands for; each counts rows/len(tls) rows), as ``roofline.workload``
    counts them.  Single-segment scripts only."""
    from benchmark.reference import synth, synth_cyclic

    tl0 = tls[0]
    if any(tl.num_segments != 1 for tl in tls):
        raise ValueError("roofline: a script with more than one segment")
    segs = np.zeros(len(tls), np.int64)
    offs = [np.asarray(tl.table_offsets, np.int64) for tl in tls]
    seg = synth_cyclic._Segment(tls, segs, offs, synth.rounder("float32"))
    # a one-shot that is finished from the start never sounds
    fin = np.stack([np.asarray(tl.ops["set_finished"][0])
                    & (np.asarray(tl.ops["finished"][0]) != 0) for tl in tls])
    seg.amp_nz = seg.amp_nz & ~fin
    cz_mod = np.where(seg.cz_reads & seg.amp_nz, CZ_MOD, 0)
    per_row = np.mean([roofline.voice_ops(seg, r).sum() + cz_mod[r].sum()
                       for r in range(len(tls))])
    n = tl0.block
    ops = rows * n * float(per_row)
    params = sum(np.asarray(v).nbytes for v in tl0.params.values())
    tables = int(np.asarray(tl0.table_buffer).nbytes)
    noise = n * 4 if bool(seg.is_noise.any()) else 0
    read_once = rows * params + tables
    nbytes = read_once / tl0.num_blocks + noise + rows * n * 2 * 4
    return {"ops": ops, "bytes": nbytes}
