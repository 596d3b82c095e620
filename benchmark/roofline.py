"""The yardstick of the kernels' roofline share: the least time a card
could take for a workload's blocks, from the workload alone.

**Operations** are counted from the plain reference's arithmetic
(``reference/synth.py``), per voice and sample, for the stages the
voice uses: adds, multiplies and divides count one, a fused
multiply-add two; comparisons, selects, conversions, integer counters
and table reads count none.  Where a stage's arithmetic takes one of
two forms (the CZ curves, the envelope's stages), the shorter counts,
so that the count never exceeds the work.  An active voice of a row
costs its stages' sum every sample; a voice that is inactive (amplitude
0, or a finished one-shot) costs none.

**Bytes**: every parameter of every row and voice and every bound table
line read once a render, the noise stream's samples read once, and the
stereo float32 audio written once; a block takes its share of the
render's reads.

**Peaks**: NVIDIA's published dense rates of the H100 SXM (the card of
``NVIDIA H100 80GB HBM3``): 67 TFLOP/s in float32 outside the tensor
cores and 3.35 TB/s of HBM, at the card's full 700 W.  An unknown card
has no peaks, and its share is not reported.
"""

from __future__ import annotations

import numpy as np

# card name -> (f32 FLOP/s, bytes/s)
PEAKS = {"NVIDIA H100 80GB HBM3": (67e12, 3.35e12)}

# f32 operations a voice-sample, per stage (reference/synth.py)
OPS = {
    "phase": 1,         # ph = phase + inc
    "fm": 3,            # g = read*depth; inc = fma(mis, g, pinc)
    "cz": 3,            # phase/size; the curve (its shorter form: 1 op,
                        # or the power's fma: 2, the fold: 2); *size
    "quant": 3,         # fma(x, levels, 0.5); *1/levels
    "biquad": 9,        # b1*x1 and four fmas
    "env": 2,           # its sustain stage: env*velocity; final*env
    "am": 2,            # read*depth; final*ampmod
    "smoother": 3,      # final - sm; fma
    "out": 1,           # s3 * final
    "pan_mod": 6,       # two fmas, two halvings
    "pan": 2,           # left, right
    "mix": 2,           # the voice sum, left and right
}


def voice_ops(seg, r: int) -> np.ndarray:
    """[V] f32 operations a sample of each voice of row ``r``, from a
    reference ``_Segment``; 0 for an inactive voice."""
    g = lambda a: np.asarray(a)[r]
    ops = np.full(g(seg.amp).shape, OPS["phase"] + OPS["out"], np.int64)
    cz = g(seg.cz_on)
    ops += np.where(g(seg.use_fm), OPS["fm"], 0)
    ops += np.where(cz, OPS["cz"], 0)
    ops += np.where(g(seg.quant), OPS["quant"], 0)
    ops += np.where(g(seg.use_flt), OPS["biquad"], 0)
    ops += np.where(g(seg.use_env), OPS["env"], 0)
    ops += np.where(g(seg.am_osc) >= 0, OPS["am"], 0)
    ops += np.where(g(seg.use_sm), OPS["smoother"], 0)
    heard = ~g(seg.disc)
    ops += np.where(heard, OPS["pan"] + OPS["mix"], 0)
    ops += np.where(g(seg.pan_on), OPS["pan_mod"], 0)
    return np.where(g(seg.amp_nz), ops, 0)


def workload(tls, rows: int) -> dict:
    """Operations and bytes a block of a batch of ``rows`` rows like the
    compiled scripts ``tls`` (the reference's compile of the rows it
    stands for; each counts rows/len(tls) rows).  Single-segment
    scripts only."""
    from benchmark.reference import synth

    tl0 = tls[0]
    if any(tl.num_segments != 1 for tl in tls):
        raise ValueError("roofline: a script with more than one segment")
    segs = np.zeros(len(tls), np.int64)
    offs = [np.asarray(tl.table_offsets, np.int64) for tl in tls]
    seg = synth._Segment(tls, segs, offs, synth.rounder("float32"))
    # a one-shot that is finished from the start never sounds
    fin = np.stack([np.asarray(tl.ops["set_finished"][0])
                    & (np.asarray(tl.ops["finished"][0]) != 0) for tl in tls])
    seg.amp_nz = seg.amp_nz & ~fin
    per_row = np.mean([voice_ops(seg, r).sum() for r in range(len(tls))])
    n = tl0.block
    ops = rows * n * float(per_row)
    params = sum(np.asarray(v).nbytes for v in tl0.params.values())
    tables = int(np.asarray(tl0.table_buffer).nbytes)
    noise = n * 4 if bool(seg.is_noise.any()) else 0
    read_once = rows * params + tables
    nbytes = read_once / tl0.num_blocks + noise + rows * n * 2 * 4
    return {"ops": ops, "bytes": nbytes}


def least_seconds(work: dict, card: str):
    """The larger of operations over the f32 peak and bytes over the
    memory peak, or None for a card without published peaks."""
    if card not in PEAKS:
        return None
    flops, bw = PEAKS[card]
    return max(work["ops"] / flops, work["bytes"] / bw)
