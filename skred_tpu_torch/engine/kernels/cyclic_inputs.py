"""Cyclic-kernel inputs: a script's own per-voice vectors, random states.

``block_inputs`` compiles a feedback script, packs it for the cyclic
engine and returns the arguments of ``cyclic_block`` for its first block,
with the carried states drawn from a numpy seed so that a single block
exercises what a long render reaches: phases anywhere inside their
tables (one-shot voices near an end, so some finish mid-block), non-zero
previous samples for the feedback taps, live filter, hold and smoother
state.  The tests hand the same arrays to the JAX package's
``cyclic_block_pallas`` and to ``cyclic_block_plain``; ``chip_smoke.py``
hands them to the CUDA kernel and to the plain version on the card.
Values stay in the ranges a render produces.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

# What corpus/fb1-fb5.sk lack, in one feedback script: a noise voice with
# sample & hold, an envelope, a smoother, pan-mod (cross and self), a
# one-shot PCM voice, a reversed voice, a disconnected voice, am-self and
# a cz-mod edge from another voice.  Every voice's amp smoother is on
# unless ``s0`` turns it off; the voices with an envelope or an amp-mod
# edge carry ``s0`` (tests/test_torch_cyclic.py says why).
ALL_FEATURES = [
    "v0 w1 f110 a40 F1,0.8 J1 K4000 Q30 s0.05",
    "v1 w2 f55 a30 F0,0.5 b1 P2,0.7",
    "v2 w6 f3 a20 h40 A0,0.5 s0",
    "v3 w101 f200 a25 T",
    "v4 w0 f330 a20 t0.01,0.02,0.5,0.05 l1 q5 c1,0.4 C3,0.3 s0",
    "v5 w0 f2 a10 m1",
    "v6 w0 f440 a10 p-0.3 P6,0.5",
    "v7 w2 f70 a15 A7,0.3 h3 s0",
]

CORPUS = pathlib.Path(__file__).resolve().parents[3] / "corpus"


def packed(lines, seconds, rows):
    """``lines`` compiled for ``seconds`` and packed for the cyclic engine
    at ``rows`` replicated rows."""
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines

    tl = compile_script(list(lines), seconds, bank=WaveBank(),
                        script_dir=CORPUS)
    return pack_stacked(stack_timelines([tl] * rows), cyclic=True)


def random_states(vecs, feat, k, rows, seed):
    """In-range carried states for ``vecs`` as numpy ``[k, rows]`` arrays
    (``vol_gain``: ``[rows]``)."""
    rng = np.random.default_rng(seed)
    shape = (k, rows)
    f = lambda lo, hi: rng.uniform(lo, hi, shape).astype(np.float32)
    lo, hi = (np.asarray(vecs[x], np.float32) for x in ("lo", "hi"))
    phase = lo + (hi - lo) * f(0.0, 1.0) * np.float32(0.999)
    if feat.finish:
        # one-shot voices within 100 steps of an end
        osn = np.asarray(vecs["osn"]) != 0
        step = np.abs(np.asarray(vecs["pinc"], np.float32)) * f(1.0, 100.0)
        near = np.where(f(0.0, 1.0) < 0.5, lo + step, hi - step)
        phase = np.where(osn, np.clip(near, lo, hi - np.float32(1e-3)),
                         phase)
    phase = phase.astype(np.float32)
    states = {
        "phase": phase, "sample": f(-0.5, 0.5),
        "finished": (rng.uniform(0, 1, shape) < 0.1).astype(np.int32)
        * np.int32(feat.finish),
        "hold_count": np.zeros(shape, np.int32), "hold_val": f(-1.0, 1.0),
        "x1": f(-0.5, 0.5), "x2": f(-0.5, 0.5), "y1": f(-0.5, 0.5),
        "y2": f(-0.5, 0.5), "smoother": f(0.1, 1.0),
        "pan_l": f(0.2, 0.8), "pan_r": f(0.2, 0.8),
        "vol_gain": rng.uniform(0.1, 1.0, rows).astype(np.float32),
    }
    if feat.hold:
        hmax = np.maximum(np.asarray(vecs["hmax"]), 1)
        states["hold_count"] = (rng.integers(0, 1 << 30, shape)
                                % hmax).astype(np.int32)
    return states


def block_inputs(lines, rows, seed, n=512, seconds=0.05):
    """The arguments of ``cyclic_block`` for the first block of ``lines``
    at ``rows`` rows, on the CPU: (table, table_off, cbase, noise_blk,
    vecs, states, vf, feat, k, n).  ``vecs`` are the script's own;
    ``states`` are random (``random_states``)."""
    from skred_tpu_torch.engine import cyclic
    from skred_tpu_torch.host.timeline import noise_stream

    st = packed(lines, seconds, rows)
    st, r, _ = cyclic._prep(st, True, "cpu")
    p = {kk: v[:, 0] for kk, v in r.params.items()}
    vecs, table_off = cyclic._vecs(p, r.feat)
    states = {kk: torch.from_numpy(v) for kk, v in random_states(
        {kk: v.numpy() for kk, v in vecs.items()}, r.feat, r.k, rows,
        seed).items()}
    noise_blk = torch.from_numpy(noise_stream(n)) if r.feat.noise else None
    # cbase 1: the block that starts the render (envelopes in attack)
    return (r.table, table_off, 1, noise_blk, vecs, states,
            p["volume_final"].contiguous(), r.feat, r.k, n)


def out_of_range(args, seed):
    """``block_inputs``' tuple with operands outside the range of the
    keyed kernel's fast wrap and CZ divide on some rows: increments of
    7.3 table lengths (10% of the lanes), NaN and infinite phases (5%
    each) and, with CZ, denormal table sizes whose reciprocal is
    infinite (10%).  The kernel renders such rows again with the exact
    helpers; the results must not change."""
    table, table_off, cbase, noise_blk, vecs, states, vf, feat, k, n = args
    rng = np.random.default_rng(seed)
    shape = vecs["pinc"].shape
    pick = lambda p: torch.from_numpy(rng.uniform(size=shape) < p)
    vecs, states = dict(vecs), dict(states)
    vecs["pinc"] = torch.where(pick(0.1), vecs["L"] * 7.3,
                               vecs["pinc"]).contiguous()
    phase = states["phase"].clone()
    phase[pick(0.05)] = float("nan")
    phase[pick(0.05)] = float("inf")
    states["phase"] = phase
    if "tsize" in vecs:
        tiny = pick(0.1)
        vecs["tsize"] = torch.where(tiny, torch.tensor(1e-39),
                                    vecs["tsize"]).contiguous()
        vecs["inv_ts"] = torch.where(tiny, torch.tensor(float("inf")),
                                     vecs["inv_ts"]).contiguous()
    return (table, table_off, cbase, noise_blk, vecs, states, vf, feat, k,
            n)


def on_device(args, dev):
    """``block_inputs``' tuple with every tensor on ``dev``."""
    table, table_off, cbase, noise_blk, vecs, states, vf, feat, k, n = args
    return (table.to(dev), table_off.to(dev), cbase,
            None if noise_blk is None else noise_blk.to(dev),
            {kk: v.to(dev) for kk, v in vecs.items()},
            {kk: v.to(dev) for kk, v in states.items()}, vf.to(dev), feat, k,
            n)
