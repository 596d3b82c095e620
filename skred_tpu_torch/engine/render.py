"""The compat engine: the bit-exact per-sample renderer.

Port of ``skred_tpu.engine.render``: the reference renders sample by
sample, voice by voice on one CPU thread (synth() — synth.c:502-630);
here all 64 voices of a row advance in lockstep, block by block, with the
serial in-frame modulation order reproduced by ``mod_passes`` fixed-point
passes a sample (host/timeline.py counts them).  The JAX package runs
this as two nested ``lax.scan``s; the port runs it as one kernel a chunk
of blocks (``engine/kernels/compat.py``, ``csrc/compat.cu``) that keeps
each row's 64 voices on chip, or, on the CPU, as that kernel's plain
version.

``render_timeline`` renders one compiled script (the JAX function's
signature, with ``device``); ``render_stream_device`` renders a script or
a stacked batch chunk by chunk with the carry and the audio on the
device.  ``parallel/batch.py``'s ``render_stacked`` renders a stacked
batch, one row a script, on one device or split over a mesh.  Numerics
are float32 throughout, matching the C engine: the LCG noise stream,
the truncating table lookup, the fast_pow bit trick (synth.c:140-147)
and fmodf wrapping, the reference's fmas at ``_fma``'s sites.  Fast and exact mode are one arithmetic here:
the card's plain multiply-add is that fma, and so is the JAX package's
fast mode on the CPU, where XLA contracts it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from skred_tpu_torch import config as C
from skred_tpu_torch import spans
from skred_tpu_torch.engine.kernels.compat import (compat_block,
                                                   pack_inputs, zero_carry)
from skred_tpu_torch.host.timeline import Timeline, noise_stream

V = C.VOICE_MAX
CHUNK = 172          # blocks a kernel call: ~2 s of audio


def stacked_inputs(st, device="cuda"):
    """A stacked batch's kernel inputs, one row a script; the table
    buffer and the noise stream are shared by every row."""
    from skred_tpu_torch.parallel.batch import _prep_params

    return pack_inputs(_prep_params(st), st.ops, st.seg_of_block,
                       st.seg_is_start, st.table_buffer, st.block, device)


def _stacked(batch):
    """A Timeline as a one-row stack; a StackedTimelines as it is."""
    from skred_tpu_torch.parallel.batch import stack_timelines

    return stack_timelines([batch]) if isinstance(batch, Timeline) \
        else batch


def _inputs(batch, device):
    """(inputs, mod_passes) of a Timeline (a one-row stack) or a
    StackedTimelines."""
    batch = _stacked(batch)
    return stacked_inputs(batch, device), batch.mod_passes


def render_chunks(inp, mod_passes: int, noise, exact: bool, capture: bool,
                  chunk_blocks: int = CHUNK, blocks: Optional[int] = None):
    """Generator over the chunks of a render: ``(out [B, nb*block, 2],
    cap [B, nb*block, V, 2] or None)`` on the inputs' device, the carry
    kept there from chunk to chunk.  ``noise``: the stream on the device,
    at least ``blocks`` (default all) blocks long.  Consume it under
    ``torch.no_grad()``."""
    n = inp.block
    blocks = inp.num_blocks if blocks is None else blocks
    carry = zero_carry(inp.rows, inp.pf.device)
    for b0 in range(0, blocks, chunk_blocks):
        nb = min(chunk_blocks, blocks - b0)
        with spans.span("render.chunk"):
            carry, out, cap = compat_block(
                inp, carry, noise[b0 * n:(b0 + nb) * n], b0, nb,
                mod_passes, exact, capture)
        yield out, cap


def _noise(noise, total, device):
    with spans.span("render.noise"):
        stream = noise_stream(total) if noise is None \
            else np.asarray(noise, np.float32)[:total]
        return torch.as_tensor(np.ascontiguousarray(stream, np.float32),
                               device=device)


def render_rows(batch, capture: bool = False, noise=None,
                exact: bool = True, device="cuda", mesh=None):
    """A Timeline or StackedTimelines rendered whole -> numpy ``[B, T,
    2]`` (and ``[B, T, V, 2]`` with capture), chunk by chunk.  With a
    ``mesh`` (a list of devices) the rows are split over it, every shard
    at the whole batch's pass count, its chunks launched in turn with
    the other shards'."""
    from skred_tpu_torch.parallel.batch import shard_rows, take_rows

    st = _stacked(batch)
    total = st.num_blocks * st.block
    with spans.span("render.timeline"):
        with spans.span("render.inputs"):
            shards = [(stacked_inputs(take_rows(st, rows), dev),
                       _noise(noise, total, dev))
                      for dev, rows in shard_rows(
                          st.batch, [device] if mesh is None else mesh)]
        gens = [render_chunks(inp, st.mod_passes, nz, exact, capture)
                for inp, nz in shards]
        outs, caps = [], []
        with torch.no_grad():
            for chunk in zip(*gens):     # every shard's chunk, launched
                with spans.span("render.download"):
                    outs.append(np.concatenate([o.cpu().numpy()
                                                for o, _ in chunk]))
                    if capture:
                        caps.append(np.concatenate([c.cpu().numpy()
                                                    for _, c in chunk]))
        out = np.concatenate(outs, axis=1)
        return (out, np.concatenate(caps, axis=1)) if capture else out


def render_timeline(tl: Timeline, capture: bool = False,
                    noise: Optional[np.ndarray] = None,
                    exact: Optional[bool] = None, device="cuda"):
    """Render a compiled Timeline -> stereo f32 ``[T, 2]`` (and
    optionally the per-voice capture ``[T, V, 2]``, the one_skred_frame
    analog, skred.c:88).  ``exact=None`` is True on every device (the
    JAX package turns it off only on a TPU, which has no f64).  Runs on
    the card unless ``device="cpu"``."""
    if tl.num_blocks == 0:
        z = np.zeros((0, 2), np.float32)
        return (z, np.zeros((0, V, 2), np.float32)) if capture else z
    res = render_rows(tl, capture, noise, True if exact is None else exact,
                      device)
    if capture:
        return res[0][0], res[1][0]
    return res[0]


def render_stream_device(batch, chunk_blocks: int = CHUNK, noise=None,
                         exact: bool = True, capture: bool = False,
                         warmup_only: bool = False, device="cuda") -> float:
    """Streamed render of a Timeline or StackedTimelines that keeps the
    carry and the audio on the device, chunk by chunk (only whole chunks
    render, as ``render_cyclic_stream_device`` does); returns a checksum,
    the |out| sum of the final chunk in f64."""
    inp, passes = _inputs(batch, device)
    whole = (inp.num_blocks // chunk_blocks) * chunk_blocks
    out = None
    with torch.no_grad():
        for out, _ in render_chunks(inp, passes,
                                    _noise(noise, whole * inp.block, device),
                                    exact, capture, chunk_blocks, whole):
            if warmup_only:
                break
    if out is None:
        return 0.0
    return float(out.abs().sum(dtype=torch.float64))
