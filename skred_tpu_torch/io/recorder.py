"""Multi-voice recorder — the ``<``/``*`` wire commands.

The reference captures every voice's post-pan stereo pair into a ring
buffer while ``rec_state`` is set (skred.c:120-131) and ``*`` writes the
voices flagged ``r1`` as an N-channel 16-bit WAV, globally peak-normalized
preserving zero (wire.c:94-185 save_wav — the scan for the scale factor
runs over the WHOLE capture buffer including unrecorded voices, a quirk
kept here).

Offline: the timeline compiler records (start_sample, stop_sample,
record_flags) for each ``<``…``*`` pair; rendering with per-voice capture
then slices and writes the same WAVs deterministically.
"""

from __future__ import annotations

import pathlib
import wave as wave_mod
from typing import List, Tuple

import numpy as np

from skred_tpu_torch import config as C


def save_wav_multichannel(path, capture: np.ndarray, record_flags: np.ndarray,
                          sample_rate: int = 44100) -> int:
    """capture: [T, V, 2] per-voice stereo; record_flags: [V] ints.

    Returns the number of channels written (0 = nothing recorded)."""
    record = np.asarray(record_flags) != 0
    num_channels = int(record.sum()) * 2
    if num_channels == 0:
        return 0
    # scale factor from the FULL buffer, preserving zero (wire.c:152-168)
    data = np.asarray(capture, dtype=np.float32)
    fbig = float(max(data.max(initial=0.0), 0.0))
    fsmall = float(min(data.min(initial=0.0), 0.0))
    if abs(fsmall) > abs(fbig):
        scale = -1.0 / fsmall if fsmall != 0 else 1.0
    else:
        scale = 1.0 / fbig if fbig != 0 else 1.0
    sel = data[:, record, :]                      # [T, R, 2]
    pcm = np.clip(sel * np.float32(scale), -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2").reshape(len(data), -1)
    with wave_mod.open(str(path), "wb") as f:
        f.setnchannels(num_channels)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm16.tobytes())
    return num_channels


def render_recordings(tl, outdir: pathlib.Path, prefix: str = "skred",
                      device="cuda") -> List[Tuple[pathlib.Path, int]]:
    """Render a timeline's ``<``…``*`` capture windows to WAV files.
    Renders on the card unless ``device="cpu"``."""
    from skred_tpu_torch.engine import render_timeline

    events = getattr(tl.final_engine, "save_events", [])
    if not events:
        return []
    _, cap = render_timeline(tl, capture=True, device=device)
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    written = []
    cap_samples = getattr(tl.final_engine, "rec_cap_samples",
                          30 * C.MAIN_SAMPLE_RATE)
    for i, (start, stop, flags) in enumerate(events):
        stop = min(stop, cap.shape[0], start + cap_samples)
        seg = cap[start:stop]
        path = outdir / f"{prefix}-{i}.wav"
        ch = save_wav_multichannel(path, seg, flags)
        if ch:
            written.append((path, ch))
    return written
