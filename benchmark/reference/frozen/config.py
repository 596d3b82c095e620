"""Global configuration constants.

Mirrors the reference compile-time constants (reference: skred.h:6-13,
skred.h:24-77, skred.h:85-100) plus renderer-specific knobs that have no
reference counterpart (the reference is a real-time callback engine; we are
an offline block renderer).
"""

from __future__ import annotations

import dataclasses

# ---- reference compile-time constants (skred.h) ----
MAIN_SAMPLE_RATE = 44100          # skred.h:6
VOICE_MAX = 64                    # skred.h:9
AUDIO_CHANNELS = 2                # skred.h:10
AMY_FACTOR = 0.025                # skred.h:11
SYNTH_FRAMES_PER_CALLBACK = 512   # skred.h:12 — our render block size
SEQ_FRAMES_PER_CALLBACK = 128     # skred.h:13 (unused; seq runs on the synth callback)

# wave table slot map (skred.h:24-73)
WAVE_TABLE_SINE = 0
WAVE_TABLE_SQR = 1
WAVE_TABLE_SAW_DOWN = 2
WAVE_TABLE_SAW_UP = 3
WAVE_TABLE_TRI = 4
WAVE_TABLE_NOISE = 5
WAVE_TABLE_NOISE_ALT = 6
WAVE_TABLE_KRG1 = 32
WAVE_TABLE_KRG32 = 63             # exclusive end is 64; slots 32..63 hold 32 banks? see assets.bank
AMY_SAMPLE_00 = 100
AMY_SAMPLE_99 = 199
EXT_SAMPLE_000 = 200
EXT_SAMPLE_999 = 1199
WAVE_TABLE_MAX = 1200

# sequencer (skred.h:75-77)
PATTERNS_MAX = 16
SEQ_STEPS_MAX = 256
STEP_MAX = 256

SEQ_STOPPED = 0
SEQ_RUNNING = 1
SEQ_PAUSED = 2

# deferred-event queue (skred.h:85-93)
QUEUE_SIZE = 1024
Q_FREE = 0
Q_PREP = 1
Q_READY = 2
Q_USING = 3

# voice smoother default (synth.c:87)
SMOOTH_DEFAULT = 0.02

# recorder (skred.h:15)
REC_IN_SEC = 5 * 60

# filter modes (synth-types.h:4-10)
FILTER_LOWPASS = 1
FILTER_HIGHPASS = 2
FILTER_BANDPASS = 3
FILTER_NOTCH = 4
FILTER_ALL_PASS = 5


@dataclasses.dataclass(frozen=True)
class Config:
    """Renderer configuration.

    The reference's runtime config surface is its CLI flags + the wire
    language itself (reference: skred.c:200-222); ours is this dataclass.
    """

    sample_rate: int = MAIN_SAMPLE_RATE
    voices: int = VOICE_MAX
    block: int = SYNTH_FRAMES_PER_CALLBACK   # samples per render block (== C callback)
    # engine selection: "scan" = faithful per-sample lax.scan engine,
    # "fused" = block-parallel engine (fast path).
    engine: str = "scan"
    # serial in-frame modulation order (synth.c:548-558): number of
    # fixed-point passes to resolve mod reads from lower-indexed voices.
    # None = computed per segment from the modulation graph.
    mod_passes: int | None = None
    # capture per-voice stereo output (one_skred_frame analog, skred.c:88)
    capture_voices: bool = False
    dtype: str = "float32"
