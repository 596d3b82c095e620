"""Observability — the reference's runtime introspection surface.

  * ``/s`` system dump: threads/udp/voices/sample count + callback stats
    (wire.c:236-261, 783-794) → here: engine/system/render stats
  * ``/S`` queue + session dump (wire.c:245-261, show_stats)
  * ``W``  wavetable stats + preview (wire.c:521-551 wavetable_show,
    downsample_block_average_min_max :468-507)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from skred_tpu_torch import config as C


def system_show(engine) -> str:
    """'/s' analog (wire.c:236-243 + audio_show :941-958)."""
    lines = ["# skred_tpu offline engine"]
    lines.append("# synth total voice count %d" % C.VOICE_MAX)
    active = int((engine.amp != 0).sum())
    lines.append("# synth active voice count %d" % active)
    lines.append("# synth sample count %d" % engine.sample_count)
    lines.append("# tempo %g bpm (time/step %g s)"
                 % (float(engine.tempo_bpm), float(engine.tempo_time_per_step)))
    running = [p for p in range(C.PATTERNS_MAX)
               if engine.seq_state[p] == C.SEQ_RUNNING]
    lines.append("# patterns running: %s" % (running or "none"))
    return "\n".join(lines)


def queue_show(engine) -> str:
    """'/S' analog (show_stats, wire.c:245-261)."""
    lines = ["# rec_state : %d rec_ptr %d" % (engine.rec_state, engine.rec_ptr)]
    for q in range(C.QUEUE_SIZE):
        if engine.queue_state[q] != C.Q_FREE:
            lines.append("# [%d] (%d) @%d {%s}" % (
                q, engine.queue_state[q], int(engine.queue_when[q]),
                engine.queue_what[q]))
    return "\n".join(lines)


def downsample_min_max(source: np.ndarray, dest_len: int):
    """reference wire.c:468-507 — block average with min/max envelope."""
    source = np.asarray(source, dtype=np.float32)
    n = source.size
    if dest_len >= n:
        pad = np.zeros(dest_len, np.float32)
        pad[:n] = source
        return pad[:n], pad[:n].copy(), pad[:n].copy()
    block = n / dest_len
    avg = np.empty(dest_len, np.float32)
    mn = np.empty(dest_len, np.float32)
    mx = np.empty(dest_len, np.float32)
    for i in range(dest_len):
        s = int(i * block)
        e = min(int((i + 1) * block), n - 1)
        seg = source[s : e + 1]
        avg[i] = seg.mean()
        mn[i] = seg.min()
        mx[i] = seg.max()
    return avg, mn, mx


def wavetable_show(bank, n: int, preview: Optional[int] = None) -> str:
    """'W' analog (wavetable_show, wire.c:521-551)."""
    if not (0 <= n < C.WAVE_TABLE_MAX):
        return ""
    s = bank.slots[n]
    if not s.valid:
        return ""
    table = s.data[: s.size]
    crossing = int(((table[:-1] > 0) & (table[1:] < 0)
                    | (table[:-1] < 0) & (table[1:] > 0)).sum())
    out = ["# w%d size:%d +hz:%g midi:%g min:%g max:%g zerocross:%d"
           % (n, s.size, s.offset_hz, s.midi_note,
              float(table.min()), float(table.max()), crossing)]
    return "\n".join(out)


# scope trigger modes (reference: scope_trigger_t + find_start_triggered,
# scope.c:90-157): align the display window to a stable feature of the
# waveform so periodic signals hold still on screen
TRIGGER_NONE = 0
TRIGGER_ZERO_RISING = 1
TRIGGER_ZERO_RISING_HYST = 2
TRIGGER_ZERO_SLOPE = 3
TRIGGER_PEAK = 4

_ZERO_EPS = 0.0
_HYST_LOW = -0.02
_HYST_HIGH = 0.02
_MIN_LEVEL = 0.05
_MIN_SLOPE = 0.01


def find_start_triggered(left: np.ndarray, right: np.ndarray,
                         write_ptr: int, window: int,
                         mode: int = TRIGGER_ZERO_RISING) -> int:
    """Port of the scope's trigger search (scope.c:90-157): walk backwards
    from ``write_ptr`` over the mono average of the stereo ring, up to two
    screen-widths, returning the index of the trigger point.

    Modes: zero-rising, zero-rising with +-0.02 hysteresis (and a minimum
    level gate), hysteresis + minimum slope, and best-positive-peak."""
    avg = (np.asarray(left, np.float32) + np.asarray(right, np.float32)) \
        * np.float32(0.5)
    n = avg.size
    if n <= 0 or mode == TRIGGER_NONE:
        return write_ptr
    max_search = min(window * 2, n)
    i = write_ptr % n
    prev = avg[i]
    best_peak = 0.0
    best_i = write_ptr
    for _ in range(max_search):
        i = (i - 1 + n) % n
        cur = float(avg[i])
        slope = cur - prev
        if mode == TRIGGER_ZERO_RISING:
            if prev <= _ZERO_EPS < cur:
                return i
        elif mode == TRIGGER_ZERO_RISING_HYST:
            if prev < _HYST_LOW and cur > _HYST_HIGH \
                    and abs(cur) > _MIN_LEVEL:
                return i
        elif mode == TRIGGER_ZERO_SLOPE:
            if prev < _HYST_LOW and cur > _HYST_HIGH \
                    and slope > _MIN_SLOPE and abs(cur) > _MIN_LEVEL:
                return i
        elif mode == TRIGGER_PEAK:
            if cur > best_peak and cur > _MIN_LEVEL:
                best_peak = cur
                best_i = i
        else:
            return write_ptr
        prev = cur
    if mode == TRIGGER_PEAK and best_peak > 0.0:
        return best_i
    return write_ptr


def scope_window(audio: np.ndarray, window: int,
                 mode: int = TRIGGER_ZERO_RISING,
                 write_ptr: Optional[int] = None) -> np.ndarray:
    """Extract a trigger-aligned display window [window, 2] from a rendered
    stereo stream — the offline analog of one scope frame."""
    audio = np.asarray(audio)
    n = len(audio)
    wp = (n - 1) if write_ptr is None else write_ptr % n
    start = find_start_triggered(audio[:, 0], audio[:, 1], wp, window, mode)
    idx = (start + np.arange(window)) % n
    return audio[idx]


def scope_dump(audio: np.ndarray, path, width: int = 800) -> None:
    """Offline scope: write the downsampled min/avg/max envelope of a
    rendered stereo stream (the scope_buffer_t analog, scope-shared.h)
    as an .npz artifact for plotting."""
    audio = np.asarray(audio)
    left, right = audio[:, 0], audio[:, 1]
    la, lmn, lmx = downsample_min_max(left, width)
    ra, rmn, rmx = downsample_min_max(right, width)
    np.savez(path, left_avg=la, left_min=lmn, left_max=lmx,
             right_avg=ra, right_min=rmn, right_max=rmx,
             samples=len(audio), rate=C.MAIN_SAMPLE_RATE)
