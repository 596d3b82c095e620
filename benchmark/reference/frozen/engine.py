"""Host-side engine model.

Replaces the reference's mutable global voice arrays (synth.def expanded in
synth.c:16-32) and all voice-control setters (synth.c:640-1160) with an
explicit host model.  Control commands mutate this model *between* render
blocks — the offline equivalent of the reference's REPL/UDP/sequencer
threads mutating live arrays read by the audio callback (which the
reference quantizes to callback boundaries anyway for sequencer/defer
events, seq.c:164-213).

Two kinds of voice state:

  * **params** — values the device kernel reads every sample but only
    control writes (amp, phase_inc, filter coefficients, envelope stamps…).
    Snapshot per segment.
  * **device ops** — writes to state that otherwise *evolves on device*
    (oscillator phase, finished flag, filter delay line, smoother gain,
    pan l/r when pan-modulated, held sample).  Recorded as (flag, value)
    pairs applied at the start of the segment's first block.

All float arithmetic in setters is performed in float32 with glibc's
transcendental functions, matching the reference binary bit-for-bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from . import config as C
from .bank import WaveBank, midi2hz_f32
from .utils_libm import cosf, sinf

F32 = np.float32
V = C.VOICE_MAX


def c_int(d: float) -> int:
    """C (int) cast of a double: truncation; NaN/out-of-range → INT_MIN
    (x86 cvttsd2si behavior, relied on by the ``x-`` command quirk,
    wire.c:727-735)."""
    if isinstance(d, float) and (math.isnan(d) or math.isinf(d)):
        return -2147483648
    try:
        i = int(d)
    except (ValueError, OverflowError):
        return -2147483648
    if i < -2147483648 or i > 2147483647:
        return -2147483648
    return i


def _zeros_f(shape=V):
    return np.zeros(shape, dtype=np.float32)


def _zeros_i(shape=V):
    return np.zeros(shape, dtype=np.int32)


@dataclasses.dataclass
class VoiceOps:
    """Device-state writes pending for the next block boundary."""

    set_phase: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(V, bool))
    phase: np.ndarray = dataclasses.field(default_factory=_zeros_f)
    set_finished: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(V, bool))
    finished: np.ndarray = dataclasses.field(default_factory=_zeros_i)
    set_sample: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(V, bool))
    sample: np.ndarray = dataclasses.field(default_factory=_zeros_f)
    clear_filter: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(V, bool))
    set_smoother: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(V, bool))
    smoother: np.ndarray = dataclasses.field(default_factory=_zeros_f)
    set_pan: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(V, bool))
    pan_left: np.ndarray = dataclasses.field(default_factory=_zeros_f)
    pan_right: np.ndarray = dataclasses.field(default_factory=_zeros_f)
    copy_hold_from: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(V, -1, dtype=np.int32)
    )

    def copy(self) -> "VoiceOps":
        return VoiceOps(**{
            f.name: getattr(self, f.name).copy() for f in dataclasses.fields(self)
        })

    def clear(self) -> None:
        for f in dataclasses.fields(self):
            a = getattr(self, f.name)
            if f.name == "copy_hold_from":
                a.fill(-1)
            else:
                a.fill(0)


class HostEngine:
    """The complete control-plane model of the synthesizer."""

    def __init__(self, bank: Optional[WaveBank] = None):
        self.bank = bank if bank is not None else WaveBank()

        # ---- voice params (synth.def) ----
        self.phase_inc = _zeros_f()
        self.table_index = _zeros_i()          # voice_wave_table_index
        self.table_size = _zeros_i()
        self.table_rate = _zeros_f()
        self.one_shot = _zeros_i()
        self.loop_enabled = _zeros_i()
        self.loop_start = _zeros_i()
        self.loop_end = _zeros_i()
        self.loop_start_f = _zeros_f()
        self.loop_end_f = _zeros_f()
        self.loop_valid = _zeros_i()
        self.midi_note = _zeros_f()
        self.midi_transpose = _zeros_f()
        self.link_midi_a = _zeros_f()
        self.link_midi_b = _zeros_f()
        self.link_velo_a = _zeros_f()
        self.link_velo_b = _zeros_f()
        self.link_trig = _zeros_f()
        self.offset_hz = _zeros_f()
        self.freq = _zeros_f()
        self.note = _zeros_f()
        self.hold_max = _zeros_i()
        self.amp = _zeros_f()
        self.user_amp = _zeros_f()
        self.pan = _zeros_f()
        self.pan_left = _zeros_f()             # control-side copy; device overwrites under pan-mod
        self.pan_right = _zeros_f()
        self.use_amp_envelope = _zeros_i()
        self.freq_mod_osc = _zeros_i()
        self.freq_mod_depth = _zeros_f()
        self.freq_scale = _zeros_f()
        self.pan_mod_osc = _zeros_i()
        self.amp_mod_osc = _zeros_i()
        self.cz_mod_osc = _zeros_i()
        self.pan_mod_depth = _zeros_f()
        self.amp_mod_depth = _zeros_f()
        self.cz_mod_depth = _zeros_f()
        self.disconnect = _zeros_i()
        self.quantize = _zeros_i()
        self.direction = _zeros_i()
        self.record = _zeros_i()
        self.cz_mode = _zeros_i()
        self.cz_distortion = _zeros_f()
        self.smoother_enable = _zeros_i()
        self.smoother_smoothing = _zeros_f()
        self.glissando_enable = _zeros_i()
        self.glissando_speed = _zeros_f()
        self.glissando_target = _zeros_f()
        self.filter_freq = _zeros_f()
        self.filter_res = _zeros_f()
        self.filter_mode = _zeros_i()
        # filter coefficients + cache (mmf_t, synth-types.h:13-23)
        self.flt_b0 = _zeros_f(); self.flt_b1 = _zeros_f(); self.flt_b2 = _zeros_f()
        self.flt_a1 = _zeros_f(); self.flt_a2 = _zeros_f()
        self.flt_last_freq = _zeros_f()
        self.flt_last_res = _zeros_f()
        self.flt_last_mode = _zeros_i()
        # envelope (envelope_t, synth-types.h:25-38)
        self.env_a = _zeros_f(); self.env_d = _zeros_f()
        self.env_s = _zeros_f(); self.env_r = _zeros_f()
        self.env_attack = _zeros_f(); self.env_decay = _zeros_f()
        self.env_sustain = _zeros_f(); self.env_release = _zeros_f()
        self.env_start = np.zeros(V, dtype=np.int64)
        self.env_rel_at = np.zeros(V, dtype=np.int64)
        self.env_active = _zeros_i()
        self.env_velocity = _zeros_f()

        # ---- globals ----
        self.volume_user = np.float32(1.0)
        self.volume_final = np.float32(C.AMY_FACTOR)
        self.sample_count = 0                  # synth_sample_count
        self.tempo_time_per_step = np.float32(60.0)   # skred.c:47
        self.tempo_bpm = np.float32(120.0 / 4.0)
        self.tempo_base = np.float32(0.0)
        self.rec_state = 0
        self.rec_ptr = 0

        # ---- sequencer (seq.c:13-20) ----
        P, S = C.PATTERNS_MAX, C.SEQ_STEPS_MAX
        self.seq_pattern: List[List[str]] = [["" for _ in range(S)] for _ in range(P)]
        self.seq_mute = np.zeros((P, S), dtype=np.int32)
        self.seq_pointer = np.zeros(P, dtype=np.int32)
        self.seq_counter = np.zeros(P, dtype=np.int32)
        self.seq_state = np.zeros(P, dtype=np.int32)
        self.seq_modulo = np.full(P, 4, dtype=np.int32)
        self.seq_clock_sec = np.float64(0.0)   # static double clock_sec, seq.c:184

        # ---- deferred-event queue (seq.c:241-257) ----
        self.queue_state = np.zeros(C.QUEUE_SIZE, dtype=np.int32)
        self.queue_when = np.zeros(C.QUEUE_SIZE, dtype=np.uint64)
        self.queue_what: List[str] = ["" for _ in range(C.QUEUE_SIZE)]
        self.queue_voice = np.zeros(C.QUEUE_SIZE, dtype=np.int32)

        # shared wire variables (wire.c:922)
        self.global_var: List[float] = [0.0] * 10

        # table bindings: voices bind table *contents*, not slots — reloading
        # a slot must not retroactively change an existing binding (the
        # reference keeps raw pointers + a graveyard, wire.c:370-390).
        self.table_list: List[np.ndarray] = []
        self._table_ids: dict = {}
        self.table_key = np.zeros(V, dtype=np.int32)

        # pending device ops + dirty flag for the timeline compiler
        self.ops = VoiceOps()
        self.dirty = True

        self.voice_init()
        self.dirty = True

    # ================= synth.c setters =================
    def _valid(self, v: int) -> bool:
        return 0 <= v < V

    def osc_get_phase_inc(self, v: int, f) -> np.float32:
        """reference synth.c:125-132 (f32 op order preserved)."""
        g = np.float32(f)
        if self.one_shot[v]:
            g = np.float32(g / self.offset_hz[v])
        rate = self.table_rate[v]
        return np.float32(
            np.float32(np.float32(g * np.float32(self.table_size[v])) / rate)
            * np.float32(rate / np.float32(C.MAIN_SAMPLE_RATE))
        )

    def osc_set_freq(self, v: int, f) -> None:
        self.phase_inc[v] = self.osc_get_phase_inc(v, f)
        self.dirty = True

    def osc_set_wave_table_index(self, v: int, wave: int) -> None:
        """reference synth.c:277-314."""
        s = self.bank.slots[wave]
        if not s.valid:
            return
        key = self._table_ids.get(id(s.data))
        if key is None:
            key = len(self.table_list)
            self.table_list.append(s.data)
            self._table_ids[id(s.data)] = key
        self.table_key[v] = key
        self.table_index[v] = wave
        fin = 1 if s.one_shot else 0
        self.ops.set_finished[v] = True
        self.ops.finished[v] = fin
        update_freq = (
            self.table_rate[v] != np.float32(s.rate) or self.table_size[v] != s.size
        )
        self.table_rate[v] = np.float32(s.rate)
        self.table_size[v] = s.size
        self.one_shot[v] = s.one_shot
        self.loop_start[v] = s.loop_start
        self.loop_enabled[v] = s.loop_enabled
        self.loop_end[v] = s.loop_end
        self.midi_note[v] = np.float32(s.midi_note)
        self.offset_hz[v] = np.float32(s.offset_hz)
        start, end = s.loop_start, s.loop_end
        self.loop_start_f[v] = np.float32(start)
        self.loop_end_f[v] = np.float32(end)
        self.loop_valid[v] = 1 if end > start else 0
        if update_freq:
            self.osc_set_freq(v, self.freq[v])
        self.dirty = True

    def osc_trigger(self, v: int) -> None:
        """reference synth.c:316-339 — computes the reset phase."""
        self.ops.set_finished[v] = True
        self.ops.finished[v] = 0
        if self.one_shot[v]:
            ph = np.float32(self.table_size[v] - 1) if self.direction[v] else np.float32(0.0)
        else:
            if self.direction[v]:
                ph = (np.float32(self.loop_end[v]) - np.float32(1e-6)
                      if self.loop_enabled[v] else np.float32(self.table_size[v] - 1))
            else:
                ph = (np.float32(self.loop_start[v]) if self.loop_enabled[v]
                      else np.float32(0.0))
        self.ops.set_phase[v] = True
        self.ops.phase[v] = ph
        self.dirty = True

    # ---- filter (synth.c:929-1030) ----
    def mmf_set_params(self, n: int, f, resonance) -> None:
        f = np.float32(f)
        resonance = np.float32(resonance)
        if (f == self.flt_last_freq[n] and resonance == self.flt_last_res[n]
                and self.filter_mode[n] == self.flt_last_mode[n]):
            return
        self.flt_last_freq[n] = f
        self.flt_last_res[n] = resonance
        self.flt_last_mode[n] = self.filter_mode[n]
        omega = np.float32(
            np.float32(np.float32(2.0) * np.float32(math.pi)) * f
            / np.float32(C.MAIN_SAMPLE_RATE)
        )
        sin_o = sinf(omega)
        cos_o = cosf(omega)
        alpha = np.float32(sin_o / np.float32(np.float32(2.0) * resonance))
        mode = int(self.filter_mode[n])
        one = np.float32(1.0)
        two = np.float32(2.0)
        if mode == 0:
            return
        if mode == C.FILTER_HIGHPASS:
            b0 = np.float32((one + cos_o) / two)
            b1 = np.float32(-(one + cos_o))
            b2 = np.float32((one + cos_o) / two)
        elif mode == C.FILTER_BANDPASS:
            b0 = alpha; b1 = np.float32(0.0); b2 = np.float32(-alpha)
        elif mode == C.FILTER_NOTCH:
            b0 = one; b1 = np.float32(-two * cos_o); b2 = one
        elif mode == C.FILTER_ALL_PASS:
            b0 = np.float32(one - alpha); b1 = np.float32(-two * cos_o)
            b2 = np.float32(one + alpha)
        else:  # default/lowpass (synth.c:953-961)
            b0 = np.float32((one - cos_o) / two)
            b1 = np.float32(one - cos_o)
            b2 = np.float32((one - cos_o) / two)
        a0 = np.float32(one + alpha)
        a1 = np.float32(-two * cos_o)
        a2 = np.float32(one - alpha)
        self.flt_b0[n] = np.float32(b0 / a0)
        self.flt_b1[n] = np.float32(b1 / a0)
        self.flt_b2[n] = np.float32(b2 / a0)
        self.flt_a1[n] = np.float32(a1 / a0)
        self.flt_a2[n] = np.float32(a2 / a0)
        self.filter_freq[n] = f
        self.filter_res[n] = resonance
        self.dirty = True

    def mmf_init(self, n: int, f, resonance) -> None:
        """reference synth.c:1015-1030 — clears the delay line."""
        self.ops.clear_filter[n] = True
        self.flt_last_freq[n] = np.float32(-1.0)
        self.flt_last_res[n] = np.float32(-1.0)
        self.flt_last_mode[n] = -1
        self.filter_freq[n] = np.float32(f)
        self.filter_res[n] = np.float32(resonance)
        self.mmf_set_params(n, f, resonance)
        self.dirty = True

    def mmf_set_freq(self, n: int, f) -> None:
        self.mmf_set_params(n, f, self.filter_res[n])

    def mmf_set_res(self, n: int, res) -> None:
        if res > 0:
            self.mmf_set_params(n, self.filter_freq[n], res)

    # ---- envelope (synth.c:367-431, 1146-1159) ----
    def envelope_init(self, v: int, a, d, s, r) -> None:
        self.env_a[v] = np.float32(a)
        self.env_d[v] = np.float32(d)
        self.env_s[v] = np.float32(s)
        self.env_r[v] = np.float32(r)
        self.env_attack[v] = np.float32(np.float32(a) * np.float32(C.MAIN_SAMPLE_RATE))
        self.env_decay[v] = np.float32(np.float32(d) * np.float32(C.MAIN_SAMPLE_RATE))
        self.env_sustain[v] = np.float32(max(0.0, min(1.0, float(s))))
        self.env_release[v] = np.float32(np.float32(r) * np.float32(C.MAIN_SAMPLE_RATE))
        self.env_start[v] = 0
        self.env_rel_at[v] = 0
        self.env_active[v] = 0
        self.dirty = True

    def _env_device_active(self, v: int) -> bool:
        """Models the device's is_active flag: amp_envelope_step
        (synth.c:398-431) flips is_active→0 once called past release end.
        We use the eager analytic rule (active until release end); the
        device's lazy variant differs only if the voice was never stepped
        after release end (skipped with amp==0/finished) and then released
        again — a corner with no effect on rendered audio."""
        if not self.env_active[v]:
            return False
        if self.env_rel_at[v] == 0:
            return True
        # first k with (float)(k) >= release_time (synth.c:423 compares f32)
        rt = float(self.env_release[v])
        k = int(math.ceil(rt))
        while np.float32(k) < np.float32(rt):
            k += 1
        return self.sample_count - int(self.env_rel_at[v]) < k

    def amp_envelope_trigger(self, v: int, f) -> None:
        self.env_start[v] = self.sample_count
        self.env_rel_at[v] = 0
        self.env_velocity[v] = np.float32(f)
        self.env_active[v] = 1
        self.dirty = True

    def amp_envelope_release(self, v: int) -> None:
        if self._env_device_active(v):
            self.env_rel_at[v] = self.sample_count
        elif self.env_active[v]:
            # device would have lazily deactivated by now
            self.env_active[v] = 0
        self.dirty = True

    def envelope_velocity(self, v: int, f) -> int:
        if not self._valid(v):
            return 100
        if f == 0:
            self.amp_envelope_release(v)
        else:
            self.use_amp_envelope[v] = 1
            if self.one_shot[v]:
                self.osc_trigger(v)
            self.amp_envelope_trigger(v, f)
        self.dirty = True
        return 0

    def envelope_is_flat(self, v: int) -> bool:
        return (self.env_a[v] == 0.0 and self.env_d[v] == 0.0
                and self.env_s[v] == 1.0 and self.env_r[v] == 0.0)

    # ---- plain setters ----
    def volume_set(self, f) -> None:
        self.volume_user = np.float32(f)
        self.volume_final = np.float32(np.float32(f) * np.float32(C.AMY_FACTOR))
        self.dirty = True

    def amp_set(self, v: int, f) -> int:
        if f >= 0:
            self.use_amp_envelope[v] = 0
            self.amp[v] = np.float32(f)
            self.user_amp[v] = np.float32(f)
            self.dirty = True
            return 0
        return 100

    def pan_set(self, v: int, f) -> int:
        if -1.0 <= f <= 1.0:
            f = np.float32(f)
            self.pan[v] = f
            self.pan_left[v] = np.float32((np.float32(1.0) - f) / np.float32(2.0))
            self.pan_right[v] = np.float32((np.float32(1.0) + f) / np.float32(2.0))
            self.ops.set_pan[v] = True
            self.ops.pan_left[v] = self.pan_left[v]
            self.ops.pan_right[v] = self.pan_right[v]
            self.dirty = True
            return 0
        return 100

    def freq_set(self, v: int, f) -> int:
        if 0 <= f < float(C.MAIN_SAMPLE_RATE):
            self.freq[v] = np.float32(f)
            self.osc_set_freq(v, np.float32(f))
            return 0
        return 101

    def wave_set(self, v: int, wave: int) -> int:
        if 0 <= wave < C.WAVE_TABLE_MAX:
            self.osc_set_wave_table_index(v, wave)
            return 0
        return 100

    def wave_mute(self, v: int, state: int) -> None:
        if state < 0:
            state = 1 if self.disconnect[v] == 0 else 0
        self.disconnect[v] = state
        self.dirty = True

    def wave_dir(self, v: int, state: int) -> None:
        if state < 0:
            state = 1 if self.direction[v] == 0 else 0
        self.direction[v] = state
        self.dirty = True

    def wave_loop(self, v: int, state: int) -> None:
        if state < 0:
            state = 1 if self.loop_enabled[v] == 0 else 0
        self.loop_enabled[v] = state
        self.dirty = True

    def wave_quant(self, v: int, n: int) -> None:
        self.quantize[v] = n
        self.dirty = True

    def freq_mod_set(self, v: int, o: int, f) -> int:
        if not self._valid(v) or not self._valid(o):
            return 100
        self.freq_mod_osc[v] = o
        self.freq_mod_depth[v] = np.float32(f)
        self.freq_scale[v] = np.float32(
            np.float32(self.table_size[v]) / np.float32(self.table_size[o])
        )
        self.dirty = True
        return 0

    def amp_mod_set(self, v: int, o: int, f) -> int:
        if not self._valid(v) or not self._valid(o):
            return 100
        self.amp_mod_osc[v] = o
        self.amp_mod_depth[v] = np.float32(f)
        self.dirty = True
        return 0

    def pan_mod_set(self, v: int, o: int, f) -> int:
        if not self._valid(v) or not self._valid(o):
            return 100
        self.pan_mod_osc[v] = o
        self.pan_mod_depth[v] = np.float32(f)
        self.dirty = True
        return 0

    def cz_set(self, v: int, n: int, f) -> int:
        self.cz_mode[v] = n
        self.cz_distortion[v] = np.float32(f)
        self.dirty = True
        return 0

    def cmod_set(self, v: int, o: int, f) -> int:
        self.cz_mod_osc[v] = o
        self.cz_mod_depth[v] = np.float32(f)
        self.dirty = True
        return 0

    def freq_midi(self, v: int, f: float) -> int:
        """reference synth.c:1081-1088."""
        if 0.0 <= f <= 127.0:
            ff = np.float32(f)
            if self.midi_transpose[v]:
                ff = np.float32(ff + self.midi_transpose[v])
            g = midi2hz_f32(ff)
            return self.freq_set(v, float(g))
        return 100

    def wave_default(self, v: int) -> None:
        """reference synth.c:1072-1079 ('/' command)."""
        g = midi2hz_f32(self.midi_note[v])
        self.freq[v] = np.float32(g)
        self.note[v] = np.float32(self.midi_note[v])
        self.osc_set_freq(v, g)

    def voice_trigger(self, v: int) -> None:
        self.osc_trigger(v)

    def voice_reset(self, i: int) -> None:
        """reference synth.c:1090-1132 — note what it does NOT reset:
        oscillator phase and sample&hold state persist."""
        self.table_index[i] = 0
        self.table_rate[i] = 0
        self.table_size[i] = 0
        self.ops.set_sample[i] = True
        self.ops.sample[i] = 0.0
        self.amp[i] = 0
        self.user_amp[i] = 0
        self.pan[i] = 0
        self.pan_left[i] = np.float32(0.5)
        self.pan_right[i] = np.float32(0.5)
        self.ops.set_pan[i] = True
        self.ops.pan_left[i] = 0.5
        self.ops.pan_right[i] = 0.5
        self.use_amp_envelope[i] = 0
        self.amp_mod_osc[i] = -1
        self.freq_mod_osc[i] = -1
        self.freq_mod_depth[i] = 0.0
        self.freq_scale[i] = 1.0
        self.pan_mod_osc[i] = -1
        self.disconnect[i] = 0
        self.quantize[i] = 0
        self.direction[i] = 0
        self.envelope_init(i, 0.0, 0.0, 1.0, 0.0)
        self.freq[i] = 440.0
        self.midi_note[i] = 69.0
        self.midi_transpose[i] = 0
        self.link_midi_a[i] = -1
        self.link_midi_b[i] = -1
        self.link_velo_a[i] = -1
        self.link_velo_b[i] = -1
        self.link_trig[i] = -1
        self.osc_set_wave_table_index(i, C.WAVE_TABLE_SINE)
        self.filter_mode[i] = 0
        self.mmf_init(i, 8000.0, 0.707)
        self.smoother_enable[i] = 1
        self.ops.set_smoother[i] = True
        self.ops.smoother[i] = 0.0
        self.smoother_smoothing[i] = np.float32(C.SMOOTH_DEFAULT)
        self.glissando_enable[i] = 0
        self.glissando_speed[i] = 0.0
        self.glissando_target[i] = self.freq[i]
        self.record[i] = 0
        # note: cz_mode/cz_distortion/cz_mod are NOT reset (reference quirk),
        # nor hold_max/note/link arrays beyond the ones above
        self.dirty = True

    def voice_init(self) -> None:
        for i in range(V):
            self.voice_reset(i)

    def wave_reset(self, voice: int, n: int) -> None:
        """reference synth.c:1140-1144 — invalid n resets ALL voices."""
        if not self._valid(n):
            self.voice_init()
        else:
            self.voice_reset(n)

    def voice_copy(self, v: int, n: int) -> None:
        """reference synth.c:1033-1054."""
        self.wave_set(n, int(self.table_index[v]))
        self.amp_set(n, float(self.user_amp[v]))
        self.freq_set(n, float(self.freq[v]))
        self.pan_set(n, float(self.pan[v]))
        self.amp_mod_set(n, int(self.amp_mod_osc[v]), float(self.amp_mod_depth[v]))
        self.freq_mod_set(n, int(self.freq_mod_osc[v]), float(self.freq_mod_depth[v]))
        self.pan_mod_set(n, int(self.pan_mod_osc[v]), float(self.pan_mod_depth[v]))
        self.wave_loop(n, int(self.loop_enabled[v]))
        self.wave_dir(n, int(self.direction[v]))
        self.wave_quant(n, int(self.quantize[v]))
        self.hold_max[n] = self.hold_max[v]
        self.ops.copy_hold_from[n] = v      # live S&H counter copied on device
        self.envelope_init(n, float(self.env_a[v]), float(self.env_d[v]),
                           float(self.env_s[v]), float(self.env_r[v]))
        self.cz_set(n, int(self.cz_mode[v]), float(self.cz_distortion[v]))
        self.cmod_set(n, int(self.cz_mod_osc[v]), float(self.cz_mod_depth[v]))
        self.filter_mode[n] = self.filter_mode[v]
        self.mmf_init(n, float(self.filter_freq[v]), float(self.filter_res[v]))

    # ================= sequencer (seq.c) =================
    def tempo_set(self, m) -> None:
        """reference seq.c:22-29 (f32 arithmetic)."""
        m = np.float32(m)
        self.tempo_base = m
        self.tempo_bpm = np.float32(m / np.float32(4.0))
        bps = np.float32(m / np.float32(60.0))
        self.tempo_time_per_step = np.float32(
            np.float32(np.float32(1.0) / bps) / np.float32(4.0)
        )
        self.dirty = True

    def queue_item(self, when: int, what: str, voice: int) -> int:
        """reference seq.c:243-257 — first free slot."""
        for q in range(C.QUEUE_SIZE):
            if self.queue_state[q] == C.Q_FREE:
                self.queue_when[q] = np.uint64(when)
                self.queue_what[q] = what
                self.queue_voice[q] = voice
                self.queue_state[q] = C.Q_READY
                return q
        return -1

    def seq_modulo_set(self, p: int, m: int) -> None:
        self.seq_modulo[p] = m

    def seq_mute_set(self, p: int, s: int, m: int) -> None:
        self.seq_mute[p][s] = m

    def seq_step_set(self, p: int, s: int, text: str) -> None:
        self.seq_pattern[p][s] = text

    def seq_state_set(self, p: int, state: int) -> None:
        """reference seq.c:273-290."""
        if state == 0:
            self.seq_state[p] = C.SEQ_STOPPED
            self.seq_pointer[p] = 0
        elif state == 1:
            self.seq_state[p] = C.SEQ_RUNNING
            self.seq_pointer[p] = 0
        elif state == 2:
            self.seq_state[p] = C.SEQ_PAUSED
        elif state == 3:
            self.seq_state[p] = C.SEQ_RUNNING

    def seq_state_all(self, state: int) -> None:
        for p in range(C.PATTERNS_MAX):
            self.seq_state_set(p, state)
