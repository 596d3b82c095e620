"""wire — command dispatch.

Semantic port of the reference dispatch table (reference: wire.c:591-867
wire_function, wire.c:869-900 defer handling, wire.c:907-920 callbacks,
wire.c:924-939 wire()).  A WireContext mirrors ``wire_t`` (wire.h:32-61):
per-session current voice, voice stack, pattern/step cursor, flags, and a
persistent skode parser whose variables are shared process-wide.

Faithful quirks preserved:
  * an atom handler reads ``arg[0]`` unconditionally — with no arguments it
    sees the *stale* value left in slot 0 (the C arg array is never zeroed);
  * ``x`` with a non-numeric argument (NaN → INT_MIN) advances the step
    cursor but does NOT store the cell (wire.c:727-735);
  * ``A`` with one argument attempts amp_mod_set(-1,…) which fails
    validation, so it does nothing (wire.c:608-612);
  * ``%``/``!``/``@``/``<``/``>`` are guarded by ``if (arg)`` — a pointer,
    always true — so they run even with no arguments using stale slot 0;
  * defers: ``t = (num + defer_last) [; t *= step*4 if '+'] ; t +=
    defer_last`` — the documented double-add (wire.c:873-876);
  * the voice stack stores floats and wraps at 8 entries (wire.c:62-73).
"""

from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np

from . import config as C
from .engine import HostEngine, c_int
from . import skode as sk

F32 = np.float32


def _not_frozen(*args, **kwargs):
    """The state printers (``W``, ``?``, ``/s``, ``/S``) are not part of
    the frozen copy: the benchmark's scripts print nothing."""
    raise NotImplementedError("state printers are not in the frozen copy")


class WireContext:
    """One wire session (reference wire_t)."""

    def __init__(self, engine: HostEngine, script_dir: Optional[pathlib.Path] = None,
                 output: bool = False):
        self.engine = engine
        self.script_dir = script_dir or pathlib.Path.cwd()
        self.voice = 0
        self.stack = [0.0] * 8   # voice_stack_t (floats, wire.h:15-18)
        self.stack_ptr = 0
        self.pattern = 0
        self.step = -1
        self.output = output
        self.trace = 0
        self.debug = 0
        self.verbose = 0
        self.events = 0   # mirror lines to engine.event_log (perf firehose)
        self.quit = 0
        self.defer_last = np.float32(0.0)
        self.defer_sample_time = 0
        self.sk: Optional[sk.Skode] = None
        self.prints: list[str] = []

    # ---- voice stack (wire.c:62-73) ----
    def _push(self, n: float) -> None:
        self.stack_ptr += 1
        if self.stack_ptr >= 8:
            self.stack_ptr = 0
        self.stack[self.stack_ptr] = n

    def _pop(self) -> float:
        n = self.stack[self.stack_ptr]
        self.stack_ptr -= 1
        if self.stack_ptr < 0:
            self.stack_ptr = 7
        return n

    def _print(self, s: str) -> None:
        if self.output:
            self.prints.append(s)

    # ---- entry point (wire.c:924-939) ----
    def wire(self, line: str) -> int:
        if self.sk is None:
            self.sk = sk.Skode(self._cb, self)
            self.sk.set_global(self.engine.global_var)
        if self.events:
            log = getattr(self.engine, "event_log", None)
            if log is not None:
                log.send(self.engine.sample_count, line)
        self.sk.feed(line)
        return self.quit

    def _cb(self, s: sk.Skode, info: int) -> int:
        if info == sk.FUNCTION:
            return self._function(s)
        if info == sk.DEFER:
            return self._defer(s)
        if info == sk.CHUNK_END:
            self.defer_last = np.float32(0.0)
            self.defer_sample_time = 0
            return 0
        if info == sk.PUSH:
            self._push(float(self.voice))
            return 0
        if info == sk.POP:
            self.voice = int(self._pop())
            return 0
        if info in (sk.GOT_STRING, sk.GOT_ARRAY):
            return 0
        return 0

    # ---- defer (wire.c:869-892) ----
    def _defer(self, s: sk.Skode) -> int:
        e = self.engine
        if self.defer_sample_time == 0:
            self.defer_sample_time = e.sample_count
        dst = self.defer_sample_time
        mode = s.defer_mode
        t = np.float32(s.defer_num + float(self.defer_last))
        if mode == "+":
            t = np.float32(t * np.float32(e.tempo_time_per_step * np.float32(4.0)))
        t = np.float32(t + self.defer_last)
        qt = int(np.float32(t * np.float32(C.MAIN_SAMPLE_RATE))) + dst
        e.queue_item(qt, s.defer_string, self.voice)
        self.defer_last = np.float32(self.defer_last + np.float32(s.defer_num))
        return 0

    # ---- sk_load (wire.c:342-368) ----
    def sk_load(self, n: int) -> int:
        e = self.engine
        path = self.script_dir / f"{n}.sk"
        if not path.exists():
            return 0
        # the reference uses one STATIC context shared by every sk_load call
        if not hasattr(e, "_skload_ctx") or e._skload_ctx is None:
            e._skload_ctx = WireContext(e, self.script_dir)
        ctx = e._skload_ctx
        for line in path.read_text().splitlines():
            r = ctx.wire(line)
            if r != 0:
                break
        return 0

    # ---- the dispatch table (wire.c:591-867) ----
    def _function(self, s: sk.Skode) -> int:
        atom = s.atom
        argc = s.arg_len
        arg = s.arg          # raw slots — stale reads are intentional
        e = self.engine
        voice = self.voice
        x = c_int(arg[0])

        if atom == "a___":
            if argc:
                e.amp_set(voice, arg[0])
        elif atom == "A___":
            if argc == 1:
                e.amp_mod_set(voice, -1, 0)   # fails validation: no-op
            elif argc > 1:
                e.amp_mod_set(voice, x, arg[1])
        elif atom == "b___":
            e.wave_dir(voice, -1 if argc == 0 else x)
        elif atom == "B___":
            e.wave_loop(voice, -1 if argc == 0 else x)
        elif atom == "c___":
            if argc == 0:
                e.cz_set(voice, 0, 0.5)
            elif argc == 1:
                e.cz_set(voice, x, 0.5)
            else:
                e.cz_set(voice, x, arg[1])
        elif atom == "C___":
            if argc <= 1:
                e.cmod_set(voice, x, -1)
            else:
                e.cmod_set(voice, x, arg[1])
        elif atom in ("D___", ":D__", "/D__", "I___"):
            pass
        elif atom == "f___":
            if argc:
                e.freq_set(voice, arg[0])
        elif atom == "F___":
            if argc <= 1:
                e.freq_mod_set(voice, x, -1)
            else:
                e.freq_mod_set(voice, x, arg[1])
        elif atom == "g___":
            if argc:
                if arg[0] <= 0:
                    e.glissando_enable[voice] = 0
                else:
                    e.glissando_enable[voice] = 1
                    e.glissando_speed[voice] = np.float32(arg[0])
        elif atom == "G___":
            if argc:
                e.link_midi_a[voice] = np.float32(x)
                if argc > 1:
                    e.link_midi_b[voice] = np.float32(c_int(arg[1]))
        elif atom == "h___":
            if argc:
                e.hold_max[voice] = x
                e.dirty = True
        elif atom == "H___":
            if argc:
                e.link_velo_a[voice] = np.float32(x)
                if argc > 1:
                    e.link_velo_b[voice] = np.float32(c_int(arg[1]))
        elif atom == "L___":
            if argc:
                e.link_trig[voice] = np.float32(x)
        elif atom == "J___":
            if argc:
                e.filter_mode[voice] = x
                e.mmf_set_params(voice, e.filter_freq[voice], e.filter_res[voice])
                e.dirty = True
        elif atom == "K___":
            if argc:
                e.mmf_set_freq(voice, arg[0])
        elif atom == "l___":
            if argc:
                e.envelope_velocity(voice, arg[0])
                if e.link_velo_a[voice] >= 0:
                    e.envelope_velocity(int(e.link_velo_a[voice]), arg[0])
                if e.link_velo_b[voice] >= 0:
                    e.envelope_velocity(int(e.link_velo_b[voice]), arg[0])
        elif atom == "m___":
            if argc:
                e.wave_mute(voice, x)
        elif atom == "M___":
            if argc:
                e.tempo_set(arg[0])
        elif atom == "n___":
            if argc:
                e.freq_midi(voice, arg[0])
                if e.link_midi_a[voice] >= 0:
                    e.freq_midi(int(e.link_midi_a[voice]), arg[0])
                if e.link_midi_b[voice] >= 0:
                    e.freq_midi(int(e.link_midi_b[voice]), arg[0])
        elif atom == "N___":
            if argc:
                e.midi_transpose[voice] = np.float32(arg[0])
        elif atom == "p___":
            if argc:
                e.pan_set(voice, arg[0])
        elif atom == "P___":
            if argc <= 1:
                e.pan_mod_set(voice, x, -1)
            else:
                e.pan_mod_set(voice, x, arg[1])
        elif atom == "q___":
            if argc:
                e.wave_quant(voice, x)
        elif atom == "Q___":
            if argc:
                e.mmf_set_res(voice, arg[0])
        elif atom == "r___":
            if argc:
                if e.rec_state == 0:
                    e.record[voice] = x
                    e.dirty = True
        elif atom == "s___":
            if argc:
                if arg[0] <= 0:
                    e.smoother_enable[voice] = 0
                else:
                    e.smoother_enable[voice] = 1
                    e.smoother_smoothing[voice] = np.float32(arg[0])
                e.dirty = True
        elif atom == "S___":
            if argc:
                e.wave_reset(voice, x)
        elif atom == "t___":
            if argc > 3:
                e.envelope_init(voice, arg[0], arg[1], arg[2], arg[3])
        elif atom == "T___":
            e.voice_trigger(voice)
            if e.link_trig[voice] > 0:
                e.voice_trigger(int(e.link_trig[voice]))
        elif atom == "v___":
            if argc:
                if 0 <= x < C.VOICE_MAX:
                    self.voice = x
        elif atom == "V___":
            if argc:
                e.volume_set(arg[0])
        elif atom == "w___":
            if argc:
                e.wave_set(voice, x)
        elif atom == "W___":
            if argc:
                wavetable_show = _not_frozen
                txt = wavetable_show(e.bank, x)
                if txt:
                    self._print(txt)
        elif atom == "x___":
            if argc:
                if x < 0:
                    self.step += 1
                else:
                    self.step = x
                if 0 <= x < C.SEQ_STEPS_MAX:
                    e.seq_step_set(self.pattern, self.step, s.string)
        elif atom == "y___":
            if argc:
                self.pattern = x
        elif atom == "z___":
            if argc:
                e.seq_state_set(self.pattern, x)
            elif self.output:
                self._pattern_show(self.pattern)
        elif atom == "Z___":
            if argc:
                e.seq_state_all(x)
            elif self.output:
                self._print("; M%g" % (float(e.tempo_bpm) * 4.0))
                for p in range(C.PATTERNS_MAX):
                    self._pattern_show(p)
        elif atom in ("?___", "\\___"):
            voice_format = _not_frozen
            txt = voice_format(e, voice, 1 if atom == "\\___" else self.verbose)
            if txt:
                self._print("; " + txt)
        elif atom == "??__":
            voice_format = _not_frozen
            for i in range(C.VOICE_MAX):
                if e.amp[i] == 0:
                    continue
                t = " # *" if i == voice else ""
                txt = voice_format(e, i, self.verbose)
                if txt:
                    self._print("; " + txt + t)
        elif atom == "?s__":
            self._print("# %s" % s.string)
        elif atom == "l>g_":
            if argc:
                s.local_to_global(x)
        elif atom == "g>l_":
            if argc:
                s.global_to_local(x)
        elif atom in ("/s__", ":s__"):
            if self.output:
                system_show = _not_frozen
                self._print(system_show(e))
        elif atom in ("/S__", ":S__"):
            if self.output:
                queue_show = _not_frozen
                self._print(queue_show(e))
        elif atom in ("/m__", ":m__", "/o__", ":o__"):
            pass  # RT latency probe / live scope — no real-time plane here
        elif atom in ("/q__", ":q__"):
            self.quit = -1
            return 0
        elif atom in ("/d__", ":d__"):
            self.debug = (0 if self.debug else 1) if argc == 0 else x
        elif atom in ("/i__", ":i__"):
            self.output = (not self.output) if argc == 0 else bool(x)
        elif atom in ("/t__", ":t__"):
            if argc == 0:
                x = 0 if self.trace else 1
            self.trace = x
        elif atom in ("/v__", ":v__"):
            if argc == 0:
                x = 0 if self.verbose else 1
            self.verbose = x
        elif atom in ("/l__", ":l__"):
            if argc:
                self.sk_load(x)
        elif atom in ("/w__", ":w__"):
            which, where, ch = 0, C.EXT_SAMPLE_000, -1
            if argc >= 2:
                which, where = c_int(arg[0]), c_int(arg[1])
                if argc > 2:
                    ch = c_int(arg[2])
            elif argc == 1:
                which = c_int(arg[0])
            e.bank.load_wav(which, where, ch, search_dir=self.script_dir)
            e.dirty = True
        elif atom == "<___":
            # record-start (wire.c:816-830); stale arg[0] read is faithful
            e.rec_state = 0
            max_sec = np.float32(arg[0])
            if max_sec > 0.0:
                rec_total = np.float32(30.0)   # matches the golden renderer's rec_sec
                if max_sec > rec_total:
                    max_sec = rec_total
                e.rec_cap_samples = int(
                    np.float32(max_sec * np.float32(C.MAIN_SAMPLE_RATE)))
            else:
                e.rec_cap_samples = 30 * C.MAIN_SAMPLE_RATE
            e.rec_ptr = 0
            e.rec_start_sample = e.sample_count
            e.rec_state = 1
            e.dirty = True
        elif atom == "*___":
            if e.rec_ptr or e.rec_state:
                e.rec_state = 0
                e.save_events = getattr(e, "save_events", [])
                e.save_events.append(
                    (getattr(e, "rec_start_sample", 0), e.sample_count,
                     e.record.copy())
                )
                e.dirty = True
        elif atom == ">___":
            e.voice_copy(voice, x)
        elif atom == "/___":
            e.wave_default(voice)
        elif atom == "%___":
            e.seq_modulo_set(self.pattern, x)
        elif atom == "!___":
            e.seq_mute_set(self.pattern, x, 0)
        elif atom == "@___":
            e.seq_mute_set(self.pattern, x, 1)
        elif atom == "=___":
            if argc > 1:
                s.set_local(x, arg[1])
        elif atom == "/wex":
            if argc and 200 <= x <= 999:
                e.bank.dynamic_expand(x)
                e.dirty = True
        else:
            pass  # unknown atoms are swallowed (wire.c:858-864)
        return 0

    def _pattern_show(self, p: int) -> None:
        """reference wire.c:450-464."""
        e = self.engine
        first = True
        for st in range(C.SEQ_STEPS_MAX):
            line = e.seq_pattern[p][st]
            if len(line) == 0:
                break
            if first:
                self._print("; y%d %%%d" % (p, e.seq_modulo[p]))
                first = False
            txt = "; {%s} x%d" % (line, st)
            if e.seq_mute[p][st]:
                txt += " @%d" % p
            self._print(txt)
