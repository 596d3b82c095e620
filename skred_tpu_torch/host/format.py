"""State round-trip formatting.

Port of voice_format (reference: synth.c:663-808) — the reference's
de-facto consistency check: a voice serializes back to replayable wire
text.  Also produces the full state dump matching golden/render_golden -S
for oracle comparison.
"""

from __future__ import annotations

import numpy as np

from skred_tpu_torch import config as C
from skred_tpu_torch.host.engine import HostEngine


def _g(x) -> str:
    """C printf %g of a float (promoted to double)."""
    return "%g" % float(x)


def voice_format(e: HostEngine, v: int, verbose: int = 0) -> str:
    if not (0 <= v < C.VOICE_MAX):
        return ""
    parts = [
        "v%d w%d f%s a%s" % (v, e.table_index[v], _g(e.freq[v]), _g(e.user_amp[v]))
    ]
    if verbose or e.midi_transpose[v]:
        parts.append(" N%s" % _g(e.midi_transpose[v]))
    if verbose or e.link_midi_a[v] >= 0 or e.link_midi_b[v] >= 0:
        parts.append(" G%s,%s" % (_g(e.link_midi_a[v]), _g(e.link_midi_b[v])))
    if verbose or e.link_velo_a[v] >= 0 or e.link_velo_b[v] >= 0:
        parts.append(" H%s,%s" % (_g(e.link_velo_a[v]), _g(e.link_velo_b[v])))
    if verbose or e.link_trig[v] >= 0:
        parts.append(" L%s" % _g(e.link_trig[v]))
    if verbose or e.direction[v]:
        parts.append(" b%d" % e.direction[v])
    if verbose or e.loop_enabled[v]:
        parts.append(" B%d" % e.loop_enabled[v])
    if verbose or e.pan[v]:
        parts.append(" p%s" % _g(e.pan[v]))
    if verbose or e.note[v]:
        parts.append(" n%s" % _g(e.note[v]))
    if verbose or e.filter_mode[v]:
        parts.append(" J%d K%s Q%s" % (e.filter_mode[v], _g(e.filter_freq[v]),
                                       _g(e.filter_res[v])))
    if verbose or e.cz_mode[v]:
        parts.append(" c%d,%s" % (e.cz_mode[v], _g(e.cz_distortion[v])))
    if verbose or e.quantize[v]:
        parts.append(" q%d" % e.quantize[v])
    if verbose or e.hold_max[v]:
        parts.append(" h%d" % e.hold_max[v])
    if verbose or (e.amp_mod_osc[v] >= 0 and e.amp_mod_depth[v] > 0):
        parts.append(" A%d,%s" % (e.amp_mod_osc[v], _g(e.amp_mod_depth[v])))
    if verbose or (e.cz_mod_osc[v] >= 0 and e.cz_mod_depth[v] > 0):
        parts.append(" C%d,%s" % (e.cz_mod_osc[v], _g(e.cz_mod_depth[v])))
    if verbose or (e.freq_mod_osc[v] >= 0 and e.freq_mod_depth[v] > 0):
        parts.append(" F%d,%s" % (e.freq_mod_osc[v], _g(e.freq_mod_depth[v])))
    if verbose or (e.pan_mod_osc[v] >= 0 and e.pan_mod_depth[v] > 0):
        parts.append(" P%d,%s" % (e.pan_mod_osc[v], _g(e.pan_mod_depth[v])))
    if verbose or e.disconnect[v]:
        parts.append(" m%d" % e.disconnect[v])
    if verbose or e.record[v]:
        parts.append(" r%d" % e.record[v])
    if verbose or e.smoother_enable[v]:
        if e.smoother_smoothing[v] != np.float32(C.SMOOTH_DEFAULT):
            parts.append(" s%s" % _g(e.smoother_smoothing[v]))
    if verbose or e.glissando_enable[v]:
        parts.append(" g%s" % _g(e.glissando_speed[v]))
    if verbose or not e.envelope_is_flat(v):
        parts.append(" t%s,%s,%s,%s" % (_g(e.env_a[v]), _g(e.env_d[v]),
                                        _g(e.env_s[v]), _g(e.env_r[v])))
    return "".join(parts)


def state_dump(e: HostEngine) -> str:
    """Matches golden/render_golden.c state_dump()."""
    out = []
    for v in range(C.VOICE_MAX):
        out.append("V%d %s" % (v, voice_format(e, v, 0)))
    out.append("TEMPO %.9g %.9g %.9g" % (float(e.tempo_base), float(e.tempo_bpm),
                                         float(e.tempo_time_per_step)))
    for p in range(C.PATTERNS_MAX):
        out.append("PAT %d state=%d ptr=%d ctr=%d mod=%d" % (
            p, e.seq_state[p], e.seq_pointer[p], e.seq_counter[p], e.seq_modulo[p]))
        for s in range(C.SEQ_STEPS_MAX):
            if e.seq_pattern[p][s] == "" and e.seq_mute[p][s] == 0:
                continue
            out.append("CELL %d %d mute=%d {%s}" % (p, s, e.seq_mute[p][s],
                                                    e.seq_pattern[p][s]))
    for q in range(C.QUEUE_SIZE):
        if e.queue_state[q] != C.Q_FREE:
            out.append("QUEUED %d %d v%d {%s}" % (q, int(e.queue_when[q]),
                                                  e.queue_voice[q], e.queue_what[q]))
    return "\n".join(out) + "\n"
