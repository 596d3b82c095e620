"""Event-timeline compiler.

The reference mutates live engine state from REPL/UDP/sequencer threads
while the audio callback renders (synth_callback, skred.c:107-152).  All
*deterministic* control — the step sequencer (seq.c:164-213) and the
deferred-event queue (seq.c:171-177, wire.c:869-892) — is quantized to
callback boundaries by construction.  This module simulates that control
plane ahead of render, block by block, and snapshots the engine into
per-segment parameter tensors the device renderer consumes.

The simulation replicates, with the reference's exact float semantics:
  * the sequencer clock: ``static double clock_sec`` accumulating the f32
    block duration, firing a step when it reaches ``tempo_time_per_step``
    (seq.c:183-191);
  * the per-pattern modulo/mute/wrap-at-empty-cell logic (seq.c:195-211);
  * the defer queue drained when ``when <= synth_sample_count +
    frame_count`` — with the counter already advanced past the current
    block, i.e. events fire up to one block early (seq.c:172);
  * the two *static* wire contexts shared by queue items and pattern cells
    (seq.c:170, seq.c:180).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import List, Optional

import numpy as np

from . import config as C
from .bank import WaveBank
from .engine import HostEngine, VoiceOps
from .wire import WireContext

V = C.VOICE_MAX

# engine attributes snapshotted per segment, by dtype
PARAM_F32 = [
    "phase_inc", "loop_start_f", "loop_end_f", "amp",
    "freq_mod_depth", "freq_scale", "pan_mod_depth", "amp_mod_depth",
    "cz_mod_depth", "cz_distortion", "smoother_smoothing",
    "flt_b0", "flt_b1", "flt_b2", "flt_a1", "flt_a2",
    "env_attack", "env_decay", "env_sustain", "env_release", "env_velocity",
]
PARAM_I32 = [
    "table_key", "table_size", "table_index", "one_shot", "loop_enabled",
    "loop_valid", "direction", "hold_max", "quantize", "filter_mode",
    "use_amp_envelope", "env_active", "freq_mod_osc", "amp_mod_osc",
    "pan_mod_osc", "cz_mod_osc", "cz_mode", "disconnect", "record",
    "smoother_enable",
]
PARAM_I64_AS_I32 = ["env_start", "env_rel_at"]
OPS_FIELDS = [f.name for f in dataclasses.fields(VoiceOps)]


@dataclasses.dataclass
class Timeline:
    """Compiled control timeline for one script."""

    num_blocks: int
    block: int
    seg_of_block: np.ndarray              # [B] int32
    seg_is_start: np.ndarray              # [B] bool — ops apply on these blocks
    params: dict                          # name → [S, V] (or [S] for scalars)
    ops: dict                             # name → [S, V]
    table_buffer: np.ndarray              # packed f32 tables
    table_offsets: np.ndarray             # [num_tables] int32
    table_arrays: List[np.ndarray]        # the bound tables (identity-dedupable)
    mod_passes: int
    fused_passes: Optional[int]           # None → cyclic mod graph
    final_engine: HostEngine              # post-simulation state (round-trip/debug)

    @property
    def num_segments(self) -> int:
        return int(self.seg_of_block[-1]) + 1 if self.num_blocks else 0


class _SeqSim:
    """seq() + queue drain simulation (seq.c:164-213), plus an external
    event track (the offline analog of the UDP/MIDI control plane:
    time-stamped wire lines executed at callback boundaries)."""

    def __init__(self, engine: HostEngine, script_dir: Optional[pathlib.Path],
                 events: Optional[List] = None):
        self.e = engine
        # the two static contexts in seq.c
        self.qctx = WireContext(engine, script_dir)   # seq.c:170 'v'
        self.cctx = WireContext(engine, script_dir)   # seq.c:180 'w'
        self.ectx = WireContext(engine, script_dir)   # external-event session
        self.events = sorted(events or [])            # [(sample, line)]
        self.event_pos = 0

    def tick(self, frame_count: int) -> None:
        e = self.e
        limit = e.sample_count + frame_count
        # --- external control events (UDP/MIDI analog) ---
        while (self.event_pos < len(self.events)
               and self.events[self.event_pos][0] <= limit):
            self.ectx.wire(self.events[self.event_pos][1])
            self.event_pos += 1
        # --- drain due queue items (seq.c:171-177) ---
        for q in range(C.QUEUE_SIZE):
            if e.queue_state[q] == C.Q_READY and int(e.queue_when[q]) <= limit:
                e.queue_state[q] = C.Q_USING
                self.qctx.voice = int(e.queue_voice[q])
                self.qctx.wire(e.queue_what[q])
                e.queue_state[q] = C.Q_FREE
        # --- clock (seq.c:183-191): double += f32(block/rate) ---
        frame_time = np.float32(np.float32(frame_count) / np.float32(C.MAIN_SAMPLE_RATE))
        e.seq_clock_sec = np.float64(e.seq_clock_sec + np.float64(frame_time))
        if e.seq_clock_sec >= np.float64(e.tempo_time_per_step):
            e.seq_clock_sec = np.float64(
                e.seq_clock_sec - np.float64(e.tempo_time_per_step)
            )
            advance = True
        else:
            advance = False
        if not advance:
            return
        # --- fire one step per running pattern (seq.c:195-211) ---
        for p in range(C.PATTERNS_MAX):
            if e.seq_state[p] != C.SEQ_RUNNING:
                continue
            if e.seq_modulo[p] > 1:
                if (e.seq_counter[p] % e.seq_modulo[p]) != 0:
                    e.seq_counter[p] += 1
                    continue
            e.seq_counter[p] += 1
            ptr = int(e.seq_pointer[p])
            if e.seq_mute[p][ptr] == 0:
                self.cctx.wire(e.seq_pattern[p][ptr])
            e.seq_pointer[p] += 1
            nxt = int(e.seq_pointer[p])
            if nxt >= C.SEQ_STEPS_MAX or e.seq_pattern[p][nxt] == "":
                e.seq_pointer[p] = 0


def _mod_edges(e: HostEngine, n: int, include_pan: bool = True):
    """Modulator reads of voice n whose *value* depends on the modulator
    (synth.c:548-602).  Zero-depth reads are constant (the read happens in
    C but multiplies to zero) and create no dataflow edge — important
    because cz_mod_osc defaults to 0 for every voice (never reset).

    ``include_pan=False`` drops pan-mod edges (see _edges_from_arrays)."""
    edges = []
    fm = int(e.freq_mod_osc[n])
    if fm >= 0 and fm != n and e.freq_mod_depth[n] != 0:
        edges.append(fm)
    am = int(e.amp_mod_osc[n])
    if am >= 0 and am != n and e.amp_mod_depth[n] != 0:
        edges.append(am)
    pm = int(e.pan_mod_osc[n])
    if include_pan and pm >= 0 and pm != n and e.disconnect[n] == 0 \
            and e.pan_mod_depth[n] != 0:
        edges.append(pm)
    cm = int(e.cz_mod_osc[n])
    if cm >= 0 and cm != n and e.cz_mode[n] != 0 and e.cz_mod_depth[n] != 0:
        edges.append(cm)
    return edges


def _fused_passes(e: HostEngine):
    """Block-level fixed-point passes for the fused engine: longest chain
    over the *sample-feeding* modulation edges (a delayed read still needs
    the modulator's current block).  Pan-mod edges are excluded: the fused
    engine applies pan in one global post-pass over every voice's final
    samples (engine/fused.py block_step), so a pan read never forces an
    extra pass — and a cycle that exists only through pan edges is still
    fused-renderable.  None if the fm/am/cz graph is cyclic (1-sample
    feedback loops are not block-parallelizable)."""
    depth = [None] * V
    visiting = [False] * V

    # an effective CZ SELF-edge is 1-sample self-feedback: the reference
    # reads voice_sample[dv] with no self-guard (synth.c:263-264, unlike
    # FM/AM whose `mod != n` skips), so dv == n sees the voice's own
    # previous sample.  The tiered block layout cannot express it (tier
    # edges exclude self) — route to the compat scan engine like any
    # other cycle (its read() already resolves self to prev[n]).
    for n in range(V):
        if (int(e.cz_mod_osc[n]) == n and e.cz_mode[n] != 0
                and e.cz_mod_depth[n] != 0):
            return None

    def dfs(n):
        if depth[n] is not None:
            return depth[n]
        if visiting[n]:
            raise ValueError("cycle")
        visiting[n] = True
        d = 0
        for m in _mod_edges(e, n, include_pan=False):
            d = max(d, dfs(m) + 1)
        visiting[n] = False
        depth[n] = d
        return d

    try:
        return 1 + max(dfs(n) for n in range(V))
    except ValueError:
        return None


def _edges_from_arrays(seg: dict, n: int, include_pan: bool = True):
    """_mod_edges on raw per-segment param arrays (native-compiler path).

    ``include_pan=False`` drops pan-mod edges: pan only scales a voice's
    mix contribution (synth.c:630-641), never its samples, so layouts
    that order voices by value dependency (the fused engine's tiers)
    ignore them — the fused engine applies pan in one global post-pass."""
    edges = []
    fm = int(seg["freq_mod_osc"][n])
    if fm >= 0 and fm != n and seg["freq_mod_depth"][n] != 0:
        edges.append(fm)
    am = int(seg["amp_mod_osc"][n])
    if am >= 0 and am != n and seg["amp_mod_depth"][n] != 0:
        edges.append(am)
    pm = int(seg["pan_mod_osc"][n])
    if include_pan and pm >= 0 and pm != n and seg["disconnect"][n] == 0 \
            and seg["pan_mod_depth"][n] != 0:
        edges.append(pm)
    cm = int(seg["cz_mod_osc"][n])
    if cm >= 0 and cm != n and seg["cz_mode"][n] != 0 \
            and seg["cz_mod_depth"][n] != 0:
        edges.append(cm)
    return edges


def _mod_passes_arrays(seg: dict) -> int:
    depth = [0] * V
    k = 1
    for n in range(V):
        d = 0
        for m in _edges_from_arrays(seg, n):
            if m < n:
                d = max(d, depth[m] + 1)
        depth[n] = d
        k = max(k, d + 1)
    return k


def _fused_passes_arrays(seg: dict):
    """_fused_passes on raw per-segment arrays — pan edges excluded for
    the same reason (global post-pass pan, engine/fused.py block_step)."""
    depth = [None] * V
    visiting = [False] * V

    # effective CZ self-edge → compat engine (see _fused_passes)
    for n in range(V):
        if (int(seg["cz_mod_osc"][n]) == n and seg["cz_mode"][n] != 0
                and seg["cz_mod_depth"][n] != 0):
            return None

    def dfs(n):
        if depth[n] is not None:
            return depth[n]
        if visiting[n]:
            raise ValueError("cycle")
        visiting[n] = True
        d = 0
        for m in _edges_from_arrays(seg, n, include_pan=False):
            d = max(d, dfs(m) + 1)
        visiting[n] = False
        depth[n] = d
        return d

    try:
        return 1 + max(dfs(n) for n in range(V))
    except ValueError:
        return None


def _mod_passes(e: HostEngine) -> int:
    """Fixed-point passes needed for serial in-frame mod order
    (synth.c:548-602): voice n reading modulator m<n sees m's *current*
    sample.  K = 1 + longest increasing dependency chain."""
    depth = [0] * V
    k = 1
    for n in range(V):
        d = 0
        for m in _mod_edges(e, n):
            if m < n:
                d = max(d, depth[m] + 1)
        depth[n] = d
        k = max(k, d + 1)
    return k


def compile_script(
    lines: List[str],
    seconds: float,
    bank: Optional[WaveBank] = None,
    script_dir: Optional[pathlib.Path] = None,
    block: int = C.SYNTH_FRAMES_PER_CALLBACK,
    engine: Optional[HostEngine] = None,
    events: Optional[List] = None,
) -> Timeline:
    """Execute script text at t=0 then simulate the control plane for the
    full render duration, producing the device timeline.

    ``events``: optional [(seconds, wire_line)] external control track
    (MIDI files, recorded UDP sessions) executed at callback boundaries."""
    e = engine or HostEngine(bank.fork() if bank is not None else None)
    top = WireContext(e, script_dir)
    for line in lines:
        top.wire(line)

    total_frames = int(seconds * C.MAIN_SAMPLE_RATE)
    num_blocks = (total_frames + block - 1) // block

    ev_samples = [(int(t * C.MAIN_SAMPLE_RATE), line)
                  for t, line in (events or [])]
    sim = _SeqSim(e, script_dir, events=ev_samples)

    seg_params: List[dict] = []
    seg_ops: List[dict] = []
    seg_of_block = np.zeros(num_blocks, dtype=np.int32)
    seg_is_start = np.zeros(num_blocks, dtype=bool)
    mod_passes = 1
    fused_passes: Optional[int] = 1

    def snapshot() -> None:
        nonlocal mod_passes, fused_passes
        p = {}
        for name in PARAM_F32:
            p[name] = getattr(e, name).copy()
        for name in PARAM_I32:
            p[name] = getattr(e, name).copy()
        for name in PARAM_I64_AS_I32:
            p[name] = getattr(e, name).astype(np.int32)
        p["volume_final"] = np.float32(e.volume_final)
        seg_params.append(p)
        o = {name: getattr(e.ops, name).copy() for name in OPS_FIELDS}
        seg_ops.append(o)
        e.ops.clear()
        e.dirty = False
        mod_passes = max(mod_passes, _mod_passes(e))
        fp = _fused_passes(e)
        fused_passes = None if (fp is None or fused_passes is None) \
            else max(fused_passes, fp)

    snapshot()  # segment 0 ← initial script state
    for k in range(num_blocks):
        seg_of_block[k] = len(seg_params) - 1
        # control for block k+1 happens after block k renders
        e.sample_count += block
        sim.tick(block)
        if e.dirty and k + 1 < num_blocks:
            snapshot()
            seg_is_start[k + 1] = True
    if num_blocks:
        seg_is_start[0] = True

    params = {}
    for name in PARAM_F32 + PARAM_I32 + PARAM_I64_AS_I32:
        params[name] = np.stack([s[name] for s in seg_params])
    params["volume_final"] = np.array(
        [s["volume_final"] for s in seg_params], dtype=np.float32
    )
    ops = {name: np.stack([s[name] for s in seg_ops]) for name in OPS_FIELDS}

    # pack bound tables
    if e.table_list:
        offsets = np.zeros(len(e.table_list), dtype=np.int32)
        off = 0
        for i, t in enumerate(e.table_list):
            offsets[i] = off
            off += t.size
        buffer = np.concatenate([t.astype(np.float32) for t in e.table_list])
    else:
        offsets = np.zeros(1, dtype=np.int32)
        buffer = np.zeros(1, dtype=np.float32)

    return Timeline(
        num_blocks=num_blocks, block=block,
        seg_of_block=seg_of_block, seg_is_start=seg_is_start,
        params=params, ops=ops,
        table_buffer=buffer, table_offsets=offsets,
        table_arrays=list(e.table_list),
        mod_passes=mod_passes, fused_passes=fused_passes, final_engine=e,
    )


def save_timeline(tl: Timeline, path) -> None:
    """Checkpoint a compiled timeline as .npz (SURVEY §5: the reference
    checkpoints state as replayable wire text; we additionally persist the
    compiled event timeline itself)."""
    data = {
        "num_blocks": tl.num_blocks, "block": tl.block,
        "seg_of_block": tl.seg_of_block, "seg_is_start": tl.seg_is_start,
        "table_buffer": tl.table_buffer, "table_offsets": tl.table_offsets,
        "mod_passes": tl.mod_passes,
        "fused_passes": -1 if tl.fused_passes is None else tl.fused_passes,
        "table_sizes": np.array([t.size for t in tl.table_arrays], np.int64),
    }
    for k, v in tl.params.items():
        data["p_" + k] = v
    for k, v in tl.ops.items():
        data["o_" + k] = v
    np.savez_compressed(path, **data)


def load_timeline(path) -> Timeline:
    z = np.load(path)
    params = {k[2:]: z[k] for k in z.files if k.startswith("p_")}
    ops = {k[2:]: z[k] for k in z.files if k.startswith("o_")}
    buf = z["table_buffer"]
    sizes = z["table_sizes"]
    offs = z["table_offsets"]
    tables = [buf[offs[i]: offs[i] + sizes[i]] for i in range(len(sizes))]
    fp = int(z["fused_passes"])
    return Timeline(
        num_blocks=int(z["num_blocks"]), block=int(z["block"]),
        seg_of_block=z["seg_of_block"], seg_is_start=z["seg_is_start"],
        params=params, ops=ops,
        table_buffer=buf, table_offsets=offs, table_arrays=tables,
        mod_passes=int(z["mod_passes"]),
        fused_passes=None if fp < 0 else fp,
        final_engine=None,
    )


def noise_stream(total_samples: int, start: int = 0) -> np.ndarray:
    """The shared per-sample 'whiteish' LCG stream (synth.c:508,525),
    seeded 1 — one draw per sample regardless of voices.  ``start`` jumps
    the stream in O(log start) (affine-map exponentiation)."""
    A = np.uint64(6364136223846793005)
    Cc = np.uint64(1442695040888963407)
    out = np.empty(total_samples, dtype=np.uint64)
    # jump: state after `start` draws from seed 1
    M = (1 << 64) - 1
    a, c = 1, 0                 # identity affine map s -> a*s + c
    pa, pc = 6364136223846793005, 1442695040888963407
    k = start
    while k:
        if k & 1:
            a, c = (pa * a) & M, (pa * c + pc) & M
        pa, pc = (pa * pa) & M, (pa * pc + pc) & M
        k >>= 1
    s = np.uint64((a * 1 + c) & M)
    CHUNK = 65536
    offs_a = np.empty(CHUNK, dtype=np.uint64)
    offs_c = np.empty(CHUNK, dtype=np.uint64)
    a, c = np.uint64(1), np.uint64(0)
    with np.errstate(over="ignore"):
        for t in range(CHUNK):
            a = a * A
            c = c * A + Cc
            offs_a[t] = a
            offs_c[t] = c
        for start in range(0, total_samples, CHUNK):
            m = min(CHUNK, total_samples - start)
            out[start : start + m] = offs_a[:m] * s + offs_c[:m]
            s = out[start + m - 1]
    hi = (out >> np.uint64(32)).astype(np.uint32).astype(np.int32)
    return (hi.astype(np.float32) / np.float32(2147483648.0)).astype(np.float32)
