"""MIDI → wire bridge.

The reference ships `crossmidi`/`cmex2`: a live MIDI thread translating
NoteOn/NoteOff to wire text over UDP — ``v{ch} n{note} l1`` / ``v{ch} l0``
(reference: cmex2.c:46-63).  Offline, the same mapping applies to
Standard MIDI Files: `midi_events()` parses an SMF (format 0/1, tempo
map honored) into time-stamped wire lines that the timeline compiler
schedules exactly like deferred events.

Live use is still available: any MIDI-capable host can keep sending the
same wire text to the UDP frontend (frontends/udp.py, port 60440).
"""

from __future__ import annotations

import pathlib
import struct
from typing import List, Tuple


def _read_varlen(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


def parse_smf(path) -> Tuple[int, List[List[Tuple[int, bytes]]]]:
    """Parse a Standard MIDI File → (division, tracks of (tick, event))."""
    data = pathlib.Path(path).read_bytes()
    if data[:4] != b"MThd":
        raise ValueError("not a MIDI file")
    hlen, fmt, ntrk, division = struct.unpack(">IHHH", data[4:14])
    pos = 8 + hlen
    tracks = []
    for _ in range(ntrk):
        if data[pos : pos + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        tlen = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
        tpos = pos + 8
        end = tpos + tlen
        pos = end
        events = []
        tick = 0
        running = 0
        while tpos < end:
            delta, tpos = _read_varlen(data, tpos)
            tick += delta
            b = data[tpos]
            if b == 0xFF:                       # meta
                mtype = data[tpos + 1]
                mlen, npos = _read_varlen(data, tpos + 2)
                events.append((tick, data[tpos : npos + mlen]))
                tpos = npos + mlen
            elif b in (0xF0, 0xF7):             # sysex
                mlen, npos = _read_varlen(data, tpos + 1)
                tpos = npos + mlen
            else:
                if b & 0x80:
                    running = b
                    tpos += 1
                status = running
                kind = status & 0xF0
                nbytes = 1 if kind in (0xC0, 0xD0) else 2
                ev = bytes([status]) + data[tpos : tpos + nbytes]
                tpos += nbytes
                events.append((tick, ev))
        tracks.append(events)
    return division, tracks


def midi_events(path, voice_offset: int = 0) -> List[Tuple[float, str]]:
    """SMF → [(seconds, wire_line)] with the cmex2 mapping
    (NoteOn → ``v{ch} n{note} l1``, NoteOff → ``v{ch} l0``)."""
    division, tracks = parse_smf(path)
    # merge tracks, honoring tempo metas (default 500000 µs/quarter)
    merged = sorted(
        (tick, ev) for track in tracks for tick, ev in track)
    out = []
    tempo = 500000
    last_tick = 0
    seconds = 0.0
    for tick, ev in merged:
        seconds += (tick - last_tick) / division * tempo / 1e6
        last_tick = tick
        if ev[0] == 0xFF:
            if ev[1] == 0x51 and len(ev) >= 6:   # set tempo
                tempo = int.from_bytes(ev[3:6], "big")
            continue
        kind = ev[0] & 0xF0
        ch = (ev[0] & 0x0F) + voice_offset
        if kind == 0x90 and len(ev) >= 3 and ev[2] > 0:
            out.append((seconds, f"v{ch} n{ev[1]} l1"))
        elif kind == 0x80 or (kind == 0x90 and len(ev) >= 3 and ev[2] == 0):
            out.append((seconds, f"v{ch} l0"))
    return out
