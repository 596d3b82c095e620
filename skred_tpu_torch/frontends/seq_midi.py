"""ALSA *sequencer* MIDI capture — the reference's plug-and-play model.

The reference's MIDI thread does not read a raw device: it opens an ALSA
sequencer client, creates a named writable port that ANY source can
subscribe to (crossmidi.c:140-176 ``cm_init_linux``: caps
``WRITE|SUBS_WRITE``, so a keyboard or DAW connects with ``aconnect``
without skred naming a device), and converts incoming sequencer events
back to raw MIDI bytes for the callback (crossmidi.c:53-138
``alsa_thread``).  This module reproduces that port model with ctypes
against libasound — no compiled extension:

  * ``seq_event_to_midi`` — sequencer event → raw MIDI bytes, including
    the reference's conversion quirks (see the function docstring).
  * ``AlsaSeqInput`` — a ``MidiBridge`` source: creates the subscribable
    port, optionally ``connect_from`` named sources (the any-source
    subscription), reads events as raw bytes.
  * ``list_ports`` / ``format_ports`` — client/port enumeration for
    ``cli midi-in --list`` (the reference relies on ``aconnect -l``;
    a bundled lister closes the plug-and-play loop).

The ctypes surface is injectable (``lib=``): CI images have no sound
subsystem, so tests drive the bridge end-to-end with a synthetic
in-process sequencer (tests/test_live_midi.py) while real hardware uses
the genuine libasound.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import List, Optional

# ---- ALSA sequencer constants (alsa/seq.h, alsa/seq_event.h) ----
SND_SEQ_OPEN_DUPLEX = 3

SND_SEQ_PORT_CAP_READ = 1 << 0
SND_SEQ_PORT_CAP_WRITE = 1 << 1
SND_SEQ_PORT_CAP_SUBS_READ = 1 << 5
SND_SEQ_PORT_CAP_SUBS_WRITE = 1 << 6

SND_SEQ_PORT_TYPE_MIDI_GENERIC = 1 << 1
SND_SEQ_PORT_TYPE_APPLICATION = 1 << 20

EV_NOTEON = 6
EV_NOTEOFF = 7
EV_KEYPRESS = 8
EV_CONTROLLER = 10
EV_PGMCHANGE = 11
EV_CHANPRESS = 12
EV_PITCHBEND = 13
EV_PORT_SUBSCRIBED = 66
EV_PORT_UNSUBSCRIBED = 67
EV_SYSEX = 130


# ---- snd_seq_event_t layout (alsa/seq_event.h, 64-bit) ----
class SeqAddr(ctypes.Structure):
    _fields_ = [("client", ctypes.c_ubyte), ("port", ctypes.c_ubyte)]


class _EvNote(ctypes.Structure):
    _fields_ = [("channel", ctypes.c_ubyte), ("note", ctypes.c_ubyte),
                ("velocity", ctypes.c_ubyte), ("off_velocity", ctypes.c_ubyte),
                ("duration", ctypes.c_uint)]


class _EvCtrl(ctypes.Structure):
    _fields_ = [("channel", ctypes.c_ubyte), ("unused", ctypes.c_ubyte * 3),
                ("param", ctypes.c_uint), ("value", ctypes.c_int)]


class _EvExt(ctypes.Structure):
    _pack_ = 1                       # snd_seq_ev_ext_t is packed upstream
    _fields_ = [("len", ctypes.c_uint), ("ptr", ctypes.c_void_p)]


class _EvData(ctypes.Union):
    _fields_ = [("note", _EvNote), ("control", _EvCtrl), ("ext", _EvExt),
                ("raw8", ctypes.c_ubyte * 12)]


class SeqEvent(ctypes.Structure):
    _fields_ = [("type", ctypes.c_ubyte), ("flags", ctypes.c_ubyte),
                ("tag", ctypes.c_ubyte), ("queue", ctypes.c_ubyte),
                ("time", ctypes.c_ulonglong),     # union of tick/real
                ("source", SeqAddr), ("dest", SeqAddr),
                ("data", _EvData)]


def seq_event_to_midi(ev: SeqEvent) -> Optional[bytes]:
    """Sequencer event → raw MIDI bytes, exactly as the reference's
    ``alsa_thread`` builds them (crossmidi.c:76-130), quirks included:

    * NoteOn with velocity 0 emits STATUS 0x80 (NoteOff), because the
      reference ORs in 0x10 only when ``type==NOTEON && velocity``
      (crossmidi.c:82-84) — which also means KEYPRESS (poly aftertouch)
      collapses to an 0x80 NoteOff-shaped message rather than 0xA0.
      cmex2's note mapping treats both encodings as note-off anyway.
    * Subscription notifications are skipped (crossmidi.c:66-70).
    * Unknown event types are skipped (crossmidi.c:126-128)."""
    t = ev.type
    if t in (EV_NOTEON, EV_NOTEOFF, EV_KEYPRESS):
        n = ev.data.note
        on = 0x10 if (t == EV_NOTEON and n.velocity) else 0x00
        return bytes([0x80 | (n.channel & 0x0F) | on, n.note, n.velocity])
    if t == EV_CONTROLLER:
        c = ev.data.control
        return bytes([0xB0 | (c.channel & 0x0F), c.param & 0x7F,
                      c.value & 0x7F])
    if t == EV_PGMCHANGE:
        c = ev.data.control
        return bytes([0xC0 | (c.channel & 0x0F), c.value & 0x7F])
    if t == EV_CHANPRESS:
        c = ev.data.control
        return bytes([0xD0 | (c.channel & 0x0F), c.value & 0x7F])
    if t == EV_PITCHBEND:
        c = ev.data.control
        pb = c.value + 8192
        return bytes([0xE0 | (c.channel & 0x0F), pb & 0x7F,
                      (pb >> 7) & 0x7F])
    if t == EV_SYSEX:
        e = ev.data.ext
        if e.len and e.ptr:
            return ctypes.string_at(e.ptr, e.len)
        return None
    return None                      # incl. PORT_(UN)SUBSCRIBED


def open_seq_lib():
    """Load and type the libasound snd_seq_* surface.  Raises
    RuntimeError when ALSA is absent (tests inject a fake instead)."""
    path = ctypes.util.find_library("asound")
    if not path:
        raise RuntimeError(
            "libasound not found — the ALSA sequencer bridge needs it "
            "(rawmidi device strings, pipes and SMF rendering still work)")
    lib = ctypes.CDLL(path)
    lib.snd_seq_open.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                 ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.snd_seq_set_client_name.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.snd_seq_create_simple_port.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint, ctypes.c_uint]
    lib.snd_seq_event_input.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(SeqEvent))]
    lib.snd_seq_connect_from.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]
    lib.snd_seq_client_id.argtypes = [ctypes.c_void_p]
    lib.snd_seq_close.argtypes = [ctypes.c_void_p]
    for f in ("snd_seq_client_info_sizeof", "snd_seq_port_info_sizeof"):
        getattr(lib, f).restype = ctypes.c_size_t
    lib.snd_seq_client_info_get_name.restype = ctypes.c_char_p
    lib.snd_seq_port_info_get_name.restype = ctypes.c_char_p
    return lib


class AlsaSeqInput:
    """Sequencer-client MIDI source (the crossmidi port model): creates
    a subscribable write port named ``name`` — keyboards/DAWs connect to
    it — and optionally subscribes itself to ``connect`` sources
    ("client:port" strings, e.g. from ``list_ports``).  ``read()``
    blocks for the next event and returns its raw MIDI bytes, plugging
    straight into live_midi.MidiBridge."""

    def __init__(self, name: str = "skred_tpu", connect: List[str] = (),
                 lib=None):
        self._lib = lib if lib is not None else open_seq_lib()
        self._seq = ctypes.c_void_p()
        rc = self._lib.snd_seq_open(ctypes.byref(self._seq), b"default",
                                    SND_SEQ_OPEN_DUPLEX, 0)
        if rc < 0:
            raise RuntimeError(f"snd_seq_open failed: {rc}")
        self._lib.snd_seq_set_client_name(self._seq, name.encode())
        self.port = self._lib.snd_seq_create_simple_port(
            self._seq, name.encode(),
            SND_SEQ_PORT_CAP_WRITE | SND_SEQ_PORT_CAP_SUBS_WRITE,
            SND_SEQ_PORT_TYPE_APPLICATION | SND_SEQ_PORT_TYPE_MIDI_GENERIC)
        if self.port < 0:
            self._lib.snd_seq_close(self._seq)
            raise RuntimeError(f"snd_seq_create_simple_port: {self.port}")
        self.client = self._lib.snd_seq_client_id(self._seq)
        for spec in connect or ():
            c, _, p = spec.partition(":")
            rc = self._lib.snd_seq_connect_from(self._seq, self.port,
                                                int(c), int(p or 0))
            if rc < 0:
                raise RuntimeError(f"snd_seq_connect_from({spec}): {rc}")

    def read(self, n: int = 256) -> bytes:
        """Block for the next event; return its raw MIDI bytes (empty on
        error/EOF, like the other sources — the bridge loop then exits).
        Skipped event types (subscriptions, unknowns) are consumed and
        the wait continues, as in crossmidi's thread."""
        ev = ctypes.POINTER(SeqEvent)()
        while True:
            rc = self._lib.snd_seq_event_input(self._seq, ctypes.byref(ev))
            if rc < 0 or not ev:
                return b""
            msg = seq_event_to_midi(ev.contents)
            if msg is not None:
                return msg

    def close(self) -> None:
        if self._seq:
            self._lib.snd_seq_close(self._seq)
            self._seq = None


def list_ports(lib=None) -> List[dict]:
    """Enumerate sequencer clients/ports (what ``aconnect -l`` shows).
    Returns dicts with client/port ids, names, and whether the port is a
    capture source (READ|SUBS_READ: we can ``connect_from`` it)."""
    lib = lib if lib is not None else open_seq_lib()
    seq = ctypes.c_void_p()
    rc = lib.snd_seq_open(ctypes.byref(seq), b"default",
                          SND_SEQ_OPEN_DUPLEX, 0)
    if rc < 0:
        raise RuntimeError(f"snd_seq_open failed: {rc}")
    try:
        cinfo = ctypes.create_string_buffer(
            int(lib.snd_seq_client_info_sizeof()))
        pinfo = ctypes.create_string_buffer(
            int(lib.snd_seq_port_info_sizeof()))
        out = []
        lib.snd_seq_client_info_set_client(cinfo, -1)
        while lib.snd_seq_query_next_client(seq, cinfo) >= 0:
            cid = lib.snd_seq_client_info_get_client(cinfo)
            cname = (lib.snd_seq_client_info_get_name(cinfo) or b"") \
                .decode(errors="replace")
            lib.snd_seq_port_info_set_client(pinfo, cid)
            lib.snd_seq_port_info_set_port(pinfo, -1)
            while lib.snd_seq_query_next_port(seq, pinfo) >= 0:
                caps = lib.snd_seq_port_info_get_capability(pinfo)
                out.append({
                    "client": int(cid),
                    "port": int(lib.snd_seq_port_info_get_port(pinfo)),
                    "client_name": cname,
                    "name": (lib.snd_seq_port_info_get_name(pinfo) or b"")
                    .decode(errors="replace"),
                    "caps": int(caps),
                    "source": bool(caps & SND_SEQ_PORT_CAP_READ
                                   and caps & SND_SEQ_PORT_CAP_SUBS_READ),
                })
        return out
    finally:
        lib.snd_seq_close(seq)


def format_ports(ports: List[dict]) -> str:
    """Human listing for ``cli midi-in --list`` (aconnect -l style)."""
    lines = []
    last_client = None
    for p in ports:
        if p["client"] != last_client:
            lines.append(f"client {p['client']}: '{p['client_name']}'")
            last_client = p["client"]
        tag = " [source]" if p["source"] else ""
        lines.append(f"  {p['client']}:{p['port']:<3d} '{p['name']}'{tag}")
    return "\n".join(lines) if lines else "(no sequencer clients)"
