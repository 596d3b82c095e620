"""Live MIDI input bridge — hardware keyboard → wire session.

The reference runs a live MIDI thread translating NoteOn/NoteOff into
wire text over UDP (crossmidi.c:354 ``CM_initialize`` opens an ALSA
sequencer port on Linux; cmex2.c:46-63 does the note→wire mapping and
``udp_send``s to skred on port 60440).  This module is the same bridge
for skred_tpu:

  * ``MidiByteParser`` — incremental raw MIDI byte-stream parser
    (running status, real-time bytes interleaved mid-message, sysex).
  * ``cmex2_wire`` — the reference's exact note→wire mapping.
  * ``AlsaRawMidiInput`` — a hardware port opened with ctypes against
    libasound (snd_rawmidi_open/read); no compiled extension needed.
  * ``StreamMidiInput`` — the same byte protocol from any readable fd
    (a named pipe, ``/dev/midi*``, or a test's synthetic stream).
  * ``MidiBridge`` — pulls bytes, parses, maps, sends wire lines (by
    default over UDP to frontends/udp.py's server, exactly like cmex2).

A musician with a keyboard runs::

    python -m skred_tpu_torch.cli serve &          # UDP wire server
    python -m skred_tpu_torch.cli midi-in --port hw:1,0

and plays; a timed capture (frontends.controllers.TimedCapture) turns
the performance into a renderable script.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading
from typing import Callable, Iterator, List, Optional

# status-byte payload lengths (crossmidi's callback always receives
# complete messages; we reassemble them from the raw byte stream)
_LEN = {0x80: 2, 0x90: 2, 0xA0: 2, 0xB0: 2, 0xC0: 1, 0xD0: 1, 0xE0: 2}


class MidiByteParser:
    """Incremental raw MIDI parser: feed arbitrary byte chunks, get
    complete channel messages.  Handles running status (status byte
    omitted on repeat), real-time bytes (0xF8-0xFF) interleaved inside
    messages, and skips sysex bodies (cmex2 only logs sysex)."""

    def __init__(self) -> None:
        self._status = 0
        self._buf: List[int] = []
        self._in_sysex = False

    def feed(self, data: bytes) -> Iterator[bytes]:
        for b in data:
            if b >= 0xF8:                  # real-time: never interrupts
                continue
            if self._in_sysex:
                if b == 0xF7:
                    self._in_sysex = False
                continue
            if b & 0x80:                   # status byte
                if b == 0xF0:
                    self._in_sysex = True
                    continue
                if b >= 0xF0:              # other system common: reset
                    self._status = 0
                    self._buf = []
                    continue
                self._status = b
                self._buf = []
                continue
            if not self._status:
                continue                   # data byte with no status: junk
            self._buf.append(b)
            need = _LEN[self._status & 0xF0]
            if len(self._buf) == need:
                msg = bytes([self._status, *self._buf])
                self._buf = []             # running status stays armed
                yield msg


def cmex2_wire(msg: bytes, voice_offset: int = 0) -> Optional[str]:
    """The reference bridge's message→wire mapping (cmex2.c:46-63):
    NoteOn → ``v{ch} n{note} l1``; NoteOff (0x80, or 0x90 with velocity
    0) → ``v{ch} l0``.  CC/program/pitchbend are logged upstream but send
    nothing; returns None for them."""
    kind = msg[0] & 0xF0
    ch = (msg[0] & 0x0F) + voice_offset
    if kind == 0x90 and len(msg) >= 3 and msg[2] > 0:
        return f"v{ch} n{msg[1]} l1"
    if kind == 0x80 or (kind == 0x90 and len(msg) >= 3 and msg[2] == 0):
        return f"v{ch} l0"
    return None


class StreamMidiInput:
    """MIDI bytes from any readable file descriptor — a named pipe fed
    by another process, a ``/dev/midi*`` OSS-style device node, or a
    test's synthetic stream."""

    def __init__(self, fd: int):
        self.fd = fd

    def read(self, n: int = 256) -> bytes:
        try:
            return os.read(self.fd, n)
        except OSError:
            return b""

    def close(self) -> None:
        try:
            os.close(self.fd)
        except OSError:
            pass


class AlsaRawMidiInput:
    """Hardware MIDI port via ALSA rawmidi, bound with ctypes (the
    offline-friendly analog of crossmidi.c's sequencer thread: same
    bytes, no compiled extension).  ``port`` is an ALSA device string
    like ``hw:1,0`` or ``virtual``."""

    def __init__(self, port: str = "hw:0,0"):
        path = ctypes.util.find_library("asound")
        if not path:
            raise RuntimeError(
                "libasound not found — live MIDI capture needs ALSA "
                "(the SMF path and the UDP wire input work without it)")
        self._lib = ctypes.CDLL(path)
        self._lib.snd_rawmidi_open.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_char_p, ctypes.c_int]
        self._lib.snd_rawmidi_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        self._lib.snd_rawmidi_read.restype = ctypes.c_ssize_t
        self._handle = ctypes.c_void_p()
        rc = self._lib.snd_rawmidi_open(
            ctypes.byref(self._handle), None, port.encode(), 0)
        if rc < 0:
            raise RuntimeError(f"snd_rawmidi_open({port!r}) failed: {rc}")

    def read(self, n: int = 256) -> bytes:
        buf = ctypes.create_string_buffer(n)
        got = self._lib.snd_rawmidi_read(self._handle, buf, n)
        return buf.raw[:got] if got > 0 else b""

    def close(self) -> None:
        if self._handle:
            self._lib.snd_rawmidi_close(self._handle)
            self._handle = None


class MidiBridge:
    """Pump a MIDI input into a wire sink (cmex2's main loop).

    ``send`` is any callable taking a wire line — a
    ``controllers.WireClient.send`` for the UDP server (the reference
    topology), or a ``WireContext`` feed for in-process use."""

    def __init__(self, source, send: Callable[[str], None],
                 voice_offset: int = 0, echo: bool = False):
        self.source = source
        self.send = send
        self.parser = MidiByteParser()
        self.voice_offset = voice_offset
        self.echo = echo
        self._stop = threading.Event()
        self.sent: int = 0

    def pump_once(self, n: int = 256) -> int:
        """Read once, translate, send; returns wire lines sent (0 on
        EOF/no data)."""
        data = self.source.read(n)
        if not data:
            return 0
        sent = 0
        for msg in self.parser.feed(data):
            line = cmex2_wire(msg, self.voice_offset)
            if line is not None:
                if self.echo:
                    print(f"  {msg.hex(' ')} -> {line}")
                self.send(line)
                sent += 1
        self.sent += sent
        return sent

    def run(self) -> None:
        """Blocking pump loop until ``stop()`` or EOF."""
        while not self._stop.is_set():
            data = self.source.read(256)
            if not data:
                break
            for msg in self.parser.feed(data):
                line = cmex2_wire(msg, self.voice_offset)
                if line is not None:
                    if self.echo:
                        print(f"  {msg.hex(' ')} -> {line}")
                    self.send(line)
                    self.sent += 1

    def stop(self) -> None:
        self._stop.set()


def open_input(port: str, connect=()):
    """``seq`` → ALSA sequencer client (the reference's plug-and-play
    port model: a subscribable destination plus optional ``connect``
    subscriptions — frontends/seq_midi.py); ``hw:…``/``virtual`` → ALSA
    rawmidi; anything else is treated as a path to a pipe/device file
    readable as a raw byte stream."""
    if port == "seq" or port.startswith("seq:"):
        from skred_tpu_torch.frontends.seq_midi import AlsaSeqInput

        name = port[4:] or "skred_tpu"
        return AlsaSeqInput(name=name, connect=connect)
    if port.startswith(("hw:", "default", "virtual")):
        return AlsaRawMidiInput(port)
    return StreamMidiInput(os.open(port, os.O_RDONLY))


def main(port: str, host: str = "127.0.0.1", udp_port: int = 60440,
         voice_offset: int = 0, connect=()) -> int:
    from skred_tpu_torch.frontends.controllers import WireClient

    client = WireClient(host, udp_port)
    src = open_input(port, connect)
    bridge = MidiBridge(src, client.send, voice_offset, echo=True)
    print(f"# midi-in: {port} -> {host}:{udp_port} (NoteOn/Off -> wire)")
    try:
        bridge.run()
    except KeyboardInterrupt:
        pass
    finally:
        src.close()
        client.close()
    print(f"# midi-in: {bridge.sent} wire lines sent")
    return 0
