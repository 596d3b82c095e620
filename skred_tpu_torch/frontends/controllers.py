"""Headless controller equivalents of the reference's Tcl/Tk tools.

The reference ships GUI controllers that all do the same thing: format a
value into a wire-protocol string and send it over UDP to port 60440
(reference: fire:1-80 — generic slider with ``min max step fmt``;
amper/freqer/czer/panner — fire wrappers with ``a%s``/``f%s``/``c1,%s``/
``p%s`` formats; fourby/keys/pads — 4×4 trigger-pad grids sending stored
wire programs; adsr — envelope editor emitting ``E`` atoms; notes/tune/
dreammachine — algorithmic senders looping over note grids).

Here the same controls are plain Python objects: scriptable, testable,
and usable both live (against frontends/udp.py or the reference binary)
and offline (capturing a timed performance into a renderable script via
the defer queue)."""

from __future__ import annotations

import dataclasses
import socket
import time
from typing import Callable, List, Optional, Sequence, Tuple


class WireClient:
    """Minimal UDP wire-text sender (reference: udpmini.c:10-40)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 60440):
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(self, line: str) -> None:
        self.sock.sendto(line.encode(), self.addr)

    def close(self) -> None:
        self.sock.close()


@dataclasses.dataclass
class Slider:
    """fire's slider semantics: clamp to [lo, hi], snap to step, format.

    Reference: ``wish fire 0 20 .0001 a%s 0 "amper"`` — amper/freqer/
    czer/panner are such wrappers (fire:1-80)."""

    lo: float
    hi: float
    step: float
    fmt: str                      # printf-style, e.g. "a%s", "c1,%s"
    value: float = 0.0
    send: Optional[Callable[[str], None]] = None

    def set(self, value: float) -> str:
        v = min(max(value, self.lo), self.hi)
        if self.step > 0:
            v = self.lo + round((v - self.lo) / self.step) * self.step
            v = min(max(v, self.lo), self.hi)
        self.value = v
        line = self.fmt % format(v, "g")
        if self.send:
            self.send(line)
        return line


def amper(**kw) -> Slider:
    return Slider(0, 20, 0.0001, "a%s", **kw)


def freqer(**kw) -> Slider:
    return Slider(10, 1870, 0.0001, "f%s", **kw)


def czer(**kw) -> Slider:
    return Slider(0, 1, 0.00001, "c1,%s", **kw)


def panner(**kw) -> Slider:
    return Slider(-1, 1, 0.001, "p%s", **kw)


@dataclasses.dataclass
class PadGrid:
    """fourby/keys/pads: N stored wire programs fired by index; toggling
    a pad down sends its program, toggling it up sends the pattern-clear
    (reference: fourby toggle → ``[p{pat} .{n}]`` / program)."""

    programs: Sequence[str]
    pattern: int = 0
    send: Optional[Callable[[str], None]] = None

    def __post_init__(self):
        self.down = [False] * len(self.programs)

    def toggle(self, n: int) -> str:
        self.down[n] = not self.down[n]
        line = (self.programs[n] if self.down[n]
                else f"[p{self.pattern} .{n}]")
        if self.send:
            self.send(line)
        return line


def adsr_text(attack: float, decay: float, sustain: float,
              release: float) -> str:
    """The adsr editor's output: an ``E`` envelope atom (wire.c `E`,
    seconds/level CSV, e.g. ``E.2,.1,.2,.5``)."""
    f = lambda x: format(x, "g").lstrip("0") or "0"
    return f"E{f(attack)},{f(decay)},{f(sustain)},{f(release)}"


def note_cycle(voices: Tuple[int, int] = (0, 1), lo: int = 9, hi: int = 69,
               step: int = 12, detune: float = 0.2) -> List[str]:
    """One sweep of the `notes`/`tune` senders: walk a note grid an
    octave at a time, alternating a voice pair with a slight detune on
    the second (reference notes:24-45)."""
    a, b = voices
    out = []
    for i in range(lo, hi + 1, step):
        out.append(f"[ v{a} n{i + 12} v{b} n{i + 12 + detune} ]")
    return out


def timed_to_script(events: Sequence[Tuple[float, str]]) -> List[str]:
    """Capture a timed live performance as an offline-renderable script.

    Each (seconds, wire_line) event becomes a deferred program: ``~T``
    defers T seconds through the engine's 1024-slot queue (wire.c
    :869-892), quantized to callback blocks exactly like live input —
    so a captured session replayed through ``compile_script`` reproduces
    the performance deterministically."""
    lines = []
    for t, line in sorted(events, key=lambda e: e[0]):
        body = line.strip()
        if body.startswith("[") and body.endswith("]"):
            body = body[1:-1].strip()
        if t <= 0:
            lines.append(f"[ {body} ]")
        else:
            lines.append(f"~{format(t, 'g')}[{body}]")
    return lines


def record_session(lines: Sequence[str], spacing: float = 0.5,
                   client: Optional[WireClient] = None,
                   clock: Callable[[], float] = time.monotonic,
                   sleep: Callable[[float], None] = time.sleep,
                   ) -> List[Tuple[float, str]]:
    """Send lines live (if a client is given) while capturing timestamps —
    the bridge from a `notes`-style sender loop to an offline script."""
    t0 = clock()
    events = []
    for line in lines:
        events.append((clock() - t0, line))
        if client:
            client.send(line)
        if spacing:
            sleep(spacing)
    return events
