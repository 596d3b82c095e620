"""Live terminal oscilloscope — animated, trigger-locked view of a
streaming render.

The reference ships a raylib scope process reading a shared-memory ring
at 60 fps with keyboard-set trigger modes and zoom (scope.c:168-375,
ring: scope-shared.h buffer_left/right of 2 s).  skred_tpu renders
offline, so the viewer animates the SAME picture over a streamed render:
chunks from ``render_fused_stream`` feed a 2-second ring, every frame
runs the ported trigger search (host/observe.py:find_start_triggered)
and rasterizes the locked window with unicode half-blocks.

Keys (scope.c:218-239 bindings where they make sense in a terminal):
  z/x/c/v/b  trigger mode (zero-rising / hysteresis / slope / peak / none)
  1 / 2      toggle left / right channel
  + / -      horizontal zoom (mag_x)
  a / A      vertical gain down / up
  q          quit
"""

from __future__ import annotations

import select
import sys
import time
from typing import Iterable, Optional

import numpy as np

from skred_tpu_torch import config as C
from skred_tpu_torch.host.observe import (TRIGGER_NONE, TRIGGER_PEAK,
                                    TRIGGER_ZERO_RISING,
                                    TRIGGER_ZERO_RISING_HYST,
                                    TRIGGER_ZERO_SLOPE,
                                    find_start_triggered)

RING_SAMPLES = C.MAIN_SAMPLE_RATE * 2      # scope-shared.h:6 (2 s)

_MODE_KEYS = {"z": TRIGGER_ZERO_RISING, "x": TRIGGER_ZERO_RISING_HYST,
              "c": TRIGGER_ZERO_SLOPE, "v": TRIGGER_PEAK, "b": TRIGGER_NONE}
_MODE_NAMES = {TRIGGER_NONE: "none", TRIGGER_ZERO_RISING: "zero-rise",
               TRIGGER_ZERO_RISING_HYST: "hysteresis",
               TRIGGER_ZERO_SLOPE: "slope", TRIGGER_PEAK: "peak"}


def render_frame(window: np.ndarray, rows: int = 20, cols: int = 80,
                 show_l: bool = True, show_r: bool = True,
                 gain: float = 1.0) -> list:
    """Rasterize a trigger-locked stereo window [N, 2] into ``rows``
    text lines of ``cols`` characters (pure function — testable).

    Each column shows the min..max vertical span of its sample bucket
    (the reference draws per-pixel line segments; min/max spans are the
    terminal equivalent), left channel '|', right ':', overlap '#'."""
    window = np.asarray(window, np.float32)
    n = len(window)
    grid = [[" "] * cols for _ in range(rows)]
    mid = (rows - 1) / 2.0

    def paint(ch_data, mark):
        # per-column min/max envelope
        for x in range(cols):
            a = int(x * n / cols)
            b = max(int((x + 1) * n / cols), a + 1)
            seg = ch_data[a:b] * gain
            y0 = int(round(mid - np.clip(seg.max(), -1, 1) * mid))
            y1 = int(round(mid - np.clip(seg.min(), -1, 1) * mid))
            for y in range(max(y0, 0), min(y1, rows - 1) + 1):
                cell = grid[y][x]
                grid[y][x] = "#" if cell not in (" ", mark) else mark

    if show_l:
        paint(window[:, 0], "|")
    if show_r:
        paint(window[:, 1], ":")
    # zero axis
    zy = int(round(mid))
    for x in range(cols):
        if grid[zy][x] == " ":
            grid[zy][x] = "-"
    return ["".join(r) for r in grid]


class ScopeRing:
    """The scope's shared-memory ring (scope-shared.h), fed by render
    chunks instead of the audio callback."""

    def __init__(self, size: int = RING_SAMPLES):
        self.buf = np.zeros((size, 2), np.float32)
        self.write_ptr = 0
        self.total = 0

    def push(self, chunk: np.ndarray) -> None:
        chunk = np.asarray(chunk, np.float32)
        n = len(chunk)
        size = len(self.buf)
        if n >= size:
            self.buf[:] = chunk[-size:]
            self.write_ptr = 0
        else:
            end = self.write_ptr + n
            if end <= size:
                self.buf[self.write_ptr:end] = chunk
            else:
                k = size - self.write_ptr
                self.buf[self.write_ptr:] = chunk[:k]
                self.buf[:end - size] = chunk[k:]
            self.write_ptr = end % size
        self.total += n

    def window(self, width: int, mode: int) -> np.ndarray:
        """Trigger-locked window ending at the write pointer."""
        start = find_start_triggered(self.buf[:, 0], self.buf[:, 1],
                                     self.write_ptr, width, mode)
        idx = (start + np.arange(width)) % len(self.buf)
        return self.buf[idx]


class _Keys:
    """Non-blocking single-key reads; inert when stdin isn't a tty."""

    def __init__(self):
        self.enabled = sys.stdin.isatty()
        self._saved = None
        if self.enabled:
            import termios
            import tty

            self._saved = termios.tcgetattr(sys.stdin.fileno())
            tty.setcbreak(sys.stdin.fileno())

    def poll(self) -> Optional[str]:
        if not self.enabled:
            return None
        r, _, _ = select.select([sys.stdin], [], [], 0)
        return sys.stdin.read(1) if r else None

    def restore(self) -> None:
        if self._saved is not None:
            import termios

            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN,
                              self._saved)


class ScopeViewer:
    """Animate a chunk stream: push → trigger → rasterize, one frame per
    step.  ``frames`` collects the last rasterization for tests."""

    def __init__(self, rows: int = 20, cols: int = 80,
                 mode: int = TRIGGER_ZERO_RISING, window: int = 2048):
        self.ring = ScopeRing()
        self.rows = rows
        self.cols = cols
        self.mode = mode
        self.window = window          # samples per screen (mag_x analog)
        self.show_l = True
        self.show_r = True
        self.gain = 1.0
        self.last_frame: list = []

    def handle_key(self, k: str) -> bool:
        """Apply one scope.c key binding; returns False on quit."""
        if k == "q":
            return False
        if k in _MODE_KEYS:
            self.mode = _MODE_KEYS[k]
        elif k == "1":
            self.show_l = not self.show_l
        elif k == "2":
            self.show_r = not self.show_r
        elif k == "+":
            self.window = max(self.window // 2, 64)
        elif k == "-":
            self.window = min(self.window * 2, RING_SAMPLES // 2)
        elif k == "a":
            self.gain = max(self.gain - 0.1, 0.1)
        elif k == "A":
            self.gain += 0.1
        return True

    def step(self, chunk: np.ndarray) -> list:
        self.ring.push(chunk)
        win = self.ring.window(self.window, self.mode)
        self.last_frame = render_frame(win, self.rows, self.cols,
                                       self.show_l, self.show_r, self.gain)
        return self.last_frame

    def status(self) -> str:
        t = self.ring.total / C.MAIN_SAMPLE_RATE
        return (f" t={t:7.2f}s  trig={_MODE_NAMES[self.mode]:10s} "
                f"win={self.window}  L={'on' if self.show_l else 'off'} "
                f"R={'on' if self.show_r else 'off'}  gain={self.gain:.1f} "
                f"[zxcvb trig, 12 ch, +- zoom, aA gain, q quit]")


def animate(chunks: Iterable[np.ndarray], fps: float = 30.0,
            realtime: bool = True, viewer: Optional[ScopeViewer] = None,
            out=sys.stdout, max_frames: Optional[int] = None) -> ScopeViewer:
    """Drive the viewer over a chunk iterator.  ``realtime`` paces the
    animation to the audio clock (the render is typically much faster);
    otherwise frames advance as fast as chunks arrive."""
    v = viewer or ScopeViewer()
    keys = _Keys()
    frame_t = 1.0 / fps
    shown = 0
    t0 = time.time()
    try:
        out.write("\x1b[2J")          # clear
        for chunk in chunks:
            # sub-divide the chunk so the animation stays smooth even
            # with big render chunks
            per = max(int(C.MAIN_SAMPLE_RATE * frame_t), 1)
            for i in range(0, len(chunk), per):
                sub = chunk[i:i + per]
                v.step(sub)
                k = keys.poll()
                if k is not None and not v.handle_key(k):
                    return v
                out.write("\x1b[H")   # home
                out.write("\n".join(v.last_frame))
                out.write("\n" + v.status() + "\n")
                out.flush()
                shown += 1
                if max_frames is not None and shown >= max_frames:
                    return v
                if realtime:
                    target = t0 + v.ring.total / C.MAIN_SAMPLE_RATE
                    delay = target - time.time()
                    if delay > 0:
                        time.sleep(min(delay, frame_t))
    finally:
        keys.restore()
    return v


def main(script: str, seconds: float = 10.0, fps: float = 30.0,
         realtime: bool = True, window: int = 2048, device="cuda") -> int:
    """``python -m skred_tpu_torch.cli scope SCRIPT.sk`` — trigger-locked
    animation of a streaming render (the scope process, sans raylib),
    rendered on the card unless ``device="cpu"``."""
    import pathlib

    from skred_tpu_torch.assets import WaveBank
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import stack_timelines

    p = pathlib.Path(script)
    tl = compile_script(p.read_text().splitlines(), seconds,
                        bank=WaveBank(), script_dir=p.resolve().parent)
    st = stack_timelines([tl])

    def chunks():
        if tl.fused_passes is not None:
            from skred_tpu_torch.engine.fused import render_fused_stream

            for c in render_fused_stream(st, chunk_blocks=16,
                                         device=device):
                yield c[0]
        else:
            from skred_tpu_torch.engine import render_timeline

            yield render_timeline(tl, device=device)

    animate(chunks(), fps=fps, realtime=realtime,
            viewer=ScopeViewer(window=window))
    return 0
