"""Pixel-rendered oscilloscope frames — the raylib scope's picture as
PNG artifacts.

The reference scope process draws an 800x480 raylib window at 60 fps
(scope.c:168-375): a trigger-locked dot-per-pixel trace of each channel,
a dark-green zero axis, and the pre-trigger offset of 1/8 screen width
(scope.c:299-300).  skred_tpu renders offline, so the equivalent is a
frame EXPORT: the same ring + trigger search as the terminal viewer
(scope_view.py), rasterized into RGB pixels and written as PNG — either
one frame or a filmstrip of the render.

Faithfully preserved reference behaviors:
  * geometry: 800x480 (scope-shared.h:7-8), y grows downward, positive
    samples draw BELOW the axis (raylib coordinates, scope.c:327-339);
  * the CHANNEL COLOR SWAP: the left trace is drawn with ``color_right``
    (yellow) and the right trace with ``color_left`` (cyan) —
    scope.c:328/338 pass the opposite channel's Color;
  * 128/255 alpha blending of the traces over black, 1-px-radius dots
    (a plus-shaped 5-pixel stamp);
  * trigger start minus SCOPE_WIDTH_IN_PIXELS/8 pre-roll.

The PNG writer is self-contained (zlib + struct): no imaging deps.
"""

from __future__ import annotations

import pathlib
import struct
import zlib
from typing import Iterable, Optional

import numpy as np

from skred_tpu_torch import config as C
from skred_tpu_torch.frontends.scope_view import RING_SAMPLES, ScopeRing
from skred_tpu_torch.host.observe import TRIGGER_ZERO_RISING

WIDTH = 800                      # scope-shared.h:7
HEIGHT = 480                     # scope-shared.h:8
_YELLOW = (255, 255, 0)          # color_right — draws the LEFT trace
_CYAN = (0, 255, 255)            # color_left  — draws the RIGHT trace
_DARKGREEN = (0, 117, 44)        # raylib DARKGREEN
_ALPHA = 128 / 255.0


def _stamp(img: np.ndarray, xs: np.ndarray, ys: np.ndarray,
           color: tuple) -> None:
    """Alpha-blend 1-px-radius dots (plus-shaped stamp) at (xs, ys)."""
    h, w, _ = img.shape
    col = np.asarray(color, np.float32) * _ALPHA
    for dx, dy in ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)):
        x = xs + dx
        y = ys + dy
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        xi, yi = x[ok], y[ok]
        img[yi, xi] = np.clip(
            img[yi, xi].astype(np.float32) * (1.0 - _ALPHA) + col,
            0, 255).astype(np.uint8)


def render_pixels(window: np.ndarray, width: int = WIDTH,
                  height: int = HEIGHT, show_l: bool = True,
                  show_r: bool = True, gain: float = 1.0) -> np.ndarray:
    """Rasterize a trigger-locked stereo window [N, 2] into an RGB
    frame [height, width, 3] the way the reference scope draws it:
    one dot per pixel column, y = sample·(height/2) below the axis,
    left trace yellow / right cyan (the reference's color swap)."""
    window = np.asarray(window, np.float32)
    img = np.zeros((height, width, 3), np.uint8)
    h0 = height / 2.0
    # zero axis (DrawLine(0, 0, sw, 0, DARKGREEN) after the h0 translate)
    img[int(h0), :] = _DARKGREEN
    n = len(window)
    cols = min(width, n)
    xs = np.arange(cols, dtype=np.int64)
    idx = xs % max(n, 1)

    def trace(ch: np.ndarray, color: tuple) -> None:
        ys = (h0 + ch[idx] * gain * h0).astype(np.int64)
        _stamp(img, xs, ys, color)

    if show_l:
        trace(window[:, 0], _YELLOW)       # scope.c:328 color_right
    if show_r:
        trace(window[:, 1], _CYAN)         # scope.c:338 color_left
    return img


def write_png(path, rgb: np.ndarray) -> None:
    """Minimal PNG encoder: 8-bit RGB, no filter, zlib default level."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    pathlib.Path(path).write_bytes(png)


def scope_frames(chunks: Iterable[np.ndarray], n_frames: int,
                 mode: int = TRIGGER_ZERO_RISING, width: int = WIDTH,
                 height: int = HEIGHT, gain: float = 1.0,
                 frame_every: Optional[int] = None) -> list:
    """Feed a chunk stream through the scope ring and capture ``n_frames``
    trigger-locked pixel frames, evenly spaced over the stream.  The
    window start is the trigger hit minus width/8 samples — the
    reference's pre-roll (scope.c:299-300)."""
    from skred_tpu_torch.host.observe import find_start_triggered

    ring = ScopeRing()
    frames = []
    fed = 0
    per = frame_every or max(C.MAIN_SAMPLE_RATE // 4, 1)
    next_at = per
    for chunk in chunks:
        ring.push(np.asarray(chunk, np.float32))
        fed += len(chunk)
        while fed >= next_at and len(frames) < n_frames:
            start = find_start_triggered(
                ring.buf[:, 0], ring.buf[:, 1], ring.write_ptr, width, mode)
            start = (start - width // 8) % RING_SAMPLES
            idx = (start + np.arange(width)) % RING_SAMPLES
            frames.append(render_pixels(ring.buf[idx], width, height,
                                        gain=gain))
            next_at += per
        if len(frames) >= n_frames:
            break
    while len(frames) < n_frames:
        start = find_start_triggered(
            ring.buf[:, 0], ring.buf[:, 1], ring.write_ptr, width, mode)
        start = (start - width // 8) % RING_SAMPLES
        idx = (start + np.arange(width)) % RING_SAMPLES
        frames.append(render_pixels(ring.buf[idx], width, height, gain=gain))
    return frames


def export_png(script: str, out: str, seconds: float = 10.0,
               n_frames: int = 1, mode: int = TRIGGER_ZERO_RISING,
               gain: float = 1.0, device="cuda") -> int:
    """Render ``script`` and write the scope picture to ``out``: a single
    800x480 frame, or (n_frames > 1) a vertical filmstrip of frames
    spaced evenly across the render.  Renders on the card unless
    ``device="cpu"``."""
    from skred_tpu_torch.assets import WaveBank
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import stack_timelines

    p = pathlib.Path(script)
    tl = compile_script(p.read_text().splitlines(), seconds,
                        bank=WaveBank(), script_dir=p.resolve().parent)

    def chunks():
        if tl.fused_passes is not None:
            from skred_tpu_torch.engine.fused import render_fused_stream

            for c in render_fused_stream(stack_timelines([tl]),
                                         chunk_blocks=32, device=device):
                yield c[0]
        else:
            from skred_tpu_torch.engine import render_timeline

            yield render_timeline(tl, device=device)

    total = tl.num_blocks * tl.block
    every = max(total // max(n_frames, 1), 1)
    frames = scope_frames(chunks(), n_frames, mode=mode, gain=gain,
                          frame_every=every)
    strip = frames[0] if len(frames) == 1 else np.concatenate(frames, axis=0)
    write_png(out, strip)
    print(f"# wrote {out}: {strip.shape[1]}x{strip.shape[0]} "
          f"({len(frames)} frame{'s' if len(frames) != 1 else ''})")
    return 0
