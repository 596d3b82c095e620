"""Terminal CZ phase-distortion curve viewer.

The reference ships two Tk sketches (`cz_show`, `cz_distortion_tcltk`,
the reference's cz_show:1-50) that plot *prototype* distortion curves —
re-implementations that drifted from the engine.  This viewer plots the
ENGINE's own warp instead: `engine.numerics.cz_phasor` is a pure
function (the same code path the engines' plain versions run, and the
card's kernels are held to them bit for bit), so what you see is what
the synth plays (reference curve source: synth.c:149-215).

Pure rasterizer (`curve_frame`) + CLI entry (`cli.py cz-show`):

    skred-tpu cz-show                 # all 7 modes at d=0.5
    skred-tpu cz-show --mode 2 --d 0.25 0.5 0.9   # one mode, d sweep
    skred-tpu cz-show --wave w0       # warped waveform, not the curve
"""

from typing import List, Optional, Sequence

import numpy as np

MODE_NAMES = {
    1: "saw (breakpoint)",
    2: "square (half squeeze)",
    3: "pulse (half shift)",
    4: "double (2x fold)",
    5: "reso (half+soft)",
    6: "pow 1+4d",
    7: "pow 1+8d",
}

_MARKS = "|:*+ox#"


def warp_curve(mode: int, d: float, tsize: int = 1024,
               points: int = 256) -> np.ndarray:
    """The engine's warped table index for ``points`` phases spanning
    one cycle, normalized to [0, 1).  Evaluated with the exact same
    `cz_phasor` the engines' plain versions render with
    (engine/numerics.py), on the CPU: a few hundred elementwise
    operations are never worth a card."""
    import torch
    from skred_tpu_torch.engine.numerics import cz_phasor
    ph = (np.arange(points, dtype=np.float32) / points) * tsize
    cpu = torch.device("cpu")
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=cpu)
    out = cz_phasor(torch.tensor(mode, dtype=torch.int32, device=cpu),
                    torch.as_tensor(ph, device=cpu), f32(d), f32(tsize),
                    modes=(mode,))
    return out.numpy().astype(np.float32) / float(tsize)


def curve_frame(curves: Sequence[np.ndarray], labels: Sequence[str],
                rows: int = 17, cols: int = 64) -> List[str]:
    """Rasterize normalized-[0,1] curves into text lines (pure —
    testable).  Curve k draws with mark _MARKS[k]; overlap '@'.  A
    dotted identity diagonal shows where warp == no distortion."""
    grid = [[" "] * cols for _ in range(rows)]
    # identity diagonal (phase == index): the undistorted reference line
    for x in range(cols):
        y = rows - 1 - int(round(x / max(cols - 1, 1) * (rows - 1)))
        grid[y][x] = "."
    for k, cur in enumerate(curves):
        mark = _MARKS[k % len(_MARKS)]
        n = len(cur)
        for x in range(cols):
            a = int(x * n / cols)
            b = max(int((x + 1) * n / cols), a + 1)
            seg = np.clip(cur[a:b], 0.0, 1.0)
            y0 = rows - 1 - int(round(float(seg.max()) * (rows - 1)))
            y1 = rows - 1 - int(round(float(seg.min()) * (rows - 1)))
            for y in range(max(y0, 0), min(y1, rows - 1) + 1):
                cell = grid[y][x]
                grid[y][x] = mark if cell in (" ", ".", mark) else "@"
    lines = ["".join(r) for r in grid]
    legend = "   ".join(f"{_MARKS[k % len(_MARKS)]} {lab}"
                        for k, lab in enumerate(labels))
    return lines + [legend[:cols * 2]]


def wave_frame(mode: int, d: float, table: np.ndarray,
               rows: int = 17, cols: int = 64) -> List[str]:
    """The warped WAVEFORM: table[warp(phase)] over one cycle, drawn
    with the scope's min/max envelope rasterizer."""
    from skred_tpu_torch.frontends.scope_view import render_frame
    tsize = len(table)
    idx = np.clip((warp_curve(mode, d, tsize, points=tsize) * tsize)
                  .astype(np.int64), 0, tsize - 1)
    w = table[idx].astype(np.float32)
    return render_frame(np.stack([w, w], axis=-1), rows=rows, cols=cols,
                        show_l=True, show_r=False)


def show(modes: Optional[Sequence[int]] = None,
         dists: Sequence[float] = (0.5,), tsize: int = 1024,
         rows: int = 17, cols: int = 64,
         wave: Optional[str] = None, bank=None,
         out=None) -> None:
    """Print curve (or waveform) frames for each requested mode."""
    import sys
    out = out or sys.stdout
    modes = list(modes) if modes else sorted(MODE_NAMES)
    for m in modes:
        name = MODE_NAMES.get(m, "?")
        print(f"-- cz mode {m} ({name}), tsize={tsize} --", file=out)
        if wave is not None:
            from skred_tpu_torch.assets.bank import WaveBank
            b = bank or WaveBank()
            w = int(wave[1:]) if wave.startswith("w") else int(wave)
            slot = b.slots[w]
            if not slot.valid:
                print(f"   w{w}: empty slot", file=out)
                continue
            for d in dists:
                print(f"   d={d}", file=out)
                for ln in wave_frame(m, d, np.asarray(slot.data),
                                     rows, cols):
                    print(ln, file=out)
        else:
            curves = [warp_curve(m, d, tsize) for d in dists]
            labels = [f"d={d}" for d in dists]
            for ln in curve_frame(curves, labels, rows, cols):
                print(ln, file=out)
