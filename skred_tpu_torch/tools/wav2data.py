"""wav2data — WAV file to skode raw-data text array.

    python -m skred_tpu_torch.tools.wav2data FILE.wav [--ch N]

A copy of ``tools/wav2data.py``, verbatim but for its import
(``skred_tpu_torch.assets.bank``, the port's copy of the WAV reader),
the reference source named without its directory, and this paragraph.
Control plane: numpy only, no device.

Port of the reference utility (wav2data.c:1-29): decode
a WAV file and print it as a ``D<len>`` + ``( ... )`` skode data array,
5 values per line, %.8f each.  The array path is inert upstream (no
reference .c consumes ``D``/``(`` arrays at runtime), so this exists for
tooling completeness: its output parses through lang/skode.py exactly as
the original's does through skode.c.

Channel handling reproduces the reference stack's behavior faithfully:
wav2data.c calls mw_get(name, ..., ch=-1), and miniwav.c:132 compares
the signed -1 against the UNSIGNED channel count, so ch becomes
``channels`` and the copy loop reads pSamples[i + channels] — channel 0
of the NEXT frame: the dump drops the first frame and the final value
reads one past the end (0.0).  Pass an explicit --ch to select a real
channel instead.
"""

import argparse
import sys

import numpy as np

COLS = 5   # wav2data.c:4


def wav_to_data(path, ch: int = -1) -> str:
    from skred_tpu_torch.assets.bank import read_wav_f32

    data, _rate, channels = read_wav_f32(path)
    frames = data.shape[0]
    # miniwav.c:132 signed/unsigned quirk (see assets/bank.py WAV loader)
    if ch < 0 or ch > channels:
        ch = channels
    flat = data.reshape(-1)
    idx = np.arange(frames) * channels + ch
    oob = idx >= flat.size
    vals = flat[np.clip(idx, 0, flat.size - 1)].astype(np.float32)
    table = np.where(oob, np.float32(0.0), vals)

    # exact output shape of wav2data.c:17-26: "D<len>\n( " then
    # "%.8f " per value with " \n" after every 5th, then " ) \n"
    out = [f"D{frames}\n( "]
    c = 0
    for v in table:
        out.append(f"{v:.8f} ")
        c += 1
        if c >= COLS:
            out.append(" \n")
            c = 0
    out.append(" ) \n")
    return "".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("wav", help="input WAV file")
    ap.add_argument("--ch", type=int, default=-1,
                    help="channel to dump (default -1 reproduces the "
                         "reference's frame-dropping quirk)")
    args = ap.parse_args()
    sys.stdout.write(wav_to_data(args.wav, args.ch))
    return 0


if __name__ == "__main__":
    sys.exit(main())
