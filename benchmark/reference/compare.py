"""The comparison that decides ``correct``: the program's audio against
the plain reference's, for the same script text.

The number compared is the widest gap, ``max |program - reference|``
over every sample and both channels of the rows compared, in dB of full
scale (1.0), as ``tools/card_parity.py`` gives the engines' parity; a
gap that is not a finite number reads ``NOT_FINITE_DB``.
"""

from __future__ import annotations

import pathlib

import numpy as np

NOT_FINITE_DB = 999.0


def compile_texts(texts, seconds: float, script_dir=None) -> list:
    """The frozen compiler's timelines of scripts (each a list of wire
    lines), one bank for all."""
    from benchmark.reference.frozen.bank import WaveBank
    from benchmark.reference.frozen.timeline import compile_script

    bank = WaveBank()
    sdir = pathlib.Path(script_dir) if script_dir else None
    return [compile_script(list(t), seconds, bank=bank, script_dir=sdir)
            for t in texts]


def render(texts, seconds: float, dtype: str = "float32",
           script_dir=None) -> np.ndarray:
    """The reference's audio of scripts, ``[len(texts), T, 2]``."""
    from benchmark.reference import synth

    return synth.render(compile_texts(texts, seconds, script_dir), dtype)


def gap_db(program: np.ndarray, reference: np.ndarray) -> float:
    """The widest gap in dB of full scale."""
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    if program.shape != reference.shape:
        return NOT_FINITE_DB
    err = np.abs(program - reference).max() if program.size else 0.0
    if not np.isfinite(err):
        return NOT_FINITE_DB
    return float(20 * np.log10(err + 1e-30))


def wav_16(audio: np.ndarray) -> np.ndarray:
    """What a 16-bit WAV of float audio holds, as float: clipped to
    [-1, 1], times 32767, truncated, over 32767."""
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    return pcm.astype(np.float64) / 32767.0
