"""Variants of a script: its numeric voice arguments scaled by factors
drawn from the seed.

Each variant is the configuration's script with every frequency (``f``),
CZ depth (``c``'s second argument), filter cutoff (``K``) and Q (``Q``)
and modulation depth (``F``, ``A``, ``P``, ``C``: the second argument)
scaled by its own factor in [1 - spread, 1 + spread], and every
amplitude (``a``) by one in [1 - cut, 1]: never across zero, since a
factor is positive.  Waves, modulation sources, feature letters, voice
copies and time advances stay as written, so every variant renders
through the same kernels as the script (the traffic drivers assert it).
"""

from __future__ import annotations

import re

import numpy as np

# command letter -> (argument scaled, "spread" or "cut")
SCALED = {"f": (0, "spread"), "c": (1, "spread"), "K": (0, "spread"),
          "Q": (0, "spread"), "F": (1, "spread"), "A": (1, "spread"),
          "P": (1, "spread"), "C": (1, "spread"), "a": (0, "cut")}
_TOKEN = re.compile(r"^([A-Za-z])(-?[0-9.]+(?:,-?[0-9.]+)*)$")


def wire_lines(text: str) -> list:
    """The script's command lines, as a user types them: comments and
    blank lines dropped."""
    return [ln.strip() for ln in text.splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")]


def slots(lines: list) -> list:
    """(line, token, kind) of every argument a variant scales."""
    out = []
    for i, ln in enumerate(lines):
        for j, tok in enumerate(ln.split()):
            m = _TOKEN.match(tok)
            if m and m.group(1) in SCALED:
                arg, kind = SCALED[m.group(1)]
                if arg < len(m.group(2).split(",")):
                    out.append((i, j, kind))
    return out


def factors(rng: np.random.Generator, n: int, lines: list,
            spread: float, cut: float) -> np.ndarray:
    """[n, slots] factors, one row a variant."""
    kinds = [k for _, _, k in slots(lines)]
    u = rng.random((n, len(kinds)))
    lo = np.array([1 - spread if k == "spread" else 1 - cut for k in kinds])
    hi = np.array([1 + spread if k == "spread" else 1.0 for k in kinds])
    return lo + u * (hi - lo)


def variant(lines: list, fac: np.ndarray) -> list:
    """The script's lines with each scaled argument times its factor."""
    toks = [ln.split() for ln in lines]
    for (i, j, _), f in zip(slots(lines), fac):
        m = _TOKEN.match(toks[i][j])
        letter, args = m.group(1), m.group(2).split(",")
        arg = SCALED[letter][0]
        args[arg] = f"{float(args[arg]) * float(f):.9g}"
        toks[i][j] = letter + ",".join(args)
    return [" ".join(t) for t in toks]


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one use (``stream``) of a run's seed."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])
