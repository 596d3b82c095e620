"""Generate deterministic substitute PCM sample data.

    python -m skred_tpu_torch.tools.gen_pcm_substitute --reference DIR
        [--out DIR]

A copy of ``tools/gen_pcm_substitute.py``, verbatim but for what it
writes and where it reads the map.  It writes only the port's
``skred_tpu_torch/assets/data/pcm_substitute.npz`` (or ``--out DIR``'s
``pcm_substitute.npz``): never the golden build's C headers under
``golden/``, which belong to the JAX package's tree.  The reference
sources are not in this repository, so ``--reference`` names the
directory that holds ``notamy/pcm_large.h``, and ``generate`` takes
the map rows it parsed; its two asserts on that input raise ValueError.
Control plane: numpy only, no device.

The reference ships the AMY PCM sample *map* (notamy/pcm_large.h: offsets,
lengths, loop points, MIDI root notes for 67 one-shot drum/instrument
samples) but the sample *data* file (notamy/pcm_samples_large.h, included
from amysamples.c:5) is missing from the snapshot.  Both the golden C build
and the TPU framework therefore use substitute data generated here:
per-segment exponentially-decaying sine + noise bursts at each sample's
root pitch — deterministic (fixed LCG), spectrally drum-like.
"""

from __future__ import annotations

import argparse
import pathlib
import re

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
OUT = REPO / "skred_tpu_torch" / "assets" / "data"

PCM_LENGTH = 1176036
PCM_RATE = 22050

LCG_A = np.uint64(6364136223846793005)
LCG_C = np.uint64(1442695040888963407)


def lcg_noise(n: int, seed: int) -> np.ndarray:
    """Vectorized Knuth-MMIX LCG stream (same generator family as
    synth.c:110-123) → float32 in [-1, 1)."""
    # closed form: s_t = A^t s0 + C (A^t - 1)/(A - 1)  (mod 2^64), computed
    # incrementally to stay in uint64.
    out = np.empty(n, dtype=np.uint64)
    s = np.uint64(seed if seed else 1)
    # generate in chunks via per-offset affine coefficients
    CHUNK = 65536
    offs_a = np.empty(CHUNK, dtype=np.uint64)
    offs_c = np.empty(CHUNK, dtype=np.uint64)
    a, c = np.uint64(1), np.uint64(0)
    with np.errstate(over="ignore"):
        for t in range(CHUNK):
            a = a * LCG_A
            c = c * LCG_A + LCG_C
            offs_a[t] = a
            offs_c[t] = c
        for start in range(0, n, CHUNK):
            m = min(CHUNK, n - start)
            out[start : start + m] = offs_a[:m] * s + offs_c[:m]
            s = out[start + m - 1]
    hi = (out >> np.uint64(32)).astype(np.uint32).astype(np.int32)
    return (hi.astype(np.float32) / np.float32(2147483648.0)).astype(np.float32)


def parse_pcm_map(text: str):
    """Parse the pcm_map initializers from notamy/pcm_large.h."""
    rows = []
    for m in re.finditer(
        r"\{(\-?\d+),\s*(\d+),\s*(\d+),\s*(\d+),\s*(?:/\*[^*]*\*/\s*)?(\d+)\}", text
    ):
        rows.append(tuple(int(g) for g in m.groups()))
    if len(rows) != 67:
        raise ValueError(f"expected 67 pcm_map rows, got {len(rows)}")
    return rows


def midi2hz(n: float) -> float:
    return 440.0 * 2.0 ** ((n - 69.0) / 12.0)


def generate(rows) -> np.ndarray:
    """The substitute data of the pcm map ``rows`` (``parse_pcm_map``)."""
    noise = lcg_noise(PCM_LENGTH, 0xC0FFEE)
    pcm = np.zeros(PCM_LENGTH, dtype=np.float64)
    for offset, length, loopstart, loopend, midinote in rows:
        t = np.arange(length, dtype=np.float64)
        f = midi2hz(midinote)
        env = np.exp(-t / max(length / 4.0, 1.0))
        tone = np.sin(2.0 * np.pi * f * t / PCM_RATE)
        seg = env * (0.7 * tone + 0.3 * noise[offset : offset + length])
        pcm[offset : offset + length] = seg
    return np.clip(pcm * 20000.0, -32767, 32767).astype(np.int16)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="gen_pcm_substitute",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--reference", required=True, type=pathlib.Path,
                    help="the reference sources' directory (it holds "
                         "notamy/pcm_large.h)")
    ap.add_argument("--out", type=pathlib.Path, default=OUT)
    a = ap.parse_args(argv)
    rows = parse_pcm_map((a.reference / "notamy" / "pcm_large.h")
                         .read_text())
    pcm = generate(rows)
    if pcm.shape != (PCM_LENGTH,):
        raise ValueError(f"generated {pcm.shape}, not ({PCM_LENGTH},)")
    a.out.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(a.out / "pcm_substitute.npz", pcm=pcm)
    print(f"wrote {len(pcm)} samples")


if __name__ == "__main__":
    main()
