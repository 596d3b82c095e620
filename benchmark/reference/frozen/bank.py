"""Wavetable / sample bank.

Re-creates the reference wavetable universe bit-exactly
(reference: synth.c:1199-1294 wave_table_init):

  * slots 0-6    — procedural sine/square/saw-down/saw-up/triangle/noise/
                   noise-alt, 4096 samples, f32 phase-accumulated generation
                   with the Knuth-MMIX LCG for the noise tables (seed 1)
  * slots 32-62  — 31 Korg DW-8000 ROM banks, first 2048 samples (octave 0),
                   int16/32767 (reference: retro/korg.h, synth.c:1255-1268)
  * slots 100-166 — 67 AMY PCM one-shots at 22050 Hz, normalized preserving
                   zero (reference: synth.c:1270-1293; sample data is the
                   deterministic substitute from tools/gen_pcm_substitute.py
                   because notamy/pcm_samples_large.h is missing upstream)
  * slots 200-1199 — user WAV / data-array slots loaded at runtime
                   (reference: wire.c:406-441 wave_load, wire.c:374-404
                   data_load)

``pack()`` flattens every valid slot into one contiguous f32 buffer with
per-slot offsets — the TPU renderer gathers samples from this packed
buffer (dynamic per-voice table binding becomes an offset, reference keeps
per-voice float pointers instead: synth.def:14).
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
import wave as wave_mod
from typing import List, Optional

import numpy as np

from . import config as C

_DATA_DIR = pathlib.Path(__file__).resolve().parent / "data"
# The package ships the parsed caches (data/*.npz); the reference's text
# dumps are read only when a cache is missing, from this directory.
_REFERENCE = _DATA_DIR / "reference"

F32 = np.float32

LCG_A = 6364136223846793005
LCG_C = 1442695040888963407
_M64 = (1 << 64) - 1


class Lcg:
    """Knuth-MMIX LCG (reference: synth.c:105-123)."""

    def __init__(self, seed: int = 1):
        self.state = seed if seed else 1

    def next_float(self) -> np.float32:
        self.state = (self.state * LCG_A + LCG_C) & _M64
        hi = (self.state >> 32) & 0xFFFFFFFF
        if hi >= 1 << 31:
            hi -= 1 << 32
        return np.float32(np.float32(hi) / np.float32(2147483648.0))

    def floats(self, n: int) -> np.ndarray:
        return np.array([self.next_float() for _ in range(n)], dtype=np.float32)


def midi2hz_f32(f) -> np.float32:
    """reference synth.c:1056-1059 (f32 powf via glibc for bit parity)."""
    from .utils_libm import powf

    f = np.float32(f)
    return np.float32(
        np.float32(440.0) * powf(np.float32(2.0), (f - np.float32(69.0)) / np.float32(12.0))
    )


def normalize_preserve_zero(data: np.ndarray) -> np.ndarray:
    """reference synth.c:1175-1197 — scale by 1/max|x| in f32."""
    if data.size == 0:
        return data
    max_abs = np.float32(np.max(np.abs(data)))
    if max_abs == 0:
        return data
    scale = np.float32(np.float32(1.0) / max_abs)
    return (data * scale).astype(np.float32)


@dataclasses.dataclass
class Slot:
    data: Optional[np.ndarray] = None   # f32 samples
    size: int = 0
    rate: float = 0.0
    one_shot: int = 0
    loop_enabled: int = 0
    loop_start: int = 0
    loop_end: int = 0
    midi_note: float = 0.0
    offset_hz: float = 0.0

    @property
    def valid(self) -> bool:
        # reference synth.c:278 — a slot binds only if data, size, rate>0
        return self.data is not None and self.size > 0 and self.rate > 0.0


def _procedural_tables() -> List[np.ndarray]:
    """Slots 0-6, mirroring synth.c:1210-1249 exactly (f32 accumulation).

    The generation loop accumulates ``phase += 1/4096`` in f32; 1/4096 is a
    power of two so the accumulation is exact and yields exactly 4096
    samples per table.  The two noise tables draw from one continuous LCG
    stream seeded at 1.
    """
    size = 4096
    phase = (np.arange(size, dtype=np.float32) * np.float32(1.0 / size)).astype(np.float32)
    two_pi = np.float32(np.float32(2.0) * np.float32(np.pi))
    # use glibc's sinf (via ctypes) — the reference binary's exact rounding
    from .utils_libm import sinf_array

    sine = sinf_array(two_pi * phase)
    sqr = np.where(phase < 0.5, np.float32(1.0), np.float32(-1.0)).astype(np.float32)
    saw_down = (np.float32(2.0) * phase - np.float32(1.0)).astype(np.float32)
    saw_up = (np.float32(1.0) - np.float32(2.0) * phase).astype(np.float32)
    tri = np.where(
        phase < np.float32(0.5),
        np.float32(4.0) * phase - np.float32(1.0),
        np.float32(3.0) - np.float32(4.0) * phase,
    ).astype(np.float32)
    rng = Lcg(1)
    noise = rng.floats(size)
    noise_alt = rng.floats(size)
    return [sine, sqr, saw_down, saw_up, tri, noise, noise_alt]


def _load_korg(reference: pathlib.Path) -> List[np.ndarray]:
    """Parse the Korg ROM decimal text dumps (reference: retro/korg.h).

    Returns the 33 int16 arrays kw00..kw32 in reference order; only the
    first 31 are mapped into slots 32..62 (synth.c:1255 loops
    KRG1..KRG32-1).  Cached in assets/data/korg.npz.
    """
    cache = _DATA_DIR / "korg.npz"
    if cache.exists():
        z = np.load(cache)
        return [z[f"kw{i:02d}"] for i in range(33)]
    roms = ["HN613256P_T70", "HN613256P_T71", "HN613256P_CB4", "HN613256P_CB5",
            "EXP_1", "EXP_2", "EXP_3", "EXP_4"]
    def _parse(txt: str) -> np.ndarray:
        return np.array(
            [int(t) for t in re.split(r"[,\s]+", txt.strip()) if t], dtype=np.int16
        )

    kw = []
    for rom in roms:
        for w in range(4):
            kw.append(_parse((reference / "retro" / f"{rom}.w{w}").read_text()))
    kw.append(_parse((reference / "retro" / "out.list").read_text()))
    _DATA_DIR.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(cache, **{f"kw{i:02d}": a for i, a in enumerate(kw)})
    return kw


_PCM_MAP_RE = re.compile(
    r"\{(\-?\d+),\s*(\d+),\s*(\d+),\s*(\d+),\s*(?:/\*[^*]*\*/\s*)?(\d+)\}"
)


def _load_pcm_map(reference: pathlib.Path):
    cache = _DATA_DIR / "pcm_map.npz"
    if cache.exists():
        return np.load(cache)["rows"]
    text = (reference / "notamy" / "pcm_large.h").read_text()
    rows = np.array(
        [[int(g) for g in m.groups()] for m in _PCM_MAP_RE.finditer(text)],
        dtype=np.int64,
    )
    assert rows.shape[0] == 67
    _DATA_DIR.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(cache, rows=rows)
    return rows


class WaveBank:
    """The full 1200-slot wavetable bank (reference: synth.def:1-10)."""

    def __init__(self, reference: Optional[pathlib.Path] = None):
        self.slots: List[Slot] = [Slot() for _ in range(C.WAVE_TABLE_MAX)]
        ref = reference or _REFERENCE
        self._init_procedural()
        self._init_korg(ref)
        self._init_pcm(ref)

    # ---- construction (mirrors wave_table_init) ----
    def _init_procedural(self) -> None:
        for w, tab in enumerate(_procedural_tables()):
            self.slots[w] = Slot(
                data=tab, size=tab.size, rate=float(C.MAIN_SAMPLE_RATE),
                one_shot=0, loop_enabled=0, loop_start=0, loop_end=tab.size - 1,
            )

    def _init_korg(self, ref: pathlib.Path) -> None:
        kw = _load_korg(ref)
        for i in range(C.WAVE_TABLE_KRG1, C.WAVE_TABLE_KRG32):  # 32..62
            k = i - C.WAVE_TABLE_KRG1
            s = 2048  # kwave_size — octave 0 only (retro/korg.h:219-222)
            tab = (kw[k][:s].astype(np.float32) / np.float32(32767)).astype(np.float32)
            self.slots[i] = Slot(
                data=tab, size=s, rate=float(C.MAIN_SAMPLE_RATE),
                one_shot=0, loop_enabled=0, loop_start=0, loop_end=s - 1,
            )

    def _init_pcm(self, ref: pathlib.Path) -> None:
        pcm = np.load(_DATA_DIR / "pcm_substitute.npz")["pcm"]
        rows = _load_pcm_map(ref)
        for i, (offset, length, loopstart, loopend, midinote) in enumerate(rows):
            j = i + C.AMY_SAMPLE_00
            tab = (pcm[offset : offset + length].astype(np.float32) / np.float32(32767.0))
            tab = normalize_preserve_zero(tab.astype(np.float32))
            self.slots[j] = Slot(
                data=tab, size=int(length), rate=22050.0, one_shot=1,
                loop_enabled=0, loop_start=int(loopstart), loop_end=int(loopend),
                midi_note=float(int(midinote)),
                offset_hz=float(midi2hz_f32(float(midinote))),
            )

    # ---- runtime loading (mirrors wire.c wave_load / data_load) ----
    def load_wav(self, which: int, where: int, ch: int = -1,
                 search_dir: Optional[pathlib.Path] = None) -> bool:
        """``:wN,slot`` — load ``N.wav`` into a user slot
        (reference: wire.c:406-441)."""
        if where < C.EXT_SAMPLE_000 or where >= C.EXT_SAMPLE_999:
            return False
        d = search_dir or pathlib.Path.cwd()
        path = d / f"{which}.wav"
        try:
            data, rate, channels = read_wav_f32(path)
        except (FileNotFoundError, wave_mod.Error):
            return False
        frames = data.shape[0]
        # reference quirk (miniwav.c:132): `ch > decoder.outputChannels`
        # compares signed ch against an UNSIGNED channel count, so the
        # default ch=-1 becomes ch=channels, and the channel-select loop
        # reads pSamples[i + channels] — channel 0 of the *next* frame.
        # Every load therefore drops the first frame (keeping the left
        # channel for multichannel files) and reads one past the end
        # (zero) for the final sample.
        if ch < 0 or ch > channels:
            ch = channels
        flat = data.reshape(-1)
        idx = np.arange(frames) * channels + ch
        oob = idx >= flat.size
        vals = flat[np.clip(idx, 0, flat.size - 1)].astype(np.float32)
        flat = np.where(oob, np.float32(0.0), vals).astype(np.float32)
        self.slots[where] = Slot(
            data=flat, size=frames, rate=float(rate), one_shot=1,
            loop_enabled=0, loop_start=1, loop_end=frames, midi_note=69.0,
            offset_hz=float(np.float32(frames) / np.float32(rate) * np.float32(440.0)),
        )
        return True

    def load_data(self, where: int, values: np.ndarray) -> bool:
        """``(…)`` array literal → sample table (reference: wire.c:374-404)."""
        if where < C.EXT_SAMPLE_000 or where >= C.EXT_SAMPLE_999:
            return False
        tab = np.asarray(values, dtype=np.float32)
        self.slots[where] = Slot(
            data=tab, size=tab.size, rate=44100.0, one_shot=1,
            loop_enabled=0, loop_start=1, loop_end=tab.size, midi_note=69.0,
            offset_hz=float(np.float32(tab.size) / np.float32(44100.0) * np.float32(440.0)),
        )
        return True

    def dynamic_expand(self, n: int) -> None:
        """``/wex`` (reference: wire.c:553-586) — rescale a user slot to
        ±1 preserving zero (sign-flipping variant)."""
        if not (200 <= n <= 999):
            return
        s = self.slots[n]
        if not s.valid:
            return
        data = s.data
        fbig = np.float32(max(np.float32(0.0), np.max(data)))
        fsmall = np.float32(min(np.float32(0.0), np.min(data)))
        if abs(fsmall) > abs(fbig):
            scale = np.float32(-1.0) / fsmall
        else:
            if fbig == 0:
                return
            scale = np.float32(1.0) / fbig
        out = np.clip(data * scale, np.float32(-1.0), np.float32(1.0)).astype(np.float32)
        self.slots[n] = dataclasses.replace(s, data=out)

    def fork(self) -> "WaveBank":
        """Cheap independent copy: slot *objects* are immutable once built
        (loads replace them), so a shallow slot-list copy suffices."""
        b = WaveBank.__new__(WaveBank)
        b.slots = list(self.slots)
        return b

    # ---- packing for the device renderer ----
    def pack(self) -> "PackedBank":
        offsets = np.zeros(C.WAVE_TABLE_MAX, dtype=np.int32)
        sizes = np.zeros(C.WAVE_TABLE_MAX, dtype=np.int32)
        chunks = []
        off = 0
        for i, s in enumerate(self.slots):
            if s.valid:
                offsets[i] = off
                sizes[i] = s.size
                chunks.append(s.data[: s.size])
                off += s.size
        buf = np.concatenate(chunks).astype(np.float32) if chunks else np.zeros(1, np.float32)
        return PackedBank(
            buffer=buf, offsets=offsets, sizes=sizes,
            rates=np.array([s.rate for s in self.slots], dtype=np.float32),
            one_shot=np.array([s.one_shot for s in self.slots], dtype=np.int32),
            loop_enabled=np.array([s.loop_enabled for s in self.slots], dtype=np.int32),
            loop_start=np.array([s.loop_start for s in self.slots], dtype=np.int32),
            loop_end=np.array([s.loop_end for s in self.slots], dtype=np.int32),
            midi_note=np.array([s.midi_note for s in self.slots], dtype=np.float32),
            offset_hz=np.array([s.offset_hz for s in self.slots], dtype=np.float32),
            valid=np.array([s.valid for s in self.slots], dtype=bool),
        )


@dataclasses.dataclass
class PackedBank:
    """Flat table buffer + per-slot metadata, device-ready."""

    buffer: np.ndarray
    offsets: np.ndarray
    sizes: np.ndarray
    rates: np.ndarray
    one_shot: np.ndarray
    loop_enabled: np.ndarray
    loop_start: np.ndarray
    loop_end: np.ndarray
    midi_note: np.ndarray
    offset_hz: np.ndarray
    valid: np.ndarray


def read_wav_f32(path) -> tuple[np.ndarray, int, int]:
    """Read a WAV file → (frames × channels f32, rate, channels).

    PCM 8/16/24/32-bit supported; 16-bit converts as x/32768 matching the
    miniaudio decoder's s16→f32 path used by the reference."""
    with wave_mod.open(str(path), "rb") as f:
        channels = f.getnchannels()
        rate = f.getframerate()
        width = f.getsampwidth()
        n = f.getnframes()
        raw = f.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / np.float32(32768.0)
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / np.float32(128.0)
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        v = np.where(v & 0x800000, v - 0x1000000, v)
        x = v.astype(np.float32) / np.float32(8388608.0)
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / np.float32(2147483648.0)
    else:
        raise wave_mod.Error(f"unsupported sample width {width}")
    return x.reshape(-1, channels), rate, channels


def write_wav_16(path, data: np.ndarray, rate: int = 44100) -> None:
    """Write float data (frames × channels) as 16-bit PCM WAV."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    pcm = np.clip(data, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave_mod.open(str(path), "wb") as f:
        f.setnchannels(data.shape[1])
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.tobytes())
