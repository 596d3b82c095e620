"""The ``preview`` traffic: one sound designer at the REPL, or one
controller over ``serve``.

Closed loop, one client.  A request is one variant of the
configuration's script (``variants.py``, the ``n``-th of a pool of
``pool`` drawn from the seed, in turn) as the session's history,
rendered for ``audio_s`` seconds through the REPL's and ``serve``'s own
render, ``frontends/repl.py``'s ``_render``: the Python compiler
(``host/timeline.compile_script``), the compat engine
(``engine.render.render_timeline``) and ``write_wav_16``.  Every request
overwrites one WAV in the temporary directory.  Set-up asserts that
every variant of the pool has the script's compat kernel key, and
renders the script and two variants (its key built and loaded).  A request's
latency runs from the call to its WAV written; the window ends with the
first request that finishes after ``--seconds``.

``correct``: ``compare_requests`` requests drawn from the seed among
those the window finished are held to the reference's render of the same
variants (the widest gap, ``reference/compare.py``) twice: the float
audio that ``render_timeline`` returned (kept for every request of the
window, in every run) against the reference's unclipped float32 audio,
and the WAV's samples against the reference's written to 16 bits; every
WAV of the window has to be 16-bit stereo at 44100 Hz of the render's
length; no kernel may be built inside the window.  The reference
compiles the script text with a frozen copy of the Python compiler that
the request times, so a fault of that compiler today does not show here
(the sweeps hold the same copy against the native compiler); a later
change to it does.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import pathlib
import tempfile
import time
import wave

import numpy as np

from benchmark import harness
from benchmark.traffic import variants

COMPARES_WAV = True


def _texts(cell, seed: int):
    tr = cell.traffic
    lines = variants.wire_lines(cell.config["script_text"])
    fac = variants.factors(variants.rng_for(seed, 0), tr["pool"], lines,
                           tr["spread"], tr["cut"])
    return lines, [variants.variant(lines, f) for f in fac]


@contextlib.contextmanager
def _keeping(module, name: str, kept: list):
    """While open, every result of ``module.name`` is appended to
    ``kept`` (the array itself, not a copy)."""
    real = getattr(module, name)

    def inner(*a, **kw):
        out = real(*a, **kw)
        kept.append(out)
        return out

    setattr(module, name, inner)
    try:
        yield
    finally:
        setattr(module, name, real)


def _sample(cell, seed: int, done: int) -> list:
    rng = variants.rng_for(seed, 1)
    k = min(int(cell.traffic["compare_requests"]), done)
    return sorted(int(i) for i in rng.choice(done, k, replace=False))


def compared_texts(cell, seed: int) -> list:
    """The variants a run compares, had it finished a pool's worth."""
    _, texts = _texts(cell, seed)
    pool = len(texts)
    return [texts[i % pool] for i in _sample(cell, seed, pool)]


def _read_wav(data: bytes):
    """(frames [T, 2] int16, (channels, width, rate))."""
    with wave.open(io.BytesIO(data)) as w:
        fmt = (w.getnchannels(), w.getsampwidth(), w.getframerate())
        raw = w.readframes(w.getnframes())
    pcm = np.frombuffer(raw, "<i2")
    return pcm.reshape(-1, max(fmt[0], 1)), fmt


def _wav_of(audio, path) -> np.ndarray:
    """The samples of ``audio`` as the program's WAV writer stores them."""
    from skred_tpu_torch.assets.bank import write_wav_16

    write_wav_16(str(path), audio)
    return _read_wav(pathlib.Path(path).read_bytes())[0]


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", substitute=None) -> int:
    """One run of the cell; ``substitute(texts, audio_s)``, where given,
    puts its audio in the program's place for the requests compared,
    after the window (the control, ``reference/control.py``)."""
    import torch

    import skred_tpu_torch.assets.bank as bankmod
    import skred_tpu_torch.engine as engine
    import skred_tpu_torch.host.timeline as timeline
    from benchmark import trace as tracing
    from benchmark.reference import compare
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.engine.kernels import build
    from skred_tpu_torch.engine.kernels.compat import compat_key
    from skred_tpu_torch.engine.render import stacked_inputs
    from skred_tpu_torch.frontends.repl import _render
    from skred_tpu_torch.host.native import compile_script_native
    from skred_tpu_torch.parallel.batch import stack_timelines

    tr = cell.traffic
    audio_s = float(tr["audio_s"])
    limits = json.loads((harness.HERE / "limits" / f"{cell.name}.json")
                        .read_text())
    lines, texts = _texts(cell, seed)
    sdir = harness.HERE / "configs"
    bank = WaveBank()

    def key(t):
        tl = compile_script_native(t, audio_s, bank=bank, script_dir=sdir)
        return compat_key(stacked_inputs(stack_timelines([tl]),
                                         device="cpu"), tl.mod_passes, False)

    k0 = key(lines)
    off = [i for i, t in enumerate(texts) if key(t) != k0]
    if off:
        raise SystemExit(f"preview: variants {off[:8]} leave the script's "
                         f"compat key {k0}")
    tmp = tempfile.TemporaryDirectory(prefix="bench_")
    wav = pathlib.Path(tmp.name) / f"{cell.name}.wav"
    quiet = io.StringIO()
    with contextlib.redirect_stdout(quiet):
        for hist in [lines] + texts[:2]:      # the warm requests
            _render(list(hist), audio_s, str(wav), bank, device)
    built = len(build.LOG)
    setup_s = time.perf_counter() - t0
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    lat, wavs, floats, compile_s = [], [], [], []
    n_traced = int(tr["traced_requests"])
    tracer = tracing.Tracer() if trace else None
    traced = lambda: trace and len(lat) < n_traced
    stack = contextlib.ExitStack()
    stack.enter_context(_keeping(engine, "render_timeline", floats))
    if trace:
        for mod, name in ((timeline, "compile_script"),
                          (engine, "render_timeline"),
                          (bankmod, "write_wav_16")):
            stack.enter_context(tracing.span_calls(
                mod, name, f"bench.{name}", traced,
                compile_s if name == "compile_script" else None))
    try:
        with stack, contextlib.redirect_stdout(quiet):
            w0 = time.perf_counter()
            while True:
                hist = texts[len(lat) % len(texts)]
                if traced() and not lat:
                    tracer.__enter__()
                t = time.perf_counter()
                _render(list(hist), audio_s, str(wav), bank, device)
                lat.append(time.perf_counter() - t)
                if trace and len(lat) == n_traced:
                    tracer.__exit__(None, None, None)
                wavs.append(wav.read_bytes())
                if (time.perf_counter() - w0 >= seconds
                        and (not trace or len(lat) >= n_traced)):
                    break
            window_s = time.perf_counter() - w0
    finally:
        wav.unlink(missing_ok=True)
    dev = harness.device_block(cell.chips, device)
    builds_in_window = len(build.LOG) - built

    # ---- correct: the reference on the requests compared ----
    done = len(lat)
    frames = None
    bad_format = 0
    decoded = []
    for data in wavs:
        pcm, fmt = _read_wav(data)
        frames = frames or len(pcm)
        if fmt != (2, 2, 44100) or len(pcm) != frames:
            bad_format += 1
        decoded.append(pcm)
    picks = _sample(cell, seed, done)
    r0 = time.perf_counter()
    chosen = [texts[i % len(texts)] for i in picks]
    ref = compare.render(chosen, audio_s)
    program = [floats[i] for i in picks]
    pcms = [decoded[i] for i in picks]
    if substitute is not None:
        program = list(substitute(chosen, audio_s))
        pcms = [_wav_of(a, wav) for a in program]
    tmp.cleanup()
    program = np.stack(program) if picks else np.zeros((0,))
    pcm = np.stack([p.astype(np.float64) / 32767.0
                    for p in pcms]) if picks else np.zeros((0,))
    if frames != ref.shape[1] or len(floats) != done:
        bad_format = max(bad_format, 1)
    gap = compare.gap_db(program, ref)
    wav_gap = compare.gap_db(pcm, compare.wav_16(ref))
    half = done // 2
    print(f"bench: set-up {setup_s:.3f} s, window {window_s:.3f} s, "
          f"{done} requests (median {np.median(lat[:half] or lat):.4f}"
          f" s in the first half, {np.median(lat[half:]):.4f} s in the"
          f" second), reference {time.perf_counter() - r0:.3f} s",
          file=sys.stderr)
    checks = {
        "gap_db": {"value": gap, "limit": limits["gap_db"]},
        "wav_gap_db": {"value": wav_gap, "limit": limits["wav_gap_db"]},
        "wavs_malformed": {"value": bad_format, "limit": 0},
        "kernels_built_in_window": {"value": builds_in_window, "limit": 0},
    }
    correct = (gap <= limits["gap_db"] and wav_gap <= limits["wav_gap_db"]
               and bad_format == 0 and builds_in_window == 0)

    e2e = {"preview_p50_s": float(np.percentile(lat, 50)),
           "preview_p90_s": float(np.percentile(lat, 90)),
           "setup_s": setup_s}
    layer, breakdown = {}, None
    if trace:
        s = tracer.summary()
        dev["busy_s"] = s.busy_s
        dev["window_s"] = s.window_s
        blocks = n_traced * -(-int(audio_s * 44100) // 512)
        layer = harness.layer_metrics(cell, s, blocks=blocks,
                                      requests=n_traced,
                                      compile_s=compile_s)
        breakdown = {"device_ops": s.top_device_ops(),
                     "idle_gaps": s.top_gaps()}
    return harness.finish(cell, trace, correct, done, 0, e2e, layer, dev,
                          checks, breakdown)
