"""The ``sweep`` traffic: a render farm making a dataset of notes.

Closed loop, one job in flight.  A job is ``rows`` distinct variants of
the configuration's script (``variants.py``, drawn from the seed), each
``audio_s`` seconds long.  Set-up compiles them with the program's
native compiler (``host/native.py``, as ``parallel/buckets.py`` does),
stacks, packs and pads them (``parallel/batch.py``), asserts that every
variant has the script's ``bucket_key`` and the batch the script's
``Plan`` (so its kernel keys), and renders one job (every kernel built
and loaded).  The window calls ``engine.fused.render_fused(st,
device="cuda")`` back to back, the call ``render_batch`` makes for each
fused group; each job ends with its audio as numpy on the host, as a
WAV writer needs it.  The window ends with the first job that finishes
after ``--seconds``.  Nothing is written to disk.

``correct``: ``compare_rows`` rows, one from each equal stratum of the
batch, drawn from the seed, each from a job drawn from the seed, are
held to the reference's render of the same variants (the widest gap,
``compare.py``); the same rows of every other job have to equal that
job's bit for bit; no kernel may be built inside the window.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from benchmark import harness
from benchmark.traffic import variants

COMPARES_WAV = False


def _texts(cell, seed: int):
    tr = cell.traffic
    lines = variants.wire_lines(cell.config["script_text"])
    fac = variants.factors(variants.rng_for(seed, 0), tr["rows"], lines,
                           tr["spread"], tr["cut"])
    return lines, [variants.variant(lines, f) for f in fac]


def _sample(cell, seed: int) -> list:
    """The rows compared: one from each of ``compare_rows`` strata."""
    rng = variants.rng_for(seed, 1)
    strata = np.array_split(np.arange(cell.traffic["rows"]),
                            cell.traffic["compare_rows"])
    return [int(rng.choice(s)) for s in strata]


def compared_texts(cell, seed: int) -> list:
    _, texts = _texts(cell, seed)
    return [texts[i] for i in _sample(cell, seed)]


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", substitute=None) -> int:
    """One run of the cell; ``substitute(texts, audio_s)``, where given,
    puts its audio in the program's place for the rows compared, after
    the window (the control, ``reference/control.py``)."""
    import torch

    from benchmark import roofline, trace as tracing
    from benchmark.reference import compare, synth
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.engine import fused
    from skred_tpu_torch.engine.kernels import build
    from skred_tpu_torch.host.native import compile_script_native
    from skred_tpu_torch.parallel.batch import (bucket_key, pack_stacked,
                                                pad_segments_pow2,
                                                stack_timelines)

    tr = cell.traffic
    rows, audio_s = int(tr["rows"]), float(tr["audio_s"])
    limits = json.loads((harness.HERE / "limits" / f"{cell.name}.json")
                        .read_text())
    lines, texts = _texts(cell, seed)
    sdir = harness.HERE / "configs"
    bank = WaveBank()
    compile_ = lambda t: compile_script_native(t, audio_s, bank=bank,
                                               script_dir=sdir)
    base = compile_(lines)
    tls = [compile_(t) for t in texts]
    key = bucket_key(base)
    off = [i for i, tl in enumerate(tls) if bucket_key(tl) != key]
    if off:
        raise SystemExit(f"sweep: variants {off[:8]} leave the script's "
                         f"bucket_key {key}")
    st = pad_segments_pow2(pack_stacked(stack_timelines(tls)))
    if fused.plan(st) != fused.plan(pack_stacked(stack_timelines([base]))):
        raise SystemExit("sweep: the batch's plan is not the script's")
    del tls
    with torch.no_grad():
        fused.render_fused(st, device=device)       # the warm job
    if device != "cpu":
        torch.cuda.synchronize()
    built = len(build.LOG)
    sample = _sample(cell, seed)
    setup_s = time.perf_counter() - t0
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    kept, walls, tracer = [], [], None
    w0 = time.perf_counter()
    while True:
        j0 = time.perf_counter()
        if trace and tracer is None:
            tracer = tracing.Tracer()
            with tracer, \
                    tracing.span_calls(fused, "_prepare", "fused._prepare"), \
                    tracing.span_calls(fused, "_block_step",
                                       "fused._block_step"):
                out = fused.render_fused(st, device=device)
        else:
            out = fused.render_fused(st, device=device)
        kept.append(out[sample].copy())
        del out
        walls.append(time.perf_counter() - j0)
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    jobs = len(kept)
    dev = harness.device_block(cell.chips, device)
    builds_in_window = len(build.LOG) - built

    # ---- correct: the reference on the rows compared ----
    rng = variants.rng_for(seed, 2)
    pick = [int(rng.integers(jobs)) for _ in sample]
    program = np.stack([kept[j][i] for i, j in enumerate(pick)])
    differ = sum(int(not np.array_equal(k[i], kept[0][i]))
                 for k in kept for i in range(len(sample)))
    r0 = time.perf_counter()
    if substitute is not None:
        program = substitute([texts[i] for i in sample], audio_s)
    ref_tls = compare.compile_texts([texts[i] for i in sample], audio_s,
                                    sdir)
    reference = synth.render(ref_tls)
    gap = compare.gap_db(program, reference)
    print(f"bench: set-up {setup_s:.3f} s, window {window_s:.3f} s, "
          f"{jobs} jobs (seconds each: "
          f"{' '.join(f'{w:.3f}' for w in walls)}), "
          f"reference {time.perf_counter() - r0:.3f} s", file=sys.stderr)
    checks = {
        "gap_db": {"value": gap, "limit": limits["gap_db"]},
        "rows_differing_between_jobs": {"value": differ, "limit": 0},
        "kernels_built_in_window": {"value": builds_in_window, "limit": 0},
    }
    correct = (gap <= limits["gap_db"] and differ == 0
               and builds_in_window == 0)

    e2e = {"audio_x_rt": jobs * rows * audio_s / window_s / cell.chips,
           "setup_s": setup_s}
    layer, breakdown = {}, None
    if trace:
        s = tracer.summary()
        dev["busy_s"] = s.busy_s
        dev["window_s"] = s.window_s
        least = roofline.least_seconds(roofline.workload(ref_tls, rows),
                                       dev["kind"])
        layer = harness.layer_metrics(cell, s, blocks=st.num_blocks, jobs=1,
                                      least_s_per_block=least)
        breakdown = {"device_ops": s.top_device_ops(),
                     "idle_gaps": s.top_gaps()}
    return harness.finish(cell, trace, correct, jobs, 0, e2e, layer, dev,
                          checks, breakdown)
