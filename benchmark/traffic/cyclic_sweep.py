"""The ``cyclic_sweep`` traffic: ``sweep``'s render farm on a patch whose
modulation graph has a cycle (1-sample feedback).

Closed loop, one job in flight.  A job is ``rows`` distinct variants of
the configuration's script (``variants.py``, drawn from the seed, as
``sweep.py`` draws them), each ``audio_s`` seconds long.  Set-up
compiles them with the program's native compiler (``host/native.py``),
stacks them and packs them for the cyclic engine
(``pack_stacked(cyclic=True)``), asserts that the engine's gate takes the
batch and, where the program has ``parallel.batch.cyclic_group_key``,
that every variant has the script's key (the one ``render_batch``
groups cyclic scripts by), and warms up: a traced run renders one whole
job, an untraced run the batch cut to its first ``WARM_BLOCKS`` blocks
(the same kernel built and loaded).  The window calls
``engine.cyclic.render_cyclic(st, device="cuda")`` back to back, the call
``render_batch`` makes for each cyclic group; each job ends with its
audio as numpy on the host.  The window ends with the first job that
finishes after ``--seconds``.  Nothing is written to disk.

``correct``: as ``sweep.py``'s, against the plain reference for feedback
loops (``reference/synth_cyclic.py``): ``compare_rows`` rows, one from
each equal stratum of the batch, each from a job drawn from the seed,
held to the reference's render of the same variants (the widest gap);
the same rows of every other job equal to that job's bit for bit; no
kernel built inside the window.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np

from benchmark import harness
from benchmark.traffic import sweep, variants

COMPARES_WAV = False
compared_texts = sweep.compared_texts
WARM_BLOCKS = 2


def _first_blocks(st, n: int):
    """The packed batch cut to its first ``n`` blocks."""
    n = min(n, st.num_blocks)
    return dataclasses.replace(st, num_blocks=n,
                               seg_of_block=st.seg_of_block[:, :n],
                               seg_is_start=st.seg_is_start[:, :n])


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", substitute=None) -> int:
    """One run of the cell; ``substitute(texts, audio_s)``, where given,
    puts its audio in the program's place for the rows compared, after
    the window (the control: ``synth_cyclic.render`` in bfloat16)."""
    import torch

    from benchmark import roofline, roofline_cyclic
    from benchmark import trace as tracing
    from benchmark.reference import compare, synth_cyclic
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.engine import cyclic
    from skred_tpu_torch.engine.kernels import build
    from skred_tpu_torch.host.native import compile_script_native
    from skred_tpu_torch.parallel import batch

    tr = cell.traffic
    rows, audio_s = int(tr["rows"]), float(tr["audio_s"])
    limits = json.loads((harness.HERE / "limits" / f"{cell.name}.json")
                        .read_text())
    lines, texts = sweep._texts(cell, seed)
    sdir = harness.HERE / "configs"
    bank = WaveBank()
    compile_ = lambda t: compile_script_native(t, audio_s, bank=bank,
                                               script_dir=sdir)
    base = compile_(lines)
    if base.fused_passes is not None:
        raise SystemExit("cyclic_sweep: the script's modulation graph has "
                         "no cycle")
    tls = [compile_(t) for t in texts]
    group_key = getattr(batch, "cyclic_group_key", None)
    if group_key is not None:
        # a program older than the key renders each cyclic script alone;
        # the gate below decides for it
        key = group_key(base)
        off = [i for i, tl in enumerate(tls) if group_key(tl) != key]
        if off:
            raise SystemExit(f"cyclic_sweep: variants {off[:8]} leave the "
                             f"script's cyclic group key")
    st = batch.pack_stacked(batch.stack_timelines(tls), cyclic=True)
    reason = cyclic.cyclic_gate(st)
    if reason is not None:
        raise SystemExit(f"cyclic_sweep: the cyclic gate refuses the "
                         f"batch: {reason}")
    del tls
    with torch.no_grad():
        # a traced run's window holds the traced job alone, so its warm
        # job is a whole one, an unprofiled job for the span readers;
        # otherwise the batch cut to its first blocks builds the same
        # kernel (its key is the voice count and the features)
        cyclic.render_cyclic(st if trace else _first_blocks(st, WARM_BLOCKS),
                             device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    built = len(build.LOG)
    sample = sweep._sample(cell, seed)
    setup_s = time.perf_counter() - t0
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    kept, walls, tracer = [], [], None
    w0 = time.perf_counter()
    while True:
        j0 = time.perf_counter()
        if trace and tracer is None:
            tracer = tracing.Tracer()
            with tracer:
                out = cyclic.render_cyclic(st, device=device)
        else:
            out = cyclic.render_cyclic(st, device=device)
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
    reference = synth_cyclic.render(ref_tls)
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
        least = roofline.least_seconds(
            roofline_cyclic.workload(ref_tls, rows), dev["kind"])
        layer = harness.layer_metrics(cell, s, blocks=st.num_blocks, jobs=1,
                                      least_s_per_block=least)
        breakdown = {"device_ops": s.top_device_ops(),
                     "idle_gaps": s.top_gaps()}
    return harness.finish(cell, trace, correct, jobs, 0, e2e, layer, dev,
                          checks, breakdown)


def bfloat16(texts, audio_s: float):
    """The control: the reference for feedback loops in bfloat16
    (``control.py``'s own control calls ``synth.py``, which refuses a
    cycle)."""
    from benchmark.reference import compare, synth_cyclic

    return synth_cyclic.render(
        compare.compile_texts(texts, audio_s, harness.HERE / "configs"),
        "bfloat16")


def main(argv=None) -> int:
    """``python3 -m benchmark.traffic.cyclic_sweep --workload <cell>
    --seconds <s> --seed <n> [--seed <n> ...]``: the control's runs, as
    ``reference/control.py`` makes them, with ``bfloat16`` in the
    program's place; ``correct`` has to read false."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips)
    harness.import_program()
    for seed in args.seed:
        rc = run(cell, seed, args.seconds, False, time.perf_counter(),
                 substitute=bfloat16)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
