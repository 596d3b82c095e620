#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: batched ×-realtime render
throughput on one NVIDIA card.

    python3 bench_torch.py [seconds] [replicas] [--fast]

The counterpart of ``bench.py`` (the JAX package's TPU bench) for
``skred_tpu_torch``.  It renders the in-repo scripts (``corpus/*.sk`` and
``skred_tpu_torch/scripts/noise64.sk``) in buckets built as ``bench.py``
builds them (``skred_tpu_torch/parallel/buckets.py``): the acyclic
scripts by packed voices, passes and feature set through
``render_fused_stream_device``, each cyclic script on its own through
``render_cyclic_stream_device``, and the cyclic scripts the cyclic
kernel's gate refuses together, ``replicas`` times each, through the
compat engine's ``render_stacked`` (the compat-scan bucket, as
``bench.py:371-397``: a warm pass, then one timed pass unless the warm
pass took more than ``COMPAT_BUDGET_S``, when its wall is credited and
the bucket is marked ``timed_cold``).  Baseline 1.0× realtime: the
reference C engine renders its 64-voice graph at exactly real time on
one CPU thread (BASELINE.md).

Per bucket: one warm pass (it builds every kernel the bucket needs; a
build inside a timed pass fails the run), ``_prepare`` timed once on its
own (``setup_s``: uploads, the noise stream), then two timed passes, each
a host clock around the stream render, whose checksum synchronises, with
``torch.cuda.synchronize()`` before each clock read; every pass must
return the same checksum.  Audio is credited per whole ``CHUNK``-block
chunk, as in ``bench.py``.  The roofline of each bucket comes from
``skred_tpu_torch/parallel/roofline.py``.

After every bucket the cumulative headline is printed as one JSON line
with ``"partial": true`` and ``build/bench_detail_torch.json`` is
written; the last line drops ``"partial"``.  The headline names the card
and its power limit (nvidia-smi).  A regression gate reads
``bench_baseline_torch.json`` (an earlier run's detail file) when there
is one from a run at the same seconds, chunk and arithmetic: a bucket
more than 10% slower is timed three more times and listed only if the
best of all passes still shows the drop.

Runs on the card only: with no card it prints an error line and exits
2, as it does under a timing-ablation switch (``SKRED_MEGA_ABLATE``,
``SKRED_CYC_ABLATE``: its renders would be invalid).  Any failure (a
compiler error, a checksum that differs between passes, a build inside
a timed pass) prints an error line and exits 1.
"""

import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from skred_tpu_torch.tools import card  # noqa: E402

CHUNK = 172          # ~2 s of blocks, as bench.py
# the compat-scan bucket's time cap (bench.py:55): a warm pass longer
# than this is credited as the bucket's wall, with no second pass
COMPAT_BUDGET_S = 120.0
DETAIL = HERE / "build" / "bench_detail_torch.json"
BASELINE = HERE / "bench_baseline_torch.json"


def _load_baseline(seconds, chunk, arith):
    """An earlier run's per-bucket x_rt keyed by (voices, passes, feat,
    rows): the regression gate's reference points.  None without a
    baseline, or when it was run at other seconds, chunk or arithmetic
    (its walls then time other work)."""
    if not BASELINE.exists():
        return None
    base = json.loads(BASELINE.read_text())
    if (base.get("seconds_each"), base.get("chunk_blocks"),
            base.get("arith")) != (seconds, chunk, arith):
        return None
    return {(b["voices"], b.get("passes"), b.get("feat"), b["rows"]):
            b["x_rt"] for b in base["buckets"]}


def _error(msg, code):
    print(json.dumps({"metric": "batched_render_throughput", "value": 0.0,
                      "unit": "x_realtime_per_card", "vs_baseline": 0.0,
                      "error": msg}), flush=True)
    sys.exit(code)


def launch_counters() -> dict:
    """name -> kernel wrapper: each adds one to its ``launches`` where it
    launches its kernel (a CPU tensor runs the plain version and counts
    nothing)."""
    from skred_tpu_torch.engine.kernels import compat as cm
    from skred_tpu_torch.engine.kernels import cyclic as ck
    from skred_tpu_torch.engine.kernels import filt_smooth as fs
    from skred_tpu_torch.engine.kernels import lookup as lk
    from skred_tpu_torch.engine.kernels import phase_walk as pw
    from skred_tpu_torch.engine.kernels import tier as tk
    from skred_tpu_torch.engine.kernels import volume as vk

    return dict(tier=tk.tier, tier_keyed=tk.tier_keyed,
                phase_walk_warp=pw.phase_walk_warp,
                lookup=lk.lookup, table_lookup=lk.table_lookup_pallas,
                table_lookup_grouped=lk.table_lookup_grouped,
                filt_smooth_noise=fs.filt_smooth_noise,
                cyclic=ck.cyclic_block,
                cyclic_fixed=ck.cyclic_fixed,
                cyclic_general=ck.cyclic_general, compat=cm.compat_block,
                volume=vk.volume)


def main(seconds: float = 10.0, replicas: int = 4, fast: bool = False,
         chunk: int = CHUNK, device="cuda", scripts=None,
         max_rows=None, select=None, detail_file=None) -> dict:
    """Run the bench; returns the final detail record (also written to
    ``detail_file``, default ``build/bench_detail_torch.json``).  ``scripts``
    defaults to the in-repo scripts; ``max_rows`` cuts every bucket's
    rows (tests); ``select``, a predicate over a
    ``parallel.buckets.Bucket``, keeps the buckets it is true of
    (``skred_tpu_torch/tools/bench_subset.py``)."""
    from skred_tpu_torch.engine import cyclic, fused
    from skred_tpu_torch.engine.kernels import build
    from skred_tpu_torch.parallel.buckets import SCRIPTS, make_buckets
    from skred_tpu_torch.parallel.roofline import estimate_bucket

    card.refuse_ablated("bench_torch", fail=_error)
    card.require(device, "bench_torch", fail=_error)
    info = card.card_info(device)
    on_card = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(0) if on_card else str(device)
    sync = lambda: card.sync(device)
    scripts = list(SCRIPTS if scripts is None else scripts)
    buckets = [bk for bk in make_buckets(scripts, seconds, replicas,
                                         max_rows)
               if select is None or select(bk)]
    exact = False if fast else None
    counters = launch_counters()
    baseline = _load_baseline(seconds, chunk, "fast" if fast else "exact")
    detail, regressions = [], []
    total = {"audio": 0.0, "wall": 0.0, "checksum": 0.0}

    def emit(partial):
        x_rt = total["audio"] / total["wall"] if total["wall"] else 0.0
        slowest = min(detail, key=lambda b: b["x_rt"], default=None)
        headline = {
            "metric": "batched_render_throughput",
            "value": round(x_rt, 2),
            "unit": "x_realtime_per_card",
            "vs_baseline": round(x_rt, 2),
            "buckets": len(detail),
            "slowest_bucket_x_rt": slowest["x_rt"] if slowest else None,
            "distinct_scripts": len(scripts),
            "total_audio_s": round(total["audio"], 1),
            "total_wall_s": round(total["wall"], 3),
            "arith": "fast" if fast else "exact",
            "card": info,
        }
        if partial:
            headline["partial"] = True
            headline["buckets_total"] = len(buckets)
        if regressions:
            headline["regressions"] = len(regressions)
        record = {**headline, "device": kind, "replicas": replicas,
                  "seconds_each": seconds, "chunk_blocks": chunk,
                  "note": "audio credited per whole chunk only; rows = "
                          "replicated batch size; setup_s = _prepare "
                          "alone, inside the timed window as in bench.py",
                  "buckets": detail, "regression_list": regressions,
                  "checksum": total["checksum"]}
        path = pathlib.Path(DETAIL if detail_file is None
                            else detail_file)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1))
        print(json.dumps(headline), flush=True)
        return record

    def timed(fn, passes, label):
        """Host-clock walls of ``passes`` calls of ``fn`` and their
        checksums; every pass must give the same checksum, and none may
        build a kernel."""
        walls, sums = [], []
        built = dict(build.LOG)
        for _ in range(passes):
            sync()
            t0 = time.perf_counter()
            sums.append(fn())
            sync()
            walls.append(time.perf_counter() - t0)
        new = sorted(k for k in build.LOG if build.LOG[k] is not built.get(k))
        if new:
            _error(f"{label}: a timed pass built {new}", 1)
        if len(set(sums)) != 1:
            _error(f"{label}: nondeterministic render, checksums {sums}", 1)
        return walls, sums

    for bk in buckets:
        if bk.kind == "compat":
            entry = compat_bucket(bk, device, sync, timed, counters)
            total["checksum"] += entry.pop("checksum")
            total["audio"] += entry.pop("audio_s")
            total["wall"] += entry["wall_s"]
            detail.append(entry)
            emit(partial=True)
            continue
        st = bk.st
        label = f"{bk.kind} bucket {','.join(bk.scripts)}"
        whole = st.num_blocks // chunk
        if bk.kind == "fused":
            run = lambda warm=False, st=st: fused.render_fused_stream_device(
                st, chunk, exact=exact, warmup_only=warm, device=device)
            prep = lambda st=st: fused._prepare(
                st, exact, device, noise_blocks=whole * chunk)
        else:
            run = lambda warm=False, st=st: \
                cyclic.render_cyclic_stream_device(
                    st, chunk, warmup_only=warm, device=device)
            prep = lambda st=st: cyclic._prep(st, True, device,
                                              noise_blocks=whole * chunk)
        run(warm=True)                              # builds every kernel
        sync()
        t0 = time.perf_counter()
        prep()
        sync()
        setup_s = time.perf_counter() - t0
        for fn in counters.values():
            fn.launches = 0
        walls, sums = timed(run, 2, label)
        launches = {nm: fn.launches for nm, fn in counters.items()
                    if fn.launches}
        wall = min(walls)
        total["checksum"] += sums[0]
        blocks = whole * chunk
        audio = st.batch * blocks * st.block / 44100.0
        total["audio"] += audio
        entry = {"voices": bk.voices if bk.kind == "fused"
                 else f"cyclic-{bk.voices}v", "rows": st.batch,
                 "scripts": bk.scripts, "distinct_scripts": len(bk.scripts),
                 "compiler": bk.compilers, "blocks": blocks,
                 "wall_s": round(wall, 3), "x_rt": round(audio / wall, 1),
                 "wall_spread": [round(min(walls), 3),
                                 round(max(walls), 3)],
                 "timed_passes": len(walls), "setup_s": round(setup_s, 3),
                 "launches": launches, "checksums": sums,
                 "roofline": estimate_bucket(st, kind).roofline(wall,
                                                                blocks)}
        if bk.kind == "fused":
            entry.update(passes=bk.passes, feat=bk.feat)

        def run_more(n, run=run, walls=walls, entry=entry, label=label):
            more, again = timed(run, n, label)
            if again[0] != entry["checksums"][0]:
                _error(f"{label}: nondeterministic render, checksums "
                       f"{entry['checksums']} then {again}", 1)
            walls.extend(more)
            entry["wall_spread"] = [round(min(walls), 3),
                                    round(max(walls), 3)]
            entry["timed_passes"] = len(walls)
            return min(walls)

        wall = gate(entry, bk.key, baseline, regressions, run_more, audio)
        total["wall"] += wall
        detail.append(entry)
        emit(partial=True)
    return emit(partial=False)


def compat_bucket(bk, device, sync, timed, counters) -> dict:
    """The compat-scan bucket (``bench.py:371-397``): ``render_stacked``
    over the refused scripts' rows, a warm pass, then one pass through
    ``timed`` (no build, and the warm pass's checksum) unless the warm
    pass took more than ``COMPAT_BUDGET_S``, when its wall is credited
    (``timed_cold``).  Returns the bucket's detail entry with its
    ``checksum`` and credited ``audio_s`` for the totals."""
    from skred_tpu_torch.host.timeline import noise_stream
    from skred_tpu_torch.parallel.batch import render_stacked

    st = bk.st
    label = f"compat bucket {','.join(bk.scripts)}"
    noise = noise_stream(st.num_blocks * st.block)

    def run():
        out = render_stacked(st, noise=noise, device=device)
        return float(np.abs(out[-1]).sum())

    def reset():
        for fn in counters.values():
            fn.launches = 0

    reset()
    sync()
    t0 = time.perf_counter()
    sums = [run()]                           # builds the kernel, warms
    sync()
    wall = time.perf_counter() - t0
    timed_cold = wall > COMPAT_BUDGET_S
    if not timed_cold:
        reset()
        (wall,), again = timed(run, 1, label)
        sums += again
        if again != sums[:1]:
            _error(f"{label}: nondeterministic render, checksums {sums}", 1)
    audio = st.batch * st.num_blocks * st.block / 44100.0
    return {"voices": "compat-scan", "rows": st.batch,
            "scripts": bk.scripts, "distinct_scripts": len(bk.scripts),
            "compiler": bk.compilers, "blocks": st.num_blocks,
            "wall_s": round(wall, 3), "timed_cold": timed_cold,
            "x_rt": round(audio / wall, 1),
            "launches": {nm: fn.launches for nm, fn in counters.items()
                         if fn.launches},
            "checksums": sums, "checksum": sums[0], "audio_s": audio}


def gate(entry, key, baseline, regressions, run_more, audio):
    """Regression gate with reproduction in the same run: a drop of more
    than 10% against the baseline times the bucket three more times and
    is listed only if the best of all passes still shows it.  ``audio``:
    the bucket's credited seconds.  Returns the bucket's wall."""
    prev = baseline.get(key) if baseline is not None else None
    if not prev:
        return entry["wall_s"]
    delta = entry["x_rt"] / prev - 1.0
    entry["x_rt_prev"] = prev
    entry["delta_vs_baseline"] = round(delta, 3)
    if delta < -0.10:
        wall = run_more(3)
        x_rt2 = round(audio / wall, 1)
        delta = x_rt2 / prev - 1.0
        entry.update(x_rt=x_rt2, wall_s=round(wall, 3),
                     delta_vs_baseline=round(delta, 3))
        if delta < -0.10:
            regressions.append({"bucket": list(key), "x_rt": x_rt2,
                                "prev": prev, "delta": round(delta, 3),
                                "reproduced_over_passes":
                                    entry["timed_passes"]})
            print(f"REGRESSION (reproduced x{entry['timed_passes']}) {key} "
                  f"{prev} -> {x_rt2} ({delta:+.1%})", file=sys.stderr,
                  flush=True)
        else:
            print(f"noise: flagged drop did not reproduce {key} best "
                  f"{x_rt2} vs prev {prev}", file=sys.stderr, flush=True)
    return entry["wall_s"]


if __name__ == "__main__":
    _args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(seconds=float(_args[0]) if _args else 10.0,
         replicas=int(_args[1]) if len(_args) > 1 else 4,
         fast="--fast" in sys.argv[1:])
