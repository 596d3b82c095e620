"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout, holds each against its
plain PyTorch version, renders corpus/stress64.sk (64 voices, the
reference's design point) at 1024 rows x 10 s through the port's main
path, and checks the audio.  Phases, in order (any failure exits
non-zero):

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc for every csrc/*.cu, all started together
  3. kernel   tier vs tier_plain on the card, bit for bit, on random
              blocks of stress64's two tier feature sets (N=512, M=8192)
  4. main     bucket_key -> fill_bucket -> stack_timelines (1024 rows)
              -> pack_stacked -> pad_segments_pow2 ->
              render_fused_stream_device(chunk_blocks=172): one warm-up,
              one timed pass with the launch counts read around it, a
              profiled chunk; then the kernel alone, its plain version
              and its bound at the main path's tier-1 call
  5. short    the first 4 blocks at 8 rows through the kernel path and
              through a tier_plain path on the card (bit for bit), and
              against the port's CPU render (-100 dB)

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Needs torch with CUDA and nvcc; imports
nothing of JAX.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_FLOPS = 67e12                  # H100 SXM f32 outside the tensor cores
SECONDS = 10.0
ROWS = 1024
CHUNK = 172
HERE = pathlib.Path(__file__).resolve().parent


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back
    calls, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def same_bits(a, b):
    a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
    if a.dtype == np.float32:
        return bool((a.view(np.int32) == b.view(np.int32)).all())
    return bool((a == b).all())


def to_card(args, dev):
    table, cbase, inc, dm, amod, vecs, states = args
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    return (t(table), cbase, t(inc), t(dm), t(amod),
            {k: t(v) for k, v in vecs.items()},
            {k: t(v) for k, v in states.items()})


def tier_bound(targs, feat, n):
    """Least time for one tier call on this card: each input read once
    and each output written once over the memory rate, against the f32
    operations per lane-sample over the f32 rate (fma counted as 2)."""
    from skred_tpu_torch.engine.kernels.tier import _flags, _state_keys

    table, cbase, inc, dm, amod, vecs, states = targs
    fl = _flags(feat)
    m = vecs["amp"].shape[0]
    nbytes = lambda x: 0 if x is None else x.numel() * x.element_size()
    read = sum(nbytes(x) for x in (table, inc, dm, amod)) \
        + sum(nbytes(v) for v in vecs.values()) \
        + sum(nbytes(v) for v in states.values())
    write = n * m * 4 + m * 4 * (len(_state_keys(fl)) + 1)
    ops = 6                                   # phase walk
    ops += 3 if fl["fm"] else 0               # read*depth, fma
    ops += 5 if fl["cz"] else 0               # normalise, knee curve, scale
    ops += 3 if fl["quant"] else 0
    ops += 9 if fl["flt"] else 0              # mul + 4 fma
    ops += 3 if fl["sm"] else 0
    ops += 12 if fl["env"] else 0
    ops += 2 if fl["am"] else 0
    ops += 1                                  # out = s3 * gain
    t_bytes = (read + write) / HBM_BYTES_PER_S * 1e3
    t_ops = ops * n * m / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "card")
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.engine import fused
    from skred_tpu_torch.engine.kernels import build, tier as tk
    from skred_tpu_torch.engine.kernels.tier_inputs import (
        STRESS64_TIER0, STRESS64_TIER1, random_tier_inputs)
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import (bucket_key, fill_bucket,
                                                pack_stacked,
                                                pad_segments_pow2,
                                                stack_timelines)

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    card = f"{kind} ({smi})"

    # ---- 2. build ----
    t0 = time.time()
    secs = build.build_all()
    build_s = time.time() - t0
    log(f"build: {len(secs)} source(s) in {build_s:.1f} s")
    for name, (s, out) in build.LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    build.load("tier")

    # ---- 3. kernel vs plain on random blocks ----
    max_err = 0.0
    for name, feat in (("tier0", STRESS64_TIER0),
                       ("tier1", STRESS64_TIER1)):
        targs = to_card(random_tier_inputs(feat, 512, 8192, seed=11), dev)
        out, res = tk.tier(*targs, feat=feat, n=512)
        torch.cuda.synchronize()
        want, want_res = tk.tier_plain(*targs, feat=feat, n=512)
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        max_err = max(max_err, err)
        bad = [k for k in want_res if not same_bits(res[k], want_res[k])]
        log(f"kernel {name}: max|diff| {err} vs plain, end states "
            f"{'equal' if not bad else 'DIFFER: ' + ','.join(bad)}, "
            f"launches {tk.tier.launches}")
        if not same_bits(out, want) or bad:
            fail(f"tier kernel disagrees with tier_plain on {name}")

    # ---- 4. main path at full width ----
    lines = (HERE / "corpus" / "stress64.sk").read_text().splitlines()
    bank = WaveBank()
    t0 = time.time()
    tl = compile_script(lines, SECONDS, bank=bank,
                        script_dir=HERE / "corpus")
    vp, passes, _ = bucket_key(tl)
    rows = fill_bucket([tl], vp)[:ROWS]
    st = pad_segments_pow2(pack_stacked(stack_timelines(rows)))
    log(f"main: {st.batch} rows x {vp} voices, tiers {st.tiers}, "
        f"{st.num_blocks} blocks, host compile+pack "
        f"{time.time() - t0:.1f} s")
    if st.batch != ROWS or vp != 64 or len(st.tiers) != 2:
        fail(f"unexpected bucket: {st.batch} rows, {vp} voices, "
             f"tiers {st.tiers}")

    # capture the main path's own tier calls (first block of each tier)
    captured = {}
    real_tier = fused.tier

    def capture(*a, **kw):
        m = a[5]["amp"].shape[0]
        if m not in captured:
            captured[m] = (a, kw)
        return real_tier(*a, **kw)

    fused.tier = capture
    try:
        fused.render_fused_stream_device(st, CHUNK, warmup_only=True,
                                         device=dev)
    finally:
        fused.tier = real_tier
    torch.cuda.synchronize()

    whole = st.num_blocks // CHUNK * CHUNK
    tk.tier.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    cs = fused.render_fused_stream_device(st, CHUNK, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = tk.tier.launches
    audio_s = st.batch * whole * st.block / 44100.0
    log(f"main: wall {wall:.3f} s, {audio_s / wall:.1f}x realtime "
        f"({st.batch} rows x {whole * st.block / 44100.0:.3f} s rendered), "
        f"tier launches {launches} ({whole} blocks x 2 tiers), checksum "
        f"{cs}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"on {card}")
    if launches != 2 * whole:
        fail(f"tier.launches {launches} != 2 x {whole} blocks")
    if not (np.isfinite(cs) and cs > 0):
        fail(f"bad checksum {cs}")

    # device time by kernel over one profiled chunk
    prof_line = "profile: not measured"
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.time()
            fused.render_fused_stream_device(st, CHUNK, warmup_only=True,
                                              device=dev)
            torch.cuda.synchronize()
            pwall = time.time() - t0
        dev_us = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            if us and e.device_type is not None \
                    and "cuda" in str(e.device_type).lower():
                dev_us[e.key] = (us, e.count)
        if dev_us:
            busy = sum(u for u, _ in dev_us.values()) / 1e6
            tus = [(u, c) for k, (u, c) in dev_us.items()
                   if "tier_kernel" in k]
            tier_part = (f"tier_kernel {tus[0][0] / 1e3 / tus[0][1]:.3f} "
                         f"ms/call x {tus[0][1]}" if tus else
                         "tier_kernel not found")
            top = sorted(dev_us.items(), key=lambda kv: -kv[1][0])[:6]
            prof_line = (f"profile ({CHUNK} blocks, wall {pwall:.3f} s): "
                         f"device busy {busy:.3f} s = "
                         f"{100 * busy / pwall:.1f}% of wall; {tier_part}; "
                         "top: " + "; ".join(
                             f"{k[:40]} {u / 1e3:.1f} ms/{c}"
                             for k, (u, c) in top))
    except Exception as ex:   # noqa: BLE001 - the profiler is optional
        prof_line = f"profile: not measured ({type(ex).__name__}: {ex})"
    log(prof_line)

    # the kernel alone at the main path's tier calls
    timings = {}
    for m, (a, kw) in sorted(captured.items()):
        feat, n = kw["feat"], kw["n"]
        targs = a
        args, out, outs = tk._pack_args(*targs, feat, True, n)
        ms = cuda_ms(lambda: tk.launch(args, dev), 20)
        t0 = time.time()
        want, want_res = tk.tier_plain(*targs, feat=feat, n=n)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        if not same_bits(out, want) or any(
                not same_bits(outs[k], want_res[k]) for k in want_res):
            fail(f"tier kernel disagrees with tier_plain on the main "
                 f"path's M={m} call")
        bound_ms, bound_by = tier_bound(targs, feat, n)
        timings[m] = (ms, plain_ms, bound_ms, bound_by)
        log(f"tier M={m} N={n}: kernel {ms:.4f} ms/call, plain "
            f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"main-path inputs bit-equal to plain, on {card}")

    m_hi, m_lo = max(timings), min(timings)
    log(f"main summary: wall {wall:.3f} s, {audio_s / wall:.1f}x realtime, "
        f"tier kernel {timings[m_hi][0]:.4f} ms/call at M={m_hi} and "
        f"{timings[m_lo][0]:.4f} ms/call at M={m_lo} (CUDA events), on "
        f"{card}")

    # ---- 5. short path vs plain on the card, and vs the CPU ----
    tl4 = compile_script(lines, 4 * 512 / 44100.0, bank=bank,
                         script_dir=HERE / "corpus")
    st4 = pack_stacked(stack_timelines([tl4] * 8))
    if st4.num_blocks != 4:
        fail(f"short render has {st4.num_blocks} blocks, not 4")
    a = fused.render_fused(st4, device=dev)
    fused.tier = tk.tier_plain
    try:
        b = fused.render_fused(st4, device=dev)
    finally:
        fused.tier = real_tier
    c = fused.render_fused(st4, device="cpu")
    peak = float(np.abs(c).max())
    db_plain = 20 * np.log10(max(float(np.abs(a - b).max()), 1e-30) / peak)
    db_cpu = 20 * np.log10(max(float(np.abs(a - c).max()), 1e-30) / peak)
    verdict = lambda x, y, db: ("bit-equal" if np.array_equal(x, y)
                                else f"{db:.1f} dB")
    log(f"short: 8 rows x 4 blocks, kernel path vs plain path on card "
        f"{verdict(a, b, db_plain)}, card vs CPU render "
        f"{verdict(a, c, db_cpu)}, peak {peak:.3f}")
    if not np.all(np.isfinite(a)) or a.shape != (8, 4 * 512, 2):
        fail("short render: bad shape or non-finite samples")
    if not np.array_equal(a, b) and db_plain > -100:
        fail(f"kernel path vs plain path {db_plain:.1f} dB")
    if db_cpu > -100:
        fail(f"card render vs CPU render {db_cpu:.1f} dB")

    m1 = max(timings)
    ms, plain_ms, bound_ms, bound_by = timings[m1]
    log(json.dumps({"kernels": [{
        "name": "tier", "route": "cuda",
        "source": "skred_tpu_torch/engine/kernels/csrc/tier.cu",
        "replaces": "skred_tpu/engine/kernels.py:1999",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
