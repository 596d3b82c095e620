"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout, holds each against its
plain PyTorch version, renders the in-repo scripts at 1024 rows through
the port's main paths, and checks the audio: corpus/stress64.sk (64
voices, the reference's design point), whose two tiers take the tier
kernel with its in-kernel stereo mix and, in tier 1, its modulator-bank
fold; skred_tpu_torch/scripts/noise64.sk (stress64 with noise voices
in both tiers), whose tiers take the noise pass (the keyed phase walk
with its reads, FM increment, CZ warp and clip; the table lookup; the
keyed filter/smoother with its noise select, dead mask, envelope and am
stream); and corpus/fb1-fb5.sk, whose cyclic modulation
graphs take the cyclic kernel; the compat engine renders stress64
through its own kernel; a mesh splits batches' rows, and the command
line renders through both engines.  Phases, in order (any failure exits
non-zero), each new one reading the launch counts set to 0 just before
it:

  1. device       the card's name and power limit (nvidia-smi), and its
                  peaks from skred_tpu_torch/parallel/roofline.py (a card
                  the table does not hold fails the run: every bound
                  would be a guess)
  2. build        the native host compiler (g++, csrc/skred_host.cpp into
                  build/host/); nvcc for every csrc/*.cu that builds
                  without a key (cyclic.cu's general variant, lookup.cu,
                  fma_probe.cu; the others build under a key only), for
                  the compat kernel's keys (the compat phase's, batch's
                  and repair's renders and the stamp build), for the
                  cyclic kernel's keys
                  (fb1-fb5 as the main path and the kernel phase render
                  them, and the all-features script), for the tier
                  kernel's keys (stress64's tiers with mix and fold on and
                  off, and the kernel phase's calls) and for the keyed
                  noise kernels' (noise64's tiers), all started
                  together; seconds, registers and spills of each (a build
                  that spills fails the run, but for the cyclic kernel's)
  3. kernel       every kernel vs its plain version on the card, bit for
                  bit, on random blocks (N=512, M=8192): tier, on
                  stress64's two tier feature sets, and with the mix,
                  with the fold of each of fm / cz / am and of all three
                  (per-lane sources, some outside the bank), and with
                  both, writing into a block buffer's columns and adding
                  onto earlier accumulators; the keyed phase_walk and
                  filt_smooth with their glue on noise64's, over a bank
                  of 4 voices (the walk also with operands outside its
                  fast wrap's range); the lookups
                  (grouped and single-lane forms at 4096- and
                  32768-sample slots, and the noise pass's base/limit
                  form); cyclic, keyed and general variants, on fb1's,
                  fb2's, fb3's, fb5's and an all-features script's own
                  vectors with random states (512 frames x 1024 rows) and
                  on the all-features script with operands outside the
                  keyed variant's fast range (64 frames), the general one
                  also on a 64-voice ring above the keyed variant's cap
                  (16 frames); the volume kernel at the main path's shape
                  (1024 rows x 512 samples) and at its largest n (4096
                  samples x 33 rows), bit for bit, with its time by CUDA
                  events (in a CUDA graph, and launched from Python)
                  beside its bytes bound and the plain version's time
  4. main         stress64: bucket_key -> fill_bucket -> stack_timelines
                  (1024 rows) -> pack_stacked -> pad_segments_pow2 ->
                  render_fused_stream_device(chunk_blocks=172): one
                  warm-up, one timed pass with the launch counts read
                  around it (every tier launch the keyed library's, one
                  volume launch a block), a profiled chunk; then each kernel alone, its plain
                  version and its bound on the path's own first-block
                  inputs, and the tier kernel in two turns at tier 1 and
                  tier 0 with clocks.sm, the mix kernel alone, the
                  SASS instructions of one sample step, and the issue and
                  chain floors beside the bytes bound.  Mix and fold are
                  on (the default).  Then a 2-chunk batch of stress64
                  rendered with mix and fold on, off, off, on, each
                  configuration profiled and its tier calls timed alone
  5. short        stress64's first 4 blocks at 8 rows through the kernel
                  path and a plain-version path on the card (the tier
                  and volume kernels' plain versions; bit for bit), against the port's CPU render (-100 dB) and
                  against the card's render with mix and fold off
                  (-120 dB: the voice sum's order); then the same for a
                  repeat-passes script (two segments whose union graph
                  is cyclic: no tiers, estimate passes)
  6. noise main   noise64 as in 4, cut to 2 chunks (344 blocks, 3.99 s
                  of audio per row) to keep the run short: the keyed
                  phase walk, the lookup and the keyed filter/smoother
                  launched twice per block, the tier kernel never;
                  torch.take timed beside the lookup.  Then on the first
                  block's inputs of each tier: the "noise block rest"
                  line (the device time of the block around the noise
                  pass); the "noise turns" lines (each keyed kernel in
                  two turns, each bit-equal to the plain version, with
                  its SASS instructions a sample step, issue floor and
                  bytes bound); the "noise alone" lines (each kernel
                  alone);
                  the single-lane lookup's form alone (row 6's shape);
                  the "lookup turns" lines: the lookup in turns with
                  torch.take (each turn 20 calls in a CUDA graph, so that
                  the device time is read, not the launch from Python)
                  on tier 1's and tier 0's first-block calls
                  and at row 6's shape (lane-major, N=512, M=8192,
                  32768-sample slots), each kernel turn bit-equal to the
                  plain version, with the SASS instructions an element,
                  the issue floor, the bytes bound, the bandwidth
                  reached as a share of the card's memory rate and a
                  device copy of the same bytes
  7. noise short  noise64 as in 5
  8. cyclic main  each of fb1-fb5: stack_timelines (1024 rows) ->
                  pack_stacked(cyclic=True) ->
                  render_cyclic_stream_device(chunk_blocks=172), 10 s
                  for fb2 and fb5, 2 chunks (3.99 s) for fb1, fb3 and
                  fb4 to keep the run short:
                  one warm-up, one timed pass with the launch counts
                  read around it (one keyed-variant launch per block, no
                  other kernel); then a 16-voice ring, above the keyed
                  variant's cap, for 1 chunk of 43 blocks (one
                  general-variant launch per block); a profiled chunk of
                  fb2 and of fb4 (4 segments); both variants alone on
                  fb2's and fb5's first-block inputs at 1024 and at
                  16,384 rows (the same inputs tiled), timed in turns
                  (general, keyed, keyed, general), each bit-equal to
                  the plain version (at 16,384 rows its 1024-row result
                  tiled), with clocks.sm beside them, and the bound
  9. cyclic short fb2, and fb4 with its waits cut to 0.012 s (a segment
                  per block), at 8 rows x 4 blocks, as in 5
 10. compat       the compat engine (engine/render.py, one CUDA block of
                  64 threads a row, csrc/compat.cu, a library per key):
                  each key it renders under with its build seconds; the
                  kernel against
                  its plain version on the card, bit for bit, on 8 rows x
                  2 blocks of stress64, noise64, fb2, fb4 cut to a segment
                  a block and a voice copy ('>' of a voice with sample &
                  hold on), exact and fast, 1 and 2 passes, capture on and
                  off, and on the next 2 blocks from the kernel's carry;
                  the card's render of the 4 blocks against the CPU's,
                  bit for bit, on the output and the capture; the main
                  path, stress64
                  10 s through render_stream_device (172-block chunks) at
                  1 row, 1 row with capture and 1024 rows, each with its
                  launches read around it (the compat kernel alone, a
                  launch a chunk), ms a block, x realtime, a static
                  SASS issue estimate a sample step and the stamped chain
                  (tools/compat_stamps.py's stage cycles at 1 and 1024
                  rows, logged stage by stage); the plain
                  version and the bound on the 1024-row run's first
                  block, the kernel held to the plain version bit for bit
                  on that block and on blocks 172-173 from its own carry;
                  the compat render of stress64 against the fused one,
                  both on the card (<= -60 dB); the fused engine's
                  capture (stress64, noise64, 8 rows x 2 blocks) on the
                  card: its capture bit-equal to the CPU's, its output
                  against the CPU's (<= -120 dB), against the captured
                  voices' sum times the volume gain and against the
                  render with the kernel's mix and fold (<= -100 dB); the
                  recorder's WAV on the card against the CPU's, byte for
                  byte
 11. batch        render_batch over stress64, noise64 and fb1-fb5 at
                  0.25 s: finite, no silent row, every kernel launched but
                  the compat kernel; then with engine="compat": the
                  compat kernel alone; the cyclic rows against the compat
                  rows, fb1 and fb4 within -60 dB
 12. repair       fast mode of the feedback engines, fb1 and fb4 at 8 rows
                  x 5 blocks: the compat kernel's fast render equals its
                  exact render bit for bit, the cyclic kernel's fast
                  render is within -60 dB of the compat exact render (the
                  kernel phase holds the cyclic kernel in fast mode to its
                  plain version too, on fb1's vectors)
 13. mesh         a mesh of two entries on the card, ["cuda:0", "cuda:0"]:
                  stress64 and noise64 at 8 rows x 4 blocks through
                  render_fused, the seven scripts through render_batch
                  (the fused and cyclic groups' rows split over it),
                  each bit-equal to its render without a mesh;
                  entry_torch.entry()'s step (one compat launch, equal to
                  render_stacked) and entry_torch.dryrun_multichip(2)
 14. cli          python -m skred_tpu_torch.cli's main: render stress64
                  (1 s) with --engine fused and --engine compat, each WAV
                  byte for byte the library render's; batch over fb1-fb5
                  with its wall and x realtime
 15. tools        the root tools on the card (skred_tpu_torch/tools/):
                  card_parity --bucketed at 1 s over the seven scripts,
                  exact and --fast, each script's dB against the compat
                  engine (<= -60 dB); endurance oracle and run, stress64
                  10 s at 1024 rows: the start, mid and end windows'
                  dB (<= -60), host RSS and device memory (after the
                  last full chunk within 1 MiB of after the first);
                  one_bucket on fb2 at 4 s; gluebench on stress64 and
                  noise64, one pass of one chunk at 256 rows: each
                  stubbed run and the real kernels back after it (its
                  ms a block are the host's noise at this cut); the
                  bench over fb1 and fb4 at 4 s with the cyclic gate
                  forced to refuse fb4: a compat-scan bucket, counted
                  into the headline
 16. ablate       the timing-ablation switches (SKRED_MEGA_ABLATE,
                  SKRED_CYC_ABLATE; this script refuses to start under
                  either): the main paths' keys hold no ablation define;
                  every ablated build of stress64's two tier calls and of
                  fb2's keyed cyclic call (1024 rows) made in one
                  parallel build; each build alone on the first block
                  (tools/mega_ablate.py's kernel rows: 20 calls in a CUDA
                  graph by CUDA events, in turns with the full build),
                  with its SASS a sample step, each stub changing the
                  output and leaving fewer instructions than full (mix:
                  the mix kernel launched 0 times, by the library's
                  own count), and the single stubs of the skeleton's
                  phases removing at most 10% more SASS together than
                  the skeleton (no instruction in two stubs' shares); a
                  phase the key does not compile in is reported, not
                  built; the environment route once (one_bucket stress64
                  2 s under SKRED_MEGA_ABLATE=phase4, every line marked
                  ABLATED); tools/op_census.py on stress64 and noise64,
                  one steady block at 1024 rows on the card and at 8 on
                  the CPU; tools/fma_probe.py (NOT-CONTRACTED under the
                  port's flags, CONTRACTED under -fmad=true, __fmaf_rn
                  bit-equal to numerics.fma32)
 17. bench        bench_torch.main at 4 s (2 chunks of 172 blocks): its
                  headline and, per bucket, x_rt, wall spread, set-up
                  seconds and roofline label; it fails unless there are
                  seven buckets (stress64, noise64, fb1-fb5), each
                  compiled by the native compiler, with equal checksums
                  over its timed passes, no build inside them (the bench
                  itself exits 1 on either), and the launches its path
                  needs: the keyed tier kernel on stress64, the keyed
                  walk, the lookup and the keyed filter on noise64, the
                  keyed cyclic kernel on fb1-fb5, not the general
                  cyclic variant

Every bound comes from skred_tpu_torch/parallel/roofline.py, and the
profiled chunks are aggregated by skred_tpu_torch/tools/profile_roofline.py.

The line before the last is the kernels' JSON record (``launches`` from
the main paths' timed passes, ``bench_launches`` from the bench's); the
last line is
{"ok": true, "device": {...}}.  Needs torch with CUDA and nvcc; imports
nothing of JAX.
"""

import ctypes
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from skred_tpu_torch.parallel import roofline
from skred_tpu_torch.parallel.roofline import nbytes
from skred_tpu_torch.tools.sass_locals import sass_functions, sass_loop

SECONDS = 10.0
ROWS = 1024
CHUNK = 172
HERE = pathlib.Path(__file__).resolve().parent
STRESS64 = HERE / "corpus" / "stress64.sk"
NOISE64 = HERE / "skred_tpu_torch" / "scripts" / "noise64.sk"
NOISE64_SECONDS = 4.0              # 344 whole blocks: 2 chunks of 172
FEEDBACK = [HERE / "corpus" / f"fb{i}.sk" for i in range(1, 6)]
# each segment's modulation graph is acyclic, their union is not: the
# pack gives no tiers and the render repeats estimate passes
UNION_CYCLE = ["v0 w0 f330 a3 F1,0.5", "v1 w2 f2 a2",
               "v2 w0 f220 a2 p0.3 ~.02 v0 F1,0 v1 F0,0.4"]
WIDE_ROWS = 16 * ROWS              # the cyclic kernel's second row count
# a ring of FM edges over 16 voices: above the keyed variant's cap
RING16 = [f"v{v} w{v % 3} f{50 + 7 * v} a5 F{(v + 1) % 16},0.3"
          for v in range(16)]
KERNEL_N, KERNEL_M = 512, 8192


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


T0 = time.time()


def phase(name):
    log(f"== {name} (at {time.time() - T0:.1f} s)")


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


def graph_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` calls captured in
    one CUDA graph, by CUDA events around its replay, after a warm-up
    call: the device runs the calls back to back, so a call shorter than
    its launch from Python is timed, not the host."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def host_ms(fn):
    """Host milliseconds of one call of ``fn`` that ends in a
    synchronize (for the plain versions: thousands of small launches)."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3, out


def same_bits(a, b):
    """Bit for bit, except that two NaNs agree whatever their payload (the
    card's fma gives another NaN than its other operations); a NaN
    against a number differs."""
    if a is None or b is None:
        return a is None and b is None
    a, b = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in (a, b))
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == np.float32:
        both_nan = np.isnan(a) & np.isnan(b)
        return bool(((a.view(np.int32) == b.view(np.int32)) | both_nan)
                    .all())
    return bool((a == b).all())


def max_abs(a, b):
    """max |a - b| over the elements where the two differ: equal values
    (infinities too) and NaN against NaN count 0; a NaN or an infinity
    against anything else gives NaN or inf."""
    if a is None or not a.is_floating_point() or not a.numel():
        return 0.0
    agree = (a == b) | (a.isnan() & b.isnan())
    return float(torch.where(agree, 0.0, (a - b).abs()).max())


def to_card(arrs, dev):
    return [None if a is None else torch.from_numpy(a).to(dev) for a in arrs]


# ---- per-kernel: the launch of packed arguments, the plain version, the
# bound, each taking (a, kw): the positional and keyword arguments as the
# renderer passed them.

def tier_spec(tk, peaks):
    from skred_tpu_torch.engine.kernels.tier import _flags, _folded

    def pack(a, kw):
        args, out, outs = tk._pack_args(
            *a, feat=kw["feat"], exact=kw.get("exact", True), n=kw["n"],
            b=kw.get("b"), mixw=kw.get("mixw"), acc=kw.get("acc"),
            fold=kw.get("fold"), out=kw.get("out"))
        return args, [out] + [outs[k] for k in sorted(outs)]

    def flat(result):
        out, res = result
        return [out] + [res[k] for k in sorted(res)]

    def fresh(a, kw, plain):
        """The call with accumulators of its own (a call adds onto them
        in place); the plain version also gets an output of its own, so
        that it does not write over the kernel's."""
        kw = dict(kw)
        if kw.get("acc") is not None:
            kw["acc"] = tuple(x.clone() for x in kw["acc"])
        if plain:
            kw["out"] = None
        return a, kw

    def key(kw):
        return tk.tier_key(kw["feat"], kw.get("exact", True),
                           kw.get("mixw") is not None,
                           _folded(_flags(kw["feat"]), kw.get("fold")))

    def launch(args, kw, dev, entry=None):
        """A launch of packed ``args`` that counts no launch: the library
        for ``kw``'s key; ``entry`` "mix" launches its mix kernel
        alone."""
        from skred_tpu_torch.engine.kernels import cuda_call

        e = "tier_mix_launch" if entry == "mix" else "tier_keyed_launch"
        return lambda: cuda_call.launch("tier", args, dev, key(kw), e)

    return dict(name="tier", fn=tk.tier, pack=pack, fresh=fresh, key=key,
                launch=launch, symbol="tier_keyed",
                folded=lambda kw: _folded(_flags(kw["feat"]), kw.get("fold")),
                run=lambda a, kw: flat(tk.tier(*a, **kw)),
                plain=lambda a, kw: flat(tk.tier_plain(*a, **kw)),
                bound=lambda a, kw: roofline.tier_bound(a, kw, peaks),
                lanes=lambda a, kw: a[5]["amp"].shape[0])


def lookup_spec(lk, peaks):
    def pack(a, kw):
        args, out = lk._pack_args(*a, False)
        return args, [out]

    def library(a):
        # torch.take indexes with int64: the i64 base makes the sum i64
        table, base, limit, idx = a
        base64 = base.long()
        return lambda: torch.take(table, base64[None] + idx)

    return dict(name="lookup", fn=lk.lookup, pack=pack,
                run=lambda a, kw: [lk.lookup(*a)],
                plain=lambda a, kw: [lk.lookup_plain(*a)],
                bound=lambda a, kw: roofline.lookup_bound(a, kw, peaks),
                library=library, symbol="lookup_time_major",
                lanes=lambda a, kw: a[1].shape[0])


# the JSON's and the max|diff| record's name of each wrapper: the noise
# kernels carry the TPU kernels' names
RECORD_NAME = {"phase_walk_warp": "phase_walk",
               "filt_smooth_noise": "filt_smooth"}


def phase_walk_warp_spec(pw, peaks):
    def pack(a, kw):
        args, outs = pw._pw_pack(*a, kw["feat"], kw["n"], kw["b"])
        return args, list(outs)

    def launch(args, kw, dev):
        from skred_tpu_torch.engine.kernels import cuda_call

        key = pw.phase_walk_key(kw["feat"])
        return lambda: cuda_call.launch("phase_walk", args, dev, key,
                                        "phase_walk_keyed_launch")

    return dict(name="phase_walk_warp", fn=pw.phase_walk_warp, pack=pack,
                launch=launch, symbol="phase_walk_keyed",
                run=lambda a, kw: list(pw.phase_walk_warp(*a, **kw)),
                plain=lambda a, kw: list(pw.phase_walk_warp_plain(*a, **kw)),
                bound=lambda a, kw: roofline.phase_walk_warp_bound(a, kw,
                                                                   peaks),
                lanes=lambda a, kw: a[2].shape[0])


def filt_smooth_noise_spec(fs, peaks):
    def pack(a, kw):
        args, out, ends = fs._fn_pack(*a, kw["feat"], kw["b"],
                                      kw.get("out"))
        return args, [out] + [ends[k] for k in sorted(ends)]

    def launch(args, kw, dev):
        from skred_tpu_torch.engine.kernels import cuda_call

        key = fs.filt_smooth_key(kw["feat"])
        return lambda: cuda_call.launch("filt_smooth", args, dev, key,
                                        "filt_smooth_keyed_launch")

    def flat(result):
        out, ends = result
        return [out] + [ends[k] for k in sorted(ends)]

    def fresh(a, kw, plain):
        """The plain version writes an output of its own, so that it does
        not write over the kernel's."""
        return a, dict(kw, out=None) if plain else kw

    return dict(name="filt_smooth_noise", fn=fs.filt_smooth_noise,
                pack=pack, launch=launch, fresh=fresh,
                symbol="filt_smooth_keyed",
                run=lambda a, kw: flat(fs.filt_smooth_noise(*a, **kw)),
                plain=lambda a, kw: flat(fs.filt_smooth_noise_plain(*a,
                                                                    **kw)),
                bound=lambda a, kw: roofline.filt_smooth_noise_bound(a, kw,
                                                                     peaks),
                lanes=lambda a, kw: a[0].shape[1])


def cyclic_spec(ck, peaks):
    def outs_of(out_l, out_r, new_states):
        return [out_l, out_r] + [new_states[k] for k in sorted(new_states)]

    def pack(a, kw):
        args, out_l, out_r, new_states = ck._pack_args(*a)
        return args, outs_of(out_l, out_r, new_states)

    def launcher(a, variant):
        """Pack ``a`` once for ``variant``; returns (a launch that counts
        no launch, the output tensors)."""
        from skred_tpu_torch.engine.kernels import cuda_call

        args, outs = pack(a, {})
        exact = a[10] if len(a) > 10 else True
        key = ck.fixed_key(a[7], a[8], exact) if variant == "fixed" else ()
        entry = f"cyclic_{variant}_launch"
        return (lambda: cuda_call.launch("cyclic", args, a[6].device, key,
                                         entry)), outs

    plain_kw = lambda kw: {k: v for k, v in kw.items() if k != "variant"}
    return dict(name="cyclic", fn=ck.cyclic_block, pack=pack,
                launcher=launcher,
                run=lambda a, kw: outs_of(*ck.cyclic_block(*a, **kw)),
                plain=lambda a, kw: outs_of(*ck.cyclic_block_plain(
                    *a, **plain_kw(kw))),
                bound=lambda a, kw: roofline.cyclic_bound(a, kw, peaks),
                lanes=lambda a, kw: a[6].shape[0])


# ---- phases ----

def kernel_phase(dev, specs, errs):
    """Every kernel against its plain version on random blocks."""
    from skred_tpu_torch.engine.kernels import lookup as lk
    from skred_tpu_torch.engine.kernels.noise_inputs import (
        NOISE64_FSN0, NOISE64_FSN1, NOISE64_WARP0, NOISE64_WARP1,
        random_lookup_inputs, random_noise_fs_inputs, random_warp_inputs)
    from skred_tpu_torch.engine.kernels.tier_inputs import (
        STRESS64_TIER0, STRESS64_TIER1, random_tier_inputs)

    from skred_tpu_torch.engine.kernels import cyclic_inputs as ci

    n, m = KERNEL_N, KERNEL_M
    calls = []
    cyc = [(f"{p.stem}, {{}} voices", p.read_text().splitlines(), 16, n)
           for p in FEEDBACK[:3] + FEEDBACK[4:]]
    cyc.append(("all-features script, {} voices", ci.ALL_FEATURES, 17, n))
    for label, lines, seed, frames in cyc:
        a = ci.on_device(ci.block_inputs(lines, ROWS, seed=seed, n=frames),
                         dev)
        for variant in ("fixed", "general"):
            calls.append(("cyclic", label.format(a[8]) + f", {variant}", a,
                          dict(variant=variant)))
    # fast mode (one fma at the render._fma sites, the CZ scales and
    # warp without their exact paths) on fb1's vectors
    a = ci.on_device(ci.block_inputs(FEEDBACK[0].read_text().splitlines(),
                                     ROWS, seed=20, n=n), dev)
    for variant in ("fixed", "general"):
        calls.append(("cyclic", f"fb1, {a[8]} voices, fast mode, {variant}",
                      a, dict(variant=variant, exact=False)))
    a = ci.on_device(ci.out_of_range(ci.block_inputs(
        ci.ALL_FEATURES, ROWS, seed=19, n=64), seed=19), dev)
    for variant in ("fixed", "general"):
        calls.append(("cyclic", f"all-features script, operands outside "
                      f"the fast range (64 frames), {variant}", a,
                      dict(variant=variant)))
    ring = [f"v{v} w{v % 3} f{50 + 7 * v} a5 F{(v + 1) % 64},0.3 "
            f"J1 K3000 Q2 h3 c1,0.4" for v in range(64)]
    a = ci.on_device(ci.block_inputs(ring, ROWS, seed=18, n=16), dev)
    calls.append(("cyclic", "64-voice ring (16 frames), general", a,
                  dict(variant="general")))
    for label, feat in (("stress64 tier0", STRESS64_TIER0),
                        ("stress64 tier1", STRESS64_TIER1)):
        table, cbase, inc, dm, amod, vecs, states = random_tier_inputs(
            feat, n, m, seed=11)
        t = lambda x: None if x is None else torch.from_numpy(x).to(dev)
        a = (t(table), cbase, t(inc), t(dm), t(amod),
             {k: t(v) for k, v in vecs.items()},
             {k: t(v) for k, v in states.items()})
        calls.append(("tier", label, a, dict(feat=feat, n=n)))
    calls += tier_variant_calls(dev, n)
    from skred_tpu_torch.engine.kernels.tier import Fold

    b, w = m // 8, 4
    for label, feat in (("noise64 tier0", NOISE64_WARP0),
                        ("noise64 tier1", NOISE64_WARP1)):
        for oor in (False, True):
            bank, prev, vecs, ph0, fin0 = random_warp_inputs(
                feat, n, m, b, w, seed=23, out_of_range=oor)
            bk, pv, p0, f0 = to_card([bank, prev, ph0, fin0], dev)
            calls.append(("phase_walk_warp", label + (
                ", operands outside the fast wrap's range" if oor else ""),
                (Fold(bk, pv, w), dict(zip(vecs, to_card(vecs.values(),
                                                         dev))), p0, f0),
                dict(feat=feat, n=n, b=b)))
    for label, feat in (("noise64 tier0", NOISE64_FSN0),
                        ("noise64 tier1", NOISE64_FSN1)):
        f, nz, cnt, cbase, bank, prev, vecs, states = \
            random_noise_fs_inputs(feat, n, m, b, w, seed=24)
        f, nz, cnt, bk, pv = to_card([f, nz, cnt, bank, prev], dev)
        calls.append(("filt_smooth_noise", label,
                      (f, nz, cnt, cbase, Fold(bk, pv, w),
                       dict(zip(vecs, to_card(vecs.values(), dev))),
                       dict(zip(states, to_card(states.values(), dev)))),
                      dict(feat=feat, b=b)))
    for ss in (4096, 32768):
        table, slot, idx = to_card(random_lookup_inputs(
            n, m, ss, seed=14, out_of_range=True), dev)
        base = slot * ss
        calls.append(("lookup", f"pass form, {ss}-sample tables",
                      (table, base, torch.full_like(base, ss),
                       idx.T.contiguous()), {}))
    plains = {}
    for name, label, a, kw in calls:
        sp = specs[name]
        fresh = sp.get("fresh", lambda a, kw, plain: (a, kw))
        got = [None if g is None else g.clone()
               for g in sp["run"](*fresh(a, kw, False))]
        torch.cuda.synchronize()
        if name == "cyclic":
            # both variants against one plain run of the same inputs
            if id(a) not in plains:
                plains[id(a)] = sp["plain"](*fresh(a, kw, True))
            want = plains[id(a)]
        else:
            want = sp["plain"](*fresh(a, kw, True))
        bad = [i for i, (g, w) in enumerate(zip(got, want))
               if not same_bits(g, w)]
        err = max(max_abs(g, w) for g, w in zip(got, want)
                  if g is not None)
        ekey = f"{name}_general" if kw.get("variant") == "general" \
            else RECORD_NAME.get(name, name)
        errs[ekey] = max(errs.get(ekey, 0.0), err)
        log(f"kernel {name} ({label}): max|diff| {err} vs plain, "
            f"{'bit-equal' if not bad else f'outputs {bad} DIFFER'}")
        if bad:
            fail(f"{name} disagrees with its plain version on {label}")
    # the JAX-form lookups: [M, N] indices, per-lane slots
    lib = {}
    for ss in (4096, 32768):
        table, slot, idx = to_card(random_lookup_inputs(n, m, ss, seed=15),
                                   dev)
        tab3 = table.reshape(-1, ss // 128, 128)
        base = slot * ss
        want = lk.lookup_plain(table, base, torch.full_like(base, ss), idx,
                               lane_major=True)
        for fn, name in ((lk.table_lookup_grouped, "lookup"),
                         (lk.table_lookup_pallas, "table_lookup")):
            got = fn(tab3, slot, idx, ss)
            torch.cuda.synchronize()
            err = max_abs(got, want)
            errs[name] = max(errs.get(name, 0.0), err)
            log(f"kernel {fn.__name__} ({ss}-sample slots): max|diff| "
                f"{err} vs plain, "
                f"{'bit-equal' if same_bits(got, want) else 'DIFFERS'}")
            if not same_bits(got, want):
                fail(f"{fn.__name__} disagrees with its plain version")
        lib[ss] = (tab3, slot, idx, table, base)
    return lib


def volume_turn(dev, card, peaks, errs):
    """The volume kernel against its plain version on random mixes,
    volumes (every seventh 0) and start gains: bit for bit at the main
    path's shape (1024 rows x 512 samples) and at its largest n (4096
    samples x 33 rows); at the main shape its device time by CUDA events
    (20 launches in a CUDA graph, and the wrapper launched from Python),
    the plain version's by host clock, and its bytes bound.  Returns the
    timings of its kernels record."""
    from skred_tpu_torch.engine.kernels import cuda_call
    from skred_tpu_torch.engine.kernels import volume as vk

    rng = np.random.default_rng(25)
    res = None
    for n, b in ((KERNEL_N, ROWS), (vk.MAX_N, 33)):
        vf = rng.uniform(0.0, 1.5, b).astype(np.float32)
        vf[::7] = 0.0
        a = tuple(to_card([rng.normal(0.0, 0.3, (n, b)).astype(np.float32),
                           rng.normal(0.0, 0.3, (n, b)).astype(np.float32),
                           vf, rng.uniform(0.0, 1.5, b).astype(np.float32)],
                          dev))
        got = vk.volume(*a, n=n)
        torch.cuda.synchronize()
        plain_ms, want = host_ms(lambda: vk.volume_plain(*a, n=n))
        same = all(same_bits(g, w) for g, w in zip(got, want))
        errs["volume"] = max([errs.get("volume", 0.0)]
                             + [max_abs(g, w) for g, w in zip(got, want)])
        log(f"kernel volume ({b} rows x {n} samples): max|diff| "
            f"{errs['volume']} vs plain, "
            f"{'bit-equal' if same else 'outputs DIFFER'}")
        if not same:
            fail(f"volume disagrees with its plain version at {b} rows x "
                 f"{n} samples")
        if res is None:
            args = vk._pack(*a, n)[0]
            ms = graph_ms(lambda: cuda_call.launch("volume", args, dev), 20)
            launched = cuda_ms(lambda: vk.volume(*a, n=n), 200)
            bound_ms, bound_by = roofline.volume_bound(a, dict(n=n), peaks)
            res = dict(ms=ms, launched_ms=launched, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            log(f"kernel volume ({b} rows x {n} samples): {ms:.4f} ms/call "
                f"(CUDA events, 20 calls in a CUDA graph), {launched:.4f} "
                f"launched from Python (200 calls), bound {bound_ms:.4f} ms "
                f"({bound_by}: {100 * bound_ms / ms:.1f}% of it), plain "
                f"version {plain_ms:.2f} ms (host clock), on {card}")
    return res


EVERY_STAGE = (True,) * 12 + ((1, 2, 3, 4, 5, 6, 7), False)


def tier_variants(feat):
    """The kernel phase's mix and fold variants of a feature set: (what,
    folded streams, mix) for the mix, each stream's fold, all streams'
    fold, and mix with fold."""
    from skred_tpu_torch.engine.kernels.tier import _flags

    fl = _flags(feat)
    have = tuple(k for k, on in (("fm", fl["fm"]), ("cz", fl["czm"]),
                                 ("am", fl["am"])) if on)
    variants = [("mix", (), True)] + [(f"fold {k}", (k,), False)
                                      for k in have]
    if len(have) > 1:
        variants.append(("fold " + "+".join(have), have, False))
    variants.append(("mix + fold " + "+".join(have), have, True))
    return variants


def kernel_tier_keys():
    """The keyed tier builds the kernel phase launches."""
    from skred_tpu_torch.engine.kernels import tier as tk
    from skred_tpu_torch.engine.kernels.tier_inputs import (STRESS64_TIER0,
                                                            STRESS64_TIER1)

    keys = [tk.tier_key(STRESS64_TIER0), tk.tier_key(STRESS64_TIER1)]
    for feat in (STRESS64_TIER1, EVERY_STAGE):
        keys += [tk.tier_key(feat, True, mix, streams)
                 for _, streams, mix in tier_variants(feat)]
    return keys


def tier_variant_calls(dev, n):
    """The tier kernel's mix and fold variants on random blocks of 8
    voices x 1024 rows over a bank of 4 voices: stress64's tier-1
    feature set (fm), and every stage at once (cz-mod and am streams,
    am self-reads).  The folded calls write into the block buffer whose
    first columns are their bank; "both" also adds onto accumulators."""
    from skred_tpu_torch.engine.kernels.tier import Fold
    from skred_tpu_torch.engine.kernels.tier_inputs import (
        STRESS64_TIER1, random_fold_inputs, random_mix_weights,
        random_tier_inputs)

    b, v, w = KERNEL_M // 8, 8, 4
    m = b * v
    t = lambda x: None if x is None else torch.from_numpy(x).to(dev)
    calls = []
    for label, feat, seed in (("stress64 tier1", STRESS64_TIER1, 21),
                              ("every stage", EVERY_STAGE, 22)):
        table, cbase, inc, dm, amod, vecs, states = random_tier_inputs(
            feat, n, m, seed=seed)
        bank, prev, fv = random_fold_inputs(n, m, b, w, seed=seed)
        wl, wr = random_mix_weights(m, seed=seed)
        tv = {k: t(x) for k, x in {**vecs, **fv}.items()}
        ts = {k: t(x) for k, x in states.items()}
        buf = torch.zeros((n, (w + v) * b), device=dev)
        buf[:, :w * b] = t(bank)
        given = {"fm": t(inc), "cz": t(dm), "am": t(amod)}
        mixw = (t(wl), t(wr))
        for what, streams, mix in tier_variants(feat):
            g = {k: (None if k in streams else x) for k, x in given.items()}
            kw = dict(feat=feat, n=n, b=b)
            if streams:
                kw.update(fold=Fold(buf[:, :w * b], t(prev), w, streams),
                          out=buf[:, w * b:])
            if mix:
                kw["mixw"] = mixw
            if mix and streams:
                kw["acc"] = (torch.full((n, b), 0.25, device=dev),
                             torch.full((n, b), -0.5, device=dev))
            calls.append(("tier", f"{label}, {what}",
                          (t(table), cbase, g["fm"], g["cz"], g["am"], tv,
                           ts), kw))
    return calls


def table_lookup_timing(lk, lib, card, peaks):
    """The single-lane form alone (it is on no render path): kernel,
    plain version, torch.take and bound at N=512, M=8192, 32768-sample
    slots."""
    from skred_tpu_torch.engine.kernels import cuda_call

    tab3, slot, idx, table, base = lib[32768]
    limit = torch.full_like(base, 32768)
    args, out = lk._pack_args(table, base, limit, idx, True)
    ms = cuda_ms(lambda: cuda_call.launch("lookup", args, idx.device), 20)
    plain_ms, want = host_ms(lambda: lk.lookup_plain(table, base, limit, idx,
                                                     lane_major=True))
    if not same_bits(out, want):
        fail("table_lookup kernel disagrees with its plain version")
    base64 = base.long()
    library = lambda: torch.take(table, base64[:, None] + idx)
    library_ms = cuda_ms(library, 20)
    if not same_bits(library(), want):
        fail("torch.take does not compute table_lookup's function")
    bound_ms, bound_by = roofline.lookup_bound((table, base, limit, idx), {},
                                               peaks)
    log(f"table_lookup M={idx.shape[0]} N={idx.shape[1]}: kernel {ms:.4f} "
        f"ms/call, plain {plain_ms:.1f} ms, torch.take {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}), on {card}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def lookup_turns(captured, lib, dev, card, errs, peaks):
    """The lookup kernel in turns with torch.take (take, kernel, kernel,
    take; 20 calls each in a CUDA graph: tier 0's call is shorter than
    its launch from Python) on the noise main path's
    first-block lookups at tier 1 and tier 0 (the pass form, [N, M]) and
    at row 6's shape (the lane-major form, N=512, M=8192, 32768-sample
    slots), each kernel turn bit-equal to the plain version; the SASS
    instructions an element of the layout's main loop, the issue floor,
    the bytes bound and the bandwidth reached."""
    from skred_tpu_torch.engine.kernels import build, cuda_call
    from skred_tpu_torch.engine.kernels import lookup as lk

    fn = build.load("lookup").lookup_step_elements
    fn.argtypes, fn.restype = [], ctypes.c_int
    step = fn()            # elements a thread handles in a main-loop pass
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    calls = sorted(((m, a) for (nm, m), (a, _) in captured.items()
                    if nm == "lookup"), key=lambda c: -c[0])
    shapes = [(f"tier {1 - i} (noise64 first block, pass form)", *a, False)
              for i, (m, a) in enumerate(calls)]
    _, _, idx, table, base = lib[32768]
    shapes.append(("row 6 (table_lookup_pallas's shape, 32768-sample "
                   "slots)", table, base, torch.full_like(base, 32768), idx,
                   True))
    fmt = lambda ts: " / ".join(f"{t:.4f}" for t in ts)
    for label, table, base, limit, idx, lane_major in shapes:
        args, out = lk._pack_args(table, base, limit, idx, lane_major)
        go = lambda: cuda_call.launch("lookup", args, dev)
        want = lk.lookup_plain(table, base, limit, idx, lane_major)
        b64 = base.long()[:, None] if lane_major else base.long()[None]
        take = lambda: torch.take(table, b64 + idx)
        if not same_bits(take(), want):
            fail(f"torch.take does not compute the lookup on {label}")
        clk0 = sm_clock()
        times = {"torch.take": [], "kernel": []}
        for turn in ("torch.take", "kernel", "kernel", "torch.take"):
            if turn == "kernel":
                out.fill_(float("nan"))
                go()
                torch.cuda.synchronize()
                errs["lookup"] = max(errs.get("lookup", 0.0),
                                     max_abs(out, want))
                if not same_bits(out, want):
                    fail(f"lookup kernel disagrees with its plain version "
                         f"on {label}")
            times[turn].append(graph_ms(go if turn == "kernel" else take,
                                        20))
        # the card's rate on this read-and-write stream: a device copy of
        # the index block (the same 8 B an element, no gathers)
        copy_ms = graph_ms(lambda: out.view(torch.int32).copy_(idx), 20)
        copy_rate = 2 * nbytes(idx) / (copy_ms * 1e-3)
        clk1 = sm_clock()
        mhz = max(float(c.split()[0]) for c in (clk0, clk1))
        kname = "lane" if lane_major else "time"
        sass = sass_loop(build._target("lookup"),
                         f"lookup_{kname}_major_kernelILb1E", 1)
        per_elem = sass["loop"] / step
        issue_ms = per_elem * idx.numel() / 32 / (4 * sms) / (mhz * 1e6) \
            * 1e3
        moved = nbytes(table, base, limit, idx) + nbytes(idx)
        bound_ms, bound_by = roofline.lookup_bound((table, base, limit, idx),
                                                   {}, peaks)
        mean = sum(times["kernel"]) / 2
        rate = moved / (mean * 1e-3)
        n, m = (idx.shape[1], idx.shape[0]) if lane_major else idx.shape
        log(f"lookup turns {label}, N={n}, M={m}: kernel "
            f"{fmt(times['kernel'])} ms/call, torch.take "
            f"{fmt(times['torch.take'])} ms/call (in turns torch.take, "
            f"kernel, kernel, torch.take; 20 calls each in a CUDA graph, "
            f"CUDA events); "
            f"bound {bound_ms:.4f} ms ({bound_by}); SASS "
            f"{per_elem:.3f} instructions an element ({sass['loop']} in "
            f"the main loop of {step} elements, {sass['instructions']} in "
            f"{sass['kernel']}), issue floor {issue_ms:.4f} ms at "
            f"{mhz:.0f} MHz, {sms} SMs; {rate / 1e12:.3f} TB/s = "
            f"{rate / peaks.hbm_bytes_s:.1%} of "
            f"{peaks.hbm_bytes_s / 1e12:.2f} TB/s, "
            f"{bound_ms / mean:.1%} of the bound; a device copy of the "
            f"index block {copy_ms:.4f} ms ({copy_rate / 1e12:.3f} TB/s); "
            f"bit-equal to the plain "
            f"version; clocks.sm {clk0} -> {clk1}, on {card}")


def prepare(path, seconds):
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import (bucket_key, fill_bucket,
                                                pack_stacked,
                                                pad_segments_pow2,
                                                stack_timelines)

    lines = path.read_text().splitlines()
    t0 = time.time()
    tl = compile_script(lines, seconds, bank=WaveBank(),
                        script_dir=HERE / "corpus")
    vp, _, _ = bucket_key(tl)
    rows = fill_bucket([tl], vp)[:ROWS]
    st = pad_segments_pow2(pack_stacked(stack_timelines(rows)))
    log(f"{path.stem}: {st.batch} rows x {vp} voices, tiers {st.tiers}, "
        f"{st.num_blocks} blocks, host compile+pack "
        f"{time.time() - t0:.1f} s")
    if st.batch != ROWS or vp != 64 or len(st.tiers) != 2:
        fail(f"unexpected bucket: {st.batch} rows, {vp} voices, "
             f"tiers {st.tiers}")
    return lines, st


def capture_first_calls(fused, specs, on_path, render):
    """Run ``render`` with every wrapper of ``on_path`` in ``fused``
    recording the arguments of its first call per lane count.  Returns
    {(kernel, lanes): (args, kwargs)}."""
    captured = {}
    real = {name: getattr(fused, name) for name in on_path}

    def capturer(name):
        def call(*a, **kw):
            m = specs[name]["lanes"](a, kw)
            captured.setdefault((name, m), (a, kw))
            return real[name](*a, **kw)
        return call

    for name in on_path:
        setattr(fused, name, capturer(name))
    try:
        render()
    finally:
        for name in on_path:
            setattr(fused, name, real[name])
    torch.cuda.synchronize()
    return captured


def time_captured(label, captured, specs, dev, card, errs):
    """Each captured call alone: the kernel (CUDA events, 20 launches)
    against its plain version (bit for bit), its bound and, where there
    is one, the library call.  Returns timings by kernel and lanes."""
    from skred_tpu_torch.engine.kernels import cuda_call

    timings = {}
    for (name, m), (a, kw) in sorted(captured.items()):
        sp = specs[name]
        fresh = sp.get("fresh", lambda a, kw, plain: (a, kw))
        ka, kkw = fresh(a, kw, False)
        args, outs = sp["pack"](ka, kkw)
        go = sp["launch"](args, kkw, dev) if "launch" in sp \
            else (lambda: cuda_call.launch(name, args, dev))
        go()
        torch.cuda.synchronize()
        got = [None if g is None else g.clone() for g in outs]
        ms = cuda_ms(go, 20)
        plain_ms, want = host_ms(lambda: sp["plain"](*fresh(a, kw, True)))
        bad = [i for i, (g, w) in enumerate(zip(got, want))
               if not same_bits(g, w)]
        ekey = RECORD_NAME.get(name, name)
        errs[ekey] = max([errs.get(ekey, 0.0)]
                         + [max_abs(g, w) for g, w in zip(got, want)
                            if g is not None])
        if bad:
            fail(f"{name} kernel disagrees with its plain version on the "
                 f"{label} path's M={m} call (outputs {bad})")
        bound_ms, bound_by = sp["bound"](a, kw)
        lib_ms = None
        if "library" in sp:
            lib = sp["library"](a)
            lib_ms = cuda_ms(lib, 20)
            if not same_bits(lib(), got[0]):
                fail(f"the library call does not compute {name}'s function")
        timings[name, m] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=lib_ms)
        lib_part = "" if lib_ms is None else f", torch.take {lib_ms:.4f} ms"
        how = ""
        if name == "tier":
            fold = kw.get("fold")
            streams = sp["folded"](kw)
            how = (" mix" if kw.get("mixw") is not None else " no mix") \
                + (f", fold {'+'.join(streams)} over {fold.w} voices"
                   if streams else ", no fold")
        log(f"{name} M={m}{how} ({label}): kernel {ms:.4f} ms/call, plain "
            f"{plain_ms:.1f} ms{lib_part}, bound {bound_ms:.4f} ms "
            f"({bound_by}), path inputs bit-equal to plain, on {card}")
    return timings


# ---- the noise pass on the card ----

def frozen(x):
    """``x`` with every tensor in it cloned (through tuples, named
    tuples, lists and dicts)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: frozen(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*(frozen(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(frozen(v) for v in x)
    return x


def capture_noise(st, dev):
    """The first call of ``fused._noise_pass`` at each lane count, and of
    ``_mix_parts`` and ``_block_step``, in a one-chunk render of ``st``,
    every tensor cloned when it is taken (later blocks write the block
    buffer again).  Returns {(name, lanes or 0): (args, kwargs)}."""
    from skred_tpu_torch.engine import fused

    got = {}
    names = ("_noise_pass", "_mix_parts", "_block_step")
    real = {nm: getattr(fused, nm) for nm in names}

    def wrap(nm):
        def call(*a, **kw):
            key = (nm, a[3]["amp"].numel() if nm == "_noise_pass" else 0)
            if key not in got:
                got[key] = frozen((a, kw))
            return real[nm](*a, **kw)
        return call

    for nm in names:
        setattr(fused, nm, wrap(nm))
    try:
        fused.render_fused_stream_device(st, CHUNK, warmup_only=True,
                                         device=dev)
    finally:
        for nm in names:
            setattr(fused, nm, real[nm])
    torch.cuda.synchronize()
    return got


def noise_rest(caught, card):
    """The device time of the rest of noise64's first block around the
    noise pass, each part alone (CUDA events, 5 calls each): the whole
    block, the torch mix of the noise tiers, the carry's concatenation
    and the volume kernel on that mix.  Returns {part: ms}."""
    from skred_tpu_torch.engine import fused
    from skred_tpu_torch.engine.kernels.volume import volume

    reps = 5
    r, carry, k0 = caught["_block_step", 0][0]
    ma, mkw = caught["_mix_parts", 0]
    n = r.block
    vf = r.p_const["volume_final"]
    mix_l, mix_r, _ = fused._mix_parts(*ma, **mkw)
    bounds = np.cumsum((0,) + tuple(r.tiers))
    cut = [(int(bounds[i]), int(bounds[i + 1])) for i in range(len(r.tiers))]
    rest = {
        "whole block": cuda_ms(lambda: fused._block_step(r, carry, k0), reps),
        "torch mix (_mix_parts)": cuda_ms(
            lambda: fused._mix_parts(*ma, **mkw), reps),
        "carry concatenation": cuda_ms(lambda: {
            k: torch.cat([carry[k][:, ts:te] for ts, te in cut], dim=1)
            for k in fused._CK}, reps),
        "volume kernel": cuda_ms(lambda: volume(
            mix_l, mix_r, vf, carry["vol_gain"], n=n), reps),
    }
    log("noise block rest (noise64 first block): " + ", ".join(
        f"{k} {t:.4f}" for k, t in rest.items())
        + f" ms (CUDA events, {reps} calls each), on {card}")
    return rest


def keyed_sass(name, key, kernel, entry):
    """SASS instructions per sample step of a keyed noise build's fast
    chunk loop (its chunk length from the library)."""
    from skred_tpu_torch.engine.kernels import build

    fn = getattr(build.load(name, key, entry), f"{name}_chunk_samples")
    fn.argtypes, fn.restype = [], ctypes.c_int
    return sass_loop(build._target(name, key), kernel, fn())


def noise_turns(caught, specs, dev, card, errs):
    """On noise64's first-block inputs at each tier: the keyed phase walk
    and the keyed filter/smoother, two turns each, each bit-equal to the
    plain version; then each kernel alone (the two, the lookup); the
    builds' SASS instructions a sample step and issue floors beside
    their bytes bounds.  Returns {lanes: numbers}."""
    from skred_tpu_torch.engine import fused
    from skred_tpu_torch.engine.kernels import cuda_call
    from skred_tpu_torch.engine.kernels import filt_smooth as fs
    from skred_tpu_torch.engine.kernels import lookup as lk
    from skred_tpu_torch.engine.kernels import phase_walk as pw

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {}
    fmt = lambda ts: " / ".join(f"{t:.4f}" for t in ts)
    for (nm, m), (a, kw) in sorted(caught.items()):
        if nm != "_noise_pass":
            continue
        est_vm, prev_vm, carry, p, tp, cbase, table, _, feat, n, b = a[:11]
        noise_blk = kw["noise_blk"]
        bank, v, ph0, fin0, states = fused._noise_inputs(
            est_vm, prev_vm, carry, tp, feat, b)
        pf, ff = fused._pw_feat(feat), fused._fs_feat(feat)
        pw_a, pw_kw = (bank, v, ph0, fin0), dict(feat=pf, n=n, b=b)
        want_pw = list(pw.phase_walk_warp_plain(*pw_a, **pw_kw))
        f = lk.lookup(table, v["base_off"], v["limit"], want_pw[0])
        fs_a = (f, noise_blk, want_pw[1], cbase, bank, v, states)
        fs_kw = dict(feat=ff, b=b)
        want_fs = specs["filt_smooth_noise"]["plain"](fs_a, fs_kw)
        clk0 = sm_clock()
        times = {}
        for kname, sa, skw, want in (
                ("phase_walk", pw_a, pw_kw, want_pw),
                ("filt_smooth", fs_a, fs_kw, want_fs)):
            sp = specs["phase_walk_warp" if kname == "phase_walk"
                       else "filt_smooth_noise"]
            args, outs = sp["pack"](sa, skw)
            go = sp["launch"](args, skw, dev)
            times[kname] = []
            for _ in range(2):
                go()
                torch.cuda.synchronize()
                bad = [i for i, (g, w) in enumerate(zip(outs, want))
                       if not same_bits(g, w)]
                ekey = RECORD_NAME[sp["name"]]
                errs[ekey] = max([errs.get(ekey, 0.0)]
                                 + [max_abs(g, w) for g, w in zip(outs, want)
                                    if g is not None])
                if bad:
                    fail(f"{kname} disagrees with the plain version on "
                         f"noise64's first block at M={m} (outputs {bad})")
                times[kname].append(cuda_ms(go, 20))
        clk1 = sm_clock()
        lk_args, lk_out = lk._pack_args(table, v["base_off"], v["limit"],
                                        want_pw[0], False)
        alone = {
            "keyed phase_walk": times["phase_walk"],
            "keyed filt_smooth": times["filt_smooth"],
            "lookup": [cuda_ms(lambda: cuda_call.launch(
                "lookup", lk_args, dev), 20)],
        }
        del lk_out
        mhz = max(float(c.split()[0]) for c in (clk0, clk1))
        warps = -(-m // 32)
        per_sched = -(-warps // (4 * sms))
        floors = {}
        for kname, name, key, entry in (
                ("phase_walk", "phase_walk", pw.phase_walk_key(pf),
                 "phase_walk_keyed_launch"),
                ("filt_smooth", "filt_smooth", fs.filt_smooth_key(ff),
                 "filt_smooth_keyed_launch")):
            sass = keyed_sass(name, key, f"{name}_keyed_kernel", entry)
            issue = sass["per_sample"] * n * per_sched / (mhz * 1e6) * 1e3
            sp = specs["phase_walk_warp" if kname == "phase_walk"
                       else "filt_smooth_noise"]
            bms, bby = sp["bound"](pw_a if kname == "phase_walk" else fs_a,
                                   pw_kw if kname == "phase_walk" else fs_kw)
            floors[kname] = dict(sass=sass["per_sample"], issue_ms=issue,
                                 bound_ms=bms, bound_by=bby)
        res[m] = dict(times=times, alone=alone, floors=floors)
        for kname in ("phase_walk", "filt_smooth"):
            t, fl = times[kname], floors[kname]
            mean_k = sum(t) / len(t)
            log(f"noise turns M={m} {kname} (noise64 first block, n={n}): "
                f"keyed {fmt(t)} ms/call (two turns; CUDA events, 20 "
                f"calls); SASS {fl['sass']:.2f} instructions a sample "
                f"step, issue floor {fl['issue_ms']:.4f} ms at {mhz:.0f} "
                f"MHz ({warps} warps, {per_sched} a scheduler), bytes "
                f"bound {fl['bound_ms']:.4f} ms ({fl['bound_by']}): "
                f"{mean_k / fl['bound_ms']:.2f}x its bound, "
                f"{mean_k / fl['issue_ms']:.2f}x its issue floor; "
                f"bit-equal to the plain version; clocks.sm {clk0} -> "
                f"{clk1}, on {card}")
        log(f"noise alone M={m}: " + ", ".join(
            f"{k} {sum(t) / len(t):.4f}" for k, t in alone.items())
            + f" ms/call (CUDA events, 20 calls), on {card}")
    return res


# ---- the tier kernel's SASS: instructions per sample step, floors ----

# The keyed tier build's serial chain per sample step, an estimate
# counted from the source, not read from the SASS: the phase walk's
# dependent operations (add the increment, subtract lo, two compares,
# the wrap's subtraction, add lo back, three selects), at the 4 cycles
# an FP32 ALU result takes to feed the next instruction.  The biquad's
# (3) and the smoother's (3) are shorter.
TIER_CHAIN_OPS = 9
OP_CYCLES = 4


def tier_chunk(key):
    """T, the keyed tier kernel's samples per chunk, from its library."""
    from skred_tpu_torch.engine.kernels import build

    fn = build.load("tier", key, "tier_keyed_launch").tier_chunk_samples
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def tier_turns(label, captured, spec, dev, card, errs):
    """The tier kernel alone on the path's first-block inputs, two turns,
    each bit-equal to the plain version, with clocks.sm around them; the
    mix kernel alone after each turn; the SASS instructions of one
    sample step, and from them the issue floor and the chain floor
    beside the bytes bound.  Returns {lanes: numbers}."""
    from skred_tpu_torch.engine.kernels import build

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {}
    for (name, m), (a, kw) in sorted(captured.items()):
        if name != "tier":
            continue
        fresh = spec["fresh"]
        want = spec["plain"](*fresh(a, kw, True))
        clk0 = sm_clock()
        times, mix = [], []
        has_mix = kw.get("mixw") is not None
        for _ in range(2):
            ka, kkw = fresh(a, kw, False)
            args, outs = spec["pack"](ka, kkw)
            go = spec["launch"](args, kkw, dev)
            go()
            torch.cuda.synchronize()
            bad = [i for i, (g, w) in enumerate(zip(outs, want))
                   if not same_bits(g, w)]
            errs["tier"] = max([errs.get("tier", 0.0)]
                               + [max_abs(g, w) for g, w in zip(outs, want)
                                  if g is not None])
            if bad:
                fail(f"tier kernel disagrees with its plain version on the "
                     f"{label} path's M={m} call (outputs {bad})")
            times.append(cuda_ms(go, 20))
            if has_mix:
                mix.append(cuda_ms(spec["launch"](args, kkw, dev, "mix"),
                                   20))
        clk1 = sm_clock()
        mhz = max(float(c.split()[0]) for c in (clk0, clk1))
        n = kw["n"]
        warps = -(-m // 32)
        per_sched = -(-warps // (4 * sms))      # warps on one scheduler
        key = spec["key"](kw)
        chunk = tier_chunk(key)
        keyed = sass_loop(build._target("tier", key), "tier_keyed_kernel",
                          chunk)
        issue_ms = keyed["per_sample"] * n * per_sched / (mhz * 1e6) * 1e3
        chain_ms = TIER_CHAIN_OPS * OP_CYCLES * n / (mhz * 1e6) * 1e3
        bound_ms, bound_by = spec["bound"](a, kw)
        mean = sum(times) / len(times)
        # the tier kernel without its mix: against the mix's least reading
        # (noise only adds time), so an upper estimate
        own = mean - min(mix, default=0.0)
        res[m] = dict(times=times, mix=mix, mean=mean, own=own,
                      sass=keyed["per_sample"], issue_ms=issue_ms,
                      chain_ms=chain_ms, bound_ms=bound_ms,
                      bound_by=bound_by)
        fmt = lambda ts: " / ".join(f"{t:.4f}" for t in ts)
        log(f"tier turns M={m} ({label} first block, n={n}): "
            f"{fmt(times)} ms/call (two turns; CUDA events, 20 calls each; "
            f"each call the tier kernel and, with the mix, its mix "
            f"kernel); "
            + (f"the mix kernel alone {fmt(mix)} ms/call (after each "
               f"turn); " if has_mix else "no mix; ")
            + f"SASS {keyed['per_sample']:.2f} instructions per sample "
            f"step ({keyed['loop']} in its {chunk}-sample loop, "
            f"{keyed['instructions']} in {keyed['kernel']}); floors at "
            f"{mhz:.0f} MHz, {sms} SMs, {warps} warps ({per_sched} a "
            f"scheduler): issue {issue_ms:.4f} ms (the tier kernel alone, "
            f"its mean call less the mix kernel's least reading: "
            f"{own:.4f} ms, {own / issue_ms:.2f}x its issue floor), chain "
            f"{chain_ms:.4f} ms (estimate from the source, "
            f"{TIER_CHAIN_OPS} dependent FP32 operations x {OP_CYCLES} "
            f"cycles a sample), bytes bound {bound_ms:.4f} ms "
            f"({bound_by}); bit-equal to the plain version; clocks.sm "
            f"{clk0} -> {clk1}, on {card}")
    return res


def main_path(label, path, dev, card, specs, on_path, counters, errs,
              seconds=SECONDS, also=()):
    """Drive ``path`` at full width through render_fused_stream_device:
    warm-up (capturing each kernel's first-block inputs), the timed pass
    with every launch count (``counters``: name -> wrapper) set to 0
    before and read after, one profiled chunk, then each kernel of
    ``on_path`` alone on its captured inputs.  ``also`` names counters
    besides ``on_path`` that the path must advance as often (a variant's
    own count).  Returns (launches, timings by kernel and lane count, the
    script's lines, the captured first-block calls)."""
    from skred_tpu_torch.engine import fused

    lines, st = prepare(path, seconds)
    captured = capture_first_calls(
        fused, specs, on_path, lambda: fused.render_fused_stream_device(
            st, CHUNK, warmup_only=True, device=dev))

    whole = st.num_blocks // CHUNK * CHUNK
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    cs = fused.render_fused_stream_device(st, CHUNK, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    audio_s = st.batch * whole * st.block / 44100.0
    if seconds != SECONDS:
        log(f"{label}: cut to {whole // CHUNK} chunks of {CHUNK} blocks "
            f"({whole * st.block / 44100.0:.3f} s of audio per row) to keep "
            f"the run short")
    log(f"{label}: wall {wall:.3f} s, {audio_s / wall:.1f}x realtime "
        f"({st.batch} rows x {whole * st.block / 44100.0:.3f} s rendered), "
        f"launches {launches} ({whole} blocks x 2 tiers), checksum {cs}, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on "
        f"{card}")
    for name, count in launches.items():
        # the volume kernel: one launch a block
        want = whole if name == "volume" else \
            2 * whole if name in on_path or name in also else 0
        if count != want:
            fail(f"{name}.launches {count} != {want} on {label} "
                 f"({whole} blocks x 2 tiers)")
    if not (np.isfinite(cs) and cs > 0):
        fail(f"bad checksum {cs}")
    log(profile_line(
        label, lambda: fused.render_fused_stream_device(
            st, CHUNK, warmup_only=True, device=dev),
        [specs[nm].get("symbol", nm) for nm in on_path]))

    timings = time_captured(label, captured, specs, dev, card, errs)
    log(f"{label} summary: wall {wall:.3f} s, {audio_s / wall:.1f}x realtime, "
        + ", ".join(f"{name} {t['ms']:.4f} ms/call at M={m}"
                    for (name, m), t in sorted(timings.items()))
        + f" (CUDA events), on {card}")
    return launches, timings, lines, captured


def config_compare(dev, card, specs, errs):
    """stress64 with the tier kernel's mix and fold on and off, in one
    run on one card: a 2-chunk batch rendered on, off, off, on; then per
    configuration a profiled chunk and the tier calls alone on its own
    first-block inputs.  Nothing is asserted about which is faster.
    Returns the timings by configuration."""
    from skred_tpu_torch.engine import fused

    _, st = prepare(STRESS64, NOISE64_SECONDS)
    whole = st.num_blocks // CHUNK * CHUNK
    configs = {"mix+fold on": dict(mix=True, fold=True),
               "mix+fold off": dict(mix=False, fold=False)}
    run = lambda cfg, **kw: fused.render_fused_stream_device(
        st, CHUNK, device=dev, **configs[cfg], **kw)
    captured = {cfg: capture_first_calls(
        fused, specs, ["tier"], lambda: run(cfg, warmup_only=True))
        for cfg in configs}
    walls = {cfg: [] for cfg in configs}
    sums = {}
    for cfg in ("mix+fold on", "mix+fold off", "mix+fold off",
                "mix+fold on"):
        torch.cuda.synchronize()
        t0 = time.time()
        sums[cfg] = run(cfg)
        torch.cuda.synchronize()
        walls[cfg].append(time.time() - t0)
    audio_s = st.batch * whole * st.block / 44100.0
    order = {"mix+fold on": "1 and 4", "mix+fold off": "2 and 3"}
    for cfg, ws in walls.items():
        log(f"config {cfg}: stress64, {whole} blocks ({whole // CHUNK} "
            f"chunks), wall " + " / ".join(f"{w:.3f}" for w in ws)
            + f" s (passes {order[cfg]} of 4), "
            f"{audio_s / min(ws):.1f}x realtime at best, checksum "
            f"{sums[cfg]} on {card}")
    rel = abs(sums["mix+fold on"] - sums["mix+fold off"]) \
        / sums["mix+fold off"]
    if not rel < 1e-6:
        fail(f"the two configurations' checksums differ by {rel:.3g}")
    out = {}
    for cfg in configs:
        log(profile_line(f"config {cfg}",
                         lambda: run(cfg, warmup_only=True),
                         ["tier_keyed"]))
        out[cfg] = time_captured(f"config {cfg}", captured[cfg], specs, dev,
                                 card, errs)
    return out


def profile_line(label, run, names):
    """Device time by kernel and by category over one profiled chunk
    (``run`` renders it), from the profiler tool's aggregation.  A
    profiler that raises, or a trace with no device events, fails the
    run."""
    from skred_tpu_torch.tools import profile_roofline as prof

    events, pwall = prof.trace(run)
    agg = prof.aggregate(events, CHUNK)
    if agg is None:
        fail(f"profile ({label}): the trace holds no device events")
    busy, kernels = agg["device_busy_s"], agg["kernels"]
    parts = []
    for name in names:
        hits = [t for k, t in kernels.items() if f"{name}_kernel" in k]
        parts.append(f"{name}_kernel {hits[0]['ms'] / hits[0]['calls']:.3f} "
                     f"ms/call x {hits[0]['calls']} = {hits[0]['ms']:.1f} ms"
                     if hits else f"{name}_kernel not found")
    top = list(kernels.items())[:6]
    return (f"profile ({label}, {CHUNK} blocks, wall {pwall:.3f} s): "
            f"device busy {busy:.3f} s = {100 * busy / pwall:.1f}% of "
            f"wall; {agg['device_ops']} device operations = "
            f"{agg['device_ops_per_block']:.1f} per block; "
            + "; ".join(parts) + "; by category: " + ", ".join(
                f"{c} {ms:.1f} ms" for c, ms in agg["categories_ms"].items())
            + "; top: " + "; ".join(f"{k[:40]} {t['ms']:.1f} ms/{t['calls']}"
                                for k, t in top)
            + "; torch ops per block (nested calls counted too): "
            + ", ".join(f"{k} {c:.1f}" for k, c in list(
                agg["torch_calls_per_block"].items())[:12]))


def short_path(label, st4, dev, module, render, plain_swap,
               unfolded=False):
    """The first 4 blocks at 8 rows: kernel path, plain-version path on
    the card (bit for bit), and the port's CPU render (-100 dB).
    ``render`` is ``module``'s entry point; ``plain_swap`` names the
    wrappers in ``module`` and their plain versions.  ``unfolded`` also
    renders on the card with the tier kernel's mix and fold off: the
    same samples, the voice sum in torch's order (-120 dB)."""
    if st4.num_blocks != 4 or st4.batch != 8:
        fail(f"short render has {st4.batch} rows x {st4.num_blocks} "
             f"blocks, not 8 x 4")
    a = render(st4, device=dev)
    real = {k: getattr(module, k) for k in plain_swap}
    for k, fn in plain_swap.items():
        setattr(module, k, fn)
    try:
        b = render(st4, device=dev)
    finally:
        for k, fn in real.items():
            setattr(module, k, fn)
    c = render(st4, device="cpu")
    peak = float(np.abs(c).max())
    db_plain = 20 * np.log10(max(float(np.abs(a - b).max()), 1e-30) / peak)
    db_cpu = 20 * np.log10(max(float(np.abs(a - c).max()), 1e-30) / peak)
    verdict = lambda x, y, db: ("bit-equal" if np.array_equal(x, y)
                                else f"{db:.1f} dB")
    log(f"{label}: 8 rows x 4 blocks, kernel path vs plain path on card "
        f"{verdict(a, b, db_plain)}, card vs CPU render "
        f"{verdict(a, c, db_cpu)}, peak {peak:.3f}")
    if not np.all(np.isfinite(a)) or a.shape != (8, 4 * 512, 2):
        fail(f"{label} render: bad shape or non-finite samples")
    if not peak > 0.01:
        fail(f"{label} render is silent")
    if not np.array_equal(a, b):
        fail(f"{label}: kernel path vs plain path {db_plain:.1f} dB")
    if db_cpu > -100:
        fail(f"{label}: card render vs CPU render {db_cpu:.1f} dB")
    if unfolded:
        d = render(st4, device=dev, mix=False, fold=False)
        e = render(st4, device=dev, mix=False, fold=True)
        db = 20 * np.log10(max(float(np.abs(a - d).max()), 1e-30) / peak)
        log(f"{label}: mix+fold on vs off on the card "
            f"{verdict(a, d, db)}; fold alone on vs off "
            f"{'bit-equal' if np.array_equal(d, e) else 'DIFFERS'}")
        if not np.array_equal(d, e):
            fail(f"{label}: the fold alone changed the render")
        if db > -120:
            fail(f"{label}: mix+fold on vs off {db:.1f} dB")


def short_batch(lines, cyclic=False):
    """``lines`` compiled for 4 blocks and packed at 8 rows."""
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines

    tl4 = compile_script(lines, 4 * 512 / 44100.0, bank=WaveBank(),
                         script_dir=HERE / "corpus")
    return pack_stacked(stack_timelines([tl4] * 8), cyclic=cyclic)


def tile_rows(x, times):
    """A ``[rows]`` or ``[k, rows]`` tensor (either layout the cyclic
    kernel takes) with its rows repeated ``times`` times."""
    if x.dim() == 1:
        return x.repeat(times)
    if x.is_contiguous():
        return x.repeat(1, times)
    return x.T.repeat(times, 1).T


def sm_clock():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def cyclic_main(dev, card, spec, counters, errs):
    """Drive fb1-fb5, and a ring above the keyed variant's cap, at full
    width through render_cyclic_stream_device (see the module docstring).
    Returns (launches by script and counter, timings by script, row
    count and variant)."""
    from skred_tpu_torch.engine import cyclic
    from skred_tpu_torch.engine.kernels import cyclic as ck

    real = cyclic.cyclic_block
    launches, captured, batches = {}, {}, {}
    runs = [(p.stem, p.read_text().splitlines(),
             SECONDS if p.stem in ("fb2", "fb5") else NOISE64_SECONDS, CHUNK)
            for p in FEEDBACK]
    # the ring: one chunk of 43 blocks, enough to show the rule's other arm
    runs.append(("ring16", RING16, 43 * 512 / 44100.0 + 0.001, 43))
    for name, lines, seconds, chunk in runs:
        t0 = time.time()
        st = cyclic_batch(lines, seconds, ROWS)
        batches[name] = st
        k = st.params["amp"].shape[-1]
        segs = st.params["amp"].shape[1]
        reason = cyclic.cyclic_gate(st)
        if st.fused_passes is not None or reason is not None:
            fail(f"{name}: not a cyclic batch the kernel takes ({reason})")
        host_s = time.time() - t0

        def capture(*a, **kw):
            captured.setdefault(name, (a, kw))
            return real(*a, **kw)

        cyclic.cyclic_block = capture
        try:
            cyclic.render_cyclic_stream_device(st, chunk, warmup_only=True,
                                               device=dev)
        finally:
            cyclic.cyclic_block = real
        torch.cuda.synchronize()
        whole = st.num_blocks // chunk * chunk
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        cs = cyclic.render_cyclic_stream_device(st, chunk, device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {nm: fn.launches for nm, fn in counters.items()}
        launches[name] = counts
        variant = ck.variant_for(k)
        audio_s = st.batch * whole * st.block / 44100.0
        log(f"cyclic main {name}: {st.batch} rows x {k} voices ({variant} "
            f"variant), {segs} segment(s), host compile+pack {host_s:.1f} "
            f"s; wall {wall:.3f} s, {audio_s / wall:.1f}x realtime "
            f"({st.batch} rows x {whole * st.block / 44100.0:.3f} s "
            f"rendered), launches {counts} ({whole} blocks), checksum {cs}, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on "
            f"{card}")
        want = {"cyclic": whole, f"cyclic_{variant}": whole}
        for nm, count in counts.items():
            if count != want.get(nm, 0):
                fail(f"{nm}.launches {count} != {want.get(nm, 0)} on cyclic "
                     f"main {name} ({whole} blocks, {variant} variant)")
        if (name == "ring16") != (variant == "general"):
            fail(f"cyclic main {name}: the rule chose the {variant} variant")
        if not (np.isfinite(cs) and cs > 0):
            fail(f"cyclic main {name}: bad checksum {cs}")
    for name in ("fb2", "fb4"):
        log(profile_line(
            f"cyclic main {name}",
            lambda: cyclic.render_cyclic_stream_device(
                batches[name], CHUNK, warmup_only=True, device=dev),
            ["cyclic_fixed"]))

    timings = {}
    for name in ("fb2", "fb5"):
        a, kw = captured[name]
        plain_ms, want1 = host_ms(lambda: spec["plain"](a, kw))
        for rows in (ROWS, WIDE_ROWS):
            times_r = rows // ROWS
            aa = a if rows == ROWS else widen(a, times_r)
            # the plain version works row by row: at 16 times the rows
            # (the same rows tiled) its result is the 1024-row one tiled
            want = [w.repeat(times_r, 1) if i < 2 else tile_rows(w, times_r)
                    for i, w in enumerate(want1)]
            clk0 = sm_clock()
            times = {"general": [], "fixed": []}
            for variant in ("general", "fixed", "fixed", "general"):
                go, outs = spec["launcher"](aa, variant)
                times[variant].append(cuda_ms(go, 20))
                bad = [i for i, (g, w) in enumerate(zip(outs, want))
                       if not same_bits(g, w)]
                ekey = "cyclic" if variant == "fixed" else "cyclic_general"
                errs[ekey] = max([errs.get(ekey, 0.0)]
                                 + [max_abs(g, w) for g, w in zip(outs, want)])
                if bad:
                    fail(f"cyclic {variant} variant disagrees with its plain "
                         f"version on {name}'s first block at {rows} rows "
                         f"(outputs {bad})")
            clk1 = sm_clock()
            bound_ms, bound_by = spec["bound"](aa, kw)
            for variant, ts in times.items():
                timings[name, rows, variant] = dict(
                    ms=sum(ts) / len(ts), plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            log(f"cyclic {name} first block, {a[8]} voices x {a[9]} frames "
                f"at {rows} rows: general "
                + " / ".join(f"{t:.4f}" for t in times["general"])
                + " ms/call, keyed "
                + " / ".join(f"{t:.4f}" for t in times["fixed"])
                + f" ms/call (in turns general, keyed, keyed, general; CUDA "
                f"events, 20 calls each), "
                f"{min(times['general']) / max(times['fixed']):.2f}x at "
                f"least; plain {plain_ms:.1f} ms at {ROWS} rows, bound {bound_ms:.4f} ms "
                f"({bound_by}), library call: none; both bit-equal to the "
                f"plain version; clocks.sm {clk0} -> {clk1}, on {card}")
    return launches, timings


def cyclic_batch(lines, seconds, rows):
    """``lines`` compiled for ``seconds`` and packed for the cyclic engine
    at ``rows`` replicated rows."""
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines

    tl = compile_script(lines, seconds, bank=WaveBank(),
                        script_dir=HERE / "corpus")
    return pack_stacked(stack_timelines([tl] * rows), cyclic=True)


def widen(a, times):
    """The cyclic kernel's arguments with every row repeated ``times``
    times."""
    wide = list(a)
    wide[4] = {kk: tile_rows(v, times) for kk, v in a[4].items()}
    wide[5] = {kk: tile_rows(v, times) for kk, v in a[5].items()}
    wide[6] = tile_rows(a[6], times)
    return tuple(wide)


def cyclic_keys():
    """{label: key} of the cyclic kernel's keyed builds the run needs:
    fb1-fb5 as the main path renders them (their whole segment list) and
    as the kernel phase draws them (one block), and the all-features
    script."""
    from skred_tpu_torch.engine.fused import compute_feat
    from skred_tpu_torch.engine.kernels import cyclic as ck
    from skred_tpu_torch.engine.kernels import cyclic_inputs as ci

    keys = {}
    for p in FEEDBACK:
        lines = p.read_text().splitlines()
        seconds = SECONDS if p.stem in ("fb2", "fb5") else NOISE64_SECONDS
        st = cyclic_batch(lines, seconds, 2)
        keys[p.stem] = ck.fixed_key(compute_feat(st),
                                    st.params["amp"].shape[-1])
        a = ci.block_inputs(lines, 2, seed=16, n=8)
        keys.setdefault(f"{p.stem} block", ck.fixed_key(a[7], a[8]))
    a = ci.block_inputs(ci.ALL_FEATURES, 2, seed=17, n=8)
    keys["all-features"] = ck.fixed_key(a[7], a[8])
    a = ci.block_inputs(FEEDBACK[0].read_text().splitlines(), 2, seed=20,
                        n=8)
    keys["fb1 block, fast"] = ck.fixed_key(a[7], a[8], exact=False)
    return keys


def tier_keys():
    """{label: key} of the keyed tier kernel's builds the run needs:
    stress64's tiers as the main path renders them (mix and fold on) and
    as the comparison renders them with mix and fold off, the
    repeat-passes script's calls (estimate and final passes) both ways,
    and the kernel phase's calls."""
    from skred_tpu_torch.engine import fused

    keys = {}
    for name, lines in (("stress64", STRESS64.read_text().splitlines()),
                        ("repeat-passes", UNION_CYCLE)):
        for cfg, kw in (("mix+fold on", dict(mix=True, fold=True)),
                        ("mix+fold off", dict(mix=False, fold=False))):
            _, r, _ = fused._prepare(short_batch(lines), True, "cpu", **kw)
            for i, key in enumerate(fused._tier_keys(r)):
                keys[f"{name} call {i}, {cfg}"] = key
    for i, key in enumerate(kernel_tier_keys()):
        keys[f"kernel phase call {i}"] = key
    return keys


def noise_keys():
    """{label: (source, key)} of the keyed noise kernels' builds the run
    needs: noise64's tiers as the main path renders them and the kernel
    phase's calls."""
    from skred_tpu_torch.engine import fused
    from skred_tpu_torch.engine.kernels import filt_smooth as fs
    from skred_tpu_torch.engine.kernels import phase_walk as pw
    from skred_tpu_torch.engine.kernels import noise_inputs as ni

    _, r, _ = fused._prepare(short_batch(NOISE64.read_text().splitlines()),
                             True, "cpu")
    keys = {f"noise64 build {i}": k
            for i, k in enumerate(fused._noise_keys(r))}
    for i, feat in enumerate((ni.NOISE64_WARP0, ni.NOISE64_WARP1)):
        keys[f"kernel phase walk {i}"] = ("phase_walk",
                                          pw.phase_walk_key(feat))
    for i, feat in enumerate((ni.NOISE64_FSN0, ni.NOISE64_FSN1)):
        keys[f"kernel phase filt_smooth {i}"] = ("filt_smooth",
                                                 fs.filt_smooth_key(feat))
    return keys


# ---- the compat engine (engine/render.py, csrc/compat.cu) ----

# a voice copy ('>') of a voice with sample & hold on, in a later segment
VOICE_COPY = ["v0 w0 f220 a3 h5 J900 K5000 Q25", "v1 w1 f110 a2 F0,0.5",
              "~.012 v0 >2 v2 f330 a2"]
# tests/test_recorder.py's recording, its wait cut to 0.02 s
RECORDER = ["v0 w0 f440 a4 r1", "v1 w4 f220 a2 r1", "v2 w2 f2 a1 m1",
            "<1", "~0.02 *"]
# the compat kernel's stamp build (tools/compat_stamps.py) renders this
# many blocks after a warm one
STAMP_BLOCKS = 4


def compat_batch(rows, seconds=0.0464):
    """stress64, noise64, fb2, fb4 cut to a segment a block and the
    voice copy, compiled for ``seconds`` (4 blocks) and stacked to
    ``rows`` rows."""
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import stack_timelines

    fb4 = [ln.replace("~.5", "~.012")
           for ln in FEEDBACK[3].read_text().splitlines()]
    scripts = [STRESS64.read_text().splitlines(),
               NOISE64.read_text().splitlines(),
               FEEDBACK[1].read_text().splitlines(), fb4, VOICE_COPY]
    bank = WaveBank()
    tls = [compile_script(lines, seconds, bank=bank,
                          script_dir=HERE / "corpus") for lines in scripts]
    return stack_timelines([tls[i % len(tls)] for i in range(rows)])


def compat_keys():
    """{label: key} of the compat kernel's builds that the compat, batch
    and repair phases launch, and the stamp build, so that the build
    phase makes them with the rest, in parallel (a key that another
    phase needs builds at its first use)."""
    from skred_tpu_torch.engine import render as cr
    from skred_tpu_torch.engine.kernels import compat as K
    from skred_tpu_torch.parallel.batch import stack_timelines

    keys = {}

    def add(label, st, captures=(False, True), passes=None):
        inp = cr.stacked_inputs(st, "cpu")
        for cap in captures:
            keys[label + (" capture" if cap else "")] = K.compat_key(
                inp, passes or st.mod_passes, cap)
        return inp

    st = compat_batch(8)
    for passes in (1, 2):
        add(f"compat batch, {passes} pass(es)", st, passes=passes)
    s64 = stack_timelines([prepare_tl(STRESS64, SECONDS)])
    inp = add("stress64", s64)
    keys["stress64 stamped"] = K.compat_key(inp, s64.mod_passes, False,
                                            stamp=True)
    add("batch", stack_timelines([prepare_tl(p, BATCH_SECONDS) for p in
                                  [STRESS64, NOISE64] + FEEDBACK]), (False,))
    for p in (FEEDBACK[0], FEEDBACK[3]):
        add(f"repair {p.stem}",
            stack_timelines([prepare_tl(p, REPAIR_SECONDS)]), (False,))
    return keys


def compat_sass(key):
    """Instructions of the compat kernel's sample loop under ``key``
    (static: each instruction once, the 32-sample voice sum's too): the
    second largest loop, inside the block loop."""
    import re

    from skred_tpu_torch.engine.kernels import build

    funcs = sass_functions(build._target("compat", key))
    name = next(nm for nm in funcs if "compat_kernel" in nm)
    ins = funcs[name]
    loops = []
    for a, t in ins:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", t)
        if m and int(m.group(1), 16) < a:
            lo = int(m.group(1), 16)
            loops.append(sum(1 for aa, _ in ins if lo <= aa <= a))
    loops.sort(reverse=True)
    return dict(kernel=name, instructions=len(ins),
                per_sample=loops[1] if len(loops) > 1 else loops[0])


def compat_phase(dev, card, peaks, counters, errs, ckeys, secs):
    """The compat engine on the card (see the module docstring); ckeys:
    compat_keys(), secs: the build phase's seconds by build label.
    Returns its record for the kernels' JSON."""
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.engine import fused
    from skred_tpu_torch.engine import render as cr
    from skred_tpu_torch.engine.kernels import build
    from skred_tpu_torch.engine.kernels import compat as K
    from skred_tpu_torch.tools import compat_stamps
    from skred_tpu_torch.host.timeline import compile_script, noise_stream
    from skred_tpu_torch.io.recorder import render_recordings
    from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines

    def db(a, b):
        """max |a - b| in dB of b's peak"""
        return 20 * np.log10(max(float(np.abs(a - b).max()), 1e-30)
                             / float(np.abs(b).max()))

    def hold(got, want, capture, what):
        """The kernel's (carry, out, cap) bit for bit against the plain
        version's; the largest difference goes into errs."""
        torch.cuda.synchronize()
        pairs = list(zip(got[0], want[0])) + [(got[1], want[1])]
        if capture:
            pairs.append((got[2], want[2]))
        errs["compat"] = max([errs.get("compat", 0.0)] + [
            max_abs(g, w) for g, w in pairs])
        bad = [i for i, (g, w) in enumerate(pairs) if not same_bits(g, w)]
        if bad:
            fail(f"compat kernel disagrees with its plain version ({what}; "
                 f"outputs {bad})")

    # ---- the builds: one library per key ----
    for label, key in ckeys.items():
        lab = build.label("compat", key)
        log(f"compat key {label}: {lab} {' '.join(key)}; built in "
            + (f"{secs[lab]:.1f} s (the build phase, in parallel)"
               if lab in secs else "an earlier run"))

    # ---- the kernel against its plain version on the card ----
    st = compat_batch(8)
    if not (np.asarray(st.seg_is_start)[:, 2:].any()
            and (st.ops["copy_hold_from"] >= 0).any()):
        fail("compat: the batch has no segment start past block 1 or no "
             "voice copy")
    inp = cr.stacked_inputs(st, dev)
    nz = torch.as_tensor(noise_stream(4 * 512), device=dev)
    plain_t = {}
    carry2 = None
    # the plain version once a pass count: its exact argument selects
    # nothing (compat_block_plain), so both modes are held to one render
    for passes in (1, 2):
        zero = K.zero_carry(8, dev)
        t_ms, want = host_ms(lambda: K.compat_block_plain(
            inp, zero, nz[:1024], 0, 2, passes, True, True))
        plain_t[passes] = t_ms
        for exact in (True, False):
            for capture in (False, True):
                got = K.compat_block(inp, zero, nz[:1024], 0, 2, passes,
                                     exact, capture)
                hold(got, want, capture, f"8 rows, blocks 0-1, exact="
                     f"{exact}, passes={passes}, capture={capture}")
                if exact and passes == 2 and not capture:
                    carry2 = got[0]
    # a later chunk: blocks 2-3 from the kernel's own carry, where the
    # segments, the sample count and the noise stream start past 0
    want = K.compat_block_plain(inp, carry2, nz[1024:], 2, 2, 2, True, True)
    hold(K.compat_block(inp, carry2, nz[1024:], 2, 2, 2, True, True), want,
         True, "8 rows, blocks 2-3 from the kernel's carry")
    log(f"compat kernel vs plain: bit-equal on 8 rows x 2 blocks (stress64, "
        f"noise64, fb2, fb4 cut, the voice copy; "
        f"{st.params['amp'].shape[1]} segments), exact and fast, 1 and 2 "
        f"passes, capture on and off, and on blocks 2-3 from the kernel's "
        f"carry (exact, 2 passes, capture); the plain version on the card "
        + ", ".join(f"{t:.0f} ms ({p} pass{'es' if p > 1 else ''})"
                    for p, t in plain_t.items()) + f", on {card}")

    # ---- the card's render against the port's CPU render ----
    out_d, cap_d = cr.render_rows(st, capture=True, device=dev)
    out_c, cap_c = cr.render_rows(st, capture=True, device="cpu")
    if not (same_bits(torch.from_numpy(out_d), torch.from_numpy(out_c))
            and same_bits(torch.from_numpy(cap_d), torch.from_numpy(cap_c))):
        fail("compat: the card's render differs from the CPU's")
    log(f"compat card vs CPU: out {out_d.shape} and capture {cap_d.shape} "
        f"bit-equal (8 rows x 4 blocks, exact, 2 passes)")

    # ---- the main path: stress64 10 s, streamed, 1 and 1024 rows ----
    tl = compile_script(STRESS64.read_text().splitlines(), SECONDS,
                        bank=WaveBank(), script_dir=STRESS64.parent)
    sass = compat_sass(ckeys["stress64"])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the stamp build's cycles a stage at 1 and 1024 rows
    stamps = {}
    for rows in (1, ROWS):
        stamps[rows] = rec = compat_stamps.stamp_cycles(STRESS64, rows, dev,
                                                       STAMP_BLOCKS)
        for line in compat_stamps.table(rec).splitlines():
            log(f"compat stamps: {line}")
        if not (rec["total"]["median"] > 0
                and rec["key"] == list(ckeys["stress64"])):
            fail(f"compat stamps ({rows} rows): {rec['total']}, key "
                 f"{rec['key']}")
    nz = torch.as_tensor(noise_stream(CHUNK * 512), device=dev)
    runs = {}
    launches = 0
    for rows, capture in ((1, False), (1, True), (ROWS, False)):
        batch = tl if rows == 1 else stack_timelines([tl] * rows)
        whole = batch.num_blocks // CHUNK * CHUNK
        # the kernel alone on the first chunk, by CUDA events
        inp = cr.stacked_inputs(stack_timelines([tl] * rows), dev)
        zero = K.zero_carry(rows, dev)
        k_ms = cuda_ms(lambda: K.compat_block(
            inp, zero, nz, 0, CHUNK, tl.mod_passes, True, capture), 2) / CHUNK
        cr.render_stream_device(batch, CHUNK, capture=capture,
                                warmup_only=True, device=dev)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        clk0 = sm_clock()
        t0 = time.time()
        cs = cr.render_stream_device(batch, CHUNK, capture=capture,
                                     device=dev)
        torch.cuda.synchronize()
        wall = time.time() - t0
        clk1 = sm_clock()
        counts = {nm: fn.launches for nm, fn in counters.items()
                  if fn.launches}
        if counts != {"compat": whole // CHUNK}:
            fail(f"compat main ({rows} rows): launches {counts}, not "
                 f"{whole // CHUNK} of compat alone")
        if not (np.isfinite(cs) and cs > 0):
            fail(f"compat main ({rows} rows): bad checksum {cs}")
        if rows == ROWS:
            launches = counts["compat"]
        mhz = max(float(c.split()[0]) for c in (clk0, clk1))
        per_sched = -(-2 * rows // (4 * sms))
        issue_us = sass["per_sample"] * per_sched / mhz
        chain_us = stamps[1]["total"]["median"] / mhz
        runs[rows, capture] = dict(wall=wall, ms=k_ms, issue_us=issue_us)
        audio = rows * whole * tl.block / 44100.0
        log(f"compat main stress64 {rows} row(s), capture "
            f"{'on' if capture else 'off'}: {whole} blocks "
            f"({tl.mod_passes} passes, exact) in {wall:.3f} s (host clock, "
            f"set-up and uploads included), {wall / whole * 1e3:.4f} ms a "
            f"block; the kernel alone {k_ms:.4f} ms a block, "
            f"{k_ms / tl.block * 1e3:.3f} us a sample step (CUDA events, "
            f"2 calls of {CHUNK} blocks); {audio / wall:.1f}x realtime ({rows} x "
            f"{whole * tl.block / 44100.0:.3f} s), launches {counts}, "
            f"checksum {cs}; a sample step at {mhz:.0f} MHz: static "
            f"issue estimate {issue_us:.3f} us (the sample loop's "
            f"{sass['per_sample']} SASS instructions, each once, the "
            f"32-sample voice sum and the slow paths too, x {per_sched} "
            f"warp(s) a scheduler: not a floor), stamped chain "
            f"{chain_us:.3f} us (the stamp build's stages at 1 row, "
            f"median warp, its stamps included); clocks.sm {clk0} -> "
            f"{clk1}, on {card}")
    # the plain version and the bound on the 1024-row run's first block
    # (inp and zero: the last run's, 1024 rows), the kernel held to it;
    # then blocks 172-173 from the kernel's carry after its first chunk
    passes = tl.mod_passes
    plain_ms, want = host_ms(lambda: K.compat_block_plain(
        inp, zero, nz[:512], 0, 1, passes, True))
    hold(K.compat_block(inp, zero, nz[:512], 0, 1, passes, True), want,
         False, f"{ROWS} rows of stress64, block 0")
    c_chunk = K.compat_block(inp, zero, nz, 0, CHUNK, passes, True)[0]
    nz2 = torch.as_tensor(noise_stream((CHUNK + 2) * 512)[CHUNK * 512:],
                          device=dev)
    want = K.compat_block_plain(inp, c_chunk, nz2, CHUNK, 2, passes, True)
    hold(K.compat_block(inp, c_chunk, nz2, CHUNK, 2, passes, True), want,
         False, f"{ROWS} rows of stress64, blocks {CHUNK}-{CHUNK + 1}")
    log(f"compat kernel vs plain at the main path's shapes: bit-equal on "
        f"{ROWS} rows of stress64 ({passes} passes, exact), block 0 from "
        f"the zero carry and blocks {CHUNK}-{CHUNK + 1} from the kernel's "
        f"carry after its first {CHUNK}-block chunk")
    bound_ms, bound_by = roofline.compat_bound(inp, 0, CHUNK, tl.mod_passes,
                                               peaks)
    bound_ms /= CHUNK
    log(f"compat stress64 at {ROWS} rows: kernel {runs[ROWS, False]['ms']:.4f}"
        f" ms a block (1 row {runs[1, False]['ms']:.4f}, with capture "
        f"{runs[1, True]['ms']:.4f}), plain {plain_ms:.0f} ms a block (host clock), bound "
        f"{bound_ms:.4f} ms a block ({bound_by}), library call: none; SASS "
        f"{sass['instructions']} instructions in {sass['kernel']}; on {card}")

    # ---- the compat render against the fused render, both on the card ----
    tl_s = compile_script(STRESS64.read_text().splitlines(), 0.25,
                          bank=WaveBank(), script_dir=STRESS64.parent)
    a = cr.render_timeline(tl_s, device=dev)
    b = fused.render_fused(pack_stacked(stack_timelines([tl_s])),
                           device=dev)[0]
    d_db = db(b, a)
    log(f"compat vs fused, stress64 0.25 s on the card: {d_db:.1f} dB of "
        f"the peak {float(np.abs(a).max()):.3f}")
    if not d_db <= -60.0:
        fail(f"compat vs fused: {d_db:.1f} dB")

    # ---- the fused engine's capture on the card and on the CPU ----
    for path in (STRESS64, NOISE64):
        ftl = compile_script(path.read_text().splitlines(), 0.0232,
                             bank=WaveBank(), script_dir=path.parent)
        fst = pack_stacked(stack_timelines([ftl] * 8))
        out_d, cap_d = fused.render_fused(fst, capture=True, device=dev)
        out_c, cap_c = fused.render_fused(fst, capture=True, device="cpu")
        if cap_d.shape != (2, 8, 64, 512, 2) or not same_bits(
                torch.from_numpy(cap_d), torch.from_numpy(cap_c)):
            fail(f"fused capture ({path.name}): the card's capture "
                 f"{cap_d.shape} differs from the CPU's")
        # the output is the captured voices' sum times the master volume
        # smoother (zero at the start), here in f64 on the engine's f32
        # constants
        a = float(np.float32(1.0) - np.float32(0.002))
        b = float(np.float32(0.002))
        vf = np.repeat(np.take_along_axis(
            np.asarray(fst.params["volume_final"], np.float64),
            np.asarray(fst.seg_of_block), 1), 512, axis=1)
        vg = np.empty_like(vf)
        g = np.zeros(vf.shape[0])
        for t in range(vf.shape[1]):
            g = a * g + b * vf[:, t]
            vg[:, t] = g
        voices = cap_d.astype(np.float64).sum(axis=2).transpose(
            1, 0, 2, 3).reshape(8, -1, 2) * vg[..., None]
        mixed = fused.render_fused(fst, device=dev)
        d_cpu, d_sum, d_mix = (db(out_d, out_c), db(out_d, voices),
                               db(out_d, mixed))
        log(f"fused capture {path.name}, 8 rows x 2 blocks on the card: "
            f"capture {cap_d.shape} bit-equal to the CPU's; out against "
            f"the CPU's {d_cpu:.1f} dB (the voice sum's order), against "
            f"the captured voices' sum x the volume gain {d_sum:.1f} dB, "
            f"against the render with the kernel's mix and fold "
            f"{d_mix:.1f} dB")
        if not (d_cpu <= -120.0 and d_sum <= -100.0 and d_mix <= -100.0):
            fail(f"fused capture ({path.name}): {d_cpu:.1f}, {d_sum:.1f}, "
                 f"{d_mix:.1f} dB")

    # ---- the recorder on the card and on the CPU ----
    import tempfile
    import wave

    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        got = {}
        for where in (dev, "cpu"):
            rt = compile_script(RECORDER, 0.05, bank=WaveBank(),
                                script_dir=HERE / "corpus")
            files = render_recordings(rt, pathlib.Path(tmp) / str(where),
                                      device=where)
            if len(files) != 1:
                fail(f"recorder on {where}: {files}")
            with wave.open(str(files[0][0])) as f:
                got[str(where)] = (f.getnchannels(), f.getnframes(),
                                   f.readframes(f.getnframes()))
        if got[str(dev)] != got["cpu"] or got["cpu"][1] == 0:
            fail("recorder: the card's WAV differs from the CPU's")
        log(f"recorder: {got['cpu'][0]} channels x {got['cpu'][1]} frames, "
            f"the card's WAV equal to the CPU's byte for byte")
    return dict(name="compat", route="cuda",
                source="skred_tpu_torch/engine/kernels/csrc/compat.cu",
                replaces="skred_tpu/engine/render.py:375",
                launches=launches, max_abs_err=errs.get("compat", 0.0),
                ms=runs[ROWS, False]["ms"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                ms_1_row=runs[1, False]["ms"],
                ms_1_row_capture=runs[1, True]["ms"],
                stamped_chain_ms_1_row=(stamps[1]["total"]["median"] * 512
                                        / 1e3 / mhz),
                sass_per_sample=sass["per_sample"],
                key_build_s=secs.get(build.label("compat",
                                                 ckeys["stress64"])))


def batch_phase(dev, card, counters):
    """render_batch over every in-repo script: the fused engine's two
    buckets and five cyclic scripts in one call, then the compat engine
    alone.  Returns (scripts, the first render, the compat render)."""
    from skred_tpu_torch.parallel.batch import render_batch

    scripts = [STRESS64, NOISE64] + FEEDBACK
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    out = auto = render_batch(scripts, BATCH_SECONDS, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {nm: fn.launches for nm, fn in counters.items()}
    peaks = [float(np.abs(row).max()) for row in out]
    log(f"batch: {len(scripts)} scripts x 0.25 s in {wall:.2f} s, out "
        f"{out.shape}, peaks {[round(x, 3) for x in peaks]}, launches "
        f"{counts} on {card}")
    if out.shape != (len(scripts), 22 * 512, 2) or out.dtype != np.float32:
        fail(f"batch: bad output {out.shape} {out.dtype}")
    if not np.isfinite(out).all():
        fail("batch: non-finite samples")
    if min(peaks) <= 0.01:
        fail(f"batch: a silent row (peaks {peaks})")
    for nm in ("tier", "tier_keyed", "phase_walk_warp", "lookup",
               "filt_smooth_noise", "cyclic"):
        if counts[nm] <= 0:
            fail(f"batch: {nm} was not launched")
    if counts["compat"]:
        fail("batch: the fused and cyclic engines launched the compat "
             "kernel")
    # the same scripts through the compat engine: its kernel alone
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    out = render_batch(scripts, BATCH_SECONDS, engine="compat", device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {nm: fn.launches for nm, fn in counters.items() if fn.launches}
    peaks = [float(np.abs(row).max()) for row in out]
    log(f"batch (engine=\"compat\"): {len(scripts)} scripts x 0.25 s in "
        f"{wall:.2f} s, out {out.shape}, peaks "
        f"{[round(x, 3) for x in peaks]}, launches {counts} on {card}")
    if out.shape != (len(scripts), 22 * 512, 2) or \
            not np.isfinite(out).all() or min(peaks) <= 0.01:
        fail(f"batch (compat): bad output {out.shape}, peaks {peaks}")
    if set(counts) != {"compat"}:
        fail(f"batch (compat): launches {counts}, not the compat kernel's "
             f"alone")
    # the cyclic kernel (exact) against the compat kernel (whose fast and
    # exact modes are one arithmetic) on the feedback scripts
    fb_db = {p.stem: db_of(auto[i], out[i])
             for i, p in enumerate(scripts) if p in FEEDBACK}
    log("batch: cyclic vs compat on the feedback scripts, dB of the "
        "compat peak: " + ", ".join(f"{k} {v:.1f}" for k, v in fb_db.items())
        + f" on {card}")
    for name in ("fb1", "fb4"):
        if not fb_db[name] <= -60.0:
            fail(f"batch: {name} cyclic vs compat at {fb_db[name]:.1f} dB, "
                 f"above -60 dB")
    return scripts, auto, out


def db_of(a, b):
    """max |a - b| in dB of b's peak (-inf where they are equal)."""
    err = float(np.abs(np.asarray(a, np.float64) - b).max())
    return 20 * np.log10(err / float(np.abs(b).max())) if err else -np.inf


def zero_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters):
    return {nm: fn.launches for nm, fn in counters.items() if fn.launches}


REPAIR_BLOCKS = 5
REPAIR_SECONDS = REPAIR_BLOCKS * 512 / 44100.0
DRYRUN_SECONDS = 0.05              # entry_torch's default
CLI_SECONDS = 1.0
BATCH_SECONDS = 0.25
PARITY_SECONDS = 1.0               # card_parity in the tools phase
TOOL_SECONDS = 4.0                 # one_bucket, the bench
# cut to keep the tools phase near 45 s (at 20 s and 4 s it took 54.3 s
# on an H100 80GB HBM3, 700 W)
ENDURANCE_SECONDS = 10.0
# gluebench: one 172-block chunk, one pass, cut rows: its stubs and
# their restore are what the phase checks
GLUE_SECONDS, GLUE_PASSES, GLUE_ROWS = 2.0, 1, 256


def tool_keys(paths, seconds, exact):
    """The keyed builds of ``paths``' bench buckets (2 rows: the keys
    are the distinct scripts') in one arithmetic mode."""
    from skred_tpu_torch.engine import fused
    from skred_tpu_torch.engine.fused import compute_feat
    from skred_tpu_torch.engine.kernels import cyclic as ck
    from skred_tpu_torch.parallel.batch import (pack_stacked,
                                                pad_segments_pow2,
                                                stack_timelines)

    items = []
    for path in paths:
        tl = prepare_tl(path, seconds)
        if tl.fused_passes is None:
            st = pack_stacked(stack_timelines([tl] * 2), cyclic=True)
            items.append(("cyclic", ck.fixed_key(
                compute_feat(st), st.params["amp"].shape[-1], exact)))
            continue
        st = pad_segments_pow2(pack_stacked(stack_timelines([tl] * 2)))
        _, r, _ = fused._prepare(st, exact, "cpu")
        items += [("tier", key) for key in fused._tier_keys(r)]
        items += list(fused._noise_keys(r))
    return items


def slice_builds():
    """The keyed builds the repair, mesh, cli and tools phases need, so
    that the build phase makes them with the rest, in parallel: the tier
    and noise kernels' keys of the dry run's batches (its two-row batch,
    stress64 and noise64 alone), and the cyclic kernel's keys
    of fb1-fb5 as render_batch compiles them at the dry run's and the
    batch's seconds, and of fb1 and fb4 in fast mode; the tools' buckets
    (every script at the parity run's seconds in both modes, the timed
    tools' at theirs, stress64 at the endurance run's)."""
    import entry_torch
    from skred_tpu_torch.engine import fused
    from skred_tpu_torch.engine.fused import compute_feat
    from skred_tpu_torch.engine.kernels import cyclic as ck
    from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines

    items = []
    batches = [entry_torch._tiny_stacked(2)]
    for path in (STRESS64, NOISE64):
        tl = prepare_tl(path, DRYRUN_SECONDS)
        batches.append(pack_stacked(stack_timelines([tl])))
    for st in batches:
        _, r, _ = fused._prepare(st, True, "cpu")
        items += [("tier", key) for key in fused._tier_keys(r)]
        items += list(fused._noise_keys(r))
    for p in FEEDBACK:
        lines = p.read_text().splitlines()
        runs = [(DRYRUN_SECONDS, True), (BATCH_SECONDS, True)]
        if p.stem in ("fb1", "fb4"):
            runs.append((REPAIR_SECONDS, False))
        for seconds, exact in runs:
            st = cyclic_batch(lines, seconds, 1)
            items.append(("cyclic", ck.fixed_key(
                compute_feat(st), st.params["amp"].shape[-1], exact)))
    scripts = [STRESS64, NOISE64] + FEEDBACK
    for exact in (True, False):
        items += tool_keys(scripts, PARITY_SECONDS, exact)
    items += tool_keys(scripts, TOOL_SECONDS, True)
    items += tool_keys([STRESS64], ENDURANCE_SECONDS, True)
    return list(dict.fromkeys(items))


def prepare_tl(path, seconds):
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.host.timeline import compile_script

    return compile_script(path.read_text().splitlines(), seconds,
                          bank=WaveBank(), script_dir=path.parent)


def repair_phase(dev, card, counters):
    """Fast mode of the feedback engines: fb1 and fb4 at 8 rows x 5
    blocks.  The compat kernel's fast render equals its exact render bit
    for bit; the cyclic kernel's fast render is within -60 dB of the
    compat kernel's exact render."""
    from skred_tpu_torch.engine.cyclic import render_cyclic
    from skred_tpu_torch.parallel.batch import (pack_stacked,
                                                render_stacked,
                                                stack_timelines)

    for p in (FEEDBACK[0], FEEDBACK[3]):
        st = stack_timelines([prepare_tl(p, REPAIR_SECONDS)] * 8)
        zero_counts(counters)
        t0 = time.time()
        exact = render_stacked(st, exact=True, device=dev)
        fast = render_stacked(st, exact=False, device=dev)
        cyc = render_cyclic(pack_stacked(st, cyclic=True), exact=False,
                            device=dev)
        wall = time.time() - t0
        counts = read_counts(counters)
        d = db_of(cyc, exact)
        log(f"repair {p.stem}: 8 rows x {st.num_blocks} blocks, compat "
            f"fast vs exact {'bit-equal' if same_bits(fast, exact) else 'DIFFER'}"
            f", cyclic fast vs compat exact {d:.1f} dB of the peak "
            f"{float(np.abs(exact).max()):.3f}, launches {counts}, "
            f"{wall:.2f} s on {card}")
        if exact.shape != (8, REPAIR_BLOCKS * 512, 2) or \
                not np.isfinite(exact).all() or np.abs(exact).max() <= 0.01:
            fail(f"repair {p.stem}: bad compat render {exact.shape}")
        if not same_bits(fast, exact):
            fail(f"repair {p.stem}: the compat kernel's fast render is not "
                 f"its exact render")
        if not d <= -60.0:
            fail(f"repair {p.stem}: cyclic fast at {d:.1f} dB, above -60")
        if counts.get("compat") != 2 or not counts.get("cyclic_fixed"):
            fail(f"repair {p.stem}: launches {counts}: not the compat and "
                 f"the keyed cyclic kernel")


def mesh_phase(dev, card, counters, batch):
    """A mesh of two entries on the one card, ["cuda:0", "cuda:0"]:
    stress64 and noise64 at 8 rows x 4 blocks through the fused engine,
    the seven in-repo scripts through render_batch (the batch phase's
    render without a mesh), each bit-equal to no mesh; entry()'s step on
    the card and dryrun_multichip(2, device="cuda")."""
    import entry_torch
    from skred_tpu_torch.engine.fused import render_fused
    from skred_tpu_torch.parallel.batch import (make_mesh, render_batch,
                                                render_stacked)

    mesh = [dev, dev]
    if torch.cuda.device_count() == 1 and make_mesh(2) != mesh:
        fail(f"mesh: make_mesh(2) is {make_mesh(2)}, not {mesh}")
    for path in (STRESS64, NOISE64):
        st = short_batch(path.read_text().splitlines())
        want = render_fused(st, device=dev)
        zero_counts(counters)
        got = render_fused(st, mesh=mesh)
        counts = read_counts(counters)
        log(f"mesh {path.stem}: 8 rows x {st.num_blocks} blocks over "
            f"{[str(d) for d in mesh]}: "
            f"{'bit-equal' if same_bits(got, want) else 'DIFFERS'} to no "
            f"mesh, launches {counts} on {card}")
        if not same_bits(got, want) or np.abs(want).max() <= 0.01:
            fail(f"mesh {path.stem}: the split render is not the unsplit "
                 f"render")
        need = ("tier_keyed",) if path == STRESS64 else \
            ("phase_walk_warp", "lookup", "filt_smooth_noise")
        if any(not counts.get(nm) for nm in need):
            fail(f"mesh {path.stem}: launches {counts}, not {need}")
    scripts, want, _ = batch
    zero_counts(counters)
    t0 = time.time()
    got = render_batch(scripts, BATCH_SECONDS, mesh=mesh)
    wall = time.time() - t0
    counts = read_counts(counters)
    log(f"mesh render_batch: {len(scripts)} scripts x {BATCH_SECONDS} s "
        f"over {[str(d) for d in mesh]} in {wall:.2f} s: "
        f"{'bit-equal' if same_bits(got, want) else 'DIFFERS'} to no mesh, "
        f"launches {counts} on {card}")
    if not same_bits(got, want):
        fail("mesh: render_batch over the mesh is not its render without")
    if any(not counts.get(nm) for nm in ("tier_keyed", "phase_walk_warp",
                                         "cyclic_fixed")):
        fail(f"mesh render_batch: launches {counts}")
    # entry_torch.py's entry points
    fn, example_args = entry_torch.entry(dev)
    zero_counts(counters)
    _, out, _ = fn(*example_args)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    want = render_stacked(entry_torch._tiny_stacked(2), exact=True,
                          device=dev)
    log(f"entry: the compat step on {out.device}, out "
        f"{tuple(out.shape)}, launches {counts}, vs render_stacked "
        f"{'bit-equal' if same_bits(out, want) else 'DIFFERS'}")
    if counts != {"compat": 1} or not same_bits(out, want):
        fail("entry: the step is not one compat launch equal to "
             "render_stacked")
    zero_counts(counters)
    t0 = time.time()
    entry_torch.dryrun_multichip(2, device="cuda")
    counts = read_counts(counters)
    log(f"dryrun_multichip(2) in {time.time() - t0:.2f} s, launches "
        f"{counts} on {card}")
    if any(not counts.get(nm) for nm in ("compat", "tier_keyed",
                                         "cyclic_fixed")):
        fail(f"dryrun_multichip: launches {counts}")


def cli_phase(dev, card, counters):
    """The command line on the card: render stress64 (1 s) with the
    fused and the compat engine, each WAV byte for byte the library
    render's; batch over fb1-fb5 with its wall and x realtime."""
    from skred_tpu_torch import cli
    from skred_tpu_torch.assets.bank import write_wav_16
    from skred_tpu_torch.engine import render_timeline
    from skred_tpu_torch.engine.fused import render_fused
    from skred_tpu_torch.parallel.batch import stack_timelines

    tmp = HERE / "build" / "chip_smoke_cli"
    tmp.mkdir(parents=True, exist_ok=True)
    tl = prepare_tl(STRESS64, CLI_SECONDS)
    for engine, need in (("fused", "tier_keyed"), ("compat", "compat")):
        out = tmp / f"stress64-{engine}.wav"
        zero_counts(counters)
        t0 = time.time()
        rc = cli.main(["render", str(STRESS64.relative_to(HERE)),
                       "--seconds", str(CLI_SECONDS), "--engine", engine,
                       "--out", str(out)])
        wall = time.time() - t0
        counts = read_counts(counters)
        want = render_fused(stack_timelines([tl]), device=dev)[0] \
            if engine == "fused" else render_timeline(tl, device=dev)
        write_wav_16(tmp / "want.wav", want)
        same = out.read_bytes() == (tmp / "want.wav").read_bytes()
        log(f"cli render --engine {engine}: rc {rc}, {wall:.2f} s, WAV "
            f"{'equal to' if same else 'DIFFERS from'} the library "
            f"render's, launches {counts} on {card}")
        if rc != 0 or not same or not counts.get(need):
            fail(f"cli render --engine {engine}: rc {rc}, same {same}, "
                 f"launches {counts}")
    zero_counts(counters)
    t0 = time.time()
    rc = cli.main(["batch", *(str(p.relative_to(HERE)) for p in FEEDBACK),
                   "--seconds", str(BATCH_SECONDS), "--outdir",
                   str(tmp / "batch")])
    wall = time.time() - t0
    counts = read_counts(counters)
    audio = len(FEEDBACK) * BATCH_SECONDS
    log(f"cli batch fb1-fb5: rc {rc}, {len(FEEDBACK)} scripts x "
        f"{BATCH_SECONDS} s in {wall:.3f} s ({audio / wall:.1f}x realtime, "
        f"wall clock, kernel builds done before), launches {counts} on "
        f"{card}")
    if rc != 0 or not counts.get("cyclic_fixed") or len(list(
            (tmp / "batch").glob("fb*.wav"))) != len(FEEDBACK):
        fail(f"cli batch: rc {rc}, launches {counts}")


def tools_phase(dev, card, counters):
    """The root tools on the card: card_parity --bucketed (exact and
    fast), endurance (oracle and run), one_bucket, gluebench, and the
    bench with the cyclic gate forced to refuse fb4."""
    import bench_torch
    from skred_tpu_torch.engine import cyclic, fused
    from skred_tpu_torch.tools import card_parity, endurance, gluebench
    from skred_tpu_torch.tools import one_bucket

    out = HERE / "build" / "chip_smoke_tools"
    secs = {}
    zero_counts(counters)
    for fast in (False, True):
        arith = "fast" if fast else "exact"
        t0 = time.time()
        rec = card_parity.card_parity(
            PARITY_SECONDS, bucketed=True, fast=fast, device=dev,
            record=out / f"card_parity_{arith}.json")
        log(f"tools card_parity --bucketed {arith} {PARITY_SECONDS} s: "
            + ", ".join(f"{n} {d:.2f} dB" for n, d in
                        sorted(rec["scripts"].items()))
            + f"; worst {rec['worst_db']} dB ({rec['worst_script']}), "
            f"median {rec['median_db']}, bit-exact {rec['bit_exact']}, "
            f"{time.time() - t0:.2f} s on {card}")
        if rec["n_scripts"] != 7 or not rec["pass"]:
            fail(f"tools: card_parity {arith}: {rec['scripts']}")
        secs[f"card_parity {arith}"] = time.time() - t0
    t0 = time.time()
    endurance.oracle(STRESS64, ENDURANCE_SECONDS, endurance.WIN, dev,
                     out / "endurance_oracle.npz")
    rec = endurance.run(STRESS64, ENDURANCE_SECONDS, ROWS, endurance.WIN,
                        dev, out / "endurance_oracle.npz",
                        out / "endurance.json")
    grow = rec["device_mem_mb_last"] - rec["device_mem_mb_first"]
    log(f"tools endurance stress64 {ENDURANCE_SECONDS} s x {ROWS} rows: "
        f"windows {rec['window_parity_db']} dB, "
        f"{rec['x_realtime']:.1f}x realtime, RSS {rec['rss_mb_first']:.1f}"
        f" -> {rec['rss_mb_last']:.1f} MB, device memory "
        f"{rec['device_mem_mb_first']:.3f} -> {rec['device_mem_mb_last']:.3f}"
        f" MB (peak {rec['device_mem_peak_mb']:.3f}), "
        f"{time.time() - t0:.2f} s with the oracle on {card}")
    if not rec["worst_window_db"] <= -60.0 or grow > 1.0:
        fail(f"tools: endurance worst window {rec['worst_window_db']} dB, "
             f"device memory grew {grow} MB")
    secs["endurance"] = time.time() - t0
    t0 = time.time()
    (ob,) = one_bucket.one_bucket("fb2.sk", TOOL_SECONDS, ["exact"], dev)
    if not ob["x_rt"] > 0:
        fail(f"tools: one_bucket {ob}")
    secs["one_bucket"] = time.time() - t0
    t0 = time.time()
    real = {nm: getattr(fused, nm) for nm in gluebench.KERNELS}
    rec = gluebench.gluebench(["stress64.sk", "noise64.sk"], GLUE_SECONDS,
                              dev, max_rows=GLUE_ROWS,
                              record=out / "gluebench.json",
                              passes=GLUE_PASSES)
    runs = {s: sorted(r["wall_s"]) for s, r in rec["scripts"].items()}
    if runs != {"noise64.sk": ["all stubbed", "filt_smooth_noise stubbed",
                               "full", "lookup stubbed",
                               "phase_walk_warp stubbed"],
                "stress64.sk": ["all stubbed", "full", "tier stubbed"]} \
            or {nm: getattr(fused, nm) for nm in gluebench.KERNELS} != real:
        fail(f"tools: gluebench runs {runs}, or the real kernels not back")
    secs["gluebench"] = time.time() - t0
    counts = read_counts(counters)
    log(f"tools: launches {counts}")
    need = ("compat", "tier_keyed", "phase_walk_warp", "lookup",
            "filt_smooth_noise", "cyclic_fixed")
    if any(not counts.get(nm) for nm in need):
        fail(f"tools: launches {counts}, not each of {need}")
    # the bench zeroes the counts for each bucket's timed passes and
    # keeps them in its detail
    t0 = time.time()
    # fb4 is the only in-repo cyclic script of several segments
    real_gate = cyclic.cyclic_gate
    cyclic.cyclic_gate = lambda st: "refused for the test" \
        if st.params["amp"].shape[1] > 1 else real_gate(st)
    try:
        res = bench_torch.main(seconds=TOOL_SECONDS, device=dev,
                               scripts=[FEEDBACK[0], FEEDBACK[3]])
    except SystemExit as ex:
        fail(f"tools: the bench with fb4 refused exited with {ex.code}")
    finally:
        cyclic.cyclic_gate = real_gate
    compat = [b for b in res["buckets"] if b["voices"] == "compat-scan"]
    log(f"tools bench, fb4 refused: {res['value']}x realtime over "
        f"{len(res['buckets'])} buckets, {res['total_audio_s']} s of audio in "
        f"{res['total_wall_s']} s; compat-scan bucket "
        + (json.dumps(compat[0]) if compat else "MISSING") + f" on {card}")
    audio = sum(b["rows"] * b["blocks"] * 512 / 44100.0
                for b in res["buckets"])
    if len(compat) != 1 or compat[0]["scripts"] != [FEEDBACK[3].name] \
            or len(res["buckets"]) != 2 or res.get("partial") \
            or abs(res["total_audio_s"] - audio) > 0.1 \
            or compat[0]["launches"] != {"compat": -(-compat[0]["blocks"]
                                                     // CHUNK)} \
            or not res["buckets"][0]["launches"].get("cyclic_fixed"):
        fail("tools: no compat-scan bucket of fb4 counted in the headline")
    secs["bench, fb4 refused"] = time.time() - t0
    log("tools: seconds " + ", ".join(f"{k} {v:.2f}" for k, v in
                                      secs.items())
        + f"; {sum(secs.values()):.2f} in all")


# the ablate phase: the env route's one_bucket run, one 172-block chunk
# (one_bucket credits whole chunks only: 1 s would be none)
ENV_ROUTE_SECONDS = 2.0
CENSUS_CPU_ROWS = 8
# how far the single stubs' SASS removals together may pass the
# skeleton's (register allocation and scheduling differ from build to
# build); an instruction in two stubs' shares shows as more
SASS_OVERLAP = 0.10


def ablate_phase(dev, card, path_keys):
    """The timing-ablation switches and the tools that read the glue:
    the main paths' keys (``path_keys``: {label: key} of the build
    phase's tier and cyclic builds) without an ablation define; the
    keyed tier kernel's phases (stress64's two tier calls at 1024 rows)
    and the keyed cyclic kernel's (fb2 at 1024 rows), each build alone
    on the first block by CUDA events in CUDA graphs, in turns with the
    full build, its SASS a sample step and whether it changed the output
    (tools/mega_ablate.py's function form); the environment route once
    (one_bucket under SKRED_MEGA_ABLATE=phase4, in a subprocess); the op
    census of stress64 and noise64 on the card at 1024 rows and on the
    CPU at 8 (in a subprocess, beside the builds and the timing: it
    counts and times nothing); the fma probe."""
    from skred_tpu_torch.engine.kernels import build
    from skred_tpu_torch.tools import fma_probe, mega_ablate, op_census

    secs = {}
    start = t0 = time.time()
    bad = [lab for lab, key in path_keys.items()
           if any("ABLATE" in d for d in key)]
    if bad:
        fail(f"ablate: main-path keys with an ablation define: {bad}")
    census_scripts = ("stress64.sk", "noise64.sk")
    cpu_census = subprocess.Popen(
        [sys.executable, "-c",
         "import json, torch\n"
         "torch.set_num_threads(1)\n"
         "from skred_tpu_torch.tools import op_census as oc\n"
         f"print(json.dumps({{s: oc.census(s, {CENSUS_CPU_ROWS}, 'cpu')\n"
         f"                  for s in {census_scripts!r}}}))\n"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    packs = {s: mega_ablate.ablation_calls(s, 0.05, dev, ROWS)
             for s in ("stress64.sk", "fb2.sk")}
    items = [k for p in packs.values() for k in mega_ablate.build_keys(p)]
    probe_keys = [("fma_probe", k) for k in fma_probe.KEYS.values()]
    made = build.build_all(items + probe_keys)
    log(f"ablate: {len(made)} builds ({len(items)} keys of the two "
        f"kernels with their full keys, the probe's 2) in "
        f"{max(made.values(), default=0.0):.1f} s")
    secs["keys and builds"] = time.time() - t0
    t0 = time.time()
    # the environment route, beside the card's census (which counts, and
    # times nothing); its keys are stress64's phase4 builds, made above
    env = dict(os.environ, SKRED_MEGA_ABLATE="phase4")
    route = subprocess.Popen(
        [sys.executable, "-m", "skred_tpu_torch.tools.one_bucket",
         "stress64.sk", str(ENV_ROUTE_SECONDS)], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cards = {}
    for script in census_scripts:
        cards[script] = rec = op_census.census(script, ROWS, dev)
        op_census.print_census(rec, 10)
        if not rec["kernel_launches_per_block"] \
                or rec["plain_ops_per_block"]:
            fail(f"op census {script}: no kernel launch, or plain "
                 f"versions on the card")
    out, err = _wait(route, "the environment route")
    lines = [ln for ln in out.splitlines() if ln.strip()]
    log(f"ablate env route (SKRED_MEGA_ABLATE=phase4 one_bucket stress64.sk "
        f"{ENV_ROUTE_SECONDS}): exit {route.returncode}; "
        + " | ".join(lines))
    if route.returncode != 0 or not lines or any(
            not ln.startswith("ABLATED SKRED_MEGA_ABLATE=phase4 ")
            for ln in lines):
        fail(f"ablate: the environment route: {err[-400:]}")
    secs["card census and env route"] = time.time() - t0
    t0 = time.time()
    for script, packed in packs.items():
        recs = mega_ablate.time_calls(packed)
        for r in recs:
            log(f"ablate {script} {mega_ablate.row_line(r)} on {card}")
            if not r["built"]:
                continue
            if r.get("mix_launches") is not None and \
                    r["mix_launches"] != (0 if "mix" in r["ablate"] else 1):
                fail(f"ablate {script}: {r['config']} launched the mix "
                     f"kernel {r['mix_launches']} times")
            # mix alone is a skipped launch, checked by its count above:
            # its accumulators show it only where the tier's voices are
            # mixed (stress64's tier-0 modulators carry weight 0)
            if r["ablate"] in ("", "mix"):
                continue
            if not r["changed"]:
                fail(f"ablate {script}: the {r['config']} stub changed "
                     f"nothing on call {r['call']}")
            if not r["sass"] < r["sass_full"]:
                fail(f"ablate {script}: the {r['config']} stub left "
                     f"{r['sass']} SASS a sample step of {r['sass_full']}")
        # no stub removes another's instructions: the skeleton's phases
        # stubbed one at a time remove no more SASS together than the
        # skeleton does, but for the compiler's own scheduling
        for call in sorted({r["call"] for r in recs}):
            (skel,) = [r for r in recs if r["call"] == call
                       and r["config"].startswith("skeleton")]
            parts = set(skel["ablate"].split(","))
            one = [r for r in recs if r["call"] == call and r["built"]
                   and r["ablate"] in parts]
            singles = sum(r["sass_full"] - r["sass"] for r in one)
            whole = skel["sass_full"] - skel["sass"]
            log(f"ablate {script} call {call}: the single stubs of the "
                f"skeleton's phases remove {singles:.2f} SASS a sample "
                f"step and {sum(r['delta_ms'] for r in one):.4f} ms "
                f"together, the skeleton {whole:.2f} and "
                f"{skel['delta_ms']:.4f} ms")
            if singles > whole * (1 + SASS_OVERLAP):
                fail(f"ablate {script} call {call}: the single stubs remove "
                     f"{singles:.2f} SASS, more than the skeleton's "
                     f"{whole:.2f} by over {SASS_OVERLAP:.0%}: two stubs "
                     f"take the same instructions")
    secs["kernel rows"] = time.time() - t0
    t0 = time.time()
    out, err = _wait(cpu_census, "the CPU census")
    if cpu_census.returncode != 0:
        fail(f"ablate: the CPU census: {err[-400:]}")
    cpus = json.loads(out.splitlines()[-1])
    for script in census_scripts:
        cpu, rec = cpus[script], cards[script]
        log(f"op census {script}: the CPU's glue at {CENSUS_CPU_ROWS} rows "
            f"{cpu['glue_ops_per_block']:.1f} aten ops a block "
            f"({cpu['views_per_block']:.1f} views, "
            f"{cpu['plain_ops_per_block']:.1f} in the plain versions), the "
            f"card's at {ROWS} {rec['glue_ops_per_block']:.1f} "
            f"({rec['views_per_block']:.1f} views); kernel launches a "
            f"block {rec['per_block'][0]['launches']}")
        if not cpu["plain_ops_per_block"] or cpu["kernel_launches_per_block"]:
            fail(f"op census {script}: the CPU's plain versions not apart")
    rec = fma_probe.probe(dev)
    port, fmad = rec["builds"]["port flags"], rec["builds"]["-fmad=true"]
    if port["verdict"] != "NOT-CONTRACTED" or fmad["verdict"] != \
            "CONTRACTED" or not port["fused_equals_fma32"]:
        fail(f"ablate: fma probe {rec['builds']}")
    secs["CPU census wait and fma probe"] = time.time() - t0
    log("ablate: seconds " + ", ".join(f"{k} {v:.2f}" for k, v in
                                       secs.items())
        + f"; {time.time() - start:.2f} in all")


def _wait(proc, what, timeout=600):
    """(stdout, stderr) of ``proc`` once it ends; killed and a failure
    after ``timeout`` seconds."""
    try:
        return proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"ablate: {what} did not end in {timeout} s")


BENCH_SECONDS = NOISE64_SECONDS    # 344 whole blocks: 2 chunks of 172


def bench_phase(card, counters):
    """bench_torch.main on the card at 4 s: its seven buckets (stress64
    and noise64 at fill_bucket's 2048 rows, fb1-fb5 at 1024), each with
    the launches its render path needs in its two timed passes and not
    the general cyclic variant's.  Returns the launches summed over the
    buckets' timed passes."""
    import bench_torch

    want_scripts = [STRESS64.name, NOISE64.name] + [p.name for p in FEEDBACK]
    try:
        res = bench_torch.main(seconds=BENCH_SECONDS)
    except SystemExit as ex:
        fail(f"bench: bench_torch.main exited with {ex.code}")
    log(f"bench: {res['value']}x realtime over {len(res['buckets'])} "
        f"buckets, "
        f"slowest bucket {res['slowest_bucket_x_rt']}x, "
        f"{res['total_audio_s']} s of audio in {res['total_wall_s']} s "
        f"(best of 2 timed passes a bucket), on {res['card']['name']}, "
        f"power limit {res['card']['power_limit']}")
    found = [s for b in res["buckets"] for s in b["scripts"]]
    if sorted(found) != sorted(want_scripts) or len(res["buckets"]) != 7 \
            or res.get("partial"):
        fail(f"bench: buckets {[b['scripts'] for b in res['buckets']]}, "
             f"not one for each of {want_scripts}")
    totals = {}
    for b in res["buckets"]:
        roof = b["roofline"]
        log(f"bench bucket {','.join(b['scripts'])}: {b['rows']} rows x "
            f"{b['blocks']} blocks, x_rt {b['x_rt']}, wall_spread "
            f"{b['wall_spread']} s, setup_s {b['setup_s']} s, roofline "
            f"{roof['bound']} ({roof['pct_hbm_peak']}% of the memory rate, "
            f"{roof['pct_f32_peak']}% of the f32 rate, bound "
            f"{roof['bound_ms_per_block']:.4f} ms a block), launches "
            f"{b['launches']}, compiler {b['compiler']}, checksums "
            f"{b['checksums']}, on {card}")
        if len(set(b["checksums"])) != 1:
            fail(f"bench: checksums differ between passes: {b}")
        if set(b["compiler"].values()) != {"native"}:
            fail(f"bench: not compiled by the native compiler: {b}")
        name, per_pass = b["scripts"][0], 2 * b["blocks"]
        if name == STRESS64.name:
            want = {"tier": 2 * per_pass, "tier_keyed": 2 * per_pass,
                    "volume": per_pass}
        elif name == NOISE64.name:
            want = {k: 2 * per_pass for k in ("phase_walk_warp", "lookup",
                                              "filt_smooth_noise")}
            want["volume"] = per_pass
        else:
            want = {"cyclic": per_pass, "cyclic_fixed": per_pass}
        if b["launches"] != want:
            fail(f"bench: {name}'s timed passes launched {b['launches']}, "
                 f"not {want}")
        for nm, c in b["launches"].items():
            totals[nm] = totals.get(nm, 0) + c
    if totals.get("cyclic_general"):
        fail(f"bench: the general cyclic variant was launched: {totals}")
    return {nm: totals.get(nm, 0) for nm in counters}


def main():
    from skred_tpu_torch.tools import card as card_tool

    # an ablated build renders invalid audio by design: every check and
    # number below would be void
    card_tool.refuse_ablated("chip_smoke", fail=lambda msg, code: fail(msg))
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "card")
    import bench_torch
    from skred_tpu_torch.engine import cyclic, fused
    from skred_tpu_torch.engine.kernels import build
    from skred_tpu_torch.engine.kernels import cyclic as ck
    from skred_tpu_torch.engine.kernels import filt_smooth as fs
    from skred_tpu_torch.engine.kernels import lookup as lk
    from skred_tpu_torch.engine.kernels import phase_walk as pw
    from skred_tpu_torch.engine.kernels import tier as tk
    from skred_tpu_torch.engine.kernels import volume as vk

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    peaks = roofline.peaks_for(kind)
    if peaks is None:
        fail(f"no published peaks for {kind} in "
             f"skred_tpu_torch/parallel/roofline.py: the bounds would be "
             f"guesses")

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    card = f"{kind} ({smi})"

    # ---- 2. build ----
    phase("build")
    t0 = time.time()
    keys = cyclic_keys()
    tkeys = tier_keys()
    nkeys = noise_keys()
    ckeys = compat_keys()
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu")
                     if p.stem not in build.KEY_ONLY)
    skeys = slice_builds()
    secs = build.build_all(sources + [("cyclic", key)
                                      for key in keys.values()]
                           + [("tier", key) for key in tkeys.values()]
                           + list(nkeys.values()) + skeys
                           + [("compat", key) for key in ckeys.values()])
    from skred_tpu_torch.host import native

    t1 = time.time()
    lib_path = native.build_library()
    log(f"build: the native host compiler {lib_path.name} in "
        f"{time.time() - t1:.1f} s (g++)")
    log(f"build: {len(secs)} build(s) ({len(sources)} sources, "
        f"{len(set(keys.values()))} keys of the cyclic kernel, "
        f"{len(set(tkeys.values()))} of the tier kernel, "
        f"{len(set(nkeys.values()))} of the keyed noise kernels, "
        f"{len(set(ckeys.values()))} of the compat kernel, "
        f"{len(skeys)} keys of the repair, mesh and cli phases) in "
        f"{time.time() - t0:.1f} s")
    uses = {}
    for name, labelled in (("cyclic", keys), ("tier", tkeys),
                           ("compat", ckeys)):
        for label, key in labelled.items():
            uses.setdefault((name, key), []).append(label)
    for label, (name, key) in nkeys.items():
        uses.setdefault((name, key), []).append(label)
    for name, key in [(src, ()) for src in sources] + list(uses):
        lab = build.label(name, key)
        what = f" ({', '.join(uses[name, key])})" if key else ""
        sec = f"{secs[lab]:.1f} s" if lab in secs else "built before"
        log(f"  {lab}{what}: {sec}")
        for line in build.report(name, key).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")
                # the cyclic kernel is a latency-bound serial recurrence:
                # a small stack frame there is printed, not held against it
                if name != "cyclic" and "spill" in line and not \
                        line.strip().startswith("0 bytes stack frame, 0 "
                                                "bytes spill stores, 0 "
                                                "bytes spill loads"):
                    fail(f"{name}.cu spills under {lab}: {line}")
    build.load("lookup")
    for key in ckeys.values():
        build.load("compat", key)
    build.load("cyclic", (), "cyclic_general_launch")
    for key in keys.values():
        build.load("cyclic", key, "cyclic_fixed_launch")
    for key in tkeys.values():
        build.load("tier", key, "tier_keyed_launch")
    for name, key in nkeys.values():
        build.load(name, key, f"{name}_keyed_launch")

    specs = {s["name"]: s for s in (
        tier_spec(tk, peaks), lookup_spec(lk, peaks),
        phase_walk_warp_spec(pw, peaks), filt_smooth_noise_spec(fs, peaks),
        cyclic_spec(ck, peaks))}
    noise_kernels = ["phase_walk_warp", "lookup", "filt_smooth_noise"]
    counters = bench_torch.launch_counters()

    # ---- 3. kernel vs plain on random blocks ----
    phase("kernel")
    errs = {}
    lib = kernel_phase(dev, specs, errs)
    v_time = volume_turn(dev, card, peaks, errs)

    # ---- 4./5. stress64: the tier kernel's path ----
    phase("main, config, short")
    s_launch, s_time, s_lines, s_calls = main_path(
        "main", STRESS64, dev, card, specs, ["tier"], counters, errs,
        also=("tier_keyed",))
    s_turns = tier_turns("main", s_calls, specs["tier"], dev, card, errs)
    cfg_time = config_compare(dev, card, specs, errs)
    for cfg, tm in cfg_time.items():
        log(f"config {cfg}: tier kernel " + ", ".join(
            f"{t['ms']:.4f} ms/call at M={m} (bound {t['bound_ms']:.4f} ms)"
            for (_, m), t in sorted(tm.items())) + f" on {card}")
    short_path("short", short_batch(s_lines), dev, fused,
               fused.render_fused, {"tier": tk.tier_plain,
                                    "volume": vk.volume_plain},
               unfolded=True)
    st4 = short_batch(UNION_CYCLE)
    if st4.tiers is not None or not st4.fused_passes >= 2 \
            or not 0 < st4.n_src < st4.params["amp"].shape[-1]:
        fail(f"repeat-passes short: tiers {st4.tiers}, passes "
             f"{st4.fused_passes}, n_src {st4.n_src}: not the layout")
    for fn in counters.values():
        fn.launches = 0
    short_path(f"repeat-passes short ({st4.fused_passes} passes, source "
               f"prefix {st4.n_src} of {st4.params['amp'].shape[-1]} "
               f"voices)", st4, dev, fused, fused.render_fused,
               {"tier": tk.tier_plain, "volume": vk.volume_plain},
               unfolded=True)
    # a block launches the estimate passes and the final pass; the kernel
    # path and the two renders with mix and fold off launch, the
    # plain-version path and the CPU render do not
    want = 3 * 4 * st4.fused_passes
    if tk.tier.launches != want:
        fail(f"repeat-passes short: tier.launches {tk.tier.launches} != "
             f"{want}")

    # ---- 6./7. noise64: the noise pass's path ----
    phase("noise main, noise short")
    n_launch, n_time, n_lines, n_calls = main_path(
        "noise main", NOISE64, dev, card, specs, noise_kernels, counters,
        errs, seconds=NOISE64_SECONDS)
    _, st = prepare(NOISE64, NOISE64_SECONDS)
    caught = capture_noise(st, dev)
    noise_rest(caught, card)
    n_turns = noise_turns(caught, specs, dev, card, errs)
    del caught, st
    short_path("noise short", short_batch(n_lines), dev, fused,
               fused.render_fused,
               {"phase_walk_warp": pw.phase_walk_warp_plain,
                "lookup": lk.lookup_plain,
                "filt_smooth_noise": fs.filt_smooth_noise_plain,
                "volume": vk.volume_plain})
    tl_time = table_lookup_timing(lk, lib, card, peaks)
    lookup_turns(n_calls, lib, dev, card, errs, peaks)

    # ---- 8./9. fb1-fb5: the cyclic kernel's path ----
    phase("cyclic main, cyclic short")
    c_launch, c_time = cyclic_main(dev, card, specs["cyclic"], counters,
                                   errs)
    fb2, fb4 = (p.read_text().splitlines() for p in (FEEDBACK[1],
                                                     FEEDBACK[3]))
    short_path("cyclic short fb2", short_batch(fb2, cyclic=True), dev,
               cyclic, cyclic.render_cyclic,
               {"cyclic_block": ck.cyclic_block_plain})
    fb4_fast = [ln.replace("~.5", "~.012") for ln in fb4]
    st4 = short_batch(fb4_fast, cyclic=True)
    if st4.params["amp"].shape[1] < 3:
        fail("cyclic short fb4: fewer than 3 segments in 4 blocks")
    short_path("cyclic short fb4 (waits cut to 0.012 s, "
               f"{st4.params['amp'].shape[1]} segments)", st4, dev, cyclic,
               cyclic.render_cyclic, {"cyclic_block": ck.cyclic_block_plain})

    # ---- 10. the compat engine ----
    phase("compat")
    compat_rec = compat_phase(dev, card, peaks, counters, errs, ckeys, secs)

    # ---- 11. every in-repo script through render_batch ----
    phase("batch")
    batch = batch_phase(dev, card, counters)

    # ---- 12.-14. the feedback engines' fast mode, a mesh, the CLI ----
    phase("repair")
    repair_phase(dev, card, counters)
    phase("mesh")
    mesh_phase(dev, card, counters, batch)
    phase("cli")
    cli_phase(dev, card, counters)

    # ---- 15. the root tools ----
    phase("tools")
    tools_phase(dev, card, counters)

    # ---- 16. the ablation switches, the op census, the fma probe ----
    phase("ablate")
    ablate_phase(dev, card, {f"tier {lab}": key for lab, key in tkeys.items()}
                 | {f"cyclic {lab}": key for lab, key in keys.items()})

    # ---- 17. the port's bench ----
    phase("bench")
    b_launch = bench_phase(card, counters)

    def record(name, launches, timings, replaces, source):
        m = max(mm for (nm, mm) in timings if nm == name)
        return dict(name=name, route="cuda",
                    source=f"skred_tpu_torch/engine/kernels/csrc/{source}.cu",
                    replaces=replaces, launches=launches,
                    max_abs_err=errs.get(name, 0.0), **timings[name, m])

    # the tier kernel, timed in two turns on the main path's tier-1
    # inputs (its widest call); launches from the main path's timed pass
    wide = max(s_turns)
    tn = s_turns[wide]
    tier_rec = dict(name="tier", route="cuda",
                    source="skred_tpu_torch/engine/kernels/csrc/tier.cu",
                    replaces="skred_tpu/engine/kernels.py:1999",
                    launches=s_launch["tier_keyed"],
                    max_abs_err=errs.get("tier", 0.0), ms=tn["mean"],
                    plain_ms=s_time["tier", wide]["plain_ms"],
                    bound_ms=tn["bound_ms"], bound_by=tn["bound_by"],
                    library_ms=None)

    # the noise kernels on the noise main path's tier-1 inputs, timed in
    # two turns (their mean); launches from the main path's timed pass
    nwide = max(n_turns)

    def noise_record(name, launches, wrapper):
        tn = n_turns[nwide]
        ms = tn["times"][name]
        return dict(name=name, route="cuda",
                    source=f"skred_tpu_torch/engine/kernels/csrc/{name}.cu",
                    replaces="skred_tpu/engine/kernels.py:"
                    + ("311" if name == "phase_walk" else "522"),
                    launches=launches, library_ms=None,
                    max_abs_err=errs.get(name, 0.0), ms=sum(ms) / len(ms),
                    plain_ms=n_time[wrapper, nwide]["plain_ms"],
                    bound_ms=tn["floors"][name]["bound_ms"],
                    bound_by=tn["floors"][name]["bound_by"])

    kernels = [
        tier_rec,
        noise_record("phase_walk", n_launch["phase_walk_warp"],
                     "phase_walk_warp"),
        record("lookup", n_launch["lookup"], n_time,
               "skred_tpu/engine/kernels.py:780", "lookup"),
        noise_record("filt_smooth", n_launch["filt_smooth_noise"],
                     "filt_smooth_noise"),
        dict(name="table_lookup", route="cuda",
             source="skred_tpu_torch/engine/kernels/csrc/lookup.cu",
             replaces="skred_tpu/engine/kernels.py:648",
             launches=n_launch["table_lookup"],
             max_abs_err=errs.get("table_lookup", 0.0), **tl_time),
        # the keyed variant: fb2's timed pass (each of fb1-fb5 showed one
        # launch per block) and fb2's first-block inputs at 1024 rows
        dict(name="cyclic", route="cuda",
             source="skred_tpu_torch/engine/kernels/csrc/cyclic.cu",
             replaces="skred_tpu/engine/cyclic.py:544",
             launches=c_launch["fb2"]["cyclic_fixed"],
             max_abs_err=errs.get("cyclic", 0.0),
             **c_time["fb2", ROWS, "fixed"]),
        # the general variant: the 16-voice ring's timed pass, and the same
        # fb2 inputs, timed in turns with the keyed variant
        dict(name="cyclic_general", route="cuda",
             source="skred_tpu_torch/engine/kernels/csrc/cyclic.cu",
             replaces="skred_tpu/engine/cyclic.py:544",
             launches=c_launch["ring16"]["cyclic_general"],
             max_abs_err=errs.get("cyclic_general", 0.0),
             **c_time["fb2", ROWS, "general"]),
        # not a TPU kernel: the compat engine's two lax.scans; stress64 10 s
        # at 1024 rows (ms a block), with its 1-row figures beside
        compat_rec,
        # not a TPU kernel: the fused block step's associative scan;
        # launches from stress64's timed pass, times at 1024 rows x 512
        dict(name="volume", route="cuda",
             source="skred_tpu_torch/engine/kernels/csrc/volume.cu",
             replaces="skred_tpu/engine/fused.py:167",
             launches=s_launch["volume"],
             max_abs_err=errs.get("volume", 0.0), **v_time),
    ]
    # the bench's launches: each bucket's two timed passes, summed; the
    # JSON's name of each record -> the wrapper whose count it reads
    bench_counter = {"tier": "tier_keyed", "phase_walk": "phase_walk_warp",
                     "filt_smooth": "filt_smooth_noise",
                     "cyclic": "cyclic_fixed"}
    for rec in kernels:
        rec["bench_launches"] = b_launch[bench_counter.get(rec["name"],
                                                           rec["name"])]
    phase("done")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))


if __name__ == "__main__":
    main()
