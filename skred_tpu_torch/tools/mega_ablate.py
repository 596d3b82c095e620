"""Attribute a bucket's keyed-kernel time to the kernel's phases.

    python -m skred_tpu_torch.tools.mega_ablate [script] [seconds]
        [exact|fast] [--rows R] [--device D]

The counterpart of ``tools/mega_ablate.py``.  As the original, it runs
``one_bucket`` (here ``python -m skred_tpu_torch.tools.one_bucket``) in a
subprocess per configuration with the ablation variable set, and prints
each run's wall: ``CONFIGS`` (the original's: full, each phase of the
tier megakernel alone, the skeleton) with ``SKRED_MEGA_ABLATE`` for a
fused bucket, ``CYC_CONFIGS`` with ``SKRED_CYC_ABLATE`` for a cyclic one
(the JAX cyclic kernel's vocabulary: reads, lookup, cz, dsp, pan, all).
An ablated render is invalid: only its wall means something.

What the port adds: beside each wall, the keyed kernel's own time a call
on one captured block of the bucket (its first), by CUDA events around
20 calls in a CUDA graph, the full build and the ablated one in turns
(full, ablated, ablated, full), for each of the block's calls (each tier
of a fused bucket); the delta against full; whether the stub changed the
call's output; and the SASS instructions of the fast pass's sample step
(a frame for the cyclic kernel) of each build.  That part runs in this
process through the key functions' ``ablate`` argument, not the variables
(``kernel_rows``, the function form chip_smoke.py calls).  The host clock
cannot resolve a phase (``tools/gluebench.py``: a bucket's passes spread
0.6-1.3 ms a block, more than any kernel's share); the device clock on
one call can.  A phase the call's key does not compile in (``gain``
without an envelope or an am stream, ``mix`` without the in-kernel mix;
``tier.tier_phases``, ``cyclic.cyclic_phases``) is not built: its row
says so.  ``mix`` is a launch that is skipped, not code: its row counts
the mix kernel's launches (the tier library's own count, where it
launches it) instead of SASS.

Card only: the stubs exist only in the keyed kernels (the plain versions
refuse a nonempty set).  Without a card, or with ``--device cpu``, it
prints an error line and exits 2.  Writes ``build/mega_ablate_torch.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

import torch

from skred_tpu_torch.tools.card import card_info, require

ROOT = pathlib.Path(__file__).resolve().parents[2]
RECORD = ROOT / "build" / "mega_ablate_torch.json"
REPS = 20

CONFIGS = [
    ("full", ""),
    ("no phase1 (serial walk)", "phase1"),
    ("no phase2 (cz/index)", "phase2"),
    ("no lookup (table DMA)", "lookup"),
    ("no gain (env precompute)", "gain"),
    ("no phase4 (serial filter)", "phase4"),
    ("no mix (stereo acc)", "mix"),
    ("skeleton (all stubbed)", "phase1,phase2,lookup,gain,phase4,mix"),
]
# the cyclic kernel's: each phase alone, the whole voice body, and the
# skeleton of the five phases (the walk, the frame loop and the volume
# smoother left)
CYC_CONFIGS = [
    ("full", ""),
    ("no reads (fm read)", "reads"),
    ("no lookup (table load)", "lookup"),
    ("no cz (warp)", "cz"),
    ("no dsp (hold..smoother)", "dsp"),
    ("no pan (per-sample pan)", "pan"),
    ("no voice body", "all"),
    ("skeleton (all stubbed)", "reads,lookup,cz,dsp,pan"),
]
VARIABLE = {"fused": "SKRED_MEGA_ABLATE", "cyclic": "SKRED_CYC_ABLATE"}


def bucket(script, seconds: float, rows=None):
    """The script's bench bucket (``parallel/buckets.make_buckets`` at 4
    replicas), cut to ``rows``."""
    from skred_tpu_torch.parallel.buckets import make_buckets
    from skred_tpu_torch.tools.card_parity import script_path

    (bk,) = make_buckets([script_path(script)], seconds, 4, rows)
    if bk.kind == "compat":
        raise SystemExit(f"mega_ablate: the cyclic kernel's gate refuses "
                         f"{script}: no keyed kernel renders it")
    return bk


def configs_for(kind) -> list:
    return CONFIGS if kind == "fused" else CYC_CONFIGS


def walls(script, seconds, mode="exact", device="cuda", kind="fused"):
    """``one_bucket`` under each configuration, in a subprocess with the
    ablation variable set; {label: its last x_rt line, or its error}."""
    out = {}
    for label, ablate in configs_for(kind):
        env = dict(os.environ, **{VARIABLE[kind]: ablate})
        r = subprocess.run(
            [sys.executable, "-m", "skred_tpu_torch.tools.one_bucket",
             str(script), str(seconds), mode, "--device", str(device)],
            env=env, capture_output=True, text=True, cwd=ROOT)
        line = [ln for ln in r.stdout.splitlines() if "x_rt" in ln]
        out[label] = line[-1] if line else r.stderr[-200:]
        print(f"{label:28s} {out[label]}", flush=True)
    return out


def capture(bk, device, exact=True) -> list:
    """The keyed kernel's calls in the bucket's first block, each with
    inputs of its own: [(args, kwargs)].  A tier call's fold bank and
    accumulators are copies (its output is a fresh tensor), so that a
    stubbed call cannot change another's inputs; a mixed call without
    accumulators adds onto zeros, so that ``mix``'s skipped launch shows
    in them."""
    from skred_tpu_torch.engine import cyclic, fused
    from skred_tpu_torch.engine.kernels.tier import Fold

    mod, name = (fused, "tier") if bk.kind == "fused" \
        else (cyclic, "cyclic_block")
    if bk.kind == "fused":
        _, r, carry = fused._prepare(bk.st, exact, device)
    else:
        _, r, carry = cyclic._prep(bk.st, exact, device)
    real = getattr(mod, name)
    calls = []

    def grab(*a, **kw):
        out = real(*a, **kw)
        kw = dict(kw)
        if name == "tier":
            f = kw.get("fold")
            if f:
                kw["fold"] = Fold(f.bank.clone(), f.prev.clone(), f.w,
                                  f.streams)
            kw["out"] = None
            if kw.get("mixw") is not None:
                n, b = kw["n"], kw["b"]
                kw["acc"] = tuple(
                    torch.zeros((n, b), device=a[0].device) if x is None
                    else x.clone() for x in (kw.get("acc") or (None, None)))
        calls.append((tuple(x.clone() if isinstance(x, torch.Tensor) else x
                            for x in a), kw))
        return out

    setattr(mod, name, grab)
    try:
        with torch.no_grad():
            mod._block_step(r, carry, 0)
    finally:
        setattr(mod, name, real)
    torch.cuda.synchronize()
    return calls


def graph(fn, reps: int = REPS):
    """``reps`` calls of ``fn`` captured in one CUDA graph, after a
    warm-up call, replayed once."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return g


def replay_ms(g, reps: int = REPS) -> float:
    """Mean device ms a call of one replay of ``g`` (``reps`` calls),
    by CUDA events around it."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def mix_launches(key, fn) -> int:
    """Launches of ``tier_mix_kernel`` in one call of ``fn``, counted by
    the keyed tier library built under ``key`` where it launches it."""
    import ctypes

    from skred_tpu_torch.engine.kernels import build

    count = build.load("tier", key, "tier_keyed_launch").tier_mix_launch_count
    count.argtypes, count.restype = [], ctypes.c_longlong
    torch.cuda.synchronize()
    before = count()
    fn()
    torch.cuda.synchronize()
    return count() - before


class _Call:
    """One captured call packed under a build key: its launch (which
    counts no launch) and its output tensors."""

    def __init__(self, kind, a, kw, ablate, dev, label):
        from skred_tpu_torch.engine.kernels import cuda_call
        from skred_tpu_torch.engine.kernels import cyclic as ck
        from skred_tpu_torch.engine.kernels import tier as tk

        if kind == "fused":
            fl = tk._flags(kw["feat"])
            mix = kw.get("mixw") is not None
            folded = tk._folded(fl, kw.get("fold"))
            self.phases = tk.tier_phases(kw["feat"], mix)
            self.key = tk.tier_key(kw["feat"], kw.get("exact", True), mix,
                                   folded, ablate & set(self.phases))
            acc = kw.get("acc")
            kw = dict(kw, acc=None if acc is None
                      else tuple(x.clone() for x in acc))
            # a mixed call adds onto its accumulators in place: the
            # comparison call starts again from these
            self.acc0 = () if acc is None else (kw["acc"],
                                                tuple(x.clone()
                                                      for x in acc))
            args, out, outs = tk._pack_args(
                *a, feat=kw["feat"], exact=kw.get("exact", True), n=kw["n"],
                b=kw.get("b"), mixw=kw.get("mixw"), acc=kw["acc"],
                fold=kw.get("fold"), out=None)
            self.outs = [out] + [outs[k] for k in sorted(outs)]
            self.lanes = out.shape[1]
            self.src, self.entry = "tier", "tier_keyed_launch"
            self.kernel, self.samples, self.first = "tier_keyed_kernel", \
                None, None
        else:
            feat, k = a[7], a[8]
            exact = a[10] if len(a) > 10 else True
            self.phases = ck.cyclic_phases(feat)
            self.key = ck.fixed_key(feat, k, exact,
                                    ablate & set(self.phases))
            args, out_l, out_r, ns = ck._pack_args(*a)
            self.outs = [out_l, out_r] + [ns[k2] for k2 in sorted(ns)]
            self.lanes = out_l.shape[0]
            self.acc0 = ()
            self.src, self.entry = "cyclic", "cyclic_fixed_launch"
            self.kernel, self.samples, self.first = "cyclic_fixed_kernel", \
                1, 1
        # the struct holds raw pointers: keep the tensors alive (a CUDA
        # graph's capture empties the allocator's cache of freed blocks)
        self.inputs = (a, kw)
        self.label = label
        self.ablate = ablate & set(self.phases)
        self.built = not ablate or bool(self.ablate)
        self.go = lambda: cuda_call.launch(self.src, args, dev, self.key,
                                           self.entry)

    def fresh(self):
        """The call's outputs as they were before its first launch (the
        accumulators it adds onto)."""
        for now, then in zip(*self.acc0):
            now.copy_(then)
        return self

    def chunk(self) -> int:
        """Samples a pass of the build's sample loop takes: the keyed
        tier kernel's chunk (from its library), a frame for the cyclic
        kernel."""
        if self.samples is not None:
            return self.samples
        import ctypes

        from skred_tpu_torch.engine.kernels import build

        fn = build.load("tier", self.key,
                        "tier_keyed_launch").tier_chunk_samples
        fn.argtypes, fn.restype = [], ctypes.c_int
        return fn()

    def sass(self, samples) -> dict:
        from skred_tpu_torch.engine.kernels import build
        from skred_tpu_torch.tools.sass_locals import sass_loop

        return sass_loop(build._target(self.src, self.key), self.kernel,
                         samples, first=self.first)


def _differs(xs, ys) -> bool:
    """Any output not bit-equal (two NaNs agree)."""
    for x, y in zip(xs, ys):
        if x is None:
            continue
        same = (x.view(torch.int32) == y.view(torch.int32)) \
            | (torch.isnan(x) & torch.isnan(y)) if x.dtype == torch.float32 \
            else x == y
        if not bool(same.all()):
            return True
    return False


def ablation_calls(script="stress64.sk", seconds: float = 0.05,
                   device="cuda", rows=None, exact=True) -> dict:
    """The bucket's first-block keyed-kernel calls, each packed under the
    build of each configuration of its kind: {(label, call index):
    _Call}.  Builds nothing but the full keys (``build_keys`` lists the
    rest)."""
    from skred_tpu_torch.engine.kernels.cuda_call import ablate_set
    from skred_tpu_torch.engine.kernels.cyclic import CYC_PHASES
    from skred_tpu_torch.engine.kernels.tier import MEGA_PHASES

    dev = torch.device(device)
    bk = bucket(script, seconds, rows)
    vocab = MEGA_PHASES if bk.kind == "fused" else CYC_PHASES
    cfgs = [(lab, ablate_set(ab, vocab, VARIABLE[bk.kind]))
            for lab, ab in configs_for(bk.kind)]
    calls = capture(bk, dev, exact)
    return {(lab, i): _Call(bk.kind, a, kw, abl, dev, lab)
            for lab, abl in cfgs for i, (a, kw) in enumerate(calls)}


def build_keys(packed: dict) -> list:
    """The builds ``packed``'s configurations need: (source, key)."""
    return list(dict.fromkeys((c.src, c.key) for c in packed.values()
                              if c.built))


def time_calls(packed: dict, reps: int = REPS) -> list:
    """Each packed call alone, under each configuration: a record a
    (configuration, call).  The builds must exist (``build_keys``).
    Each build's calls are captured once in a CUDA graph, and the full
    build's graph and the ablated one replay in turns (full, ablated,
    ablated, full); the SASS counts are read in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from skred_tpu_torch.engine.kernels import build

    built = {c.key: c for c in packed.values() if c.built}
    samples = {k: c.chunk() for k, c in built.items()}
    with ThreadPoolExecutor(8) as ex:
        sass = dict(zip(built, ex.map(lambda k: built[k].sass(samples[k]),
                                      built)))
    out = []
    for i in sorted({i for _, i in packed}):
        full = packed["full", i]
        full.fresh().go()
        torch.cuda.synchronize()
        want = [None if x is None else x.clone() for x in full.outs]
        g_full = graph(full.go, reps)
        for (lab, j), c in packed.items():
            if j != i:
                continue
            rec = {"config": lab, "ablate": ",".join(sorted(c.ablate)),
                   "call": i, "lanes": c.lanes, "built": c.built,
                   "phases_in_key": list(c.phases)}
            if not c.built:
                out.append(rec)
                continue
            g = g_full if c is full else graph(c.go, reps)
            times = {"full": [], "ablated": []}
            for which in ("full", "ablated", "ablated", "full"):
                times[which].append(replay_ms(
                    g_full if which == "full" else g, reps))
            c.fresh().go()
            torch.cuda.synchronize()
            mean = {w: sum(ts) / len(ts) for w, ts in times.items()}
            rec.update(
                ms=mean["ablated"], full_ms=mean["full"],
                delta_ms=mean["full"] - mean["ablated"], times=times,
                sass=sass[c.key]["per_sample"],
                sass_full=sass[full.key]["per_sample"],
                sass_loop=sass[c.key]["loop"],
                build=build.label(c.src, c.key),
                changed=_differs(c.outs, want) if c.ablate else False)
            if c.src == "tier" and "mix" in c.phases \
                    and (not c.ablate or "mix" in c.ablate):
                rec["mix_launches"] = mix_launches(c.key, c.go)
            out.append(rec)
    return out


def kernel_rows(script="stress64.sk", seconds: float = 0.05,
                device="cuda", rows=None, exact=True,
                reps: int = REPS) -> list:
    """The keyed kernel alone on the bucket's first block under each
    configuration: ``ablation_calls``, every build in one parallel
    ``build_all``, then ``time_calls``."""
    from skred_tpu_torch.engine.kernels import build

    packed = ablation_calls(script, seconds, device, rows, exact)
    build.build_all(build_keys(packed))
    return time_calls(packed, reps)


def row_line(rec) -> str:
    """One printed line of a ``kernel_rows`` record."""
    head = f"{rec['config']:28s} call {rec['call']} M={rec['lanes']}:"
    if not rec["built"]:
        return f"{head} not in this key (its phases: " \
               f"{', '.join(rec['phases_in_key'])})"
    mix = f", mix kernel launches {rec['mix_launches']}" \
        if "mix_launches" in rec else ""
    return (f"{head} kernel {rec['ms']:.4f} ms/call (full "
            f"{rec['full_ms']:.4f}, delta {rec['delta_ms']:+.4f}), SASS "
            f"{rec['sass']:.2f} a sample step (full {rec['sass_full']:.2f})"
            f", output {'changed' if rec['changed'] else 'unchanged'}{mix}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mega_ablate", description=(
        "Attribute a bucket's keyed-kernel time to its phases."))
    ap.add_argument("script", nargs="?", default="stress64.sk")
    ap.add_argument("seconds", nargs="?", type=float, default=10.0)
    ap.add_argument("mode", nargs="?", default="exact",
                    choices=("exact", "fast"))
    ap.add_argument("--rows", type=int, default=None,
                    help="cut the bucket's rows for the kernel rows")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if torch.device(a.device).type != "cuda":
        print("mega_ablate: the stubs exist only in the keyed CUDA "
              "kernels: it runs on the card", file=sys.stderr, flush=True)
        return 2
    require(a.device, "mega_ablate")
    kind = bucket(a.script, 0.05).kind
    card = card_info(a.device)
    print(f"walls (one_bucket, {VARIABLE[kind]}) on {card['name']}, power "
          f"limit {card['power_limit']}:", flush=True)
    rec = {"script": a.script, "seconds": a.seconds, "mode": a.mode,
           "card": card,
           "walls": walls(a.script, a.seconds, a.mode, a.device, kind)}
    print("the keyed kernel alone on the bucket's first block (CUDA events "
          f"in CUDA graphs, {REPS} calls, in turns with full):", flush=True)
    rows = kernel_rows(a.script, a.seconds, a.device, a.rows,
                       a.mode == "exact")
    for r in rows:
        print(row_line(r), flush=True)
    rec["kernel_rows"] = rows
    RECORD.parent.mkdir(parents=True, exist_ok=True)
    RECORD.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
