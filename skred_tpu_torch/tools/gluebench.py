"""Attribute a fused bucket's wall a block to its kernels and to the
torch glue around them.

    python -m skred_tpu_torch.tools.gluebench [script,...] [seconds]
        [--device D]

The counterpart of ``tools/gluebench.py``.  Defaults: stress64.sk and
noise64.sk, 10 s, the card.  For each script its bench bucket
(``parallel/buckets.make_buckets``, 4 replicas) renders through
``render_fused_stream_device`` once with the real kernels, once with
each kernel its path launches swapped for a stub, and once with all of
them stubbed: a warm pass of one chunk (the builds), then each run's
timed passes over the whole chunks, with ``torch.cuda.synchronize()``
before each clock read, the runs in turns for ``PASSES`` rounds and
each taking its best pass (one pass a run read the host's noise: on an
H100 the stubbed runs of noise64 came out up to 1 ms a block slower
than the full one); a build inside a timed pass is an error.  A
kernel's share is the full run less its stubbed run; the glue is the
all-stubbed residue.  A stub also skips its wrapper's host work (the
argument packing and the launch), which the share counts as the
kernel's.  The stubs swap the names ``engine/fused.py``
imported (``tier``, ``phase_walk_warp``, ``lookup``,
``filt_smooth_noise``) and the real ones are put back afterwards, also
when a run raises; nothing in the engine gains a switch for it.

The JAX tool's run with its megakernel off has no counterpart: the port
routes a noise tier to its three kernels by the render's plan, and
noise64 is that path.

Prints ms a block for each run and the attribution; writes the record
to ``build/gluebench_torch.json``.  Exits 2 without a card (unless
``--device cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

import torch

from skred_tpu_torch.tools.card import card_info, require, sync

ROOT = pathlib.Path(__file__).resolve().parents[2]
RECORD = ROOT / "build" / "gluebench_torch.json"
CHUNK = 172                      # bench_torch.py's chunk
KERNELS = ("tier", "phase_walk_warp", "lookup", "filt_smooth_noise")
PASSES = 3                       # timed rounds; the best pass of each run
F32, I32 = torch.float32, torch.int32


class Stubs:
    """Shape- and dtype-preserving no-ops for the fused path's kernels:
    each takes its kernel's arguments and returns its outputs and end
    states, taken from its inputs (end states are the start states; a
    tier's or a walk's alive count is the block) or from zero tensors
    made once a shape, which no caller writes."""

    def __init__(self):
        self._const = {}

    def const(self, shape, dtype, device, value=0):
        key = (tuple(shape), dtype, str(device), value)
        if key not in self._const:
            self._const[key] = torch.full(shape, value, dtype=dtype,
                                          device=device)
        return self._const[key]

    def tier(self, table, cbase, inc, dm, amod, vecs, states, *, feat,
             exact=True, n, b=None, mixw=None, acc=None, fold=None,
             out=None):
        m, dev = vecs["amp"].shape[0], vecs["amp"].device
        if out is None:
            out = self.const((n, m), F32, dev)
        res = dict(states, cnt=self.const((m,), I32, dev, n))
        if mixw is not None:
            res["out_last"] = out[n - 1]
            res["acc_l"], res["acc_r"] = acc if acc is not None else (
                torch.zeros((n, b), dtype=F32, device=dev),
                torch.zeros((n, b), dtype=F32, device=dev))
        return out, res

    def phase_walk_warp(self, bank, vecs, phase0, fin0, *, feat, n, b):
        m, dev = phase0.shape[0], phase0.device
        return (self.const((n, m), I32, dev),
                self.const((m,), I32, dev, n), phase0,
                fin0 if feat[1] else None)

    def lookup(self, table, base, limit, idx):
        return self.const(idx.shape, F32, idx.device)

    def filt_smooth_noise(self, f, noise_blk, cnt, cbase, bank, vecs,
                          states, *, feat, b, out=None):
        if out is None:
            out = self.const(f.shape, F32, f.device)
        return out, dict(states)


@contextlib.contextmanager
def stubbed(names, stubs: Stubs):
    """``engine/fused.py``'s kernel names in ``names`` swapped for the
    stubs; the real ones are back on exit, also when the body raises."""
    from skred_tpu_torch.engine import fused

    real = {nm: getattr(fused, nm) for nm in KERNELS}
    try:
        for nm in names:
            setattr(fused, nm, getattr(stubs, nm))
        yield
    finally:
        for nm, fn in real.items():
            setattr(fused, nm, fn)


def path_kernels(st) -> list:
    """The kernels a fused bucket's blocks launch, by the render's
    plan: the tier kernel for a tier without noise voices, the three
    noise kernels for a tier with one."""
    from skred_tpu_torch.engine import fused

    _, pl = fused._packed(st)
    noise = [pl.tier_feat(ti).noise for ti in range(len(pl.tiers))]
    return (["tier"] if not all(noise) else []) \
        + (["phase_walk_warp", "lookup", "filt_smooth_noise"]
           if any(noise) else [])


def time_runs(st, device, passes: int = PASSES, stubs=None) -> tuple:
    """(runs, blocks): ``{label: [wall s of each pass]}`` of the full
    run, each path kernel stubbed and all stubbed (the one run where the
    path has one kernel), over the whole chunks of ``st``.  After a warm
    pass, the runs are timed in turns: each of ``passes`` rounds times
    every one once, in the plan's order and then reversed, so that a
    change in the host's speed falls on all of them alike."""
    from skred_tpu_torch.engine import fused
    from skred_tpu_torch.engine.kernels import build

    stubs = Stubs() if stubs is None else stubs
    whole = st.num_blocks // CHUNK
    if whole == 0:
        raise SystemExit(f"gluebench: shorter than one {CHUNK}-block chunk")
    kernels = path_kernels(st)
    plan = [("full", [])] + [(f"{k} stubbed", [k]) for k in kernels]
    if len(kernels) > 1:
        plan.append(("all stubbed", kernels))
    # the full run builds every kernel; a stub builds nothing
    fused.render_fused_stream_device(st, CHUNK, warmup_only=True,
                                     device=device)
    built = dict(build.LOG)
    runs = {label: [] for label, _ in plan}
    for p in range(passes):
        for label, names in plan if p % 2 == 0 else plan[::-1]:
            with stubbed(names, stubs):
                sync(device)
                t0 = time.perf_counter()
                fused.render_fused_stream_device(st, CHUNK, device=device)
                sync(device)
                runs[label].append(time.perf_counter() - t0)
    new = sorted(k for k in build.LOG if build.LOG[k] is not built.get(k))
    if new:
        raise RuntimeError(f"gluebench: a timed pass built {new}")
    runs.setdefault("all stubbed", runs[plan[-1][0]])   # one kernel
    return runs, whole * CHUNK


def gluebench(scripts=("stress64.sk", "noise64.sk"), seconds: float = 10.0,
              device="cuda", replicas: int = 4, max_rows=None,
              record=None, passes: int = PASSES) -> dict:
    """Time and attribute each script's bucket, each run by its best of
    ``passes`` timed passes; print, write the record to ``record``
    (default ``RECORD``) and return it.  ``max_rows`` cuts the buckets'
    rows (tests)."""
    from skred_tpu_torch.parallel.buckets import make_buckets
    from skred_tpu_torch.tools.card_parity import script_path

    card = card_info(device)
    out = {"seconds": seconds, "replicas": replicas, "passes": passes,
           "card": card, "scripts": {}}
    for script in scripts:
        (bk,) = make_buckets([script_path(script)], seconds, replicas,
                             max_rows)
        if bk.kind != "fused":
            print(f"{script}: a {bk.kind} bucket; gluebench times the "
                  f"fused path", flush=True)
            continue
        walls, blocks = time_runs(bk.st, device, passes)
        runs = {k: min(w) for k, w in walls.items()}
        ms = {k: 1e3 * w / blocks for k, w in runs.items()}
        share = {k.removesuffix(" stubbed"): ms["full"] - v
                 for k, v in ms.items() if k not in ("full", "all stubbed")}
        print(f"{bk.scripts[0]}: batch {bk.st.batch} tiers "
              f"{list(bk.st.tiers or ())} blocks {blocks} on {card['name']} "
              f"(power limit {card['power_limit']})", flush=True)
        for k, w in runs.items():
            print(f"  {k:28s} {w:8.3f} s  {ms[k]:8.4f} ms/block  (passes "
                  + ", ".join(f"{x:.3f}" for x in walls[k]) + " s)",
                  flush=True)
        print(f"  attribution, ms a block: "
              + "  ".join(f"{k} {v:.4f}" for k, v in share.items())
              + f"  glue {ms['all stubbed']:.4f}", flush=True)
        out["scripts"][bk.scripts[0]] = {
            "batch": bk.st.batch, "tiers": list(bk.st.tiers or ()),
            "blocks": blocks, "wall_s": runs, "pass_walls_s": walls,
            "ms_per_block": ms,
            "kernel_ms_per_block": share,
            "glue_ms_per_block": ms["all stubbed"]}
    path = pathlib.Path(RECORD if record is None else record)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gluebench", description=(
        "Attribute a fused bucket's wall to its kernels and its glue."))
    ap.add_argument("scripts", nargs="?", default="stress64.sk,noise64.sk",
                    help="comma-separated")
    ap.add_argument("seconds", nargs="?", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    require(a.device, "gluebench")
    gluebench(a.scripts.split(","), a.seconds, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
