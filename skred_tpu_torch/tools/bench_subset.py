"""Time only the bench buckets a predicate selects: the fast iteration
loop for work on the heaviest buckets.

    python -m skred_tpu_torch.tools.bench_subset [seconds] [replicas]
        [--all] [--fast] [--rows R] [--chunk C] [--device D]

The counterpart of ``tools/bench_subset.py``.  It selects fused buckets
by a predicate over (packed voices, passes, feature set), by default the
original's (its docstring's "passes == 2, filter on, vp >= 7"; its code
tests the last two only, which selects the same in-repo buckets),
``--all`` every fused bucket, and times them through ``bench_torch.py``'s
own bucket timing (``bench_torch.main(select=...)``: the same buckets,
warm pass, checks and best of two timed passes), not a copy of it.  Its
detail goes to ``build/bench_subset_torch.json``, not the bench's file.
Prints the original's line a bucket (voices, passes, feat, rows,
scripts, tiers, compile_s as the bench's set-up seconds, wall_s, x_rt,
roofline) and the subset's total.  ``--rows`` cuts every bucket's rows
and ``--chunk`` the chunk (short runs on the CPU).  On the card unless
``--device cpu``; without a card, or under a timing-ablation switch, the
bench prints its error line and exits 2.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
RECORD = ROOT / "build" / "bench_subset_torch.json"


def slow(bk) -> bool:
    """The original's default predicate: the heavy class (two passes,
    the filter on, 7 or more packed voices)."""
    feat = bk.feat.split(",") if bk.feat else []
    return bk.passes == 2 and "flt" in feat and bk.voices >= 7


def bench_subset(seconds: float = 10.0, replicas: int = 4, every=False,
                 fast=False, device="cuda", max_rows=None,
                 chunk=None) -> dict:
    """Time the selected buckets; returns the bench's detail record."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import bench_torch

    pred = (lambda bk: bk.kind == "fused") if every \
        else (lambda bk: bk.kind == "fused" and slow(bk))
    rec = bench_torch.main(seconds=seconds, replicas=replicas, fast=fast,
                           chunk=chunk or bench_torch.CHUNK, device=device,
                           max_rows=max_rows, select=pred,
                           detail_file=RECORD)
    audio = wall = 0.0
    for b in rec["buckets"]:
        print(json.dumps({"voices": b["voices"], "passes": b["passes"],
                          "feat": b["feat"], "rows": b["rows"],
                          "scripts": b["scripts"],
                          "compile_s": b["setup_s"], "wall_s": b["wall_s"],
                          "x_rt": b["x_rt"], "roofline": b["roofline"]}),
              flush=True)
        audio += b["x_rt"] * b["wall_s"]
        wall += b["wall_s"]
    if wall:
        print(f"# subset total: {audio / wall:.1f} x_rt ({wall:.2f}s wall)"
              f" on {rec['card']['name']}, power limit "
              f"{rec['card']['power_limit']}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_subset", description=(
        "Time only the bench buckets a predicate selects."))
    ap.add_argument("seconds", nargs="?", type=float, default=10.0)
    ap.add_argument("replicas", nargs="?", type=int, default=4)
    ap.add_argument("--all", action="store_true", dest="every")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    bench_subset(a.seconds, a.replicas, a.every, a.fast, a.device, a.rows,
                 a.chunk)
    return 0


if __name__ == "__main__":
    sys.exit(main())
