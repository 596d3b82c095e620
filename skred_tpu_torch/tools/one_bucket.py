"""Time one script's bench bucket alone, in each arithmetic mode.

    python -m skred_tpu_torch.tools.one_bucket [script] [seconds]
        [exact,fast] [--device D]

The counterpart of ``tools/one_bucket.py``.  Defaults: stress64.sk,
10 s, exact.  The bucket is built as ``bench_torch.py`` builds it
(``parallel/buckets.make_buckets`` at 4 replicas): a fused bucket, or a
cyclic one at ``CYCLIC_ROWS`` rows.  Per mode: one warm pass of one
chunk, which builds the kernels ("build"), then the best of two streamed
passes over the whole chunks, with ``torch.cuda.synchronize()`` before
each clock read.  Prints the batch, the tiers, the build seconds, the
wall and x realtime (audio credited per whole 172-block chunk, as the
bench credits it), with the card's name and power limit.  Exits 2
without a card (unless ``--device cpu``).  Under a nonempty timing-ablation
set (``SKRED_MEGA_ABLATE``, ``SKRED_CYC_ABLATE``; ``tools/mega_ablate.py``
drives it so) the keyed kernels build with those phases stubbed, and
every line it prints starts with ``ABLATED <set>``: the render is
invalid, only its wall means something.
"""

from __future__ import annotations

import argparse
import sys
import time

from skred_tpu_torch.tools.card import (ablated_tag, card_info, require,
                                        sync)

CHUNK = 172                      # bench_torch.py's chunk


def one_bucket(script="stress64.sk", seconds: float = 10.0,
               modes=("exact",), device="cuda", replicas: int = 4,
               max_rows=None) -> list:
    """Time ``script``'s bucket in each mode; returns a record a mode.
    ``max_rows`` cuts the bucket's rows (tests)."""
    from skred_tpu_torch.engine import cyclic, fused
    from skred_tpu_torch.parallel.buckets import make_buckets
    from skred_tpu_torch.tools.card_parity import script_path

    (bk,) = make_buckets([script_path(script)], seconds, replicas, max_rows)
    if bk.kind == "compat":
        raise SystemExit(f"one_bucket: the cyclic kernel's gate refuses "
                         f"{script}: the compat engine renders it")
    st = bk.st
    whole = st.num_blocks // CHUNK
    if whole == 0:
        raise SystemExit(f"one_bucket: {seconds} s is shorter than one "
                         f"{CHUNK}-block chunk")
    audio = st.batch * whole * CHUNK * st.block / 44100.0
    card = card_info(device)
    tag = ablated_tag()
    tag = tag + " " if tag else ""
    out = []
    for mode in modes:
        if mode not in ("exact", "fast"):
            raise SystemExit(f"one_bucket: no mode {mode!r}")
        if bk.kind == "fused":
            run = lambda warm, ex=(None if mode == "exact" else False): \
                fused.render_fused_stream_device(
                    st, CHUNK, exact=ex, warmup_only=warm, device=device)
        else:
            run = lambda warm, ex=(mode == "exact"): \
                cyclic.render_cyclic_stream_device(
                    st, CHUNK, exact=ex, warmup_only=warm, device=device)
        sync(device)
        t0 = time.perf_counter()
        run(True)
        sync(device)
        build_s = time.perf_counter() - t0
        wall = float("inf")
        for _ in range(2):
            sync(device)
            t0 = time.perf_counter()
            run(False)
            sync(device)
            wall = min(wall, time.perf_counter() - t0)
        rec = {"script": bk.scripts[0], "mode": mode, "kind": bk.kind,
               "batch": st.batch, "tiers": list(st.tiers or ()),
               "blocks": whole * CHUNK, "build_s": build_s, "wall_s": wall,
               "x_rt": audio / wall, "card": card, "ablated": tag.strip()}
        print(f"{tag}{rec['script']} {mode}: {bk.kind} batch {st.batch} tiers "
              f"{rec['tiers']} build {build_s:.3f} s wall {wall:.4f} s "
              f"x_rt {rec['x_rt']:.1f} on {card['name']} (power limit "
              f"{card['power_limit']})", flush=True)
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="one_bucket", description=(
        "Time one script's bench bucket alone."))
    ap.add_argument("script", nargs="?", default="stress64.sk")
    ap.add_argument("seconds", nargs="?", type=float, default=10.0)
    ap.add_argument("modes", nargs="?", default="exact",
                    help="comma-separated: exact, fast")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    require(a.device, "one_bucket")
    one_bucket(a.script, a.seconds, a.modes.split(","), a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
