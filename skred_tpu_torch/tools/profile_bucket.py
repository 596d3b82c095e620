"""Time one fused bucket with pieces of the engine toggled, to locate its
bottleneck.

    python -m skred_tpu_torch.tools.profile_bucket [vp] [passes] [rows]
        [seconds] [--device D]

The counterpart of ``tools/profile_bucket.py``.  It selects the bucket
by (packed voices, fixed-point passes) over the in-repo scripts
(``corpus/*.sk`` and ``skred_tpu_torch/scripts/*.sk``, where the
original read the reference's corpus), stacks every such script
replicated to at least ``rows`` rows, and times
``render_fused_stream_device`` (a warm pass of one chunk, then one timed
pass with ``torch.cuda.synchronize()`` around it) in four rows: exact,
fast (``exact=False``), ``mix=False`` (the voice sum in torch: the
counterpart of the JAX package's ``SKRED_MEGA_MIX=0``, fused.py:902) and
``mix=False, fold=False`` (the modulator reads in torch too).  The
original's ``use_pallas=False`` rows have no counterpart: the port has
no non-kernel branch on the card (ROADMAP section 1, "left out by
design"), only the plain versions on the CPU.  Audio is credited per
whole 172-block chunk (a render shorter than one chunk streams as one
chunk of its blocks).  Defaults: 64 voices, 2 passes (stress64 and
noise64), 1024 rows, 10 s.  On the card unless ``--device cpu``; without
a card it prints an error line and exits 2.
"""

from __future__ import annotations

import argparse
import sys
import time

from skred_tpu_torch.tools.card import ablated_tag, card_info, require, sync

CHUNK = 172
ROWS = [("full (exact)", {}), ("exact=False", {"exact": False}),
        ("mix=False", {"mix": False}),
        ("mix=False fold=False", {"mix": False, "fold": False})]


def profile_bucket(vp: int = 64, passes: int = 2, rows: int = 1024,
                   seconds: float = 10.0, device="cuda") -> dict:
    """Time the rows; returns {label: (wall, x_rt)} (None: no script in
    the bucket)."""
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.engine.fused import render_fused_stream_device
    from skred_tpu_torch.parallel.batch import (pack_stacked,
                                                pad_segments_pow2,
                                                stack_timelines)
    from skred_tpu_torch.parallel.buckets import SCRIPTS, compile_one

    bank = WaveBank()
    group, names = [], []
    for p in SCRIPTS:
        tl, _ = compile_one(p, seconds, bank)
        if tl.fused_passes is None:
            continue
        st1 = pack_stacked(stack_timelines([tl]))
        if st1.params["amp"].shape[-1] == vp and tl.fused_passes == passes:
            group.append(tl)
            names.append(p.name)
    if not group:
        print("no scripts in this bucket")
        return None
    print(f"bucket ({vp},{passes}): {names}")
    group = group * -(-rows // len(group))
    st = pad_segments_pow2(pack_stacked(stack_timelines(group)))
    print(f"batch={st.batch} n_src={st.n_src} segs={st.params['amp'].shape[1]}"
          f" tables={st.table_buffer.size} tiers={st.tiers}")
    chunk = min(CHUNK, st.num_blocks)
    audio = st.batch * (st.num_blocks // chunk) * chunk * st.block / 44100.0
    card = card_info(device)
    tag = ablated_tag()
    out = {}
    for label, kw in ROWS:
        render_fused_stream_device(st, chunk, warmup_only=True,
                                   device=device, **kw)
        sync(device)
        t0 = time.perf_counter()
        render_fused_stream_device(st, chunk, device=device, **kw)
        sync(device)
        wall = time.perf_counter() - t0
        out[label] = (wall, audio / wall)
        print(f"{tag + ' ' if tag else ''}{label:30s} wall={wall:7.3f}s  "
              f"x_rt={audio / wall:8.1f}  on {card['name']} (power limit "
              f"{card['power_limit']})", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_bucket", description=(
        "Time one fused bucket with pieces of the engine toggled."))
    ap.add_argument("vp", nargs="?", type=int, default=64)
    ap.add_argument("passes", nargs="?", type=int, default=2)
    ap.add_argument("rows", nargs="?", type=int, default=1024)
    ap.add_argument("seconds", nargs="?", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    require(a.device, "profile_bucket")
    profile_bucket(a.vp, a.passes, a.rows, a.seconds, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
