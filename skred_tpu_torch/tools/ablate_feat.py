"""Cost attribution for one bench bucket by feature: time the bucket with
single feature flags cleared.

    python -m skred_tpu_torch.tools.ablate_feat [script] [rows] [seconds]
        [--device D]

The counterpart of ``tools/ablate_feat.py``.  It replaces the port's
``engine/fused.compute_feat`` with one that returns the script's feature
set with one flag cleared (it serves the per-tier calls too, as the
original's does), so that ``fused.plan`` routes and the tier kernel
builds a key without that stage: each cleared flag is a new key build
(made before the timed passes, in the render's ``_prepare``).  Per flag
of ``fm, cz, am, pm, env, flt, sm, hold, quant, noise, finish, disc``
that the script has: a warm pass, then the best of two streamed passes
(``render_fused_stream_device``, ``torch.cuda.synchronize()`` around
each), and the share of the baseline's wall the stage costs; then the
``passes=1`` variant (the fixed-point passes' cost).  The renders are
throwaway (the semantics change: timing only).  The real
``compute_feat`` is restored in a ``finally``, as in the original.
Audio is credited per whole 172-block chunk (a render shorter than one
chunk streams as one chunk of its blocks).  Defaults: stress64.sk (the
original's 20.sk is in the reference corpus), 512 rows, 10 s.  On the
card unless ``--device cpu``; without a card it prints an error line and
exits 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from skred_tpu_torch.tools.card import ablated_tag, card_info, require, sync

CHUNK = 172
FLAGS = ("fm", "cz", "am", "pm", "env", "flt", "sm", "hold", "quant",
         "noise", "finish", "disc")


def ablate_feat(script="stress64.sk", rows: int = 512,
                seconds: float = 10.0, device="cuda") -> dict:
    """Time the baseline, each flag cleared and ``passes=1``; returns
    {label: best wall}."""
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.engine import fused as F
    from skred_tpu_torch.parallel.batch import (pack_stacked,
                                                pad_segments_pow2,
                                                stack_timelines)
    from skred_tpu_torch.parallel.buckets import compile_one
    from skred_tpu_torch.tools.card_parity import script_path

    path = script_path(script)
    tl, _ = compile_one(path, seconds, WaveBank())
    st = pad_segments_pow2(pack_stacked(stack_timelines([tl] * rows)))
    feat0 = F.compute_feat(st)
    on = ",".join(k for k, v in feat0._asdict().items() if v is True)
    card = card_info(device)
    tag = ablated_tag()
    tag = tag + " " if tag else ""
    print(f"{tag}{path.name}: vp={st.params['amp'].shape[-1]} "
          f"passes={st.fused_passes} n_src={st.n_src} {on} on "
          f"{card['name']} (power limit {card['power_limit']})", flush=True)
    chunk = min(CHUNK, st.num_blocks)
    audio = st.batch * (st.num_blocks // chunk) * chunk * st.block / 44100.0
    walls = {}
    real = F.compute_feat

    def run(label, feat, stx):
        # the override serves the per-tier calls (lanes=) too
        F.compute_feat = lambda _st, lanes=None: feat
        F.render_fused_stream_device(stx, chunk, warmup_only=True,
                                     device=device)
        best = float("inf")
        for _ in range(2):
            sync(device)
            t0 = time.perf_counter()
            F.render_fused_stream_device(stx, chunk, device=device)
            sync(device)
            best = min(best, time.perf_counter() - t0)
        walls[label] = best
        print(f"{tag}{label:24s} wall={best:7.3f}s  x_rt={audio / best:8.1f}",
              flush=True)
        return best

    try:
        base = run("baseline", feat0, st)
        for flag in FLAGS:
            if getattr(feat0, flag):
                w = run(f"-{flag}", feat0._replace(**{flag: False}), st)
                print(f"{tag}    {flag} costs "
                      f"~{(base - w) / base * 100:5.1f}%", flush=True)
        if st.fused_passes and st.fused_passes > 1:
            w = run("passes=1", feat0,
                    dataclasses.replace(st, fused_passes=1))
            print(f"{tag}    extra passes cost ~"
                  f"{(base - w) / base * 100:.1f}%", flush=True)
    finally:
        F.compute_feat = real
    return walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ablate_feat", description=(
        "Time one bench bucket with single feature flags cleared."))
    ap.add_argument("script", nargs="?", default="stress64.sk")
    ap.add_argument("rows", nargs="?", type=int, default=512)
    ap.add_argument("seconds", nargs="?", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    require(a.device, "ablate_feat")
    ablate_feat(a.script, a.rows, a.seconds, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
