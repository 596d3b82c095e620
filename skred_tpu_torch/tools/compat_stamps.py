"""Clock cycles per stage of the compat kernel's sample step, on the card.

    python -m skred_tpu_torch.tools.compat_stamps [script ...] [--rows R,R]
        [--blocks N]

Builds ``csrc/compat.cu`` under each script's key with ``COMPAT_STAMP=1``
added (the measurement build: each warp reads ``%clock`` at the end of
every stage of a sample step and sums the cycles since its last stamp; a
stamp first waits for the stage's last result) and renders each script
(default stress64, noise64, fb2) at each row count (default 1 and 1024):
block 0 through the unstamped build, to warm the caches, then ``N``
blocks (default 4) through the stamped build from that carry.  For each
stage it prints the cycles a sample step as the median and the maximum
over the warps, and their sum; beside them the same blocks' ms a block
through the unstamped and the stamped build (CUDA events), which says
what the stamps themselves cost, and the SM clock (``nvidia-smi``).

The stages (``kernels/compat.py`` ``STAMPS``): the noise sample's load,
the barrier after the previous samples' store, then for the
non-committing passes (``r_``, summed when there are several) and the
committing one (``c_``): the modulator reads, the phase wrap, the CZ
warp, the table load, hold / quantizer / biquad, the envelope, the
smoother and pan; the barrier after each estimate store; ``store``,
the voices' stereo pairs into the sum's history (and the capture);
``reduce``, the voice sums of 32 samples and their ``out`` store, every
32nd sample.  A stamp serialises what the scheduler would overlap,
so a stage's cycles are its latency on the chain as stamped, not what it
adds to an unstamped step.  A warp that skips a stage (a voice no one
reads) records the cycles of its branch.

Card only: without one it prints an error line and exits 2.  One JSON
line per (script, rows) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from skred_tpu_torch.tools.card import card_info, require

ROOT = pathlib.Path(__file__).resolve().parents[2]
SCRIPTS = (ROOT / "corpus" / "stress64.sk",
           ROOT / "skred_tpu_torch" / "scripts" / "noise64.sk",
           ROOT / "corpus" / "fb2.sk")


def sm_mhz() -> float:
    """The SM clock nvidia-smi reads now, in MHz (0 where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.CalledProcessError, ValueError, IndexError):
        return 0.0


def _events_ms(fn, reps: int = 2) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stamp_cycles(path, rows: int, device="cuda", blocks: int = 4) -> dict:
    """The stamped build's cycles a sample step per stage for ``path``
    stacked to ``rows`` rows, over blocks 1..``blocks`` from the carry
    after block 0 (see the module docstring)."""
    from skred_tpu_torch.assets import WaveBank
    from skred_tpu_torch.engine import render as cr
    from skred_tpu_torch.engine.kernels import compat as K
    from skred_tpu_torch.host.timeline import compile_script, noise_stream
    from skred_tpu_torch.parallel.batch import stack_timelines

    path = pathlib.Path(path)
    n = 512
    tl = compile_script(path.read_text().splitlines(),
                        (1 + blocks) * n / 44100.0 + 1e-4, bank=WaveBank(),
                        script_dir=path.parent)
    dev = torch.device(device)
    inp = cr.stacked_inputs(stack_timelines([tl] * rows), dev)
    passes = tl.mod_passes
    nz = torch.as_tensor(noise_stream((1 + blocks) * n), device=dev)
    key = K.compat_key(inp, passes, False)
    with torch.no_grad():
        carry = K._launch(inp, K.zero_carry(rows, dev), nz[:n], 0, 1,
                          passes, True, False)[0]
        buf = K.stamp_buffer(inp)
        mhz0 = sm_mhz()
        ms = _events_ms(lambda: K._launch(inp, carry, nz[n:], 1, blocks,
                                          passes, True, False)) / blocks
        ms_st = _events_ms(lambda: K._launch(
            inp, carry, nz[n:], 1, blocks, passes, True, False,
            stamps=buf)) / blocks
        mhz1 = sm_mhz()
    steps = blocks * n
    cyc = buf.cpu().numpy().view(np.uint32).astype(np.float64).reshape(
        -1, len(K.STAMPS)) / steps
    total = cyc.sum(axis=1)
    stages = {nm: dict(median=float(np.median(cyc[:, j])),
                       max=float(cyc[:, j].max()))
              for j, nm in enumerate(K.STAMPS)}
    return dict(script=path.name, rows=rows, passes=passes, blocks=blocks,
                key=list(key),
                warps=int(cyc.shape[0]), stages=stages,
                total=dict(median=float(np.median(total)),
                           max=float(total.max())),
                ms_block=ms, ms_block_stamped=ms_st,
                mhz=[mhz0, mhz1])


def build_keys(scripts) -> dict:
    """Build every key the scripts launch, stamped and not, in one
    parallel ``build_all``; returns its seconds."""
    from skred_tpu_torch.assets import WaveBank
    from skred_tpu_torch.engine import render as cr
    from skred_tpu_torch.engine.kernels import build
    from skred_tpu_torch.engine.kernels import compat as K
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import stack_timelines

    items = []
    for path in scripts:
        path = pathlib.Path(path)
        tl = compile_script(path.read_text().splitlines(), 0.05,
                            bank=WaveBank(), script_dir=path.parent)
        inp = cr.stacked_inputs(stack_timelines([tl]), "cpu")
        items += [("compat", K.compat_key(inp, tl.mod_passes, False, stamp))
                  for stamp in (False, True)]
    return build.build_all(items)


def table(rec: dict) -> str:
    """The record as lines: stage, median, max."""
    lines = [f"{rec['script']} {rec['rows']} row(s), {rec['passes']} "
             f"passes, {rec['warps']} warps: cycles a sample step "
             f"(median / max over the warps); ms a block "
             f"{rec['ms_block']:.4f} unstamped, {rec['ms_block_stamped']:.4f}"
             f" stamped; SM clock {rec['mhz']} MHz"]
    for nm, v in rec["stages"].items():
        lines.append(f"  {nm:9s} {v['median']:9.1f} {v['max']:9.1f}")
    t = rec["total"]
    lines.append(f"  {'sum':9s} {t['median']:9.1f} {t['max']:9.1f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="compat_stamps")
    ap.add_argument("scripts", nargs="*", default=[str(p) for p in SCRIPTS])
    ap.add_argument("--rows", default="1,1024")
    ap.add_argument("--blocks", type=int, default=4)
    args = ap.parse_args(argv)
    require("cuda", "compat_stamps")
    card = card_info("cuda")
    build_keys(args.scripts)
    for path, rows in [(path, int(rows)) for path in args.scripts
                       for rows in args.rows.split(",")]:
        rec = stamp_cycles(path, rows, "cuda", args.blocks)
        rec["card"] = card
        print(table(rec), flush=True)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
