"""Endurance: a long streamed render on the card, held to the compat
engine at three windows, with its throughput, host memory and device
memory recorded.

    python -m skred_tpu_torch.tools.endurance oracle [script] [seconds]
        [--window W] [--device D]
    python -m skred_tpu_torch.tools.endurance run [script] [seconds]
        [--rows R] [--window W] [--device D]

The counterpart of ``tools/endurance.py``.  Defaults: corpus/stress64.sk,
300 s, 1024 rows, a 44,100-sample window, the card.

``oracle`` renders the script at one row with the compat engine in exact
mode (``engine/render.render_chunks``, one kernel call a 172-block
chunk) and keeps only the windows at the start, the middle and the end,
so its memory is a chunk's; it saves them with the script, length and
window to ``build/endurance_oracle_torch.npz``.

``run`` renders ``rows`` copies of the script through
``render_fused_stream(chunk_blocks=172, keep_rows=1)``, cuts the same
windows from row 0, and after every chunk samples the host's max RSS and
``torch.cuda.memory_allocated()``; ``torch.cuda.max_memory_allocated()``
gives the peak.  The device memory compared is after the first chunk
and after the last chunk of full length: a shorter final chunk holds a
smaller output.  It refuses an oracle minted for another script, length
or window, writes ``build/endurance_torch.json`` (``ENDURANCE.json``'s
keys, the device memory and the card's name and power limit) and exits
1 when the worst window is above -60 dB, 2 without a card (unless
``--device cpu``) or under a timing-ablation switch.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import resource
import sys
import time

import numpy as np
import torch

from skred_tpu_torch.tools.card import (card_info, refuse_ablated, require,
                                        sync)

ROOT = pathlib.Path(__file__).resolve().parents[2]
ORACLE = ROOT / "build" / "endurance_oracle_torch.npz"
RECORD = ROOT / "build" / "endurance_torch.json"
CHUNK = 172
WIN = 44100                      # the window: 1 s
TARGET_DB = -60.0


class Windows:
    """The start, middle and end windows of a render fed to it chunk by
    chunk; only the windows are kept."""

    def __init__(self, total: int, win: int):
        self.offsets = {"start": 0, "mid": total // 2, "end": total - win}
        self.win, self.got = win, 0
        self.parts = {k: [] for k in self.offsets}

    def feed(self, chunk) -> None:
        """``chunk``: [T, 2], a numpy array or a tensor on any device."""
        n = chunk.shape[0]
        for k, o in self.offsets.items():
            lo, hi = max(o, self.got), min(o + self.win, self.got + n)
            if lo < hi:
                part = chunk[lo - self.got:hi - self.got]
                self.parts[k].append(part.cpu().numpy()
                                     if isinstance(part, torch.Tensor)
                                     else part)
        self.got += n

    def result(self) -> dict:
        return {k: np.concatenate(v, axis=0) for k, v in self.parts.items()}


def timeline(script, seconds: float):
    """The script compiled as the bench compiles it."""
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.parallel.buckets import compile_one
    from skred_tpu_torch.tools.card_parity import script_path

    return compile_one(script_path(script), seconds, WaveBank())[0]


def oracle(script="stress64.sk", seconds: float = 300.0, win: int = WIN,
           device="cuda", path=None) -> dict:
    """The compat engine's windows of the script at one row, saved to
    ``path`` (default ``ORACLE``); returns them."""
    from skred_tpu_torch.engine.render import render_chunks, stacked_inputs

    refuse_ablated("endurance")
    from skred_tpu_torch.host.timeline import noise_stream
    from skred_tpu_torch.parallel.batch import stack_timelines

    tl = timeline(script, seconds)
    total = tl.num_blocks * tl.block
    inp = stacked_inputs(stack_timelines([tl]), device)
    noise = torch.as_tensor(noise_stream(total), device=device)
    wins = Windows(total, win)
    t0 = time.perf_counter()
    with torch.no_grad():
        for out, _ in render_chunks(inp, tl.mod_passes, noise, True, False,
                                    CHUNK):
            wins.feed(out[0])
    sync(device)
    wall = time.perf_counter() - t0
    got = wins.result()
    path = pathlib.Path(ORACLE if path is None else path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, script=pathlib.Path(script).name, seconds=seconds,
             window=win, total=total, **got)
    card = card_info(device)
    print(f"oracle: {pathlib.Path(script).name} {seconds} s at 1 row, "
          f"compat engine (exact) {wall:.3f} s ({total / 44100 / wall:.1f}x "
          f"realtime) on {card['name']} (power limit {card['power_limit']})"
          f" -> {path}", flush=True)
    return got


def run(script="stress64.sk", seconds: float = 300.0, rows: int = 1024,
        win: int = WIN, device="cuda", oracle_path=None,
        record=None) -> dict:
    """The streamed render at ``rows`` rows against the oracle's
    windows; writes the record to ``record`` (default ``RECORD``) and
    returns it."""
    from skred_tpu_torch.engine.fused import render_fused_stream
    from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines

    refuse_ablated("endurance")
    name = pathlib.Path(script).name
    g = np.load(ORACLE if oracle_path is None else oracle_path)
    minted = (str(g["script"]), float(g["seconds"]), int(g["window"]))
    if minted != (name, float(seconds), int(win)):
        raise SystemExit(f"endurance: the oracle was minted for {minted}, "
                         f"not {(name, float(seconds), int(win))}; run "
                         f"'oracle' first")
    tl = timeline(script, seconds)
    st = pack_stacked(stack_timelines([tl] * rows))
    total = st.num_blocks * st.block
    wins = Windows(total, win)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    rss, mem, sizes = [], [], []
    t0 = time.perf_counter()
    t_first = None
    for chunk in render_fused_stream(st, chunk_blocks=CHUNK, keep_rows=1,
                                     device=device):
        if t_first is None:
            t_first = time.perf_counter() - t0      # the kernels' builds
        wins.feed(chunk[0])
        sizes.append(chunk.shape[1])
        rss.append(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
        mem.append(torch.cuda.memory_allocated() if on_card else None)
    sync(device)
    wall = time.perf_counter() - t0
    audio_s = rows * wins.got / 44100.0
    ref = {k: g[k] for k in wins.offsets}
    parity = {}
    for k, ours in wins.result().items():
        err = float(np.abs(ours - ref[k][:ours.shape[0]]).max())
        parity[k] = float(20 * np.log10(max(err, 1e-30)))
    full = [i for i, n in enumerate(sizes) if n == sizes[0]]
    mb = lambda x: None if x is None else x / 2**20
    card = card_info(device)
    rec = {
        "script": name, "seconds": seconds, "rows": rows,
        "audio_s": audio_s, "wall_s": wall, "x_realtime": audio_s / wall,
        "wall_after_compile_s": wall - t_first,
        "window_parity_db": parity, "worst_window_db": max(parity.values()),
        "rss_mb_first": rss[0] / 1024, "rss_mb_last": rss[-1] / 1024,
        "rss_growth_pct": 100 * (rss[-1] / rss[0] - 1),
        "device_mem_mb_first": mb(mem[0]),
        "device_mem_mb_last": mb(mem[full[-1]]),
        "device_mem_peak_mb": mb(torch.cuda.max_memory_allocated())
        if on_card else None,
        "chunks": len(sizes), "window": win, "card": card,
        "note": "streamed render (render_fused_stream, 172-block chunks, "
                "the carry kept on the device from chunk to chunk); parity "
                "vs the compat engine's exact render at one row over three "
                "windows (start/mid/end); wall_after_compile_s is the wall "
                "after the first chunk, which builds the kernels; rss is "
                "the host's max RSS and device_mem torch.cuda."
                "memory_allocated(), both sampled after every chunk; "
                "device_mem_mb_last is after the last chunk of full "
                "length",
    }
    path = pathlib.Path(RECORD if record is None else record)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="endurance", description=(
        "A long streamed render held to the compat engine."))
    ap.add_argument("mode", choices=("oracle", "run"))
    ap.add_argument("script", nargs="?", default="stress64.sk")
    ap.add_argument("seconds", nargs="?", type=float, default=300.0)
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--window", type=int, default=WIN)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    refuse_ablated("endurance")
    require(a.device, "endurance")
    if a.mode == "oracle":
        oracle(a.script, a.seconds, a.window, a.device)
        return 0
    rec = run(a.script, a.seconds, a.rows, a.window, a.device)
    return 0 if rec["worst_window_db"] <= TARGET_DB else 1


if __name__ == "__main__":
    sys.exit(main())
