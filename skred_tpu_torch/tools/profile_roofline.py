"""Hold the roofline model against a torch.profiler trace of the card.

    python -m skred_tpu_torch.tools.profile_roofline [seconds] [replicas]

For each bucket of the bench (built as ``bench_torch.py`` builds it,
``parallel/buckets.py``; defaults 10 s and 4 replicas), one steady chunk
of ``CHUNK`` blocks is traced: the batch is prepared and its first chunk
rendered outside the trace, then the next chunk (the first again if
there is one only) renders under ``torch.profiler`` and a synchronise.
The device time is summed by category (``aggregate``): the tier kernel
and its mix, the keyed walk, the lookup, the keyed filter, the cyclic
kernel, the volume kernel, copies and slices, and the rest.  Each
bucket's line gives the device's busy share of the wall, device
operations and torch calls per block, and the model's bytes and
operations per block (``parallel/roofline.py``) against the rate they
reach over the wall and over the busy time.

Writes ``build/profile_roofline_torch.json`` and prints one JSON line.
Runs on the card only.  The JAX package's counterpart is
``tools/profile_roofline.py`` (jax.profiler, xplane).
"""

from __future__ import annotations

import json
import pathlib
import re
import sys
import time

import torch

CHUNK = 172
OUT = pathlib.Path(__file__).resolve().parents[2] / "build" \
    / "profile_roofline_torch.json"

# device-kernel name -> category, first match wins
CATEGORIES = (
    ("tier mix", re.compile(r"tier_mix_kernel")),
    ("tier kernel", re.compile(r"tier_keyed_kernel")),
    ("keyed walk", re.compile(r"phase_walk_keyed_kernel")),
    ("lookup", re.compile(r"lookup_(time|lane)_major")),
    ("keyed filter", re.compile(r"filt_smooth_keyed_kernel")),
    ("cyclic kernel", re.compile(r"cyclic_(fixed|general)_kernel")),
    ("volume kernel", re.compile(r"volume_kernel")),
    ("copies and slices", re.compile(
        r"[Mm]emcpy|[Mm]emset|copy|Copy|[Cc]at|index|gather|scatter|slice",
    )),
)


def category(name: str) -> str:
    for cat, rx in CATEGORIES:
        if rx.search(name):
            return cat
    return "rest"


def aggregate(events, blocks: int):
    """Device time by kernel and by category from ``key_averages()``
    rows (objects with ``key``, ``count``, ``device_type`` and
    ``device_time_total`` or ``cuda_time_total`` in microseconds).
    Returns None when the trace holds no device time."""
    kernels, torch_calls = {}, {}
    for e in events:
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        on_device = e.device_type is not None \
            and "cuda" in str(e.device_type).lower()
        if us and on_device:
            kernels[e.key] = (us, e.count)
        elif e.key.startswith("aten::"):
            torch_calls[e.key[6:]] = e.count
    if not kernels:
        return None
    cats = {}
    for key, (us, _) in kernels.items():
        cat = category(key)
        cats[cat] = cats.get(cat, 0.0) + us / 1e3
    busy_us = sum(us for us, _ in kernels.values())
    n_ops = sum(c for _, c in kernels.values())
    return {"device_busy_s": busy_us / 1e6,
            "device_ops": n_ops, "device_ops_per_block": n_ops / blocks,
            "categories_ms": dict(sorted(cats.items(),
                                         key=lambda kv: -kv[1])),
            "kernels": {k: {"ms": us / 1e3, "calls": c} for k, (us, c) in
                        sorted(kernels.items(), key=lambda kv: -kv[1][0])},
            "torch_calls_per_block": {
                k: c / blocks for k, c in sorted(torch_calls.items(),
                                                 key=lambda kv: -kv[1])}}


def trace(run):
    """(key_averages rows, wall seconds) of one call of ``run`` under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.key_averages(), wall


def steady_chunk(bk, chunk, device):
    """A call that renders one steady chunk of bucket ``bk``: the batch
    is prepared and its first chunk rendered (every kernel built) here."""
    from skred_tpu_torch.engine import cyclic, fused

    mod, prep = (fused, fused._prepare) if bk.kind == "fused" \
        else (cyclic, cyclic._prep)
    whole = bk.st.num_blocks // chunk
    st, r, carry = prep(bk.st, True if bk.kind == "cyclic" else None,
                        device, noise_blocks=whole * chunk)
    with torch.no_grad():
        carry, _ = mod._render_chunk(r, carry, 0, chunk)
    torch.cuda.synchronize()
    b0 = chunk if whole > 1 else 0

    def run():
        with torch.no_grad():
            mod._render_chunk(r, carry, b0, chunk)
    return run


def profile_buckets(seconds: float = 10.0, replicas: int = 4,
                    chunk: int = CHUNK) -> dict:
    """Trace one steady chunk of every bench bucket; returns the record
    written to ``build/profile_roofline_torch.json``."""
    from skred_tpu_torch.parallel.buckets import SCRIPTS, make_buckets
    from skred_tpu_torch.parallel.roofline import estimate_bucket

    if not torch.cuda.is_available():
        raise SystemExit("profile_roofline: no card (torch.cuda.is_available() "
                         "is false)")
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    rows = []
    for bk in make_buckets(SCRIPTS, seconds, replicas):
        if bk.kind == "compat":        # the roofline models the block loop
            continue
        events, wall = trace(steady_chunk(bk, chunk, dev))
        agg = aggregate(events, chunk)
        cost = estimate_bucket(bk.st, card)
        row = {"scripts": bk.scripts, "kind": bk.kind, "rows": bk.st.batch,
               "tiers": list(bk.st.tiers or ()), "blocks": chunk,
               "wall_s": wall, "model": cost.roofline(wall, chunk)}
        if agg is None:
            row["device"] = "not measured (no device events in the trace)"
        else:
            busy = agg["device_busy_s"]
            row.update(
                device_busy_pct=100 * busy / wall,
                model_gb_s_over_busy=cost.bytes_per_block * chunk / busy
                / 1e9, **agg)
        rows.append(row)
    record = {"card": card, "seconds": seconds, "replicas": replicas,
              "chunk": chunk, "buckets": rows}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    _args = [a for a in sys.argv[1:] if not a.startswith("--")]
    rec = profile_buckets(float(_args[0]) if _args else 10.0,
                          int(_args[1]) if len(_args) > 1 else 4)
    print(json.dumps({"card": rec["card"], "buckets": [
        {k: b.get(k) for k in ("scripts", "wall_s", "device_busy_pct",
                               "device_ops_per_block", "categories_ms",
                               "model")}
        for b in rec["buckets"]]}), flush=True)
