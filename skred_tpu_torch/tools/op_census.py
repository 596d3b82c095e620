"""Census the torch operations of one steady block of a bench bucket.

    python -m skred_tpu_torch.tools.op_census [script ...] [--rows R]
        [--blocks B] [--top N] [--device D]

The counterpart of ``tools/hlocensus.py``, which compiles the JAX
package's chunk program and walks its optimized HLO: the while-loop
body (the per-block step) op by op, each op's output bytes as a proxy
for its memory writes, sorted by size, so that the glue between the
Pallas kernels is attributable op by op.  The port compiles no HLO: its
block step is ``engine/fused.py``'s (``engine/cyclic.py``'s for a
cyclic bucket) torch calls, issued one by one from the host, and on the
card they set the wall (PERF.md section 5: the card is 8.3-10.0% busy on
stress64).  So this census counts them where they are issued: a
``TorchDispatchMode`` sees every aten operation the block issues, and
each is grouped by the nearest ``skred_tpu_torch/engine/*.py`` line on
the Python stack (the engine line that issued it; a kernel wrapper's
own argument checks and output allocations count at the line that
called it) and by operation name, sorted by count and by output bytes
(the bytes of the tensors it returns; a view, and an allocation such
as ``empty``, writes none).  The hand-written kernels' launches come
from the wrappers' ``launches`` counters
(``bench_torch.launch_counters``, the per-variant ones; a keyed tier
launch with the mix launches the mix kernel too, in the same call).

The block is a steady one: the first block of the bucket's second
172-block chunk (and the ``--blocks`` after it), after one warm-up
block; scripts (default stress64.sk and noise64.sk) are found as
``card_parity.script_path`` finds them.  On the CPU the plain versions
run in the kernels' place; their operations (those of an
``engine/kernels`` function named ``*_plain`` inside a kernel wrapper)
go in a group of their own, "plain versions (CPU only)", so that the
glue's count compares across devices.  Prints the totals a block (aten
operations in the glue, kernel launches, output bytes) and the top
sites, and writes ``build/op_census_torch.json``.  On the card unless
``--device cpu``; without a card it prints an error line and exits 2.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from skred_tpu_torch.tools.card import card_info, require, sync

ROOT = pathlib.Path(__file__).resolve().parents[2]
RECORD = ROOT / "build" / "op_census_torch.json"
ENGINE = ROOT / "skred_tpu_torch" / "engine"
KERNELS = ENGINE / "kernels"
CHUNK = 172                      # bench_torch.py's chunk
PLAIN = "plain versions (CPU only)"
# the per-variant counters: "tier" and "cyclic" count their variants' sum
AGGREGATE = ("tier", "cyclic")
# operations that allocate and write nothing: no output bytes
ALLOCATIONS = ("empty", "empty_like", "empty_strided", "new_empty")


_KIND = {}          # code object -> "plain", "kernels", an engine file, None


def _kind(code):
    k = _KIND.get(code)
    if k is None and code not in _KIND:
        path = pathlib.Path(code.co_filename)
        k = ("plain" if code.co_name.endswith("_plain") else "kernels") \
            if path.parent == KERNELS \
            else f"engine/{path.name}" if path.parent == ENGINE else None
        _KIND[code] = k
    return k


def _site(wrappers):
    """(site, plain) of the operation being dispatched.  A kernel's plain
    version (an ``engine/kernels`` function named ``*_plain``) on the
    stack inside one of the kernel ``wrappers`` (code objects) makes it
    the plain versions' (the wrapper ran it in the kernel's place); else
    the nearest frame of an ``engine/*.py`` module gives its site,
    "engine/<file>:<line>" (a wrapper's own argument checks and output
    allocations on the card count there, as glue)."""
    f = sys._getframe(2)
    site = None
    plain = False
    while f is not None:
        code = f.f_code
        if plain and code in wrappers:
            return PLAIN, True
        k = _kind(code)
        if k == "plain":
            plain = True
        elif site is None and k is not None and k != "kernels":
            site = f"{k}:{f.f_lineno}"
        f = f.f_back
    return site or "elsewhere", False


def _out_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (tuple, list)):
        return sum(_out_bytes(x) for x in out)
    return 0


class Census(TorchDispatchMode):
    """Counts every aten operation dispatched while it is on: by site
    and by name, with output bytes (views: none)."""

    def __init__(self, wrappers=()):
        super().__init__()
        self.wrappers = frozenset(wrappers)
        self.sites = {}
        self.names = {}
        self.views = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        site, plain = _site(self.wrappers)
        view = bool(getattr(func, "is_view", False))
        name = str(func.overloadpacket.__name__)
        nb = 0 if view or name in ALLOCATIONS else _out_bytes(out)
        for table, k in ((self.sites, site),
                         (self.names, PLAIN if plain else name)):
            c = table.setdefault(k, [0, 0])
            c[0] += 1
            c[1] += nb
        self.views += view and not plain
        return out


def _bucket(script, rows, blocks):
    """The script's bench bucket, long enough for a warm-up block and
    ``blocks`` blocks of its second chunk, cut to ``rows``."""
    from skred_tpu_torch.parallel.buckets import make_buckets
    from skred_tpu_torch.tools.card_parity import script_path

    seconds = (CHUNK + blocks + 1) * 512 / 44100.0
    (bk,) = make_buckets([script_path(script)], seconds, 4, rows)
    if bk.kind == "compat":
        raise SystemExit(f"op_census: {script} takes the compat engine, "
                         f"a kernel launch a chunk: no block loop")
    return bk


def census(script="stress64.sk", rows=None, device="cuda", blocks=1,
           exact=True) -> dict:
    """The census of ``blocks`` steady blocks of ``script``'s bucket at
    ``rows`` rows (default the bucket's): its record, with per-block
    totals in ``per_block`` and the sites and names summed over the
    blocks."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import bench_torch
    from skred_tpu_torch.engine import cyclic, fused

    bk = _bucket(script, rows, blocks)
    eng = fused if bk.kind == "fused" else cyclic
    if bk.kind == "fused":
        _, r, carry = fused._prepare(bk.st, exact, device)
    else:
        _, r, carry = cyclic._prep(bk.st, exact, device)
    counters = {k: fn for k, fn in bench_torch.launch_counters().items()
                if k not in AGGREGATE}
    mode = Census(fn.__code__ for fn in bench_torch.launch_counters()
                  .values())
    per_block = []
    with torch.no_grad():
        carry, _ = eng._block_step(r, carry, 0)      # warm-up
        for k in range(CHUNK, CHUNK + blocks):
            sync(device)
            before = {nm: fn.launches for nm, fn in counters.items()}
            ops0 = {n: c[:] for n, c in mode.names.items()}
            with mode:
                carry, _ = eng._block_step(r, carry, k)
            sync(device)
            launches = {nm: fn.launches - before[nm]
                        for nm, fn in counters.items()
                        if fn.launches != before[nm]}
            d = {n: [c[0] - ops0.get(n, [0, 0])[0],
                     c[1] - ops0.get(n, [0, 0])[1]]
                 for n, c in mode.names.items()}
            glue = {n: c for n, c in d.items() if n != PLAIN}
            per_block.append({
                "block": k, "glue_ops": sum(c[0] for c in glue.values()),
                "glue_bytes": sum(c[1] for c in glue.values()),
                "plain_ops": d.get(PLAIN, [0, 0])[0],
                "kernel_launches": sum(launches.values()),
                "launches": launches})
    order = lambda table, i: [
        {"site" if table is mode.sites else "op": k, "count": c[0],
         "bytes": c[1]}
        for k, c in sorted(table.items(), key=lambda kv: -kv[1][i])]
    n = len(per_block)
    return {
        "script": bk.scripts[0], "kind": bk.kind, "rows": bk.st.batch,
        "tiers": list(bk.st.tiers or ()), "device": str(device),
        "card": card_info(device), "blocks": [b["block"]
                                              for b in per_block],
        "glue_ops_per_block": sum(b["glue_ops"] for b in per_block) / n,
        "glue_bytes_per_block": sum(b["glue_bytes"]
                                    for b in per_block) / n,
        "views_per_block": mode.views / n,
        "kernel_launches_per_block": sum(b["kernel_launches"]
                                         for b in per_block) / n,
        "plain_ops_per_block": sum(b["plain_ops"] for b in per_block) / n,
        "per_block": per_block,
        "sites_by_count": order(mode.sites, 0),
        "sites_by_bytes": order(mode.sites, 1),
        "ops_by_count": order(mode.names, 0),
    }


def print_census(rec, top: int = 15) -> None:
    card = rec["card"]
    print(f"op census {rec['script']} ({rec['kind']}, {rec['rows']} rows, "
          f"tiers {rec['tiers']}, blocks {rec['blocks']}) on "
          f"{card['name']} (power limit {card['power_limit']}): "
          f"{rec['glue_ops_per_block']:.1f} aten ops a block in the glue "
          f"({rec['views_per_block']:.1f} of them views), "
          f"{rec['kernel_launches_per_block']:.1f} kernel launches a "
          f"block, {rec['glue_bytes_per_block'] / 1e6:.3f} MB of output a "
          f"block; {rec['plain_ops_per_block']:.1f} ops a block in the "
          f"plain versions; launches {rec['per_block'][0]['launches']}",
          flush=True)
    for what, rows in (("count", rec["sites_by_count"]),
                       ("bytes", rec["sites_by_bytes"])):
        print(f"  top {top} sites by {what}: " + "; ".join(
            f"{r['site']} {r['count']} ops {r['bytes'] / 1e6:.3f} MB"
            for r in rows[:top]), flush=True)
    print(f"  top {top} ops by count: " + "; ".join(
        f"{r['op']} {r['count']}" for r in rec["ops_by_count"][:top]),
        flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="op_census", description=(
        "Census the torch operations of one steady block."))
    ap.add_argument("scripts", nargs="*",
                    default=["stress64.sk", "noise64.sk"])
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    require(a.device, "op_census")
    recs = []
    for s in a.scripts:
        rec = census(s, a.rows, a.device, a.blocks)
        print_census(rec, a.top)
        recs.append(rec)
    RECORD.parent.mkdir(parents=True, exist_ok=True)
    RECORD.write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
