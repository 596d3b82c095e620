"""The compat kernel in turns with another tree's, on one card.

    python skred_tpu_torch/tools/compat_turns.py --other DIR
        [script ...] [--rows R,R]
    python skred_tpu_torch/tools/compat_turns.py --keys [script ...]
        [--rows R,R]
    python skred_tpu_torch/tools/compat_turns.py --walls --other DIR
        [--other DIR ...]

``DIR`` is another checkout of the repository (e.g. the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  The tool runs four worker processes one after another: the
other tree, this tree, this tree, the other tree.  Each imports its own
tree's ``skred_tpu_torch`` (built into that tree's ``build/``), and for
each script (default stress64, noise64, fb2) at each row count (default
1 and 1024) renders the first 172-block chunk through
``compat_block`` once to warm up, then times two more launches of that
chunk by CUDA events: ms a block.  Prints each worker's times, in the
order they ran, and one JSON line with the card's name and power limit.

``--keys``: this tree only, each script (default stress64, noise64, fb1,
fb2, fb5) at each row count under its own ``compat_key`` and under that
key widened one part at a time (every flag bit, every modulator read,
every CZ curve, the CZ divide in place of the power-of-two multiply),
all at once, and its own key again: what each part of the key saves at
run time, timed as above.  The widened keys launch the library directly (the wrapper takes
only a batch's own key).

``--walls``: what a user waits for, build included.  For each tree in
turns (the others in order, this tree twice, the others in reverse),
with the tree's compat libraries deleted first, the process wall and
the CLI's own render seconds of ``cli render --engine compat`` of 10 s
of stress64 (a cold checkout), again (warm), of fb2 (the next script),
then of ``entry_torch.entry()``'s step, and of that step again after the
compat libraries are deleted once more.

Card only: without one it prints an error line and exits 2.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve()
ROOT = HERE.parents[2]
SCRIPTS = ("corpus/stress64.sk", "skred_tpu_torch/scripts/noise64.sk",
           "corpus/fb2.sk")
KEY_SCRIPTS = ("corpus/stress64.sk", "skred_tpu_torch/scripts/noise64.sk",
               "corpus/fb1.sk", "corpus/fb2.sk", "corpus/fb5.sk")
CHUNK = 172
# the key's parts widened by --keys: define -> its widest value
WIDE = {"flags": ("COMPAT_FLAGS", "0x1fff"), "mods": ("COMPAT_MODS", "0x1f"),
        "curves": ("COMPAT_CZ_MASK", "0xff"), "divide": ("COMPAT_TS_POW2", "0")}
ENTRY = ("import sys, time, torch; sys.path.insert(0, '.'); "
         "import entry_torch as e; fn, a = e.entry(); t = time.time(); "
         "fn(*a); torch.cuda.synchronize(); "
         "print(f'# step {time.time() - t:.3f}s')")


def _cells(scripts, rows_list, dev):
    """(path, rows, inputs, timeline) of each script at each row count,
    over the first chunk."""
    from skred_tpu_torch.assets import WaveBank
    from skred_tpu_torch.engine import render as cr
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import stack_timelines

    cells = []
    for script in scripts:
        path = ROOT / script
        tl = compile_script(path.read_text().splitlines(),
                            CHUNK * 512 / 44100.0 + 1e-3, bank=WaveBank(),
                            script_dir=path.parent)
        for rows in rows_list:
            cells.append((path, rows,
                          cr.stacked_inputs(stack_timelines([tl] * rows),
                                            dev), tl))
    return cells


def _events_ms(fn) -> float:
    """ms a block of ``fn`` (a chunk's launch): one warm call, then two
    timed by CUDA events."""
    import torch

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(2):
            fn()
        t1.record()
        torch.cuda.synchronize()
    return t0.elapsed_time(t1) / 2 / CHUNK


def worker(tree: str, scripts, rows_list) -> dict:
    """In this process: ``tree``'s package, its ms a block per cell."""
    sys.path.insert(0, tree)
    import torch

    from skred_tpu_torch.engine.kernels import compat as K
    from skred_tpu_torch.host.timeline import noise_stream

    assert pathlib.Path(K.__file__).resolve().is_relative_to(
        pathlib.Path(tree).resolve()), K.__file__
    from skred_tpu_torch.engine.kernels import build

    dev = torch.device("cuda", 0)
    nz = torch.as_tensor(noise_stream(CHUNK * 512), device=dev)
    cells = _cells(scripts, rows_list, dev)
    if hasattr(K, "compat_key"):
        # every key this tree's cells launch, in one parallel build
        build.build_all(list(dict.fromkeys(
            ("compat", K.compat_key(inp, tl.mod_passes, False))
            for _, _, inp, tl in cells)))
    out = {}
    for path, rows, inp, tl in cells:
        zero = K.zero_carry(rows, dev)
        out[f"{path.name} {rows}"] = _events_ms(
            lambda: K.compat_block(inp, zero, nz, 0, CHUNK, tl.mod_passes,
                                   True, False))
    return out


def widened(key, parts) -> tuple:
    """``key`` with each of ``parts`` (names of WIDE) at its widest."""
    set_ = dict(WIDE[p] for p in parts)
    return tuple(f"{d}={set_.get(d, v)}"
                 for d, v in (k.split("=") for k in key))


def keys_worker(scripts, rows_list) -> dict:
    """--keys in this process: {cell: {variant: ms a block}}."""
    import torch

    from skred_tpu_torch.engine.kernels import build, cuda_call
    from skred_tpu_torch.engine.kernels import compat as K
    from skred_tpu_torch.host.timeline import noise_stream

    dev = torch.device("cuda", 0)
    nz = torch.as_tensor(noise_stream(CHUNK * 512), device=dev)
    # "own" again last: the drift over the cell's runs
    variants = ({"own": ()} | {p: (p,) for p in WIDE}
                | {"all": tuple(WIDE), "own again": ()})
    cells = []
    for path, rows, inp, tl in _cells(scripts, rows_list, dev):
        own = K.compat_key(inp, tl.mod_passes, False)
        keys = {nm: widened(own, parts) for nm, parts in variants.items()}
        cells.append((f"{path.name} {rows}", inp, tl.mod_passes, keys))
    t0 = time.time()
    secs = build.build_all(list(dict.fromkeys(
        ("compat", k) for *_, keys in cells for k in keys.values())))
    out = {"build_s": time.time() - t0, "builds": len(secs)}
    for cell, inp, passes, keys in cells:
        zero = K.zero_carry(inp.rows, dev)

        def run(key, inp=inp, passes=passes, zero=zero):
            args = K._pack_args(inp, zero, nz, 0, CHUNK, passes, False)[0]
            cuda_call.launch("compat", args, dev, key)

        out[cell] = {nm: _events_ms(lambda k=k: run(k))
                     for nm, k in keys.items()}
        print(cell, {nm: round(ms, 4) for nm, ms in out[cell].items()},
              file=sys.stderr, flush=True)
    return out


def _clear(tree: pathlib.Path) -> None:
    """Delete ``tree``'s compat libraries (and their reports)."""
    for p in (tree / "build" / "kernels").glob("compat*"):
        p.unlink()


def walls(trees) -> list:
    """--walls: [(label, {step: (process wall s, CLI render s)})]."""
    py = sys.executable
    cli = lambda sk: [py, "-m", "skred_tpu_torch.cli", "render", sk,
                      "--seconds", "10", "--engine", "compat", "--out",
                      "build/compat_walls.f32"]
    steps = (("cold stress64", cli("corpus/stress64.sk"), True),
             ("warm stress64", cli("corpus/stress64.sk"), False),
             ("next fb2", cli("corpus/fb2.sk"), False),
             ("entry step", [py, "-c", ENTRY], False),
             ("entry step cold", [py, "-c", ENTRY], True))
    order = trees + [("this", ROOT), ("this", ROOT)] + trees[::-1]
    _clear(ROOT)
    for _, tree in trees:
        _clear(tree)
    res = []
    for label, tree in order:
        got = {}
        for step, cmd, cold in steps:
            if cold:
                _clear(tree)
            t0 = time.time()
            r = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
            wall = time.time() - t0
            if r.returncode != 0:
                raise RuntimeError(f"{label} {step}: {r.stdout}{r.stderr}")
            m = re.search(r"rendered [\d.]+s in ([\d.]+)s|# step ([\d.]+)s",
                          r.stdout)
            got[step] = (wall, float(m.group(1) or m.group(2)))
            print(f"{label:6s} {step}: {wall:.2f} s wall, "
                  f"{got[step][1]:.2f} s render", flush=True)
        res.append((label, got))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="compat_turns")
    ap.add_argument("scripts", nargs="*")
    ap.add_argument("--other", action="append", default=[])
    ap.add_argument("--rows", default="1,1024")
    ap.add_argument("--keys", action="store_true")
    ap.add_argument("--walls", action="store_true")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    rows = [int(r) for r in args.rows.split(",")]
    scripts = args.scripts or list(KEY_SCRIPTS if args.keys else SCRIPTS)
    if args.worker is not None:
        print(json.dumps(worker(args.worker, scripts, rows)))
        return 0
    sys.path.insert(0, str(ROOT))
    from skred_tpu_torch.tools.card import card_info, require

    require("cuda", "compat_turns")
    if args.keys:
        print(json.dumps({"card": card_info("cuda"),
                          "keys": keys_worker(scripts, rows)}))
        return 0
    if not args.other:
        ap.error("--other DIR is needed but with --keys")
    others = [(f"other{j}" if len(args.other) > 1 else "other",
               pathlib.Path(o).resolve()) for j, o in enumerate(args.other)]
    if args.walls:
        print(json.dumps({"card": card_info("cuda"),
                          "walls": walls(others)}))
        return 0
    other = str(others[0][1])
    turns = []
    for label, tree in (("other", other), ("this", str(ROOT)),
                        ("this", str(ROOT)), ("other", other)):
        cmd = [sys.executable, str(HERE), *scripts, "--rows",
               args.rows, "--other", other, "--worker", tree]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        times = json.loads(res.stdout.strip().splitlines()[-1])
        turns.append((label, times))
        for cell, ms in times.items():
            print(f"{label:5s} {cell}: {ms:.4f} ms a block", flush=True)
    print(json.dumps({"card": card_info("cuda"), "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
