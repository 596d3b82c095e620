"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its traffic
mix's driver (``benchmark/traffic/<kind>.py``) builds the inputs from the
seed, warms every shape the window uses (set-up), runs the window for
``--seconds``, and checks what the window produced against the plain
reference (``benchmark/reference``).  With ``--trace 0`` the result line
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a ``torch.profiler`` trace of a steady stretch.  The
last line of standard output is the result, a JSON object; the numbers
compared with their limits are the last lines of standard error.

Runs on a CUDA card only: without one it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()           # set-up starts with the process

import argparse   # noqa: E402
import os         # noqa: E402
import pathlib    # noqa: E402
import sys        # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips)
    harness.import_program()
    drive = harness.driver(cell.traffic["kind"])
    return drive.run(cell, args.seed, args.seconds, bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
