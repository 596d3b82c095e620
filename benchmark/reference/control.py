"""The comparison's control: the plain reference in bfloat16, the
precision below the configuration's float32, put in the program's place
and judged by the run's own comparison, which has to read ``correct``
false.

    python3 benchmark/reference/control.py --workload <cell>
        --seconds <s> --seed <n> [--seed <n> ...]

runs the cell once a seed, as ``run.py`` does (on the card, the same
set-up and window), except that after the window the audio of the rows
(sweep) or requests (preview) compared is the reference's bfloat16
render of their scripts; the result line and the checks are the run's.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def bfloat16(texts, seconds: float):
    """The reference's audio of scripts, computed in bfloat16."""
    from benchmark import harness
    from benchmark.reference import compare

    return compare.render(texts, seconds, "bfloat16",
                          script_dir=harness.HERE / "configs")


def run(cell, seed: int, seconds: float, device: str = "cuda") -> int:
    """One run of ``cell`` with the control in the program's place."""
    from benchmark import harness

    drive = harness.driver(cell.traffic["kind"])
    return drive.run(cell, seed, seconds, False, time.perf_counter(),
                     device=device, substitute=bfloat16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips)
    harness.import_program()
    for seed in args.seed:
        rc = run(cell, seed, args.seconds)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
