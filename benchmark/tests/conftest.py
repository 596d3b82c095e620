"""Shared helpers of the benchmark's CPU tests: a cell cut to a size a
test run holds, and a driver's run on the CPU with its result line."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"rows": 8, "compare_rows": 4, "pool": 4, "compare_requests": 2,
        "traced_requests": 2}


def tiny_cell(name: str, audio_s: float):
    from benchmark import harness

    cell = harness.load_cell(name)
    traffic = dict(cell.traffic, audio_s=audio_s, **{
        k: v for k, v in TINY.items() if k in cell.traffic})
    return dataclasses.replace(cell, traffic=traffic)


@pytest.fixture
def run_cpu(capsys):
    """Run a cell's driver on the CPU (the card check skipped) and return
    its exit code and result line."""
    from benchmark import harness

    def run(cell, seed=4294967311, trace=False):
        drive = harness.driver(cell.traffic["kind"])
        rc = drive.run(cell, seed, 0.0, trace, time.perf_counter(),
                       device="cpu")
        lines = capsys.readouterr().out.strip().splitlines()
        return rc, json.loads(lines[-1])

    return run
