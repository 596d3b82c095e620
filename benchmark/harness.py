"""What every cell's run shares: the cell's files, the card check, the
set-up clock, the kernels' names, the guard against JAX, and the result
line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a
configuration (``configs/<name>.json`` and the script beside it) under a
traffic mix (``traffic/<traffic>.json``), which names the driver of its
kind (``traffic/<kind>.py``).  A per-layer metric is a reader of its own
(``metrics/<name>.py``).  Everything is found by the names in
``BENCHMARK.json``, so a cell or a metric is added by adding files and
entries.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import pathlib
import re
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
KERNEL_SOURCES = ROOT / "skred_tpu_torch" / "engine" / "kernels" / "csrc"
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "skred_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<name>.json, with "script_text"
    traffic: dict           # traffic/<traffic>.json
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_cell(name: str) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"benchmark: no workload {name!r} "
                         f"(known: {', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    script = (HERE / "configs" / config["script"]).read_bytes()
    if hashlib.sha256(script).hexdigest() != config["script_sha256"]:
        raise SystemExit(f"benchmark: {config['script']} is not the frozen "
                         f"script its configuration records")
    config["script_text"] = script.decode()
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def driver(kind: str):
    """The traffic driver of a kind: ``traffic/<kind>.py``."""
    if not re.fullmatch(r"[a-z_][a-z0-9_]*", kind):
        raise SystemExit(f"benchmark: no traffic kind {kind!r}")
    return importlib.import_module(f"benchmark.traffic.{kind}")


def reader(metric: str):
    """A per-layer metric's reader: ``metrics/<name>.py``'s ``read``."""
    mod = _load(HERE / "metrics" / f"{metric}.py",
                "benchmark_metric_" + re.sub(r"\W", "_", metric))
    return mod.read


def layer_metrics(cell: Cell, summary, **counts) -> dict:
    """Every per-layer metric of the cell, each from its own reader,
    which takes the trace summary, the port's kernel names and the
    traced stretch's counts; a reader that finds nothing returns None."""
    import types

    ctx = types.SimpleNamespace(trace=summary, port_kernels=port_kernels(),
                                **counts)
    return {m["name"]: reader(m["name"])(ctx) for m in cell.per_layer}


def _load(path: pathlib.Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def require_cards(n: int):
    """Exit 2, printing no result, unless ``n`` CUDA cards are visible."""
    import torch

    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is false; the "
              "benchmark runs on a CUDA card only", file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < n:
        print(f"benchmark: the cell needs {n} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        raise SystemExit(2)


def import_program():
    """The program under test, from this checkout (not an installed
    copy)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import skred_tpu_torch

    where = pathlib.Path(skred_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        raise SystemExit(f"benchmark: skred_tpu_torch loads from {where}, "
                         f"outside the checkout {ROOT}")
    return skred_tpu_torch


def port_kernels() -> tuple:
    """The names of the program's own CUDA kernels (``__global__``
    functions of ``csrc/*.cu``)."""
    names = set()
    for p in sorted(KERNEL_SOURCES.glob("*.cu")):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
            r"(\w+)\s*\(", p.read_text()))
    return tuple(sorted(names))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def device_block(count: int, device: str = "cuda") -> dict:
    """The result's ``device``: the card, the cards used and the peak
    device memory of the fullest (a CPU test run reports the CPU)."""
    import torch

    if torch.device(device).type == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count))}


def finish(cell: Cell, trace: bool, correct: bool, attempted: int,
           failed: int, e2e: dict, layer: dict, device: dict,
           checks: dict, breakdown=None) -> int:
    """Print the result line (stdout's last line) and the checks (the
    last lines on stderr); 3 and no result if a forbidden module is
    loaded."""
    bad = forbidden_modules()
    if bad:
        print("benchmark: forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    metrics = {}
    if trace:
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        for name, value in layer.items():
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
