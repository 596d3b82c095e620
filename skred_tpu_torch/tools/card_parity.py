"""Parity on the card: render scripts with the fused engine (cyclic
scripts with the cyclic engine) and hold each to the compat engine at
the -60 dB target (BASELINE.md).

    python -m skred_tpu_torch.tools.card_parity [seconds] [script ... | all]
        [--bucketed] [--replicas N] [--fast] [--device D]

The counterpart of ``tools/tpu_parity.py``.  Defaults: 3 s, the seven
in-repo scripts (``corpus/*.sk`` and ``skred_tpu_torch/scripts/noise64.sk``;
``all`` names the same seven), the card.  A script is a path or a name
in one of those two folders.

Plain mode stacks the acyclic scripts into one batch and renders it
with ``render_fused_device``; each cyclic script renders alone through
``render_cyclic``.  ``--bucketed`` renders exactly the buckets
``bench_torch.py`` times (``parallel/buckets.make_buckets`` with the same
``--replicas``, pow2 segment padding and 172-block chunks) through
``render_fused_stream`` and ``render_cyclic_stream``, and recovers each
head row's script by name, since ``fill_bucket`` orders the head rows by
table binding.  Unlike the JAX tool it keeps the last, shorter chunk:
the card has no compiled shapes to keep, and a render shorter than a
chunk (1 s) still compares.  ``--fast`` renders with ``exact=False``,
the arithmetic ``bench_torch.py --fast`` times, cyclic scripts included.
A cyclic script the cyclic kernel's gate refuses prints ``SKIP``: only
the compat engine renders it.

The oracle is the port's compat engine in exact mode
(``engine/render.render_timeline``) on the same device: on the card that
is ``csrc/compat.cu``, which chip_smoke.py holds bit for bit to its plain
version, ``compat_block_plain``.  The JAX tool renders its oracle in a
CPU subprocess only because the TPU host compiled even CPU programs for
another microarchitecture; the card has no such quirk.

Prints one ``OK``/``FAIL`` line a script (max |error| in dB of full
scale, as ``tpu_parity.py`` reports it), then the worst eight; writes
the record (``TPU_PARITY.json``'s keys, the card's name and power limit)
to ``build/card_parity_torch.json``.  Exits 1 when the worst script is
above -60 dB, 2 without a card (unless ``--device cpu``) or under a
timing-ablation switch (``SKRED_MEGA_ABLATE``, ``SKRED_CYC_ABLATE``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from skred_tpu_torch.tools.card import card_info, refuse_ablated, require

ROOT = pathlib.Path(__file__).resolve().parents[2]
RECORD = ROOT / "build" / "card_parity_torch.json"
FOLDERS = (ROOT / "corpus", ROOT / "skred_tpu_torch" / "scripts")
CHUNK = 172                      # bench_torch.py's chunk
TARGET_DB = -60.0
BIT_EXACT_DB = -290.0


def script_path(name) -> pathlib.Path:
    """A script by path, or by name in ``corpus/`` or
    ``skred_tpu_torch/scripts/``."""
    p = pathlib.Path(name)
    if p.exists():
        return p
    for d in FOLDERS:
        if (d / p.name).exists():
            return d / p.name
    raise FileNotFoundError(f"no script {name}")


def db_of(err: float) -> float:
    """max |error| in dB of full scale."""
    return float(20 * np.log10(err + 1e-30))


def _rows(out: torch.Tensor) -> np.ndarray:
    """``render_fused_device``'s [num_blocks, B, block, 2] as [B, T, 2]."""
    nb, b, n, _ = out.shape
    return out.permute(1, 0, 2, 3).reshape(b, nb * n, 2).cpu().numpy()


def render_plain(tls: dict, fast: bool, device) -> tuple:
    """The acyclic scripts stacked through ``render_fused_device``, each
    cyclic script alone through ``render_cyclic``.  Returns ({name:
    [T, 2]}, bucket shapes)."""
    from skred_tpu_torch.engine import cyclic, fused
    from skred_tpu_torch.parallel.batch import pack_stacked, stack_timelines

    outs, shapes = {}, []
    acyclic = [n for n, tl in tls.items() if tl.fused_passes is not None]
    if acyclic:
        st = pack_stacked(stack_timelines([tls[n] for n in acyclic]))
        o = _rows(fused.render_fused_device(
            st, exact=False if fast else None, device=device))
        outs.update(zip(acyclic, o))
        shapes.append({"voices": int(st.params["amp"].shape[-1]),
                       "passes": int(st.fused_passes), "rows": st.batch,
                       "scripts": len(acyclic)})
    for n, tl in tls.items():
        if tl.fused_passes is not None:
            continue
        st = pack_stacked(stack_timelines([tl]), cyclic=True)
        reason = cyclic.cyclic_gate(st)
        if reason is not None:
            print(f"SKIP {n}: cyclic, {reason} (compat engine only)")
            continue
        outs[n] = cyclic.render_cyclic(st, exact=not fast, device=device)[0]
        shapes.append({"voices": f"cyclic-{st.params['amp'].shape[-1]}v",
                       "passes": 0, "rows": 1, "scripts": 1})
    return outs, shapes


def render_bucketed(paths: list, seconds: float, replicas: int, fast: bool,
                    device, max_rows=None) -> tuple:
    """The bench's buckets, streamed in its 172-block chunks; each
    bucket's head rows recovered by name.  Returns ({name: [T, 2]},
    bucket shapes)."""
    from skred_tpu_torch.engine import cyclic, fused
    from skred_tpu_torch.parallel.buckets import make_buckets

    outs, shapes = {}, []
    for bk in make_buckets(paths, seconds, replicas, max_rows):
        if bk.kind == "compat":
            for n in bk.scripts:
                print(f"SKIP {n}: cyclic, refused by the cyclic kernel's "
                      f"gate (compat engine only)")
            continue
        heads = {}
        for i, n in enumerate(bk.row_scripts):
            heads.setdefault(n, i)
        keep = max(heads.values()) + 1
        if bk.kind == "fused":
            chunks = fused.render_fused_stream(
                bk.st, CHUNK, exact=False if fast else None,
                keep_rows=keep, device=device)
            shape = {"voices": bk.voices, "passes": bk.passes}
        else:
            chunks = cyclic.render_cyclic_stream(
                bk.st, CHUNK, exact=not fast, keep_rows=keep, device=device)
            shape = {"voices": f"cyclic-{bk.voices}v", "passes": 0}
        o = np.concatenate(list(chunks), axis=1)
        for n, i in heads.items():
            outs[n] = o[i]
        shapes.append({**shape, "rows": int(bk.st.batch),
                       "scripts": len(heads)})
        print(f"bucket {shape['voices']} x{bk.st.batch} {sorted(heads)}: "
              f"done", flush=True)
    return outs, shapes


def card_parity(seconds: float = 3.0, scripts=None, bucketed: bool = False,
                replicas: int = 4, fast: bool = False, device="cuda",
                max_rows=None, record=None) -> dict:
    """Render, compare with the compat engine, print, write the record
    to ``record`` (default ``RECORD``) and return it.  ``max_rows`` cuts
    every bucket's rows (tests).  Refuses to start under a timing-ablation
    switch (``tools/card.py``)."""
    from skred_tpu_torch.assets.bank import WaveBank
    from skred_tpu_torch.engine.render import render_timeline

    refuse_ablated("card_parity")
    from skred_tpu_torch.parallel.buckets import SCRIPTS, compile_one

    if not scripts or list(scripts) == ["all"]:
        scripts = SCRIPTS
    paths = [script_path(s) for s in scripts]
    bank = WaveBank()
    tls = {p.name: compile_one(p, seconds, bank)[0] for p in paths}
    t0 = time.perf_counter()
    if bucketed:
        outs, shapes = render_bucketed(paths, seconds, replicas, fast,
                                       device, max_rows)
    else:
        outs, shapes = render_plain(tls, fast, device)
    print(f"render: {time.perf_counter() - t0:.3f} s ({len(outs)} scripts, "
          f"{len(shapes)} batches) on {device}", flush=True)
    t0 = time.perf_counter()
    results = {}
    for n, out in outs.items():
        ref = render_timeline(tls[n], exact=True, device=device)
        m = min(out.shape[0], ref.shape[0])
        err = float(np.abs(out[:m] - ref[:m]).max())
        d = db_of(err)
        flag = "OK  " if d <= TARGET_DB else "FAIL"
        print(f"{flag} {n:12s} {d:8.2f} dB  err={err:.3e}", flush=True)
        results[n] = d
    print(f"oracle: {time.perf_counter() - t0:.3f} s (compat engine, exact)")
    worst = sorted(((d, n) for n, d in results.items()), reverse=True)
    print("\nworst:", [(round(d, 2), n) for d, n in worst[:8]], flush=True)
    rec = {
        "worst_db": round(worst[0][0], 2) if worst else None,
        "worst_script": worst[0][1] if worst else None,
        "median_db": round(float(np.median([d for d, _ in worst])), 2)
        if worst else None,
        "bit_exact": sum(1 for d, _ in worst if d <= BIT_EXACT_DB),
        "n_scripts": len(worst),
        "pass": bool(not worst or worst[0][0] <= TARGET_DB),
        "arith": "fast" if fast else "exact",
        "seconds": seconds,
        "target_db": TARGET_DB,
        "bucketed": bucketed,
        "replicas": replicas,
        "buckets": shapes,
        "scripts": {n: round(d, 2) for d, n in worst},
        "card": card_info(device),
    }
    record = pathlib.Path(RECORD if record is None else record)
    record.parent.mkdir(parents=True, exist_ok=True)
    record.write_text(json.dumps(rec, indent=1))
    print(f"wrote {record}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="card_parity", description=(
        "Hold the fused and cyclic engines to the compat engine."))
    ap.add_argument("args", nargs="*", help="[seconds] [script ... | all]")
    ap.add_argument("--bucketed", action="store_true")
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    refuse_ablated("card_parity")
    require(a.device, "card_parity")
    seconds = float(a.args[0]) if a.args else 3.0
    rec = card_parity(seconds, a.args[1:], a.bucketed, a.replicas, a.fast,
                      a.device)
    return 0 if rec["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
