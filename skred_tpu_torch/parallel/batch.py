"""Batch packing: many scripts stacked into one ``[scripts, ...]`` batch.

Scripts are padded to a common segment count (repeating their final
segment) and share one packed wavetable buffer and one noise stream.
The packing is numpy; ``render_batch`` sends each script to its engine
(``engine/fused.py``, ``engine/cyclic.py`` for a cyclic modulation graph,
or the compat engine, ``engine/render.py``, through ``render_stacked``),
imported when it is called.  A mesh (``make_mesh``: a list of devices)
splits a batch's rows over several devices (``shard_rows``,
``take_rows``), data-parallel: scripts are independent, so no shard
reads another's.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys
from typing import List, Optional, Sequence

import numpy as np

from skred_tpu_torch import config as C
from skred_tpu_torch.host.timeline import Timeline

V = C.VOICE_MAX

@dataclasses.dataclass
class StackedTimelines:
    params: dict                 # name → [B, S, V] (volume_final: [B, S])
    ops: dict                    # name → [B, S, V]
    seg_of_block: np.ndarray     # [B, NB]
    seg_is_start: np.ndarray     # [B, NB]
    table_buffer: np.ndarray     # shared packed tables
    num_blocks: int
    block: int
    mod_passes: int
    fused_passes: Optional[int]
    batch: int
    n_src: int = 0               # packed modulator-source prefix (fused)
    # tiered evaluation: voices packed by modulation-DAG depth; tier k's
    # lanes are [sum(tiers[:k]), sum(tiers[:k+1])) and read only earlier
    # tiers — each voice renders exactly once per block (engine/fused.py).
    # None → depth layout unavailable (cyclic union graph): repeat-passes.
    tiers: Optional[tuple] = None


def stack_timelines(tls: Sequence[Timeline]) -> StackedTimelines:
    assert len({tl.block for tl in tls}) == 1
    assert len({tl.num_blocks for tl in tls}) == 1
    block = tls[0].block
    num_blocks = tls[0].num_blocks
    max_s = max(tl.num_segments for tl in tls)

    # shared table buffer with identity dedup: scripts sharing a bank share
    # the same table objects (procedural waves, ROMs, PCM, loaded WAVs) —
    # store each once and point every script's slots at the global copy
    uniq: dict = {}
    chunks = []
    goff = 0
    script_offmaps = []
    # The JAX package's slot alignment, kept so both packages build the
    # same buffer: small tables (<= 4096) start on 4096 boundaries,
    # everything larger on 32768 boundaries.
    SLOT, SLOT_MED = 4096, 32768
    for tl in tls:
        offmap = np.zeros(max(len(tl.table_arrays), 1), dtype=np.int32)
        for i, arr in enumerate(tl.table_arrays):
            key = id(arr)
            if key not in uniq:
                a = np.asarray(arr, dtype=np.float32)
                align = SLOT if a.size <= SLOT else SLOT_MED
                lead = (-goff) % align
                if lead:
                    chunks.append(np.zeros(lead, np.float32))
                    goff += lead
                uniq[key] = goff
                pad = (-a.size) % SLOT
                if pad:
                    a = np.concatenate([a, np.zeros(pad, np.float32)])
                chunks.append(a)
                goff += a.size
            offmap[i] = uniq[key]
        script_offmaps.append(offmap)
    if goff % SLOT_MED:
        chunks.append(np.zeros((-goff) % SLOT_MED, np.float32))
    table_buffer = (np.concatenate(chunks).astype(np.float32)
                    if chunks else np.zeros(SLOT_MED, np.float32))

    def pad_seg(a: np.ndarray, s: int) -> np.ndarray:
        if a.shape[0] == s:
            return a
        reps = np.repeat(a[-1:], s - a.shape[0], axis=0)
        return np.concatenate([a, reps], axis=0)

    params = {}
    names = set(tls[0].params) | {"table_off"}
    for name in names:
        rows = []
        for tl, offmap in zip(tls, script_offmaps):
            if name == "table_off":
                a = offmap[tl.params["table_key"]].astype(np.int32)
            else:
                a = tl.params[name]
            rows.append(pad_seg(a, max_s))
        params[name] = np.stack(rows)
    ops = {}
    for name in tls[0].ops:
        rows = []
        for tl in tls:
            a = tl.ops[name]
            pad = np.zeros((max_s - a.shape[0],) + a.shape[1:], dtype=a.dtype)
            if name == "copy_hold_from":
                pad = pad - 1
            rows.append(np.concatenate([a, pad], axis=0))
        ops[name] = np.stack(rows)

    return StackedTimelines(
        params=params, ops=ops,
        seg_of_block=np.stack([tl.seg_of_block for tl in tls]),
        seg_is_start=np.stack([tl.seg_is_start for tl in tls]),
        table_buffer=table_buffer,
        num_blocks=num_blocks, block=block,
        mod_passes=max(tl.mod_passes for tl in tls),
        fused_passes=(None if any(tl.fused_passes is None for tl in tls)
                      else max(tl.fused_passes for tl in tls)),
        batch=len(tls),
    )


def rename_filter(params: dict) -> dict:
    """``flt_*`` -> ``b0, b1, b2, na1, na2``, the feedback terms negated
    (exact), as the engines take the biquad's coefficients."""
    params = dict(params)
    for old, new in (("flt_b0", "b0"), ("flt_b1", "b1"), ("flt_b2", "b2"),
                     ("flt_a1", "na1"), ("flt_a2", "na2")):
        a = params.pop(old)
        params[new] = -a if new.startswith("na") else a
    return params


def _prep_params(st: StackedTimelines):
    params = rename_filter(st.params)
    params.pop("table_key", None)
    # the renderer reads table_key only through table_off
    params["table_key"] = np.zeros_like(params["table_off"])
    return params


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> list:
    """A mesh: the list of devices a batch's rows are split over,
    data-parallel (the JAX package's one-axis ``"dp"`` mesh).  The
    visible cards, or the CPU with ``device="cpu"``; the first
    ``n_devices`` of them, or, where there are fewer, each again in turn:
    a device may stand for several entries, as ``["cuda:0", "cuda:0"]``
    shows a split on a one-card machine, and ``["cpu"] * 8`` stands for
    the JAX package's eight virtual CPU devices.  Without a card a
    ``"cuda"`` mesh is an error."""
    import torch

    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA card is visible; a CPU "
                               "mesh needs device='cpu'")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        devs = [torch.device("cpu")]
    else:
        raise ValueError(f"make_mesh: no mesh of {kind} devices")
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"make_mesh: {n} devices")
    return [devs[i % len(devs)] for i in range(n)]


def shard_rows(batch: int, mesh) -> list:
    """``(device, rows)`` of each shard of a ``batch``-row batch over a
    mesh: the rows in order, in ``len(mesh)`` runs as even as they go; an
    entry that gets no row gets no shard."""
    import torch

    if not len(mesh):
        raise ValueError("an empty mesh")
    runs = np.array_split(np.arange(batch), len(mesh))
    return [(torch.device(d), r) for d, r in zip(mesh, runs) if len(r)]


def take_rows(st: StackedTimelines, rows) -> StackedTimelines:
    """The batch's ``rows`` (a shard) as a batch of their own, with the
    whole batch's table buffer, pass counts and packing (tiers, source
    prefix): the engines render a shard by the whole batch's plan."""
    rows = np.asarray(rows)
    if np.array_equal(rows, np.arange(st.batch)):
        return st
    take = lambda d: {k: np.asarray(v)[rows] for k, v in d.items()}
    return dataclasses.replace(
        st, params=take(st.params), ops=take(st.ops),
        seg_of_block=np.asarray(st.seg_of_block)[rows],
        seg_is_start=np.asarray(st.seg_is_start)[rows], batch=len(rows))


def _padded(rows: list, ndev: int) -> list:
    """``rows`` and copies of its last to a multiple of ``ndev``, so a
    batch splits evenly over a mesh; the copies add nothing to the
    batch's plan, and their audio is dropped."""
    return rows + [rows[-1]] * ((-len(rows)) % max(ndev, 1))


def render_stacked(st: StackedTimelines, mesh=None,
                   noise: Optional[np.ndarray] = None, exact: bool = False,
                   *, device="cuda") -> np.ndarray:
    """Render a stacked batch with the compat engine -> numpy ``[B, T,
    2]``, one row a script; the rows share the table buffer and the
    noise stream (synth.c:508 seeds the stream once per process).
    ``exact=False`` is the JAX package's default for a batch
    (``_render_batch_jit``); the compat engine's two modes are one
    arithmetic (``engine/kernels/compat.py``).  With a ``mesh``
    (``make_mesh``) the rows are split over its devices, each shard's
    kernel chunks launched in turn.  Runs on the card unless
    ``device="cpu"`` (without a mesh)."""
    from skred_tpu_torch.engine.render import render_rows

    return render_rows(st, noise=noise, exact=exact, device=device,
                       mesh=mesh)


def render_batch(scripts: List[pathlib.Path], seconds: float,
                 outdir: Optional[pathlib.Path] = None, mesh=None,
                 engine: str = "auto", *, device="cuda") -> np.ndarray:
    """Batch-render scripts → ``[scripts, T, 2]``, with per-script error
    isolation: a script that fails to compile is skipped (reported)
    without killing the batch, the analog of the reference's
    parse-and-survive stance.

    engine "auto": acyclic scripts are grouped by ``bucket_key`` (voices,
    passes, feature set) and each group renders as one batch with the
    fused engine; scripts with a cyclic modulation graph are grouped by
    ``cyclic_group_key`` and each group renders as one batch with the
    cyclic engine (``render_cyclic``), each row equal bit for bit to its
    script rendered alone, or, where that engine's gate refuses the
    group, with the compat engine (loudly, on stderr).  "compat" renders
    every script with the compat engine (``render_stacked``).  ``outdir``
    writes one 16-bit WAV per rendered script.  With a ``mesh``
    (``make_mesh``) each group is padded to a multiple of its device
    count and its rows split over it (``shard_rows``); the audio is the
    render without a mesh, bit for bit.  Runs on the card unless
    ``device="cpu"`` (without a mesh).  Each cyclic group's packing, gate
    and render run in the span ``batch.cyclic_group``, ``n`` = its
    rows."""
    from skred_tpu_torch import spans
    from skred_tpu_torch.assets.bank import WaveBank, write_wav_16
    from skred_tpu_torch.engine import cyclic
    from skred_tpu_torch.engine.fused import render_fused
    from skred_tpu_torch.host.timeline import compile_script

    bank = WaveBank()
    tls, ok_scripts = [], []
    for p in scripts:
        try:
            tls.append(compile_script(p.read_text().splitlines(), seconds,
                                      bank=bank,
                                      script_dir=p.resolve().parent))
            ok_scripts.append(p)
        except Exception as ex:   # noqa: BLE001 — isolate per script
            print(f"# skipping {p}: {type(ex).__name__}: {ex}")
    if not tls:
        return np.zeros((0, 0, 2), np.float32)
    ndev = 1 if mesh is None else len(mesh)

    def stacked(idxs):
        return render_stacked(
            stack_timelines(_padded([tls[i] for i in idxs], ndev)),
            mesh=mesh, device=device)[:len(idxs)]

    if engine == "compat":
        out = stacked(range(len(tls)))
    else:
        out = np.zeros((len(tls), tls[0].num_blocks * tls[0].block, 2),
                       np.float32)
        buckets: dict = {}
        cyclic_idx, scan_idx = [], []
        for i, tl in enumerate(tls):
            if tl.fused_passes is None:
                cyclic_idx.append(i)
            else:
                buckets.setdefault(bucket_key(tl), []).append(i)
        for _, idxs in sorted(buckets.items()):
            st = pack_stacked(stack_timelines(
                _padded([tls[i] for i in idxs], ndev)))
            out[idxs] = render_fused(st, mesh=mesh,
                                     device=device)[:len(idxs)]
        groups: dict = {}
        for i in cyclic_idx:
            groups.setdefault(cyclic_group_key(tls[i]), []).append(i)
        for idxs in groups.values():
            with spans.span("batch.cyclic_group", len(idxs)):
                st = pack_stacked(stack_timelines(
                    _padded([tls[i] for i in idxs], ndev)), cyclic=True)
                reason = cyclic.cyclic_gate(st)
                if reason is not None:
                    # the compat engine runs the scripts on the device
                    # through its own kernel; it is slower than the cyclic
                    # kernel, so the fall-back is loud
                    # (skred_tpu/parallel/batch.py:250)
                    print(f"# WARNING: cyclic engine refused scripts "
                          f"{', '.join(f'#{i}' for i in idxs)} ({reason}); "
                          f"falling back to the compat scan engine (orders "
                          f"of magnitude slower on accelerators)",
                          file=sys.stderr, flush=True)
                    scan_idx += idxs
                else:
                    out[idxs] = cyclic.render_cyclic(
                        st, mesh=mesh, device=device)[:len(idxs)]
        if scan_idx:
            out[scan_idx] = stacked(scan_idx)

    if outdir is not None:
        for p, audio in zip(ok_scripts, out):
            write_wav_16(outdir / (p.stem + ".wav"), audio)
    return out


def fused_cost_per_device(st: StackedTimelines, mesh) -> float:
    """The weak-scaling metric: the f32 operations of one shard's block
    (the first mesh entry's rows) of a fused render split over ``mesh``,
    as ``parallel/roofline.block_calls`` counts the kernel calls of the
    whole batch's plan.  At fixed rows per device it must stay flat as
    the mesh grows: a split that replicated work, or a plan that grew
    with the batch, would show as a slope.  (The JAX package reads XLA's
    cost analysis of the per-device program, which has no torch
    counterpart.)"""
    from skred_tpu_torch.engine.fused import plan
    from skred_tpu_torch.parallel.roofline import block_calls

    if "fm_delayed" not in st.params:
        st = pack_stacked(st)
    _, rows = shard_rows(st.batch, mesh)[0]
    calls = block_calls(take_rows(st, rows), plan(st))
    return float(sum(c.ops for c in calls))


_MOD_TYPES = ("freq_mod_osc", "amp_mod_osc", "pan_mod_osc", "cz_mod_osc")
_EDGE_FIELDS = ("freq_mod_osc", "amp_mod_osc", "pan_mod_osc", "cz_mod_osc",
                "freq_mod_depth", "amp_mod_depth", "pan_mod_depth",
                "cz_mod_depth", "cz_mode", "disconnect")


def _union_depths(params_b: dict, rel: np.ndarray):
    """Per-voice depth in the union (over segments) of the value-carrying
    modulation graphs: depth(v) = 0 if v reads nothing, else
    1 + max(depth of its modulators).  Returns {voice: depth} or None if
    the union graph is cyclic (per-segment graphs may still be acyclic —
    the caller falls back to the repeat-passes layout)."""
    from skred_tpu_torch.host.timeline import _edges_from_arrays

    rel_set = set(int(v) for v in rel)
    nseg = params_b["amp"].shape[0]
    edges = {v: set() for v in rel_set}
    for s in range(nseg):
        seg = {name: params_b[name][s] for name in _EDGE_FIELDS}
        for v in rel_set:
            # pan-mod edges don't order the tier layout: pan is applied
            # globally after all tiers (engine/fused.py block_step)
            for m in _edges_from_arrays(seg, v, include_pan=False):
                if m != v:
                    edges[v].add(m)
    depth = {}
    visiting = set()

    def dfs(v):
        if v in depth:
            return depth[v]
        if v in visiting:
            raise ValueError("cycle")
        visiting.add(v)
        d = 0
        for m in edges[v]:
            d = max(d, dfs(m) + 1)
        visiting.discard(v)
        depth[v] = d
        return d

    try:
        for v in rel_set:
            dfs(v)
    except ValueError:
        return None
    return depth


def _relevant_voices(params: dict) -> np.ndarray:
    """Voices that can influence output: active in any segment, plus the
    transitive closure of their modulation sources (a read of an inactive
    source still yields a 0 multiplier — the edge matters)."""
    amp = params["amp"]              # [S, V]
    nseg, nv = amp.shape
    rel = set(np.where((amp != 0).any(axis=0))[0].tolist())
    frontier = list(rel)
    while frontier:
        nxt = []
        for name in _MOD_TYPES:
            osc = params[name]
            for v in frontier:
                for s in range(nseg):
                    m = int(osc[s, v])
                    if m >= 0 and m not in rel:
                        rel.add(m)
                        nxt.append(m)
        frontier = nxt
    return np.array(sorted(rel), dtype=np.int32)


def pack_stacked(st: StackedTimelines, pack: bool = True,
                 cyclic: bool = False) -> StackedTimelines:
    """Pack each script's relevant voices densely (fused-engine layout).

    ``cyclic=True`` selects the cyclic-engine layout instead: packed
    lanes in ascending ORIGINAL index order (no tiers, no source
    prefix), so the per-frame serial voice loop of engine/cyclic.py
    preserves the reference's evaluation order; the ``*_delayed`` /
    ``*_self`` flags (computed from original indices either way) carry
    the same-frame-vs-previous read rule.

    Voices are laid out by modulation-DAG depth ("tiers"): tier k's lanes
    read only tiers < k, so the fused engine renders each voice exactly
    once per block — tier by tier — instead of repeating full fixed-point
    passes.  A ``-1`` perm entry is a filler lane (tier padding across
    the batch): inactive, contributes nothing.

    The serial in-frame modulation order (synth.c:526: current-sample read
    iff modulator index < reader index) is preserved through explicit
    per-edge ``*_delayed`` / ``*_self`` flags computed from the ORIGINAL
    indices, so renumbering is transparent.  Irrelevant voices (never
    audible, never read) are dropped: the per-sample work scales with
    the packed voice count."""
    B = st.batch

    def _sources(params_b, rel):
        """Voices read by any relevant voice (transitively closed by
        construction: a source's dependencies are themselves read)."""
        src = set()
        for name in _MOD_TYPES:
            osc = params_b[name]
            for v in rel:
                for s in range(osc.shape[0]):
                    m = int(osc[s, v])
                    if m >= 0:
                        src.add(m)
        return src

    tiers = None
    if pack:
        # memoize per unique script row (replicated batches are common)
        cache: dict = {}
        infos = []
        for b in range(B):
            key = b"".join(np.ascontiguousarray(st.params[k][b]).tobytes()
                           for k in _EDGE_FIELDS + ("amp",))
            if key not in cache:
                pb = {k: v[b] for k, v in st.params.items()}
                rel = _relevant_voices(pb)
                depths = _union_depths(pb, rel)
                src = _sources(pb, rel.tolist()) & set(rel.tolist())
                cache[key] = (rel, depths, src)
            infos.append(cache[key])

        tiers_ok = (not cyclic) and all(d is not None for _, d, _ in infos)
        if cyclic:
            perms = [np.array(sorted(rel.tolist()), dtype=np.int32)
                     for rel, _, _ in infos]
            vp = max((len(p) for p in perms), default=1)
            n_src = 0
        elif tiers_ok:
            n_tiers = max((max(d.values()) + 1 if d else 1)
                          for _, d, _ in infos)
            tsizes = [0] * n_tiers
            for _, d, _ in infos:
                cnt = [0] * n_tiers
                for v, k in d.items():
                    cnt[k] += 1
                tsizes = [max(a, c) for a, c in zip(tsizes, cnt)]
            if not any(tsizes):
                tsizes = [1]
            perms = []
            pcache: dict = {}
            for _, d, _ in infos:
                pkey = id(d)
                if pkey not in pcache:
                    perm = []
                    for k in range(len(tsizes)):
                        vs = sorted(v for v, kk in d.items() if kk == k)
                        perm += vs + [-1] * (tsizes[k] - len(vs))
                    pcache[pkey] = np.array(perm, dtype=np.int32)
                perms.append(pcache[pkey])
            vp = sum(tsizes)
            tiers = tuple(tsizes)
            n_src = vp - tsizes[-1]
        else:
            perms = []
            n_srcs = []
            for rel, _, src in infos:
                # modulator sources first: early fixed-point passes only
                # need their blocks
                ordered = sorted(src) + sorted(set(rel.tolist()) - src)
                perms.append(np.array(ordered, dtype=np.int32))
                n_srcs.append(len(src))
            vmax = max((len(p) for p in perms), default=1)
            vp = 1
            while vp < vmax:
                vp *= 2
            vp = min(vp, V)
            smax = max(n_srcs, default=0)
            n_src = 0
            if smax:
                n_src = 1
                while n_src < smax:
                    n_src *= 2
            n_src = min(n_src, vp)
    else:
        perms = [np.arange(V, dtype=np.int32) for _ in range(B)]
        vp = V
        n_src = V

    def pack_arr(a, perm, fill=0):
        out = np.full(a.shape[:-1] + (vp,), fill, dtype=a.dtype)
        live = perm >= 0
        out[..., : len(perm)][..., live] = a[..., perm[live]]
        return out

    new_params = {k: [] for k in st.params}
    for extra in ("fm_delayed", "cm_delayed", "am_delayed", "pm_delayed",
                  "fm_self", "am_self", "pm_self"):
        new_params[extra] = []
    new_ops = {k: [] for k in st.ops}
    for b in range(B):
        perm = perms[b]
        live = perm >= 0
        inv = np.full(V, -1, dtype=np.int32)
        inv[perm[live]] = np.arange(len(perm), dtype=np.int32)[live]
        for k, arr in st.params.items():
            a = arr[b]
            if a.ndim == 1:          # scalar per segment (volume_final)
                new_params[k].append(a)
                continue
            p = pack_arr(a, perm, fill=-1 if k in _MOD_TYPES else 0)
            if k in _MOD_TYPES:
                old = p                       # original target indices
                remapped = np.where(old >= 0, inv[np.maximum(old, 0)], -1)
                new_params[k].append(remapped.astype(np.int32))
                orig_n = np.broadcast_to(perm[None, :len(perm)],
                                         (a.shape[0], len(perm)))
                flag = np.zeros(old.shape, dtype=np.int32)
                flag[..., :len(perm)] = ((old[..., :len(perm)] >= orig_n)
                                         & live[None, :])
                selff = np.zeros(old.shape, dtype=np.int32)
                selff[..., :len(perm)] = ((old[..., :len(perm)] == orig_n)
                                          & live[None, :])
                key = {"freq_mod_osc": "fm", "amp_mod_osc": "am",
                       "pan_mod_osc": "pm", "cz_mod_osc": "cm"}[k]
                new_params[key + "_delayed"].append(flag)
                if key in ("fm", "am", "pm"):
                    new_params[key + "_self"].append(selff)
            else:
                new_params[k].append(p)
        for k, arr in st.ops.items():
            a = pack_arr(arr[b], perm, fill=-1 if k == "copy_hold_from" else 0)
            if k == "copy_hold_from":
                a = np.where(a >= 0, inv[np.maximum(a, 0)], -1).astype(np.int32)
            new_ops[k].append(a)
    params = {k: np.stack(v) for k, v in new_params.items()}
    ops = {k: np.stack(v) for k, v in new_ops.items()}

    # ---- table-lookup rosters ----
    # The JAX package's lookup rosters (small <= 4096, medium <= 32768,
    # big), kept so both packages pack the same fields.  The port's tier
    # kernel reads every table from the flat buffer and ignores them.
    ts = params["table_size"]                          # [B, S, Vp]
    ti = params["table_index"]
    nz = ti != C.WAVE_TABLE_NOISE_ALT
    med = ((ts > 4096) & (ts <= 32768) & nz).any(axis=1)      # [B, Vp]
    big = ((ts > 32768) & nz).any(axis=1)
    med = med & ~big           # a voice ever binding a >32K table → gather
    params["small_voice"] = np.broadcast_to(
        (~(med | big)).astype(np.int32)[:, None, :], ts.shape).copy()
    params["med_voice"] = np.broadcast_to(
        med.astype(np.int32)[:, None, :], ts.shape).copy()
    vp_ = ts.shape[2]

    def roster(mask, name, width):
        """Dense compaction of ``mask`` columns: entries are voice indices
        local to the slice, ``width`` is the no-op sentinel."""
        gmax = int(mask.sum(axis=1).max()) if mask.size else 0
        if not gmax:
            return
        bm = np.full((B, gmax), width, np.int32)
        for b in range(B):
            w = np.where(mask[b])[0]
            bm[b, : len(w)] = w
        params[name] = np.broadcast_to(
            bm[:, None, :], (B, ts.shape[1], gmax)).copy()

    if tiers is not None:
        # per-tier rosters with tier-local indices (the tiered engine
        # renders each tier's lane slice in its own pass)
        bounds = np.cumsum((0,) + tiers)
        for k in range(len(tiers)):
            s, e = int(bounds[k]), int(bounds[k + 1])
            roster(med[:, s:e], f"med_map_t{k}", e - s)
            roster(big[:, s:e], f"big_map_t{k}", e - s)
    else:
        roster(med, "med_map", vp_)
        roster(big, "big_map", vp_)
    return dataclasses.replace(st, params=params, ops=ops, n_src=n_src,
                               tiers=tiers)


def bucket_key(tl) -> tuple:
    """Specialization bucket for a fused-capable timeline: (packed voice
    count, fixed-point passes, static feature set).  Scripts sharing a
    key render as one batch with one set of static feature flags, the
    same grouping the JAX package's bench uses.

    The single-row pack is memoized on the timeline object (the pack is
    O(segments·voices) Python work; large corpora call this per script
    and then re-pack each group)."""
    cached = getattr(tl, "_bucket_key", None)
    if cached is not None:
        return cached
    from skred_tpu_torch.engine.fused import compute_feat

    st1 = pack_stacked(stack_timelines([tl]))
    key = (st1.params["amp"].shape[-1], tl.fused_passes, compute_feat(st1))
    tl._bucket_key = key
    return key


def cyclic_group_key(tl) -> tuple:
    """The group of a timeline whose modulation graph has a cycle: its
    packed voice count and static feature set (of its cyclic pack), and
    the table each packed lane binds in each segment (``_table_sig``
    taken in the pack's lane order, with the lanes' table sizes).  Each
    row packs its own relevant voices, so lane ``j`` of two scripts can
    be different voices: the bindings are keyed by lane, as the gate
    checks them.  Scripts sharing a key render as one batch with the
    cyclic engine: one kernel build (the count and the features), and
    per-lane tables uniform across the rows, which is all its gate asks
    for; each row renders as it would alone."""
    from skred_tpu_torch.engine.fused import compute_feat

    st1 = pack_stacked(stack_timelines([tl]), cyclic=True)
    # the cyclic pack's lanes: the relevant voices in ascending order
    lanes = _relevant_voices(tl.params)
    sig = np.asarray(_table_sig(tl)).reshape(
        np.shape(tl.params["table_key"]))[..., lanes]
    return (st1.params["amp"].shape[-1], compute_feat(st1),
            tuple(sig.ravel().tolist()),
            st1.params["table_size"][0].tobytes())


def fill_bucket(group: list, vp: int, min_reps: int = 4) -> list:
    """Replicate a bucket's timelines to the JAX package's bench row
    count (2048 rows for the widest and narrowest buckets, else 1024).

    Layout: the distinct scripts first (consumers reading the head rows
    see one of each), then each script's replicas in an ADJACENT run, so
    lanes that bind the same table sit next to each other."""
    target = 2048 if (vp <= 2 or vp > 8) else 1024
    reps = max(min_reps, -(-target // len(group)))
    # scripts bound to the same tables sit adjacent
    group = sorted(group, key=_table_sig)
    rows = list(group)
    for tl in group:
        rows += [tl] * (reps - 1)
    return rows


def _table_sig(tl) -> tuple:
    """Table-binding signature of a timeline: the identity of the table
    array each (segment, voice) slot binds.  Rows sharing a signature
    share table slots after stack_timelines' identity dedup."""
    sig = getattr(tl, "_table_sig", None)
    if sig is None:
        keys = np.asarray(tl.params["table_key"]).ravel()
        arrs = tl.table_arrays
        sig = tuple(id(arrs[k]) if 0 <= k < len(arrs) else -1 for k in keys)
        tl._table_sig = sig
    return sig


def pad_segments_pow2(st: StackedTimelines) -> StackedTimelines:
    """Pad the segment axis to a power of two (repeating the final
    segment) so compiled shapes are duration-independent — repeated
    benches and production batches of similar scripts reuse the
    persistent compile cache."""
    s = st.params["amp"].shape[1]
    sp = 1
    while sp < s:
        sp *= 2
    if sp == s:
        return st

    def pad(a):
        a = np.asarray(a)
        reps = np.repeat(a[:, -1:], sp - s, axis=1)
        return np.concatenate([a, reps], axis=1)

    return dataclasses.replace(
        st, params={k: pad(v) for k, v in st.params.items()},
        ops={k: pad(v) for k, v in st.ops.items()})

