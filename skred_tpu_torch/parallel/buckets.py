"""The benchmark's buckets: scripts compiled, grouped and packed as the
JAX package's ``bench.py`` groups them (``bench.py:105-175``).

Each script compiles with the native host compiler (``host/native.py``);
only a script that compiler refuses (``NotImplementedError``: recorder
capture or ``/wex``) compiles with the Python one, and each bucket
records which compiled its scripts.  Any other compiler error raises.

Acyclic scripts group by ``bucket_key`` (packed voices, fixed-point
passes, feature set) and fill to ``fill_bucket``'s rows; the TPU's
lane-quantum fill (``_pad_quantum``) is not ported.  Each cyclic script
is a bucket of its own at ``CYCLIC_ROWS`` rows, the JAX bench's count (a
TPU grid quantum there, kept so the figures stay comparable).  The
cyclic scripts the kernel's gate refuses share one compat-scan bucket,
each ``replicas`` times, rendered by the compat engine
(``engine/render.py``), as ``bench.py:371-376`` builds it.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import List, Optional

from skred_tpu_torch import config as C
from skred_tpu_torch.assets.bank import WaveBank
from skred_tpu_torch.host.timeline import compile_script

ROOT = pathlib.Path(__file__).resolve().parents[2]
SCRIPTS = sorted((ROOT / "corpus").glob("*.sk")) \
    + [ROOT / "skred_tpu_torch" / "scripts" / "noise64.sk"]
CYCLIC_ROWS = 1024


@dataclasses.dataclass
class Bucket:
    kind: str                   # "fused", "cyclic" or "compat"
    st: object                  # the batch as it renders (packed but
                                # for "compat": stacked)
    scripts: List[str]          # distinct script names
    compilers: dict             # script name -> "native" | "python"
    voices: int
    row_scripts: List[str]      # the script name of each row of ``st``
    passes: Optional[int] = None
    feat: Optional[str] = None  # the fused bucket's feature set

    @property
    def key(self) -> tuple:
        """The regression gate's key, as the JAX bench keys a bucket."""
        if self.kind == "cyclic":
            return (f"cyclic-{self.voices}v", None, None, self.st.batch)
        return (self.voices, self.passes, self.feat, self.st.batch)


def compile_one(path: pathlib.Path, seconds: float, bank: WaveBank):
    """(Timeline, "native" | "python") of one script."""
    from skred_tpu_torch.host.native import compile_script_native

    lines = path.read_text().splitlines()
    try:
        return compile_script_native(lines, seconds, bank=bank,
                                     script_dir=path.parent), "native"
    except NotImplementedError:
        return compile_script(lines, seconds, bank=bank.fork(),
                              script_dir=path.parent), "python"


def _feat_str(feat) -> str:
    return ",".join(k if v is True else f"{k}={list(v)}"
                    for k, v in feat._asdict().items() if v)


def make_buckets(scripts, seconds: float, replicas: int = 4,
                 max_rows: Optional[int] = None) -> List[Bucket]:
    """The fused buckets in key order, then one cyclic bucket per cyclic
    script the kernel's gate takes, then one compat bucket of the cyclic
    scripts it refuses.  ``max_rows`` cuts every bucket's rows (tests
    only)."""
    from skred_tpu_torch.engine.cyclic import cyclic_gate
    from skred_tpu_torch.parallel.batch import (bucket_key, fill_bucket,
                                                pack_stacked,
                                                pad_segments_pow2,
                                                stack_timelines)

    bank = WaveBank()
    groups, cyclic = {}, []
    compilers = {}
    for p in scripts:
        tl, how = compile_one(pathlib.Path(p), seconds, bank)
        compilers[id(tl)] = (pathlib.Path(p).name, how)
        if tl.fused_passes is None:
            cyclic.append(tl)
        else:
            groups.setdefault(bucket_key(tl), []).append(tl)

    def named(tls):
        return dict(compilers[id(tl)] for tl in tls)

    def row_names(tls):
        return [compilers[id(tl)][0] for tl in tls]

    out = []
    for (vp, passes, feat), group in sorted(groups.items()):
        rows = fill_bucket(group, vp, replicas)[:max_rows]
        st = pad_segments_pow2(pack_stacked(stack_timelines(rows)))
        names = named(group)
        out.append(Bucket("fused", st, sorted(names), names, int(vp),
                          row_names(rows), int(passes), _feat_str(feat)))
    rows = CYCLIC_ROWS if max_rows is None else min(CYCLIC_ROWS, max_rows)
    refused = []
    for tl in cyclic:
        st = pack_stacked(stack_timelines([tl] * rows), cyclic=True)
        if cyclic_gate(st) is not None:
            refused.append(tl)
            continue
        name, how = compilers[id(tl)]
        out.append(Bucket("cyclic", st, [name], {name: how},
                          int(st.params["amp"].shape[-1]), [name] * rows))
    if refused:
        rows = (refused * replicas)[:max_rows]
        names = named(refused)
        out.append(Bucket("compat", stack_timelines(rows), sorted(names),
                          names, C.VOICE_MAX, row_names(rows)))
    return out
