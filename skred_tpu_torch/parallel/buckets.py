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
TPU grid quantum there, kept so the figures stay comparable).  A cyclic
script the kernel's gate refuses is a ``GateRefusal``: the bench has no
compat-scan bucket to send it to (the compat engine, ``engine/render.py``,
renders it outside the bench).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import List, Optional

from skred_tpu_torch.assets.bank import WaveBank
from skred_tpu_torch.host.timeline import compile_script

ROOT = pathlib.Path(__file__).resolve().parents[2]
SCRIPTS = sorted((ROOT / "corpus").glob("*.sk")) \
    + [ROOT / "skred_tpu_torch" / "scripts" / "noise64.sk"]
CYCLIC_ROWS = 1024


class GateRefusal(Exception):
    """The cyclic kernel's gate refused a script."""

    def __init__(self, script: str, reason: str):
        super().__init__(f"{script}: {reason}")
        self.script, self.reason = script, reason


@dataclasses.dataclass
class Bucket:
    kind: str                   # "fused" or "cyclic"
    st: object                  # the packed batch, as it renders
    scripts: List[str]          # distinct script names
    compilers: dict             # script name -> "native" | "python"
    voices: int
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
    script.  ``max_rows`` cuts every bucket's rows (tests only)."""
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

    out = []
    for (vp, passes, feat), group in sorted(groups.items()):
        rows = fill_bucket(group, vp, replicas)[:max_rows]
        st = pad_segments_pow2(pack_stacked(stack_timelines(rows)))
        names = named(group)
        out.append(Bucket("fused", st, sorted(names), names, int(vp),
                          int(passes), _feat_str(feat)))
    rows = CYCLIC_ROWS if max_rows is None else min(CYCLIC_ROWS, max_rows)
    for tl in cyclic:
        st = pack_stacked(stack_timelines([tl] * rows), cyclic=True)
        name, how = compilers[id(tl)]
        reason = cyclic_gate(st)
        if reason is not None:
            raise GateRefusal(name, reason)
        out.append(Bucket("cyclic", st, [name], {name: how},
                          int(st.params["amp"].shape[-1])))
    return out
