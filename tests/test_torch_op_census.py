"""``skred_tpu_torch/tools/op_census.py`` on the CPU: the torch
operations of one steady block (a block of the bucket's second chunk)
of stress64 and noise64 at 8 rows.

The per-site counts sum to the total, and the total equals a direct
dispatch-mode count of the same block.  The glue's count depends on the
script, not on the rows or the block: equal at 8 and at 16 rows and for
two steady blocks.  The plain versions, which run in the kernels' place
on the CPU, are a group of their own, and no glue site lies inside a
kernel module.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from skred_tpu_torch.engine import fused
from skred_tpu_torch.tools import op_census as oc

torch.set_num_threads(1)


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def stress64():
    return oc.census("stress64.sk", 8, "cpu", blocks=2)


def test_sites_sum_to_a_direct_count(stress64):
    rec = stress64
    total = sum(r["count"] for r in rec["sites_by_count"])
    assert total == 2 * (rec["glue_ops_per_block"]
                         + rec["plain_ops_per_block"])
    assert total == sum(r["count"] for r in rec["ops_by_count"])
    assert sum(r["bytes"] for r in rec["sites_by_bytes"]) \
        == sum(r["bytes"] for r in rec["sites_by_count"])
    # the same block counted directly
    bk = oc._bucket("stress64.sk", 8, 1)
    _, r, carry = fused._prepare(bk.st, True, "cpu")
    mode = Count()
    with torch.no_grad():
        carry, _ = fused._block_step(r, carry, 0)
        with mode:
            fused._block_step(r, carry, oc.CHUNK)
    first = rec["per_block"][0]
    assert mode.n == first["glue_ops"] + first["plain_ops"]


def test_glue_does_not_depend_on_rows_or_block(stress64):
    a, b = stress64["per_block"]
    assert (a["block"], b["block"]) == (oc.CHUNK, oc.CHUNK + 1)
    assert a["glue_ops"] == b["glue_ops"] > 0
    assert a["glue_bytes"] == b["glue_bytes"]
    wide = oc.census("stress64.sk", 16, "cpu")
    assert wide["glue_ops_per_block"] == stress64["glue_ops_per_block"]
    assert wide["rows"] == 16 and stress64["rows"] == 8


def test_plain_versions_are_grouped_apart(stress64):
    sites = {r["site"]: r for r in stress64["sites_by_count"]}
    assert sites[oc.PLAIN]["count"] == 2 * stress64["plain_ops_per_block"]
    assert stress64["plain_ops_per_block"] > stress64["glue_ops_per_block"]
    glue = [s for s in sites if s != oc.PLAIN]
    assert glue and all(s.startswith("engine/") and ":" in s
                        and not s.startswith("engine/kernels")
                        for s in glue)
    assert stress64["kernel_launches_per_block"] == 0      # the CPU
    ops = {r["op"] for r in stress64["ops_by_count"]}
    assert oc.PLAIN in ops and "slice" in ops


def test_noise64_and_the_command_line(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(oc, "RECORD", tmp_path / "census.json")
    assert oc.main(["noise64.sk", "--rows", "8", "--device", "cpu",
                    "--top", "5"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("op census noise64.sk (fused, 8 rows")
    assert "top 5 sites by count" in out and "top 5 sites by bytes" in out
    import json

    (rec,) = json.loads((tmp_path / "census.json").read_text())
    assert rec["glue_ops_per_block"] > 0 and rec["plain_ops_per_block"] > 0
    assert rec["views_per_block"] < rec["glue_ops_per_block"]
