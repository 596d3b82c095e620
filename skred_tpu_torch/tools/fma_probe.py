"""Does nvcc contract ``a*b + c`` into one correctly rounded fma under the
port's flags?

    python -m skred_tpu_torch.tools.fma_probe [--device D]

The counterpart of ``tools/fma_probe.py``, which asks it of Mosaic for
the JAX package's Pallas kernels (there a YES would let exact mode drop
its software fma chain).  Here the question is the port's bit parity:
every kernel builds with ``-fmad=false`` (``engine/kernels/build.py``),
so that the only multiply-adds fused are the ``__fmaf_rn`` calls the
kernels spell out (two faults of the port's fast mode sat at that
boundary: ROADMAP section 3).
The kernel (``engine/kernels/csrc/fma_probe.cu``) writes ``a * b + c``
and ``__fmaf_rn(a, b, c)`` over the original's adversarial inputs (seed
7, ``1 << 20`` values, the same ``rand(scale)``, half the ``c`` cancelling
``a*b``), built twice: with the port's ``NVCC_FLAGS`` and with
``-fmad=true`` in their place (a key of its own under
``build/kernels/``), to show that the flag decides.  Each build prints
the original's line and verdict: CONTRACTED (the plain expression equals
the fma everywhere), NOT-CONTRACTED (it differs from the fma in at least
half the places where two roundings do), MIXED.  The oracle is the card's
own ``__fmaf_rn`` where the original took the software ``_kfma`` chain,
and the tool also states whether that ``__fmaf_rn`` is bit-equal to
``engine/numerics.fma32``, the plain versions' fma (two NaNs count as
equal whatever their payload: ROADMAP section 3).

With ``--device cpu`` there is no nvcc: torch's separate multiply and add
stand in for the plain expression and ``numerics.fma32`` for the fma (the
plain versions' arithmetic), and the ``-fmad=true`` build is not made.
Without a card (and no ``--device cpu``) it prints an error line and
exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

from skred_tpu_torch.tools.card import card_info, require

N = 1 << 20
SEED = 7
# the probe's two builds: the port's flags, and -fmad=true in place of
# -fmad=false (a key element that is an nvcc option: engine/kernels/build.py)
KEYS = {"port flags": (), "-fmad=true": ("-fmad=true",)}


def inputs(n: int = N, seed: int = SEED):
    """The original's adversarial operands: magnitudes spanning ulp
    cancellation, half the c's cancelling a*b.  Returns f32 (a, b, c)."""
    rng = np.random.default_rng(seed)

    def rand(scale):
        m = rng.normal(size=n) * np.exp(rng.uniform(-scale, scale, n))
        return m.astype(np.float32)

    a = rand(20)
    b = rand(20)
    c = np.where(rng.uniform(size=n) < 0.5, -(a * b).astype(np.float32),
                 rand(20)).astype(np.float32)
    return a, b, c


def same_bits(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Per element: the same f32 bits, or both NaN."""
    return (x.view(np.int32) == y.view(np.int32)) | (np.isnan(x)
                                                      & np.isnan(y))


def verdict(plain: np.ndarray, fused: np.ndarray, a, b, c) -> dict:
    """The original's counts and verdict: mismatches of the plain
    expression against the fma, and of two roundings against the fma
    (a sanity count, > 0 on these inputs)."""
    two = np.float32(a * b) + c
    neq = int(np.count_nonzero(~same_bits(plain, fused)))
    neq_two = int(np.count_nonzero(~same_bits(two, fused)))
    word = ("CONTRACTED" if neq == 0 else
            "NOT-CONTRACTED" if neq_two and neq >= neq_two // 2
            else "MIXED")
    return {"mismatches": neq, "two_rounding_mismatches": neq_two,
            "verdict": word}


class FmaArgs(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int)] + [
        (k, ctypes.c_void_p) for k in ("a", "b", "c", "plain", "fused")]


def run_kernel(a, b, c, key, device):
    """(plain, fused) of ``csrc/fma_probe.cu`` built under ``key``."""
    from skred_tpu_torch.engine.kernels import cuda_call

    t = [torch.from_numpy(x).to(device) for x in (a, b, c)]
    outs = [torch.empty_like(t[0]) for _ in range(2)]
    args = FmaArgs(len(a), *(x.data_ptr() for x in t + outs))
    cuda_call.launch("fma_probe", args, torch.device(device), key)
    torch.cuda.synchronize()
    return [o.cpu().numpy() for o in outs]


def probe(device="cuda", n: int = N) -> dict:
    """Run the probe; prints a line a build and returns the record."""
    from skred_tpu_torch.engine.kernels import build
    from skred_tpu_torch.engine.numerics import fma32

    a, b, c = inputs(n)
    ref = fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    card = card_info(device)
    rec = {"n": n, "seed": SEED, "card": card, "builds": {}}
    if torch.device(device).type == "cpu":
        plain = (torch.from_numpy(a) * torch.from_numpy(b)
                 + torch.from_numpy(c)).numpy()
        runs = {"torch on the CPU": (plain, ref)}
    else:
        build.build_all([("fma_probe", k) for k in KEYS.values()])
        runs = {label: run_kernel(a, b, c, key, device)
                for label, key in KEYS.items()}
    for label, (plain, fused) in runs.items():
        r = verdict(plain, fused, a, b, c)
        r["fused_equals_fma32"] = bool(same_bits(fused, ref).all())
        rec["builds"][label] = r
        print(f"{label}: hw-vs-sw mismatches: {r['mismatches']}/{n}  "
              f"(sw-vs-two-rounding: {r['two_rounding_mismatches']} — "
              f"sanity, should be >0)  {r['verdict']}; the fma bit-equal "
              f"to numerics.fma32: {r['fused_equals_fma32']} "
              f"(on {card['name']}, power limit {card['power_limit']})",
              flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fma_probe", description=(
        "Does nvcc contract a*b + c under the port's flags?"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    require(a.device, "fma_probe")
    probe(a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
