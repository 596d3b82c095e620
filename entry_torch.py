"""The port's entry points (the analogs of __graft_entry__.py).

  entry()               -> (fn, example_args): one batched compat render
                           step on the card (``csrc/compat.cu``) over a
                           small batch, its tensors on the device.
  dryrun_multichip(n)   -> split a script batch over an n-entry mesh of
                           devices and render it with the compat and the
                           fused engine; check shard invariance, the
                           weak-scaling curve and a heterogeneous
                           ``render_batch`` against its unsplit render.

    python3 entry_torch.py [N] [--device cpu]

runs ``entry()``'s step once and ``dryrun_multichip(N)`` (default: one
entry a visible card).  A mesh may name a card more than once
(``parallel/batch.make_mesh``), so ``N`` may exceed the cards.  Imports
torch and the port, never JAX or ``skred_tpu``.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
CORPUS = ROOT / "corpus"
NOISE64 = ROOT / "skred_tpu_torch" / "scripts" / "noise64.sk"
# __graft_entry__.py's inline script (its fall-back without the corpus)
INLINE = ["v0 w0 f440 a4 F1,10", "v1 w0 f1 a50 m1"]


def _sources():
    """Acyclic in-repo scripts of other voice counts, tiers and features:
    the fused engine renders each of them."""
    return [INLINE, (CORPUS / "stress64.sk").read_text().splitlines(),
            NOISE64.read_text().splitlines()]


def _tiny_stacked(batch: int, seconds: float = 0.05, block: int = 128):
    from skred_tpu_torch.assets import WaveBank
    from skred_tpu_torch.host.timeline import compile_script
    from skred_tpu_torch.parallel.batch import stack_timelines

    bank = WaveBank()
    sources = _sources()
    tls = [compile_script(sources[i % len(sources)], seconds, bank=bank,
                          script_dir=CORPUS, block=block)
           for i in range(batch)]
    return stack_timelines(tls)


def entry(device="cuda", seconds: float = 0.05):
    """One batched compat render step: ``fn(inp, carry, noise)`` renders
    every block of a two-row batch (``seconds`` long) through the compat
    kernel with the reference's fmas (exact; the card has
    ``__fmaf_rn``) and returns ``(carry, out [B, T, 2], None)`` on the
    device."""
    import torch

    from skred_tpu_torch.engine.kernels.compat import (compat_block,
                                                       zero_carry)
    from skred_tpu_torch.engine.render import stacked_inputs
    from skred_tpu_torch.host.timeline import noise_stream

    st = _tiny_stacked(batch=2, seconds=seconds)
    passes = st.mod_passes

    def fn(inp, carry, noise):
        return compat_block(inp, carry, noise, 0, inp.num_blocks, passes,
                            exact=True)

    noise = torch.as_tensor(noise_stream(st.num_blocks * st.block),
                            device=device)
    example_args = (stacked_inputs(st, device),
                    zero_carry(st.batch, device), noise)
    return fn, example_args


def dryrun_multichip(n_devices: int, device="cuda",
                     seconds: float = 0.05) -> None:
    """Split the script-batch axis over an ``n_devices``-entry mesh of
    ``device``'s kind and render ``seconds`` of each script with both
    engines (the compat kernel and the fused engine).  Scripts are
    independent: pure data parallelism, no collectives on the render
    path.  Raises on any failed check; prints one summary line."""
    import time

    from skred_tpu_torch.engine.fused import render_fused
    from skred_tpu_torch.host.timeline import noise_stream
    from skred_tpu_torch.parallel.batch import (fused_cost_per_device,
                                                make_mesh, render_batch,
                                                render_stacked)

    mesh = make_mesh(n_devices, device)
    st = _tiny_stacked(batch=n_devices, seconds=seconds)
    noise = noise_stream(st.num_blocks * st.block)
    out = render_stacked(st, mesh=mesh, noise=noise)
    assert out.shape == (n_devices, st.num_blocks * st.block, 2), out.shape
    assert np.isfinite(out).all()
    out2 = render_fused(st, noise, mesh)
    assert out2.shape == out.shape and np.isfinite(out2).all()
    err = float(np.abs(out2 - out).max())
    assert err < 1e-3, f"fused split render diverged from compat: {err}"
    # shard-count invariance: the batch rendered unsplit must be bit for
    # bit what the mesh produced
    out_unsharded = render_fused(st, noise, device=device)
    inv = float(np.abs(out2 - out_unsharded).max())
    assert inv == 0.0, f"mesh render not shard-count invariant: {inv}"
    # rows a device a second on this mesh (correctness evidence, not a
    # speed claim: mesh entries may share a device)
    t0 = time.time()
    render_fused(st, noise, mesh)
    dt = time.time() - t0
    rows_per_dev_s = st.batch / n_devices / max(dt, 1e-9)
    # weak scaling: fixed rows a device over growing meshes; one shard's
    # f32 operations a block must stay flat (every mesh size carries the
    # same script mix: 4 rows a device over 3 cycled sources)
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_devices]
    curve = [fused_cost_per_device(_tiny_stacked(4 * d, seconds),
                                   make_mesh(d, device)) for d in sizes]
    rel = [c / curve[0] for c in curve]
    assert max(rel) <= 1.25, (
        f"weak scaling broken: per-device operations grow with mesh size "
        f"{list(zip(sizes, rel))}")
    scaling = ", ".join(f"{d}dev={r:.3f}" for d, r in zip(sizes, rel))
    # the heterogeneous path: render_batch's buckets (two fused buckets,
    # two cyclic scripts) over the same mesh, a script count that is not
    # a multiple of the device count; every row equals its unsplit render
    het = [CORPUS / "stress64.sk", NOISE64, CORPUS / "fb1.sk",
           CORPUS / "fb4.sk", CORPUS / "fb2.sk"]
    om = render_batch(het, seconds, mesh=mesh)
    o1 = render_batch(het, seconds, device=device)
    het_err = float(np.abs(om - o1).max())
    assert om.shape[0] == len(het) and np.isfinite(om).all()
    assert het_err == 0.0, (
        f"bucketed heterogeneous mesh render diverged: {het_err}")
    print(f"# dryrun_multichip: {n_devices} devices "
          f"({', '.join(str(d) for d in mesh)}), batch {st.batch}, "
          f"out {out.shape}, rms {np.sqrt((out ** 2).mean()):.5f}, "
          f"fused-vs-compat {err:.2e}, shard-invariance {inv:.1e}, "
          f"rows/device/s {rows_per_dev_s:.1f}, "
          f"weak-scaling ops/device rel [{scaling}], "
          f"bucketed-heterogeneous {len(het)} scripts over "
          f"{n_devices} devices max|d| {het_err}")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(prog="entry_torch.py")
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="mesh entries (default: one a visible card)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA card is visible (--device cpu runs on the "
              "CPU)", file=sys.stderr)
        return 1
    fn, example_args = entry(args.device)
    _, out, _ = fn(*example_args)
    print("entry ok:", tuple(out.shape), out.device)
    n = args.n or (torch.cuda.device_count() if args.device == "cuda"
                   else 1)
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
