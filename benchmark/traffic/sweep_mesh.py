"""The ``sweep_mesh`` traffic: ``sweep``'s render farm over a mesh of the
cell's cards.

The same run as ``sweep.py``'s (its ``run``, unedited: the variants, the
set-up, the closed loop with one job in flight, ``correct`` against the
plain reference), with every ``render_fused`` call given
``mesh=make_mesh(cell.chips)``: the batch's rows split into one run a
card, the shards' blocks stepped in turn by one host thread, the audio
the unsplit render's bit for bit.  ``audio_x_rt`` is per card, as
``sweep.py`` divides it.
"""

from __future__ import annotations

import contextlib
import functools

from benchmark.traffic import sweep

COMPARES_WAV = False
compared_texts = sweep.compared_texts


@contextlib.contextmanager
def _on_mesh(mesh):
    """While open, ``render_fused`` renders over ``mesh``."""
    from skred_tpu_torch.engine import fused

    real = fused.render_fused
    fused.render_fused = functools.partial(real, mesh=mesh)
    try:
        yield
    finally:
        fused.render_fused = real


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", substitute=None) -> int:
    """One run of the cell over ``make_mesh(cell.chips, device)``."""
    from skred_tpu_torch.parallel.batch import make_mesh

    with _on_mesh(make_mesh(cell.chips, device=device)):
        return sweep.run(cell, seed, seconds, trace, t0, device=device,
                         substitute=substitute)
