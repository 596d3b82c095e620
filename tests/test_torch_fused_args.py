"""``render_fused``'s arguments: the JAX package's names in its order.

A noise stream other than the engine's own reaches the noise voices, as
in ``skred_tpu.engine.fused.render_fused(st, noise=...)``, and
``pack=False`` packs every voice, as there; the port-only arguments come
after, by keyword only.
"""

import inspect

import numpy as np
import pytest
import torch

from skred_tpu.engine import fused as jf
from skred_tpu_torch.engine import fused as tf
from skred_tpu_torch.parallel import batch as tb
from tests.test_torch_fast_mode import _flushed, _stacks
from tests.test_torch_render import db

torch.set_num_threads(1)


def test_signature_follows_the_jax_package():
    jax_names = [n for n in inspect.signature(jf.render_fused).parameters
                 if n != "use_pallas"]
    params = inspect.signature(tf.render_fused).parameters
    positional = [n for n, p in params.items()
                  if p.kind is p.POSITIONAL_OR_KEYWORD]
    assert positional == jax_names
    assert [n for n, p in params.items() if p.kind is p.KEYWORD_ONLY] \
        == ["device", "mix", "fold"]


def _seeded_noise(total):
    rng = np.random.default_rng(20261017)
    return rng.uniform(-1.0, 1.0, total).astype(np.float32)


# Measured: -131.5 dB; the engine's own stream is +1.4 dB from it.
def test_noise_stream_reaches_the_noise_voices():
    jst, tst = _stacks("noise64", 5 * 512 / 44100.0)
    noise = _seeded_noise(tst.num_blocks * tst.block)
    want = np.asarray(jf.render_fused(jst, noise=noise))
    got = _flushed(tf.render_fused, tst, noise, device="cpu")
    assert got.shape == want.shape
    assert db(want, got) <= -100.0
    own = _flushed(tf.render_fused, tst, device="cpu")
    assert db(want, own) > -20.0, "the stream changed nothing"


# Measured: -130.0 dB.
def test_pack_false_packs_every_voice():
    jst, tst = _stacks("stress64", 5 * 512 / 44100.0)
    want = np.asarray(jf.render_fused(jst, pack=False))
    got = _flushed(tf.render_fused, tst, pack=False, device="cpu")
    assert db(want, got) <= -100.0
    assert tb.pack_stacked(tst, pack=False).params["amp"].shape[-1] == 64


@pytest.mark.parametrize("pack", [True, False])
def test_pack_of_a_packed_batch_changes_nothing(pack):
    """A batch packed already renders as it was packed."""
    _, tst = _stacks("stress64", 5 * 512 / 44100.0)
    st = tb.pack_stacked(tst)
    assert np.array_equal(tf.render_fused(st, pack=pack, device="cpu"),
                          tf.render_fused(st, device="cpu"))
