"""The port's compat engine against the JAX package's on the feedback and
multi-segment scripts, on the CPU (tests/test_torch_render.py says how
and what is left out of the bitwise comparison): corpus/fb2-fb5, fb4 with
its waits cut so that its segments start inside the render, and a voice
copy (``>``, host/wire.py:400, engine.py:612) of a voice with sample &
hold on in a later segment, which the engine applies as its
``copy_hold_from`` state write."""

import numpy as np
import pytest

from tests.test_torch_render import (TWO_BLOCKS, check_render, compile_both,
                                     lines_of)

# fb4 with each ~.5 s wait cut to ~.012 s (529 samples): three or more
# segments in four blocks
FB4_CUT = [ln.replace("~.5", "~.012") for ln in lines_of("fb4")]
FOUR_BLOCKS = 0.0464
# v0 holds each sample for 5 (S&H on), v1 reads it through FM; the later
# segment copies v0 into v2 (its hold state too) and retunes the copy
VOICE_COPY = ["v0 w0 f220 a3 h5 J900 K5000 Q25", "v1 w1 f110 a2 F0,0.5",
              "~.012 v0 >2 v2 f330 a2"]


# Measured: out -136.9 dB (fb2), bit-equal (fb3, fb4, fb5; fb4 cut too);
# the voice copy's out -139.2 dB; capture bit-equal but for fb2's v1.
@pytest.mark.parametrize("name", ["fb2", "fb3", "fb4", "fb5"])
def test_feedback_scripts_match_the_jax_engine(name):
    _, differ = check_render(name, lines_of(name), TWO_BLOCKS)
    assert differ == ([1] if name == "fb2" else [])


def test_segment_ops_match_the_jax_engine():
    """fb4 cut: a table swap, new frequencies and a CZ self edge arrive
    at block starts, each with its segment's state writes."""
    _, ttl = compile_both(FB4_CUT, FOUR_BLOCKS)
    assert ttl.num_blocks == 4 and ttl.num_segments >= 3
    _, differ = check_render("fb4 cut", FB4_CUT, FOUR_BLOCKS)
    assert differ == []


def test_voice_copy_carries_the_hold_state():
    _, ttl = compile_both(VOICE_COPY, TWO_BLOCKS)
    src = ttl.ops["copy_hold_from"]
    assert ttl.num_segments == 2 and (src[0] < 0).all()
    assert src[1, 2] == 0 and ttl.params["hold_max"][1, 2] != 0
    _, differ = check_render("voice copy", VOICE_COPY, TWO_BLOCKS)
    assert differ == []
    assert np.array_equal(np.nonzero(src[1] >= 0)[0], [2])
