"""The port's copies of the JAX package's ``frontends/`` modules against
the originals, on the CPU.

Six copies are the originals' text but for import paths; four point
their engine calls at the port (``repl``, ``scope_view``, ``scope_px``
render on a device given to them, ``cz_view`` draws with the port's
``cz_phasor``).  Each copy's output on the same input is the original's:
the CZ curves array-equal for all seven modes at two distortions, the
rasterizers, the PNG writer, the MIDI parsers, the controllers, and the
UDP and TCP wire servers (on localhost, with timeouts) driving the port's
and the JAX package's host engines to the same state.  Mirrors
tests/test_frontends.py, test_cz_view.py, test_scope_view.py,
test_scope_px.py, test_midi.py and test_live_midi.py.
"""

import importlib
import io
import pathlib
import socket
import threading
import time
import wave

import numpy as np
import pytest

from skred_tpu import frontends as J
from skred_tpu.frontends import controllers as jctl
from skred_tpu.frontends import cz_view as jcz
from skred_tpu.frontends import live_midi as jlm
from skred_tpu.frontends import midi as jmidi
from skred_tpu.frontends import repl as jrepl
from skred_tpu.frontends import scope_px as jpx
from skred_tpu.frontends import scope_view as jsv
from skred_tpu.frontends import seq_midi as jsm
from skred_tpu.frontends import tcp as jtcp
from skred_tpu.frontends import udp as judp
from skred_tpu.host import HostEngine as JHost
from skred_tpu_torch import frontends as T
from skred_tpu_torch.frontends import controllers as tctl
from skred_tpu_torch.frontends import cz_view as tcz
from skred_tpu_torch.frontends import live_midi as tlm
from skred_tpu_torch.frontends import midi as tmidi
from skred_tpu_torch.frontends import repl as trepl
from skred_tpu_torch.frontends import scope_px as tpx
from skred_tpu_torch.frontends import scope_view as tsv
from skred_tpu_torch.frontends import seq_midi as tsm
from skred_tpu_torch.frontends import tcp as ttcp
from skred_tpu_torch.frontends import udp as tudp
from skred_tpu_torch.host import HostEngine as THost
from tests.test_live_midi import FakeSeqLib, _ctrl_ev, _note_ev
from tests.test_midi import make_test_midi

VERBATIM = ["controllers", "midi", "udp", "tcp", "seq_midi", "live_midi"]
EDITED = ["repl", "scope_view", "scope_px", "cz_view"]


def _source(pkg, name):
    return pathlib.Path(pkg.__file__).with_name(f"{name}.py").read_text()


@pytest.mark.parametrize("name", VERBATIM + EDITED)
def test_copy_is_the_original_but_for_imports(name):
    """Line for line, once the port's package name reads as the
    original's; an edited copy differs only in its engine calls."""
    orig = _source(J, name).splitlines()
    copy = _source(T, name).replace("skred_tpu_torch",
                                    "skred_tpu").splitlines()
    if name in VERBATIM:
        assert copy == orig
    else:
        import difflib

        changed = [ln for ln in difflib.unified_diff(orig, copy, n=0)
                   if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
        assert changed and len(changed) <= 40, changed
        assert not any("jax" in ln for ln in changed if ln[0] == "+")
    mod = importlib.import_module(f"skred_tpu_torch.frontends.{name}")
    assert mod.__name__.startswith("skred_tpu_torch")


# ---- cz_view ----

@pytest.mark.parametrize("d", [0.33, 0.9])
@pytest.mark.parametrize("mode", range(1, 8))
def test_warp_curve_equals_the_original(mode, d):
    want = jcz.warp_curve(mode, d, 1024, points=256)
    got = tcz.warp_curve(mode, d, 1024, points=256)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("wave_slot", [None, "w0"])
def test_cz_show_equals_the_original(wave_slot):
    outs = []
    for m in (jcz, tcz):
        buf = io.StringIO()
        m.show(modes=[2, 5], dists=[0.25, 0.9], rows=9, cols=32,
               wave=wave_slot, out=buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "cz mode 5" in outs[1]


# ---- scope_view, scope_px ----

def _sine(n, period=100, amp=1.0):
    s = amp * np.sin(2 * np.pi * np.arange(n) / period).astype(np.float32)
    return np.stack([s, 0.5 * s], axis=-1)


def test_scope_view_equals_the_original():
    w = np.random.default_rng(3).normal(size=(400, 2)).astype(np.float32)
    for kw in ({}, {"show_l": False}, {"show_r": False}):
        assert tsv.render_frame(w, rows=11, cols=40, **kw) \
            == jsv.render_frame(w, rows=11, cols=40, **kw)
    texts = []
    for m in (jsv, tsv):
        out = io.StringIO()
        chunks = [_sine(4410, period=147) for _ in range(3)]
        v = m.animate(iter(chunks), fps=30.0, realtime=False, out=out,
                      max_frames=5)
        texts.append((out.getvalue(), v.last_frame, v.ring.total))
    assert texts[0] == texts[1]


def test_scope_px_equals_the_original(tmp_path):
    img = tpx.render_pixels(_sine(tpx.WIDTH), gain=0.8)
    assert np.array_equal(img, jpx.render_pixels(_sine(jpx.WIDTH), gain=0.8))
    tpx.write_png(tmp_path / "t.png", img)
    jpx.write_png(tmp_path / "j.png", img)
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
    frames = [m.scope_frames(iter([_sine(4410, period=50)] * 10), 3,
                             frame_every=11025) for m in (jpx, tpx)]
    assert all(np.array_equal(a, b) for a, b in zip(*frames))


def test_scope_png_of_a_script_equals_the_original(tmp_path):
    """export_png renders the script (the port on the CPU) and draws the
    same pixels as the original from its own render."""
    script = tmp_path / "s.sk"
    script.write_text("v0 w0 f220 a3\nv1 w1 f330 a2 p0.4\n")
    jpx.export_png(str(script), str(tmp_path / "j.png"), seconds=0.1)
    tpx.export_png(str(script), str(tmp_path / "t.png"), seconds=0.1,
                   device="cpu")
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()


# ---- midi, live_midi, seq_midi, controllers ----

def test_midi_events_equal_the_original(tmp_path):
    f = tmp_path / "t.mid"
    make_test_midi(f)
    assert tmidi.midi_events(f) == jmidi.midi_events(f)
    assert len(tmidi.midi_events(f)) == 4


def test_live_midi_parser_and_mapping_equal_the_original():
    stream = bytes([0x90, 60, 100, 62, 0x7F, 0xF8, 60, 0, 0x80, 62, 64,
                    0xF0, 1, 2, 3, 0xF7, 0xB0, 7, 99, 0x93, 72, 1,
                    0xE0, 0, 64])
    msgs = [list(m.MidiByteParser().feed(stream)) for m in (jlm, tlm)]
    assert msgs[0] == msgs[1] and len(msgs[1]) == 7
    for off in (0, 4):
        assert [tlm.cmex2_wire(m, voice_offset=off) for m in msgs[1]] \
            == [jlm.cmex2_wire(m, voice_offset=off) for m in msgs[0]]


def test_seq_midi_equals_the_original():
    events = [_note_ev(jsm.EV_NOTEON, 2, 69, 100),
              _note_ev(jsm.EV_NOTEON, 2, 69, 0),
              _note_ev(jsm.EV_KEYPRESS, 1, 60, 33),
              _ctrl_ev(jsm.EV_CONTROLLER, 0, 7, 99),
              _ctrl_ev(jsm.EV_PITCHBEND, 0, 0, -8192),
              _note_ev(jsm.EV_PORT_SUBSCRIBED, 0, 0, 0)]
    assert [tsm.seq_event_to_midi(e) for e in events] \
        == [jsm.seq_event_to_midi(e) for e in events]
    lines = []
    for m in (jsm, tsm):
        lib = FakeSeqLib(list(events))
        got = []
        src = m.AlsaSeqInput(name="x", connect=["20:0"], lib=lib)
        jlm.MidiBridge(src, got.append).run()
        src.close()
        lines.append((got, lib.created_ports, lib.connected))
    assert lines[0] == lines[1]
    clients = [(20, "Keys", [(0, "MIDI 1", jsm.SND_SEQ_PORT_CAP_READ
                              | jsm.SND_SEQ_PORT_CAP_SUBS_READ)])]
    assert tsm.format_ports(tsm.list_ports(lib=FakeSeqLib(clients=clients))) \
        == jsm.format_ports(jsm.list_ports(lib=FakeSeqLib(clients=clients)))


def test_controllers_equal_the_original():
    def run(m):
        sent = []
        s = m.amper(send=sent.append)
        pad = m.PadGrid(["[v0l1]", "[v0l0]"], pattern=3)
        return (s.set(5.0), s.set(99.0), sent,
                m.Slider(0, 1, 0.00001, "c1,%s").set(0.5),
                pad.toggle(0), pad.toggle(0),
                m.adsr_text(0.2, 0.1, 0.2, 0.5), m.note_cycle())
    assert run(tctl) == run(jctl)


# ---- the wire servers (localhost) ----

WIRE = ["v3 w0 f220 a5", "v4 a2 p-0.5", "v3 E.2,.1,.2,.5 l1"]


def _state(engine):
    return [np.asarray(getattr(engine, k)).tolist()
            for k in ("amp", "freq", "pan", "env_active")]


def _udp_session(mod, engine, tmp_path):
    rendered = {}

    def on_render(history, sec, out):
        rendered["history"], rendered["sec"] = list(history), sec

    srv = mod.UdpServer(engine, script_dir=tmp_path, port=0,
                        on_render=on_render)
    srv.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    srv.sock.bind(("127.0.0.1", 0))
    srv.sock.settimeout(0.2)
    port = srv.sock.getsockname()[1]
    srv.running = True
    t = threading.Thread(target=srv._loop, daemon=True)
    t.start()
    try:
        c = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for line in WIRE + [".render 1.5 out.wav"]:
            c.sendto(line.encode(), ("127.0.0.1", port))
        deadline = time.time() + 5
        while time.time() < deadline and "history" not in rendered:
            time.sleep(0.02)
        c.close()
    finally:
        srv.stop()
    return rendered, _state(engine)


def test_udp_server_equals_the_original(tmp_path):
    want = _udp_session(judp, JHost(), tmp_path)
    got = _udp_session(tudp, THost(), tmp_path)
    assert got == want and want[0]["history"] == WIRE
    ip = socket.inet_aton("127.0.0.1")
    assert tudp._hash_addr(ip, 12345) == judp._hash_addr(ip, 12345)


def _tcp_session(mod, engine):
    srv = mod.TcpWireServer(engine, port=0)
    port = srv.start()
    try:
        c = socket.create_connection(("127.0.0.1", port), timeout=3)
        c.sendall(("\n".join(WIRE) + "\n?\n").encode())
        buf = b""
        deadline = time.time() + 5
        while time.time() < deadline and b"f220" not in buf:
            try:
                buf += c.recv(4096)
            except socket.timeout:
                break
        c.close()
    finally:
        srv.stop()
    return buf, _state(engine)


def test_tcp_server_equals_the_original():
    want = _tcp_session(jtcp, JHost())
    got = _tcp_session(ttcp, THost())
    assert got == want and b"v3" in got[0]
    assert ttcp.ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==") \
        == jtcp.ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==")


# ---- repl ----

def _wav_frames(path):
    with wave.open(str(path)) as f:
        return np.frombuffer(f.readframes(f.getnframes()), np.int16)


def test_repl_render_equals_the_original(tmp_path, monkeypatch):
    """The REPL's ``.render`` of a session history: the port's compat
    engine on the CPU against the original's, sample for sample within
    one step of the 16-bit WAV; the completer as the original's."""
    from skred_tpu.assets import WaveBank as JBank
    from skred_tpu_torch.assets import WaveBank as TBank

    monkeypatch.chdir(tmp_path)
    history = ["v0 w0 f220 a3", "v1 w2 f3 a1", "v0 F1,0.4"]
    jrepl._render(history, 0.05, str(tmp_path / "j.wav"), JBank())
    trepl._render(history, 0.05, str(tmp_path / "t.wav"), TBank(),
                  device="cpu")
    want, got = _wav_frames(tmp_path / "j.wav"), _wav_frames(tmp_path
                                                             / "t.wav")
    assert got.shape == want.shape and np.abs(want).max() > 1000
    assert np.abs(got.astype(np.int32) - want).max() <= 1
    for text in ("/", "/l", ".r", ":w"):
        assert [trepl._completer(text, i) for i in range(20)] \
            == [jrepl._completer(text, i) for i in range(20)]
