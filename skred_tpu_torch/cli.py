"""Command-line interface of the port.

  python -m skred_tpu_torch.cli render SCRIPT.sk --seconds 10 --out out.wav
  python -m skred_tpu_torch.cli batch  A.sk B.sk … --seconds 10 --outdir renders/
  python -m skred_tpu_torch.cli repl                 (interactive wire REPL)
  python -m skred_tpu_torch.cli --device cpu render SCRIPT.sk   (no card)

The offline analog of the reference `skred` binary's CLI
(reference: skred.c:194-222 flag parsing, REPL loop :313-347), with the
subcommands of ``skred_tpu.cli``.  Renders run on the card; ``--device
cpu`` runs the kernels' plain versions on the CPU.  Without a card and
without ``--device cpu`` a rendering command fails: it never falls back
to the CPU.  ``cz-show`` draws on the CPU whatever the device.
"""

from __future__ import annotations

import argparse
import pathlib
import sys


def _card_missing(device: str) -> bool:
    """True (and a message on stderr) where ``device`` is a card and no
    card is visible."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {device}: no CUDA card is visible (pass "
              f"--device cpu to render on the CPU)", file=sys.stderr)
        return True
    return False


def cmd_render(args) -> int:
    import numpy as np

    from skred_tpu_torch import spans
    from skred_tpu_torch.assets import WaveBank, bank as bank_mod
    from skred_tpu_torch.engine import render_timeline
    from skred_tpu_torch.host.timeline import compile_script

    script = pathlib.Path(args.script)
    if not script.exists():
        print(f"error: no such script: {script}", file=sys.stderr)
        return 2
    script_dir = script.resolve().parent
    bank = WaveBank()
    lines = script.read_text().splitlines()
    for e in args.execute or []:
        lines.append(e)
    with spans.span("cli.compile") as comp:
        tl = compile_script(lines, args.seconds, bank=bank,
                            script_dir=script_dir)
        comp.n = tl.num_segments
    with spans.span("cli.render") as rend:
        if args.engine == "fused" and tl.fused_passes is not None:
            from skred_tpu_torch.engine.fused import render_fused
            from skred_tpu_torch.parallel.batch import stack_timelines

            out = render_fused(stack_timelines([tl]), device=args.device)[0]
        else:
            out = render_timeline(tl, device=args.device)
    t_compile, t_render = comp.dur_ns / 1e9, rend.dur_ns / 1e9
    dur = len(out) / 44100.0
    print(f"# compiled {comp.n} segments in {t_compile:.2f}s; "
          f"rendered {dur:.2f}s in {t_render:.2f}s "
          f"({dur / max(t_render, 1e-9):.1f}x realtime)")
    out_path = pathlib.Path(args.out or script.with_suffix(".rendered.wav").name)
    if out_path.suffix == ".f32":
        out.astype(np.float32).tofile(out_path)
    else:
        bank_mod.write_wav_16(out_path, out)
    print(f"# wrote {out_path}")
    return 0


def cmd_batch(args) -> int:
    from skred_tpu_torch import spans
    from skred_tpu_torch.parallel.batch import render_batch

    scripts = [pathlib.Path(s) for s in args.scripts]
    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    with spans.span("cli.batch") as whole:
        out = render_batch(scripts, args.seconds, outdir,
                           engine=args.engine, device=args.device)
    wall = whole.dur_ns / 1e9
    audio = out.shape[0] * out.shape[1] / 44100.0
    print(f"# rendered {out.shape[0]} scripts x {out.shape[1] / 44100.0:.2f}s "
          f"in {wall:.2f}s ({audio / max(wall, 1e-9):.1f}x realtime) "
          f"-> {outdir}")
    return 0


def cmd_render_midi(args) -> int:
    import numpy as np  # noqa: F401

    from skred_tpu_torch.assets import WaveBank, bank as bank_mod
    from skred_tpu_torch.engine import render_timeline
    from skred_tpu_torch.frontends.midi import midi_events
    from skred_tpu_torch.host.timeline import compile_script

    events = midi_events(args.midi)
    if not events:
        print("# no note events in MIDI file")
        return 1
    seconds = args.seconds or (events[-1][0] + 2.0)
    lines = []
    sdir = pathlib.Path(args.midi).resolve().parent
    if args.patch:
        patch = pathlib.Path(args.patch)
        lines = patch.read_text().splitlines()
        sdir = patch.resolve().parent
    else:
        chans = sorted({int(l.split()[0][1:]) for _, l in events})
        lines = [f"v{c} w0 a4 t0.005,0.05,0.7,0.2" for c in chans]
    tl = compile_script(lines, seconds, bank=WaveBank(), script_dir=sdir,
                        events=events)
    audio = render_timeline(tl, device=args.device)
    out = pathlib.Path(args.out or pathlib.Path(args.midi).stem + ".wav")
    bank_mod.write_wav_16(out, audio)
    print(f"# rendered {len(events)} MIDI events over {seconds:.2f}s -> {out}")
    return 0


def cmd_repl(args) -> int:
    from skred_tpu_torch.frontends.repl import main as repl_main

    return repl_main(seconds=args.seconds, device=args.device)


def cmd_serve(args) -> int:
    """UDP wire server (reference: udp.c thread, port 60440) — clients
    (Tcl controllers, MIDI bridges, udpmini) send wire text; the
    ``.render [sec] [out.wav]`` meta-command flushes the session to
    audio."""
    import time as _time

    from skred_tpu_torch.assets import WaveBank
    from skred_tpu_torch.frontends.repl import _render
    from skred_tpu_torch.frontends.udp import UdpServer
    from skred_tpu_torch.host import HostEngine

    bank = WaveBank()
    engine = HostEngine(bank.fork())

    def on_render(history, sec, out):
        _render(history, sec, out, bank, args.device)

    srv = UdpServer(engine, script_dir=pathlib.Path.cwd(), port=args.port,
                    on_render=on_render)
    port = srv.start()
    print(f"# skred_tpu serve: UDP wire server on port {port} "
          f"(.render [sec] [out.wav] to flush)")
    tcp_srv = None
    if args.tcp_port is not None:
        from skred_tpu_torch.frontends.tcp import TcpWireServer

        tcp_srv = TcpWireServer(engine, script_dir=pathlib.Path.cwd(),
                                port=args.tcp_port, on_render=on_render)
        tport = tcp_srv.start()
        print(f"# skred_tpu serve: TCP/WebSocket wire server on port {tport}")
    try:
        while True:
            _time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
        if tcp_srv is not None:
            tcp_srv.stop()
    return 0


def cmd_midi_in(args) -> int:
    if args.list:
        from skred_tpu_torch.frontends.seq_midi import format_ports, list_ports

        print(format_ports(list_ports()))
        return 0
    from skred_tpu_torch.frontends.live_midi import main as midi_main

    host, _, port = args.to.partition(":")
    return midi_main(args.port, host or "127.0.0.1",
                     int(port) if port else 60440,
                     voice_offset=args.voice_offset,
                     connect=args.connect or ())


def cmd_cz_show(args) -> int:
    # the curves are a few hundred elementwise ops, never worth a card:
    # cz_view draws them on the CPU whatever --device says
    from skred_tpu_torch.frontends.cz_view import show

    show(modes=args.mode or None, dists=args.d, tsize=args.tsize,
         rows=args.rows, cols=args.cols, wave=args.wave)
    return 0


def cmd_scope(args) -> int:
    if args.png:
        from skred_tpu_torch.frontends.scope_px import export_png

        return export_png(args.script, args.png, seconds=args.seconds,
                          n_frames=args.png_frames, device=args.device)
    from skred_tpu_torch.frontends.scope_view import main as scope_main

    return scope_main(args.script, seconds=args.seconds, fps=args.fps,
                      realtime=not args.fast, window=args.window,
                      device=args.device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="skred_tpu_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda: the "
                         "card; cpu: the kernels' plain versions)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render one .sk script")
    r.add_argument("script")
    r.add_argument("--seconds", type=float, default=10.0)
    r.add_argument("--out", default=None, help=".wav or .f32 output path")
    r.add_argument("-e", "--execute", action="append",
                   help="extra wire command after the script")
    r.add_argument("--engine", choices=("compat", "fused"), default="compat",
                   help="compat = bit-exact scan engine; fused = fast")
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("batch", help="batch-render many scripts")
    b.add_argument("scripts", nargs="+")
    b.add_argument("--seconds", type=float, default=10.0)
    b.add_argument("--outdir", default="renders")
    b.add_argument("--engine", choices=("auto", "compat"), default="auto",
                   help="auto = specialized fused engine per feature "
                        "bucket (fast; parity <= -60 dB vs the reference, "
                        "NOT bit-exact); compat = bit-exact scan engine")
    b.set_defaults(fn=cmd_batch)

    m = sub.add_parser("render-midi",
                       help="render a Standard MIDI File through a patch")
    m.add_argument("midi")
    m.add_argument("--patch", default=None,
                   help=".sk script defining the voices (else sine defaults)")
    m.add_argument("--seconds", type=float, default=None,
                   help="render length (default: last event + 2s)")
    m.add_argument("--out", default=None)
    m.set_defaults(fn=cmd_render_midi)

    p = sub.add_parser("repl", help="interactive wire REPL (offline)")
    p.add_argument("--seconds", type=float, default=4.0,
                   help="render window per interactive evaluation")
    p.set_defaults(fn=cmd_repl)

    s = sub.add_parser("serve", help="UDP wire server (port 60440)")
    s.add_argument("--port", type=int, default=60440)
    s.add_argument("--tcp-port", type=int, default=None, metavar="PORT",
                   help="also serve TCP/WebSocket wire clients on PORT "
                        "(reference tcp_server.c; 0 = ephemeral)")
    s.set_defaults(fn=cmd_serve)

    mi = sub.add_parser("midi-in",
                        help="live MIDI input -> wire over UDP (cmex2)")
    mi.add_argument("--port", default="seq",
                    help="'seq[:NAME]' = ALSA sequencer client (a "
                         "subscribable port, the reference's plug-and-"
                         "play model); hw:X,Y / virtual = rawmidi; or a "
                         "pipe/device path readable as raw MIDI bytes")
    mi.add_argument("--to", default="127.0.0.1:60440",
                    help="wire server host:port")
    mi.add_argument("--voice-offset", type=int, default=0)
    mi.add_argument("--list", action="store_true",
                    help="list sequencer clients/ports and exit")
    mi.add_argument("--connect", action="append", metavar="CLIENT:PORT",
                    help="also subscribe the seq port to this source "
                         "(repeatable; see --list)")
    mi.set_defaults(fn=cmd_midi_in)

    sc = sub.add_parser("scope",
                        help="live trigger-locked scope over a render")
    sc.add_argument("script")
    sc.add_argument("--seconds", type=float, default=10.0)
    sc.add_argument("--fps", type=float, default=30.0)
    sc.add_argument("--fast", action="store_true",
                    help="animate as fast as rendered (no audio-clock pace)")
    sc.add_argument("--window", type=int, default=2048,
                    help="samples per screen")
    sc.add_argument("--png", default=None, metavar="OUT",
                    help="write the reference scope's 800x480 pixel "
                         "picture to OUT instead of animating")
    sc.add_argument("--png-frames", type=int, default=1,
                    help="filmstrip: stack N frames spaced over the render")
    sc.set_defaults(fn=cmd_scope)

    cz = sub.add_parser("cz-show",
                        help="plot the engine's CZ phase-distortion "
                             "curves (reference cz_show analog)")
    cz.add_argument("--mode", type=int, action="append", choices=range(1, 8),
                    help="curve mode (repeatable; default: all 7)")
    cz.add_argument("--d", type=float, nargs="+", default=[0.5],
                    help="distortion amount(s) to overlay")
    cz.add_argument("--tsize", type=int, default=1024)
    cz.add_argument("--rows", type=int, default=17)
    cz.add_argument("--cols", type=int, default=64)
    cz.add_argument("--wave", default=None, metavar="wN",
                    help="draw table[warp(phase)] for bank slot wN "
                         "instead of the transfer curve")
    cz.set_defaults(fn=cmd_cz_show)

    args = ap.parse_args(argv)
    # every command but these two renders on --device
    if args.cmd not in ("midi-in", "cz-show") and _card_missing(args.device):
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
