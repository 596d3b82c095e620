"""Interactive wire REPL (offline analog of the reference REPL,
skred.c:313-347).

Commands execute live against a persistent host engine; state queries
(``?``, ``??``, ``z``, ``Z``) print exactly as the reference does.  Since
there is no real-time audio thread, the meta-command ``.render [sec]
[out.wav]`` replays the whole session history through the timeline
compiler and renders the window to a WAV file; ``.reset`` clears the
session.  History is kept in ``.skred_tpu_history``.  Renders run on
the card unless ``device="cpu"``.
"""

from __future__ import annotations

import pathlib

HISTORY_FILE = ".skred_tpu_history"


# completion vocabulary (bestline offers completion hooks; the reference
# doesn't populate them, so this is a strict superset of its editor):
# meta-commands, the /-system commands (wire.c:762-858) and :aliases
_COMPLETIONS = (
    ".render", ".reset", ".quit",
    "/q", "/d", "/t", "/v", "/i", "/s", "/S", "/o", "/l", "/w", "/m",
    ":w", ":wex", ":q",
)


def _completer(text: str, state: int):
    """readline completer: meta/system commands, plus N.sk script names
    after /l (patch loader, wire.c:342)."""
    cands = [c for c in _COMPLETIONS if c.startswith(text)]
    if text.startswith("/l"):
        stem = text[2:]
        cands += sorted(
            "/l" + p.stem for p in pathlib.Path.cwd().glob("*.sk")
            if p.stem.startswith(stem))
    return cands[state] if state < len(cands) else None


def main(seconds: float = 4.0, device="cuda") -> int:
    import readline  # line editing like bestline

    from skred_tpu_torch.assets import WaveBank
    from skred_tpu_torch.host import HostEngine, WireContext

    readline.set_completer(_completer)
    readline.set_completer_delims(" \t")
    readline.parse_and_bind("tab: complete")

    hist = pathlib.Path(HISTORY_FILE)
    try:
        readline.read_history_file(hist)
    except (FileNotFoundError, OSError):
        pass

    bank = WaveBank()
    engine = HostEngine(bank.fork())
    ctx = WireContext(engine, script_dir=pathlib.Path.cwd(), output=True)
    history: list[str] = []

    print("# skred_tpu repl — wire commands; .render [sec] [out.wav], "
          ".reset, .quit")
    while True:
        try:
            line = input("# ")
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if not line.strip():
            continue
        readline.append_history_file(1, hist) if hist.exists() else \
            readline.write_history_file(hist)
        if line.startswith(".quit") or line.startswith("/q"):
            break
        if line.startswith(".reset"):
            engine = HostEngine(bank.fork())
            ctx = WireContext(engine, script_dir=pathlib.Path.cwd(), output=True)
            history = []
            continue
        if line.startswith(".render"):
            parts = line.split()
            sec = float(parts[1]) if len(parts) > 1 else seconds
            out = parts[2] if len(parts) > 2 else "repl.wav"
            _render(history, sec, out, bank, device)
            continue
        history.append(line)
        r = ctx.wire(line)
        for p in ctx.prints:
            print(p)
        ctx.prints.clear()
        if r < 0:
            break
    return 0


def _render(history: list[str], sec: float, out: str, bank,
            device="cuda") -> None:
    from skred_tpu_torch import spans
    from skred_tpu_torch.assets.bank import write_wav_16
    from skred_tpu_torch.engine import render_timeline
    from skred_tpu_torch.host.timeline import compile_script

    with spans.span("repl.render") as whole:
        with spans.span("repl.compile") as comp:
            tl = compile_script(list(history), sec, bank=bank,
                                script_dir=pathlib.Path.cwd())
            comp.n = tl.num_segments
        audio = render_timeline(tl, device=device)
        with spans.span("repl.write_wav"):
            write_wav_16(out, audio)
    print(f"# rendered {sec:g}s -> {out} in {whole.dur_ns / 1e9:.2f}s "
          f"({comp.n} segments)")
