"""UDP wire-protocol server (reference: udp.c, default port 60440).

The reference's remote-control plane: any client (the Tcl GUIs, MIDI
bridges, `udpmini`) sends wire text as datagrams; each client address gets
its own session context (hashed into 127 slots, udp.c:26-37,107-112).

Offline analog: commands mutate a shared host engine live (and are
recorded); a client can send the meta-command ``.render [sec] [out.wav]``
to flush the accumulated session to audio.  This keeps every Tcl
controller and MIDI bridge in the reference ecosystem functional against
the TPU renderer.
"""

from __future__ import annotations

import pathlib
import socket
import threading

UDP_PORT = 60440  # reference udp.h:4
SLOTS = 127       # reference udp.c:79


def _hash_addr(ip: bytes, port: int) -> int:
    """Knuth multiplicative hash of ip:port (udp.c:26-37)."""
    ipv = int.from_bytes(ip, "little")
    h = (ipv ^ ((port << 16) & 0xFFFFFFFF) ^ port) & 0xFFFFFFFF
    h = (h * 2654435761) & 0xFFFFFFFF
    return h % SLOTS


class UdpServer:
    def __init__(self, engine, script_dir: pathlib.Path | None = None,
                 port: int = UDP_PORT, on_render=None):
        from skred_tpu_torch.host.wire import WireContext

        self.engine = engine
        self.port = port
        self.script_dir = script_dir or pathlib.Path.cwd()
        self.on_render = on_render
        self.history: list[str] = []
        self._ctx_cls = WireContext
        self.sessions = [None] * SLOTS
        self.sock: socket.socket | None = None
        self.thread: threading.Thread | None = None
        self.running = False

    def _session(self, addr):
        ip = socket.inet_aton(addr[0])
        idx = _hash_addr(ip, addr[1])
        if self.sessions[idx] is None:
            self.sessions[idx] = self._ctx_cls(self.engine, self.script_dir)
        return self.sessions[idx]

    def handle(self, line: str, addr) -> None:
        if line.startswith(".render"):
            if self.on_render:
                parts = line.split()
                sec = float(parts[1]) if len(parts) > 1 else 4.0
                out = parts[2] if len(parts) > 2 else "udp.wav"
                self.on_render(list(self.history), sec, out)
            return
        self.history.append(line)
        ctx = self._session(addr)
        ctx.wire(line)

    def _loop(self) -> None:
        assert self.sock is not None
        while self.running:
            try:
                data, addr = self.sock.recvfrom(1024)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self.handle(data.decode("utf-8", "replace").rstrip("\x00"), addr)
            except Exception:
                pass  # the reference UDP thread survives bad packets

    def start(self) -> int:
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.settimeout(1.0)
        self.sock.bind(("0.0.0.0", self.port))
        self.running = True
        self.thread = threading.Thread(target=self._loop, daemon=True, name="udp")
        self.thread.start()
        return self.port

    def stop(self) -> None:
        self.running = False
        if self.sock is not None:
            self.sock.close()
