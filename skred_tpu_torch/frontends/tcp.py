"""TCP / WebSocket wire-protocol server (reference: tcp_server.c).

The reference ships a select()-based line-oriented TCP server with an
optional RFC-6455 WebSocket mode — handshake via SHA-1 + base64
(tcp_server.c:59-109), masked client text frames decoded to lines
(:112-152), responses sent as unmasked text frames (:155-180).  Only
``example.c`` links it upstream, but it is part of the reference's
remote-control surface, so the framework keeps the capability.

TPU-framework analog: a threaded line server feeding per-client
``WireContext`` sessions (the same session model as the UDP frontend —
state persists per connection) and replying with each command's printed
output.  The protocol is auto-detected per connection: a client whose
first bytes form an HTTP Upgrade request gets the WebSocket handshake
and framed text; anything else is plain newline-terminated wire text.
``.render [sec] [out.wav]`` flushes the accumulated history to audio,
exactly like the UDP server's meta-command.
"""

from __future__ import annotations

import base64
import hashlib
import pathlib
import socket
import threading

TCP_PORT = 60441  # one above the reference UDP port (udp.h:4)
_WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"  # RFC 6455 / sha1.c use


def ws_accept_key(key: str) -> str:
    """Sec-WebSocket-Accept for a client key (tcp_server.c:84-93)."""
    digest = hashlib.sha1(key.strip().encode() + _WS_GUID).digest()
    return base64.b64encode(digest).decode()


def ws_encode(payload: bytes) -> bytes:
    """One unmasked FIN text frame (tcp_server.c:155-180)."""
    n = len(payload)
    if n < 126:
        head = bytes((0x81, n))
    elif n < (1 << 16):
        head = bytes((0x81, 126)) + n.to_bytes(2, "big")
    else:
        head = bytes((0x81, 127)) + n.to_bytes(8, "big")
    return head + payload


def ws_decode(buf: bytearray):
    """Decode one complete client frame from ``buf`` in place.

    Returns (opcode, payload) or None if the frame is incomplete.
    Client frames must be masked (tcp_server.c:136)."""
    if len(buf) < 2:
        return None
    opcode = buf[0] & 0x0F
    masked = bool(buf[1] & 0x80)
    n = buf[1] & 0x7F
    off = 2
    if n == 126:
        if len(buf) < 4:
            return None
        n = int.from_bytes(buf[2:4], "big")
        off = 4
    elif n == 127:
        if len(buf) < 10:
            return None
        n = int.from_bytes(buf[2:10], "big")
        off = 10
    if not masked:
        del buf[:]          # protocol error: drop the buffer
        return (0x8, b"")
    if len(buf) < off + 4 + n:
        return None
    mask = buf[off:off + 4]
    data = bytes(b ^ mask[i % 4] for i, b in
                 enumerate(buf[off + 4:off + 4 + n]))
    del buf[:off + 4 + n]
    return (opcode, data)


class TcpWireServer:
    """Line/WebSocket wire server over one listening socket."""

    def __init__(self, engine, script_dir: pathlib.Path | None = None,
                 port: int = TCP_PORT, on_render=None):
        from skred_tpu_torch.host.wire import WireContext

        self.engine = engine
        self.port = port
        self.script_dir = script_dir or pathlib.Path.cwd()
        self.on_render = on_render
        self.history: list[str] = []
        self._ctx_cls = WireContext
        self.sock: socket.socket | None = None
        self.thread: threading.Thread | None = None
        self.running = False
        self._lock = threading.Lock()

    # ---- shared wire dispatch (one engine, per-connection session) ----
    def handle(self, line: str, ctx) -> list[str]:
        line = line.rstrip("\r\n")
        if not line:
            return []
        if line.startswith(".render"):
            if self.on_render:
                parts = line.split()
                sec = float(parts[1]) if len(parts) > 1 else 4.0
                out = parts[2] if len(parts) > 2 else "tcp.wav"
                self.on_render(list(self.history), sec, out)
            return [f"# render requested ({line})"]
        with self._lock:
            self.history.append(line)
            ctx.wire(line)
            replies = list(ctx.prints)
            ctx.prints.clear()
        return replies

    # ---- per-connection protocol loops ----
    def _client(self, conn: socket.socket) -> None:
        conn.settimeout(1.0)
        ctx = self._ctx_cls(self.engine, self.script_dir, output=True)
        buf = bytearray()
        ws = None          # None = undecided, False = plain, True = websocket
        try:
            while self.running:
                try:
                    data = conn.recv(4096)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not data:
                    break
                buf += data
                if ws is None:
                    if buf[:4] in (b"GET ", b"GET\t") or \
                            (len(buf) < 4 and b"GET "[: len(buf)] == buf):
                        if len(buf) < 4:
                            continue
                        ws = True
                    else:
                        ws = False
                if ws and b"\r\n\r\n" in buf:
                    head, _, rest = bytes(buf).partition(b"\r\n\r\n")
                    buf = bytearray(rest)
                    key = ""
                    for ln in head.decode("latin-1").split("\r\n"):
                        if ln.lower().startswith("sec-websocket-key:"):
                            key = ln.split(":", 1)[1]
                    conn.sendall(
                        b"HTTP/1.1 101 Switching Protocols\r\n"
                        b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                        b"Sec-WebSocket-Accept: "
                        + ws_accept_key(key).encode() + b"\r\n\r\n")
                    ws = "framed"
                if ws == "framed":
                    while True:
                        fr = ws_decode(buf)
                        if fr is None:
                            break
                        op, payload = fr
                        if op == 0x8:           # close -> close reply
                            conn.sendall(bytes((0x88, 0x00)))
                            return
                        if op == 0x9:           # ping -> pong
                            conn.sendall(bytes((0x8A, len(payload)))
                                         + payload)
                            continue
                        for line in payload.decode("utf-8",
                                                   "replace").splitlines():
                            for r in self.handle(line, ctx):
                                conn.sendall(ws_encode(r.encode()))
                elif ws is False:
                    while b"\n" in buf:
                        raw, _, rest = bytes(buf).partition(b"\n")
                        buf = bytearray(rest)
                        for r in self.handle(
                                raw.decode("utf-8", "replace"), ctx):
                            conn.sendall(r.encode() + b"\n")
        except Exception:
            pass               # the reference server survives bad clients
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _loop(self) -> None:
        assert self.sock is not None
        while self.running:
            try:
                conn, _addr = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._client, args=(conn,),
                             daemon=True, name="tcp-client").start()

    def start(self) -> int:
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.settimeout(1.0)
        self.sock.bind(("0.0.0.0", self.port))
        self.port = self.sock.getsockname()[1]
        self.sock.listen(8)
        self.running = True
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="tcp")
        self.thread.start()
        return self.port

    def stop(self) -> None:
        self.running = False
        if self.sock is not None:
            self.sock.close()
