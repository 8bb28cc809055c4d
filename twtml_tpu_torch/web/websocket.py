"""RFC 6455 websockets on the standard library: the server side over
``asyncio`` streams, and a small blocking client on ``socket``.

The JAX package's dashboard server takes its websockets from ``aiohttp``
(``twtml_tpu/web/server.py``); the port's server runs where only the
standard library is, so the protocol is written here, with aiohttp's
server defaults where the RFC leaves a choice:

- the handshake answers ``Sec-WebSocket-Accept`` = base64(SHA-1(key +
  GUID)) and negotiates no extension or subprotocol;
- client frames must be masked (an unmasked one is a protocol error,
  close 1002); server frames are not;
- payload lengths take the 7-, 16- and 64-bit forms; a message may arrive
  in continuation frames and is reassembled; a message of ``MAX_MESSAGE``
  (4 MiB, aiohttp's ``max_msg_size``) or more closes with 1009;
  text that is not UTF-8 closes with 1007;
- a ping is answered with a pong of the same payload; a close is answered
  with a close (1000, as aiohttp answers) and ends the socket;
- a heartbeat (aiohttp's ``heartbeat=30``): after ``heartbeat`` seconds
  without a frame from the client the server pings, and closes the
  connection when no pong arrives within half that.

``WebSocketClient`` is the blocking client the port's tests and
``chip_smoke.py`` drive a server with.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import os
import socket
import struct
from urllib.parse import urlsplit

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_MESSAGE = 4 * 1024 * 1024
HEARTBEAT_S = 30.0

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA

CLOSE_OK = 1000
CLOSE_PROTOCOL = 1002
CLOSE_INVALID_TEXT = 1007
CLOSE_TOO_BIG = 1009


class ProtocolError(Exception):
    """A frame the RFC forbids; ``code`` is the close code to send."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def accept_key(key: str) -> str:
    """The ``Sec-WebSocket-Accept`` value for a client's key."""
    digest = hashlib.sha1((key + GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def valid_key(key: str) -> bool:
    """A client key is the base64 of 16 bytes (decoded as aiohttp decodes
    it)."""
    try:
        return len(base64.b64decode(key)) == 16
    except ValueError:
        return False


def apply_mask(data: bytes, mask: bytes) -> bytes:
    """XOR ``data`` with the repeated 4-byte ``mask`` (masking and unmasking
    are the same operation), as one wide-integer XOR."""
    if not data:
        return b""
    n = len(data)
    key = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "little") ^ int.from_bytes(key, "little")).to_bytes(n, "little")


def encode_frame(opcode: int, payload: bytes, fin: bool = True, mask: bytes | None = None) -> bytes:
    """One frame: the 7-, 16- or 64-bit length form by size; masked with
    ``mask`` (a client's frame) or not (a server's)."""
    head = bytearray([(0x80 if fin else 0) | opcode])
    bit = 0x80 if mask is not None else 0
    n = len(payload)
    if n < 126:
        head.append(bit | n)
    elif n < 1 << 16:
        head.append(bit | 126)
        head += struct.pack("!H", n)
    else:
        head.append(bit | 127)
        head += struct.pack("!Q", n)
    if mask is None:
        return bytes(head) + payload
    return bytes(head) + mask + apply_mask(payload, mask)


def close_payload(code: int, reason: str = "") -> bytes:
    return struct.pack("!H", code) + reason.encode("utf-8")


def parse_close(payload: bytes) -> tuple[int | None, str]:
    if len(payload) < 2:
        return None, ""
    return struct.unpack("!H", payload[:2])[0], payload[2:].decode("utf-8", "replace")


class ServerWebSocket:
    """The server end of one upgraded connection. ``receive()`` returns
    each text or binary message as ``(opcode, payload)`` and None once the
    socket has closed; control frames are handled inside it."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 heartbeat: float = HEARTBEAT_S, max_message: int = MAX_MESSAGE):
        self._reader = reader
        self._writer = writer
        self.heartbeat = heartbeat
        self.max_message = max_message
        self.closed = False
        self.close_code: int | None = None
        self._close_sent = False
        self._reading = False
        self._peer_closed = asyncio.Event()
        self._pong = asyncio.Event()
        self._heartbeat_task: asyncio.Task | None = None
        self._last_frame = asyncio.get_running_loop().time()

    # -- sending ---------------------------------------------------------------
    async def _send(self, opcode: int, payload: bytes) -> None:
        if self.closed or self._writer.is_closing():
            raise ConnectionResetError("websocket is closed")
        self._writer.write(encode_frame(opcode, payload))
        await self._writer.drain()

    async def send_text(self, text: str) -> None:
        await self._send(OP_TEXT, text.encode("utf-8"))

    async def ping(self, payload: bytes = b"") -> None:
        await self._send(OP_PING, payload)

    async def close(self, code: int = CLOSE_OK, reason: str = "", wait: float = 1.0) -> None:
        """Send a close frame (once), read to the peer's close for up to
        ``wait`` s (the reading ``receive`` sees it, or this call reads and
        drops frames itself), then end the connection."""
        if not self.closed and not self._close_sent:
            self._close_sent = True
            self.close_code = code
            try:
                self._writer.write(encode_frame(OP_CLOSE, close_payload(code, reason)))
                await asyncio.wait_for(self._writer.drain(), wait)
                peer = self._peer_closed.wait() if self._reading else self._read_to_close()
                await asyncio.wait_for(peer, wait)
            except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError, ProtocolError):
                pass
        self.abort()

    async def _read_to_close(self) -> None:
        while not self._peer_closed.is_set():
            _, opcode, _ = await self._frame()
            if opcode == OP_CLOSE:
                self._peer_closed.set()

    def abort(self) -> None:
        """End the connection now, without a close handshake."""
        self.closed = True
        if self._heartbeat_task is not None:
            self._heartbeat_task.cancel()
        self._writer.close()

    # -- the heartbeat ---------------------------------------------------------
    def start_heartbeat(self) -> None:
        if self.heartbeat and self.heartbeat > 0:
            self._heartbeat_task = asyncio.get_running_loop().create_task(self._beat())

    async def _beat(self) -> None:
        loop = asyncio.get_running_loop()
        while not self.closed:
            idle = loop.time() - self._last_frame
            if idle < self.heartbeat:
                await asyncio.sleep(self.heartbeat - idle)
                continue
            self._pong.clear()
            try:
                await self.ping(b"")
                await asyncio.wait_for(self._pong.wait(), self.heartbeat / 2)
            except (OSError, asyncio.TimeoutError):
                # no pong within half the heartbeat: the peer is gone
                self.close_code = 1006
                self.abort()
                return

    # -- receiving -------------------------------------------------------------
    async def _frame(self) -> tuple[bool, int, bytes]:
        read = self._reader.readexactly
        b0, b1 = await read(2)
        fin, opcode, n = bool(b0 & 0x80), b0 & 0x0F, b1 & 0x7F
        if b0 & 0x70:
            raise ProtocolError(CLOSE_PROTOCOL, "reserved bits set without an extension")
        if opcode not in (OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG):
            raise ProtocolError(CLOSE_PROTOCOL, f"unknown opcode {opcode:#x}")
        if not b1 & 0x80:
            raise ProtocolError(CLOSE_PROTOCOL, "client frame not masked")
        if n == 126:
            (n,) = struct.unpack("!H", await read(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", await read(8))
            if n >> 63:
                raise ProtocolError(CLOSE_PROTOCOL, "64-bit length with the top bit set")
        if opcode >= OP_CLOSE and (not fin or n > 125):
            raise ProtocolError(CLOSE_PROTOCOL, "fragmented or long control frame")
        mask = await read(4)
        if n >= self.max_message:
            # read past the payload (so the peer's send completes), then refuse
            while n:
                chunk = await self._reader.read(min(n, 1 << 20))
                if not chunk:
                    raise asyncio.IncompleteReadError(b"", n)
                n -= len(chunk)
            raise ProtocolError(CLOSE_TOO_BIG, f"a frame reaches {self.max_message} B")
        payload = apply_mask(await read(n), mask)
        self._last_frame = asyncio.get_running_loop().time()
        return fin, opcode, payload

    async def receive(self) -> tuple[int, bytes] | None:
        """The next whole message, or None once the socket closed (the
        peer's close, a protocol error, a lost connection)."""
        parts: list[bytes] = []
        size, first = 0, None
        while not self.closed:
            try:
                self._reading = True
                try:
                    fin, opcode, payload = await self._frame()
                finally:
                    self._reading = False
                if opcode == OP_PING:
                    await self._send(OP_PONG, payload)
                    continue
                if opcode == OP_PONG:
                    self._pong.set()
                    continue
                if opcode == OP_CLOSE:
                    self._peer_closed.set()
                    code, _ = parse_close(payload)
                    if self.close_code is None:
                        self.close_code = code
                    await self.close(CLOSE_OK)
                    return None
                if (opcode == OP_CONT) == (first is None):
                    raise ProtocolError(CLOSE_PROTOCOL, "continuation out of sequence")
                if first is None:
                    first = opcode
                size += len(payload)
                if size >= self.max_message:
                    raise ProtocolError(CLOSE_TOO_BIG, f"message reaches {self.max_message} B")
                parts.append(payload)
                if not fin:
                    continue
                data = b"".join(parts)
                if first == OP_TEXT:
                    try:
                        data.decode("utf-8")
                    except UnicodeDecodeError:
                        raise ProtocolError(CLOSE_INVALID_TEXT, "text is not UTF-8")
                return first, data
            except ProtocolError as exc:
                await self.close(exc.code, str(exc))
                return None
            except (asyncio.IncompleteReadError, OSError):
                self.abort()
                return None
        return None


class WebSocketClient:
    """A blocking websocket client on one ``socket`` (the tests' and the
    chip script's dashboard): ``recv_text`` returns the next text message,
    answering pings; ``recv_frame`` returns raw frames."""

    def __init__(self, url: str, timeout: float = 10.0):
        parts = urlsplit(url)
        self.sock = socket.create_connection((parts.hostname, parts.port or 80), timeout=timeout)
        self._buf = bytearray()
        key = base64.b64encode(os.urandom(16)).decode("ascii")
        path = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        self.sock.sendall(
            f"GET {path} HTTP/1.1\r\nHost: {parts.netloc}\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n".encode("ascii"))
        head = self._read_until(b"\r\n\r\n").decode("latin-1").split("\r\n")
        self.status = int(head[0].split()[1])
        self.headers = {k.strip().lower(): v.strip()
                        for k, _, v in (h.partition(":") for h in head[1:] if h)}
        if self.status != 101:
            self.sock.close()
            raise ConnectionError(f"websocket handshake answered {head[0]!r}")
        if self.headers.get("sec-websocket-accept") != accept_key(key):
            self.sock.close()
            raise ConnectionError("websocket handshake: wrong Sec-WebSocket-Accept")
        self.close_code: int | None = None

    def _fill(self) -> None:
        data = self.sock.recv(1 << 20)
        if not data:
            raise ConnectionError("websocket connection closed")
        self._buf += data

    def _read_until(self, marker: bytes) -> bytes:
        while (end := self._buf.find(marker)) < 0:
            self._fill()
        out = bytes(self._buf[:end])
        del self._buf[:end + len(marker)]
        return out

    def _read(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._fill()
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def send_frame(self, opcode: int, payload: bytes, fin: bool = True) -> None:
        self.sock.sendall(encode_frame(opcode, payload, fin=fin, mask=os.urandom(4)))

    def send_text(self, text: str) -> None:
        self.send_frame(OP_TEXT, text.encode("utf-8"))

    def recv_frame(self) -> tuple[bool, int, bytes]:
        """One raw frame as ``(fin, opcode, payload)``."""
        b0, b1 = self._read(2)
        n = b1 & 0x7F
        if n == 126:
            (n,) = struct.unpack("!H", self._read(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", self._read(8))
        mask = self._read(4) if b1 & 0x80 else None
        payload = self._read(n)
        return bool(b0 & 0x80), b0 & 0x0F, apply_mask(payload, mask) if mask else payload

    def recv_text(self) -> str | None:
        """The next text message (fragments joined); pings are answered,
        pongs skipped; None when the server closed (``close_code`` holds
        its code)."""
        parts: list[bytes] = []
        while True:
            fin, opcode, payload = self.recv_frame()
            if opcode == OP_PING:
                self.send_frame(OP_PONG, payload)
            elif opcode == OP_CLOSE:
                self.close_code = parse_close(payload)[0]
                return None
            elif opcode in (OP_TEXT, OP_CONT):
                parts.append(payload)
                if fin:
                    return b"".join(parts).decode("utf-8")

    def close(self, code: int = CLOSE_OK) -> int | None:
        """Send a close frame, read to the server's close, and end the
        connection; returns the server's close code (None if it sent none)."""
        try:
            self.send_frame(OP_CLOSE, close_payload(code))
            while True:
                _, opcode, payload = self.recv_frame()
                if opcode == OP_CLOSE:
                    self.close_code = parse_close(payload)[0]
                    break
        except OSError:
            pass
        finally:
            self.sock.close()
        return self.close_code
