"""Minimal streaming HTTP/1.1 client for long-lived delimited-JSON streams
(counterpart of ``twtml_tpu/streaming/httpstream.py``).

Twitter's v1.1 streaming endpoints speak HTTP/1.1 with ``Transfer-Encoding:
chunked``, one JSON document a ``\\r\\n``-delimited line, and blank
keep-alive lines every ~30 s. The reference takes this layer from
Twitter4j; here it is on the standard library: a raw socket (TLS for
https), the request, the status and header parse, chunked decoding, and
lines reassembled across chunk boundaries. ``urllib`` buffers and cannot
hand a streaming consumer the lines as they arrive. Held against a local
server in tests/test_torch_twitter.py.
"""

from __future__ import annotations

import socket
import ssl
from typing import Iterator
from urllib.parse import urlsplit

__all__ = ["StreamHTTPError", "RateLimitedError", "open_stream"]


class StreamHTTPError(ConnectionError):
    """Non-200 response on a streaming endpoint."""

    def __init__(self, status: int, reason: str = ""):
        super().__init__(f"HTTP {status} {reason}".strip())
        self.status = status
        self.reason = reason


class RateLimitedError(StreamHTTPError):
    """HTTP 420 (Twitter's 'Enhance Your Calm') / 429: the caller must back
    off exponentially starting at a full minute (Twitter streaming rules)."""


def _read_line(sock: socket.socket, buf: bytearray) -> bytes:
    """Read one CRLF-terminated line from the socket (for status/headers and
    chunk-size lines). ``buf`` carries overflow bytes between calls."""
    while True:
        nl = buf.find(b"\n")
        if nl >= 0:
            line = bytes(buf[:nl])
            del buf[: nl + 1]
            return line.rstrip(b"\r")
        data = sock.recv(65536)
        if not data:
            raise ConnectionError("connection closed during HTTP header read")
        buf.extend(data)


def _read_exact(sock: socket.socket, buf: bytearray, n: int) -> bytes:
    while len(buf) < n:
        data = sock.recv(65536)
        if not data:
            raise ConnectionError("connection closed mid-chunk")
        buf.extend(data)
    out = bytes(buf[:n])
    del buf[:n]
    return out


def _body_chunks(
    sock: socket.socket, buf: bytearray, headers: dict[str, str]
) -> Iterator[bytes]:
    """Yield raw body byte chunks per the response framing."""
    encoding = headers.get("transfer-encoding", "").lower()
    if "chunked" in encoding:
        while True:
            size_line = _read_line(sock, buf)
            if not size_line:
                continue  # tolerate stray blank between chunks
            size = int(size_line.split(b";")[0], 16)  # ignore chunk extensions
            if size == 0:
                # trailer section until blank line, then done
                while _read_line(sock, buf):
                    pass
                return
            yield _read_exact(sock, buf, size)
            _read_line(sock, buf)  # CRLF after chunk data
    elif "content-length" in headers:
        remaining = int(headers["content-length"])
        if buf:
            take = min(len(buf), remaining)
            yield _read_exact(sock, buf, take)
            remaining -= take
        while remaining > 0:
            data = sock.recv(min(65536, remaining))
            if not data:
                return
            remaining -= len(data)
            yield data
    else:
        # read-until-close framing
        if buf:
            yield bytes(buf)
            buf.clear()
        while True:
            data = sock.recv(65536)
            if not data:
                return
            yield data


def open_stream(
    url: str,
    headers: dict[str, str] | None = None,
    method: str = "GET",
    body: bytes | None = None,
    timeout: float = 90.0,
    ssl_context: ssl.SSLContext | None = None,
) -> Iterator[str]:
    """Open ``url`` and yield decoded text lines (without terminators) as
    they arrive. Blank keep-alive lines ARE yielded — the consumer decides.

    Raises ``RateLimitedError`` on 420/429, ``StreamHTTPError`` on any other
    non-200, plain ``ConnectionError``/``OSError``/``TimeoutError`` on
    transport failures — the distinction drives the reconnect/backoff policy
    (twitter.py).
    """
    parts = urlsplit(url)
    host = parts.hostname or "localhost"
    port = parts.port or (443 if parts.scheme == "https" else 80)
    target = parts.path or "/"
    if parts.query:
        target += "?" + parts.query

    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        if parts.scheme == "https":
            ctx = ssl_context or ssl.create_default_context()
            sock = ctx.wrap_socket(sock, server_hostname=host)

        req_headers = {
            "Host": parts.netloc,
            "User-Agent": "twtml-tpu/0.2",
            "Accept": "*/*",
            "Connection": "close",
        }
        if body is not None:
            req_headers["Content-Length"] = str(len(body))
            req_headers.setdefault(
                "Content-Type", "application/x-www-form-urlencoded"
            )
        if headers:
            req_headers.update(headers)
        request = f"{method} {target} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in req_headers.items()
        ) + "\r\n"
        sock.sendall(request.encode("ascii") + (body or b""))

        buf = bytearray()
        status_line = _read_line(sock, buf)
        try:
            status = int(status_line.split()[1])
        except (IndexError, ValueError):
            raise ConnectionError(f"malformed status line: {status_line!r}")
        reason = b" ".join(status_line.split()[2:]).decode("latin-1")
        resp_headers: dict[str, str] = {}
        while True:
            line = _read_line(sock, buf)
            if not line:
                break
            key, _, value = line.decode("latin-1").partition(":")
            resp_headers[key.strip().lower()] = value.strip()

        if status in (420, 429):
            raise RateLimitedError(status, reason)
        if status != 200:
            raise StreamHTTPError(status, reason)

        # reassemble text lines across chunk boundaries
        pending = b""
        for chunk in _body_chunks(sock, buf, resp_headers):
            pending += chunk
            while True:
                nl = pending.find(b"\n")
                if nl < 0:
                    break
                line_bytes = pending[:nl].rstrip(b"\r")
                pending = pending[nl + 1 :]
                yield line_bytes.decode("utf-8", errors="replace")
        if pending.strip():
            yield pending.decode("utf-8", errors="replace")
    finally:
        try:
            sock.close()
        except OSError:
            pass
