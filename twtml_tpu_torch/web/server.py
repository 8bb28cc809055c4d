"""The twtml-web dashboard server on the standard library (counterpart of
``twtml_tpu/web/server.py``; the reference's Socko server, Server.scala and
ApiHandler.scala).

The JAX package serves with ``aiohttp``; this server runs on ``asyncio``
streams with the websocket protocol of ``web/websocket.py``, so it starts
where only the standard library is. Routes, statuses and broadcast
semantics are the JAX server's:

- ``POST /api``: cache the payload, answer ``{"status": "OK"}`` and send
  the raw JSON to every live websocket;
- ``WS /api``: push the cached Config to the new socket; every text frame
  it sends is cached and sent to every socket, the sender included;
- ``GET /api/{config,stats,series,metrics,hosts,tenants,model,serving,
  fleet,freshness,history}``: the cached views; ``/api/fleet`` is the live
  router view when a ``FleetRouter`` is attached (``attach_fleet``);
- ``POST /api/predict``: the serving front door. With a ``ServingPlane``
  attached (``attach_serving``, apps/serve.py) the rows go to its
  coalescer and the handler awaits the plane's future without blocking
  the loop: 200 with ``predictions``, ``snapshotStep``, ``servedRows`` and
  ``modelStalenessS``; 400 for a malformed or oversized body; 503 after a
  plane abort. With a router attached (apps/router.py) the body is
  forwarded in the router's own thread pool, off the event loop, and the
  replica's status and body pass through (503 when the whole fleet is
  down). With neither, 503: this process serves no model. Errors are
  JSON with an ``error`` field;
- ``GET /`` the dashboard, ``GET /{path}`` its assets (each path segment
  vetted; a fresher ``.min.js`` shadows its ``.js``); 404 for an unknown
  path, 405 for a known path with another method (GET routes take HEAD).

HTTP/1.1 with keep-alive (75 s idle, as aiohttp), request bodies by
``Content-Length`` or chunked, up to 1 MiB (413 at it, aiohttp's
``client_max_size``). ``start_background`` runs the event loop in a daemon
thread and returns once the socket listens (a failed bind raises);
``stop`` is bounded at 5 s, live sockets or not; ``run_forever`` is the
foreground mode of ``web/main.py``.
"""

from __future__ import annotations

import asyncio
import json
import mimetypes
import os
import threading
from importlib import resources as _res
from urllib.parse import unquote, urlsplit

from ..utils import get_logger
from . import websocket as ws
from .cache import ApiCache

log = get_logger("web.server")

OK = json.dumps({"status": "OK"})
JSON = "application/json; charset=utf-8"
TEXT = "text/plain; charset=utf-8"
MAX_BODY = 1024 ** 2
KEEPALIVE_S = 75.0
STOP_S = 5.0
REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
           413: "Request Entity Too Large", 503: "Service Unavailable"}

# GET /api/<name> -> the cache's view of that name
VIEWS = ("config", "stats", "series", "metrics", "hosts", "tenants", "model",
         "serving", "fleet", "freshness", "history")


class HTTPError(Exception):
    def __init__(self, status: int, text: str = "", allow: str = ""):
        super().__init__(text)
        self.status = status
        self.text = text or f"{status}: {REASONS.get(status, '')}"
        self.allow = allow


class Request:
    def __init__(self, method: str, target: str, version: str, headers: dict, body: bytes):
        self.method = method
        self.path = unquote(urlsplit(target).path)
        self.version = version
        self.headers = headers
        self.body = body

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return "keep-alive" in conn
        return "close" not in conn


def _response(status: int, body: bytes, ctype: str, keep_alive: bool,
              extra: dict | None = None, head_only: bool = False) -> bytes:
    head = [f"HTTP/1.1 {status} {REASONS.get(status, '')}",
            f"Content-Type: {ctype}", f"Content-Length: {len(body)}",
            "Connection: " + ("keep-alive" if keep_alive else "close")]
    head += [f"{k}: {v}" for k, v in (extra or {}).items()]
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + (b"" if head_only else body)


async def _read_body(reader: asyncio.StreamReader, headers: dict) -> bytes:
    if "chunked" in headers.get("transfer-encoding", "").lower():
        body = bytearray()
        while True:
            size_line = (await reader.readuntil(b"\r\n")).split(b";")[0].strip()
            try:
                size = int(size_line, 16)
            except ValueError:
                raise HTTPError(400, "bad chunk size")
            if size == 0:
                while (await reader.readuntil(b"\r\n")) != b"\r\n":
                    pass  # trailers
                return bytes(body)
            body += await reader.readexactly(size)
            await reader.readexactly(2)
            if len(body) >= MAX_BODY:
                raise HTTPError(413, f"Maximum request body size {MAX_BODY} exceeded")
    try:
        n = int(headers.get("content-length", "0"))
    except ValueError:
        raise HTTPError(400, "bad Content-Length")
    if n >= MAX_BODY:
        while n:  # read past it, so the client's send completes, then refuse
            n -= len(await reader.readexactly(min(n, 1 << 20)))
        raise HTTPError(413, f"Maximum request body size {MAX_BODY} exceeded")
    return await reader.readexactly(n) if n > 0 else b""


async def _read_request(reader: asyncio.StreamReader) -> Request | None:
    """The next request on a connection, or None at a clean end."""
    line = await reader.readuntil(b"\r\n")
    while line == b"\r\n":  # stray blank lines between requests
        line = await reader.readuntil(b"\r\n")
    try:
        method, target, version = line.decode("latin-1").split()
    except ValueError:
        raise HTTPError(400, "bad request line")
    headers: dict[str, str] = {}
    while (raw := await reader.readuntil(b"\r\n")) != b"\r\n":
        key, sep, value = raw.decode("latin-1").partition(":")
        if not sep:
            raise HTTPError(400, "bad header line")
        headers[key.strip().lower()] = value.strip()
    return Request(method.upper(), target, version, headers, await _read_body(reader, headers))


class Server:
    # aiohttp's heartbeat=30 on every socket (web/websocket.py)
    heartbeat = ws.HEARTBEAT_S

    def __init__(self, port: int = 8888, host: str = "0.0.0.0", cache: ApiCache | None = None):
        self.port = port
        self.host = host
        self.cache = cache if cache is not None else ApiCache()
        self._websockets: set[ws.ServerWebSocket] = set()
        self._connections: set[asyncio.Task] = set()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.Server | None = None
        self._thread: threading.Thread | None = None
        self._assets = _res.files(__package__).joinpath("assets")
        # the serving front door: a ServingPlane (apps/serve.py) or a
        # FleetRouter (apps/router.py) makes POST /api/predict live
        self._serving = None
        self._fleet = None

    def attach_serving(self, plane) -> "Server":
        """Attach a ``serving.ServingPlane``: POST /api/predict submits to
        its coalescer and awaits the pipelined result."""
        self._serving = plane
        return self

    def attach_fleet(self, router) -> "Server":
        """Attach a ``serving.FleetRouter``: POST /api/predict forwards to a
        replica by the route policy, and GET /api/fleet answers with the
        router's live view."""
        self._fleet = router
        return self

    # -- routing ---------------------------------------------------------------
    @staticmethod
    def _route(req: Request) -> str:
        """The handler of a request, resolved as aiohttp resolves the JAX
        server's routes: the first route whose path and method match wins;
        a path some route matches with other methods only is a 405 (its
        ``Allow`` lists them), a path none matches a 404."""
        path, allowed = req.path, []
        routes = (
            ("ws", path == "/api", ("GET", "HEAD")),
            ("post", path == "/api", ("POST",)),
            ("view", path.startswith("/api/") and path[5:] in VIEWS, ("GET", "HEAD")),
            ("predict", path == "/api/predict", ("POST",)),
            ("index", path == "/", ("GET", "HEAD")),
            ("static", len(path) > 1, ("GET", "HEAD")),
        )
        for name, matches, methods in routes:
            if matches:
                if req.method in methods:
                    return name
                allowed += [m for m in methods if m not in allowed]
        if allowed:
            raise HTTPError(405, allow=", ".join(allowed))
        raise HTTPError(404)

    async def _handle(self, req: Request, reader, writer) -> bytes | None:
        """The response bytes of one request; None when the connection was
        upgraded to a websocket (served to its end inside)."""
        name = self._route(req)
        status, ctype = 200, JSON
        if name == "ws":
            await self._ws_api(req, reader, writer)
            return None
        if name == "post":
            text = req.body.decode("utf-8", "replace")
            log.debug("http - post data %s", text)
            self.cache.cache(text)
            await self._broadcast(text)
            body = OK.encode()
        elif name == "predict":
            status, body = await self._predict(req.body)
        elif name == "view" and req.path == "/api/fleet" and self._fleet is not None:
            # a router answers live (host bookkeeping under its lock)
            body = json.dumps({"jsonClass": "Fleet", **self._fleet.stats()}).encode()
        elif name == "view":
            body = getattr(self.cache, req.path[5:])().encode()
        else:
            body, ctype = self._static_file("index.html" if name == "index" else req.path[1:])
        return _response(status, body, ctype, req.keep_alive, head_only=req.method == "HEAD")

    async def _predict(self, body: bytes) -> tuple[int, bytes]:
        """(status, JSON body) of ``POST /api/predict`` (module docstring)."""
        def fail(status: int, message: str) -> tuple[int, bytes]:
            return status, json.dumps({"error": message}).encode()

        if self._fleet is not None:
            # urllib blocks: forward in the router's own pool, whose size
            # bounds the fleet's in-flight forwards
            return await asyncio.get_running_loop().run_in_executor(
                self._fleet.executor, self._fleet.predict, body)
        plane = self._serving
        if plane is None:
            return fail(503, "serving not enabled on this server (start via "
                             "twtml_tpu_torch.apps.serve or route a fleet via "
                             "twtml_tpu_torch.apps.router)")
        try:
            payload = json.loads(body.decode("utf-8"))
            rows = payload["rows"] if isinstance(payload, dict) else payload
            if not isinstance(rows, list):
                raise ValueError("body must be {\"rows\": [...]} ")
            statuses = plane.statuses_from_rows(rows)
        except (ValueError, KeyError, TypeError) as exc:
            return fail(400, f"bad predict request: {exc}")
        try:
            # the plane's future resolves on its serve loop; the fetch
            # watchdog bounds how long it can take
            result = await asyncio.wrap_future(plane.submit(statuses))
        except ValueError as exc:  # an oversized request
            return fail(400, str(exc))
        except Exception as exc:  # a plane abort or shutdown: the client may retry
            return fail(503, str(exc))
        return 200, json.dumps({
            "predictions": result["predictions"],
            "snapshotStep": result["snapshot_step"],
            "servedRows": len(result["predictions"]),
            "modelStalenessS": result.get("model_staleness_s", -1.0),
        }).encode()

    def _static_file(self, rel: str) -> tuple[bytes, str]:
        # join segment by segment with every segment vetted: an absolute
        # segment would discard the assets root, and a control character
        # would raise from is_file(); each is a 404
        parts = rel.split("/")
        if any(p in ("", ".", "..") or "\\" in p or ":" in p or any(ord(c) < 32 for c in p)
               for p in parts):
            raise HTTPError(404)
        parent = self._assets
        for p in parts[:-1]:
            parent = parent.joinpath(p)
        target = parent.joinpath(parts[-1])
        if rel.endswith(".js") and not rel.endswith(".min.js"):
            # a dist build's minified twin wins unless the source is newer
            # (a stale dev-tree .min.js must not shadow an edit)
            minified = parent.joinpath(parts[-1][:-3] + ".min.js")
            if minified.is_file():
                try:
                    fresh = os.path.getmtime(str(minified)) >= os.path.getmtime(str(target))
                except OSError:
                    fresh = True
                if fresh:
                    target = minified
        if not target.is_file():
            raise HTTPError(404)
        ctype, _ = mimetypes.guess_type(rel)
        return target.read_bytes(), ctype or "application/octet-stream"

    # -- websockets ------------------------------------------------------------
    async def _ws_api(self, req: Request, reader, writer) -> None:
        h = req.headers
        if h.get("upgrade", "").lower().strip() != "websocket":
            raise HTTPError(400, f"No WebSocket UPGRADE hdr: {h.get('upgrade')}\n Can "
                                 '"Upgrade" only to "WebSocket".')
        if "upgrade" not in h.get("connection", "").lower():
            raise HTTPError(400, f"No CONNECTION upgrade hdr: {h.get('connection')}")
        if h.get("sec-websocket-version", "") not in ("13", "8", "7"):
            raise HTTPError(400, f"Unsupported version: {h.get('sec-websocket-version', '')}")
        key = h.get("sec-websocket-key", "")
        if not ws.valid_key(key):
            raise HTTPError(400, f"Handshake error: {key!r}")
        writer.write(("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                      "Connection: upgrade\r\nSec-WebSocket-Accept: "
                      f"{ws.accept_key(key)}\r\n\r\n").encode("ascii"))
        await writer.drain()
        sock = ws.ServerWebSocket(reader, writer, heartbeat=self.heartbeat)
        self._websockets.add(sock)
        log.debug("websocket connected (%d live)", len(self._websockets))
        sock.start_heartbeat()
        try:
            await sock.send_text(self.cache.config())  # the connect push
            while (msg := await sock.receive()) is not None:
                opcode, data = msg
                if opcode == ws.OP_TEXT:
                    text = data.decode("utf-8")
                    self.cache.cache(text)
                    await self._broadcast(text)
        except OSError:
            pass  # the peer went away mid-send
        finally:
            self._websockets.discard(sock)
            sock.abort()

    async def _broadcast(self, text: str) -> None:
        """Send a frame to every live socket; a dead one is dropped."""
        for sock in list(self._websockets):
            try:
                await sock.send_text(text)
            except OSError:
                self._websockets.discard(sock)

    # -- connections -----------------------------------------------------------
    async def _connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        try:
            while True:
                try:
                    req = await asyncio.wait_for(_read_request(reader), KEEPALIVE_S)
                except HTTPError as exc:
                    writer.write(_response(exc.status, exc.text.encode(), TEXT, False))
                    break
                try:
                    out = await self._handle(req, reader, writer)
                except HTTPError as exc:
                    extra = {"Allow": exc.allow} if exc.allow else None
                    out = _response(exc.status, exc.text.encode(), TEXT, req.keep_alive, extra)
                if out is None:  # a websocket, ended
                    break
                writer.write(out)
                await writer.drain()
                if not req.keep_alive:
                    break
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, asyncio.TimeoutError,
                ValueError, OSError):
            pass  # the client closed, idled out or sent what cannot be framed
        finally:
            self._connections.discard(task)
            writer.close()

    async def _start_async(self) -> None:
        self._server = await asyncio.start_server(self._connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("Open your browser and navigate to http://%s:%d", self.host, self.port)

    async def _stop_async(self) -> None:
        if self._server is not None:
            self._server.close()
        socks = list(self._websockets)
        if socks:
            await asyncio.wait([asyncio.ensure_future(s.close(ws.CLOSE_OK)) for s in socks],
                               timeout=STOP_S / 2)
        for task in list(self._connections):
            task.cancel()
        if self._connections:
            await asyncio.wait(list(self._connections), timeout=1.0)

    # -- lifecycle -------------------------------------------------------------
    def start_background(self) -> "Server":
        """Run the server's loop in a daemon thread; returns once the socket
        listens, and raises what a failed bind raised."""
        started = threading.Event()
        failure: list[BaseException] = []

        def runner():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self._start_async())
            except OSError as exc:
                failure.append(exc)
                started.set()
                self._loop.close()
                return
            started.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=runner, name="twtml-web", daemon=True)
        self._thread.start()
        if not started.wait(timeout=10):
            raise RuntimeError("web server failed to start")
        if failure:
            self._loop = None
            raise failure[0]
        return self

    def stop(self) -> None:
        """Close the websockets and the listener, within ``STOP_S``; a loop
        that does not finish by then is abandoned (a daemon thread)."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        fut = asyncio.run_coroutine_threadsafe(self._stop_async(), loop)
        try:
            fut.result(timeout=STOP_S - 1)
        except TimeoutError:
            log.warning("web server stop timed out; abandoning its loop")
        loop.call_soon_threadsafe(loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=1)

    def run_forever(self) -> None:
        """Foreground mode for the standalone process (web/main.py)."""
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        loop.run_until_complete(self._start_async())
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(self._stop_async())
