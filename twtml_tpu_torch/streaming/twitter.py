"""Live Twitter stream source (counterpart of
``twtml_tpu/streaming/twitter.py``; the reference's TwitterUtils.createStream
and its Twitter4j receiver).

The receiver connects to the streaming endpoint with the four
``twitter4j.oauth.*`` credentials of the process property table (the
``-C/-S/-A/-T`` flags or an ``application.conf``), parses one JSON tweet a
line and yields ``Status`` objects. Connection handling is the ``Source``
supervisor's (sources.py): a drop or an HTTP error raises, and the
supervisor reconnects after the Twitter streaming rules' backoff, which
Twitter4j implements: transport errors retry linearly (250 ms more each
attempt, capped at 16 s), HTTP errors exponentially from 5 s (capped at
320 s), and HTTP 420/429 rate limiting exponentially from a full minute.

The protocol path is the standard library's: OAuth1 HMAC-SHA1 signing
(oauth1.py) over a chunked streaming HTTP/1.1 client (httpstream.py). The
``twitter4j.streamBaseURL`` property (Twitter4j's own endpoint override)
points the source at another server, such as a local one speaking the
v1.1 protocol. ``connect_fn`` replaces the connection for protocol-free
tests. ``BlockTwitterSource`` (``--ingest block``) parses the stream's lines
in byte blocks with the native block parser instead of one ``json.loads``
a line.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Iterator

from .. import config as _config
from ..features.blocks import merge_blocks
from ..features.featurizer import Status
from ..utils import get_logger
from .httpstream import RateLimitedError, StreamHTTPError, open_stream
from .oauth1 import authorization_header
from .sources import BlockParserMixin, Source

log = get_logger("streaming.twitter")

STREAM_URL = "https://stream.twitter.com/1.1/statuses/sample.json"

OAUTH_KEYS = (
    "twitter4j.oauth.consumerKey",
    "twitter4j.oauth.consumerSecret",
    "twitter4j.oauth.accessToken",
    "twitter4j.oauth.accessTokenSecret",
)


class TwitterSource(Source):
    """Supervised live-stream receiver. ``connect_fn()`` returns an
    iterator of raw JSON lines; by default the source opens ``url`` signed
    with ``credentials``."""

    name = "twitter"

    def __init__(self, credentials: dict[str, str],
                 connect_fn: Callable[[], Iterator[str]] | None = None,
                 url: str = STREAM_URL, **kw):
        # a live receiver retries indefinitely, as Twitter4j does: the
        # backoff ladder is the pressure valve, not a restart cap (three
        # failed connects emit nothing, so the cap would never reset)
        kw.setdefault("max_restarts", 1_000_000)
        super().__init__(**kw)
        self.credentials = credentials
        self.url = url
        self._connect_fn = connect_fn

    @classmethod
    def from_properties(cls, **kw) -> "TwitterSource":
        """Build from the ``twitter4j.oauth.*`` property table; a missing
        credential exits naming it. ``twitter4j.streamBaseURL`` overrides
        the endpoint."""
        creds = {k: _config.get_property(k, "") for k in OAUTH_KEYS}
        missing = [k for k, v in creds.items() if not v]
        if missing:
            raise SystemExit(
                "Twitter credentials missing: " + ", ".join(missing)
                + " — pass --consumerKey/--consumerSecret/--accessToken/"
                "--accessTokenSecret or set them in application.conf"
            )
        kw.setdefault("url", _config.get_property("twitter4j.streamBaseURL", STREAM_URL))
        return cls(creds, **kw)

    def _connect(self) -> Iterator[str]:
        if self._connect_fn is not None:
            return self._connect_fn()
        auth = authorization_header(
            "GET", self.url,
            consumer_key=self.credentials.get("twitter4j.oauth.consumerKey", ""),
            consumer_secret=self.credentials.get("twitter4j.oauth.consumerSecret", ""),
            token=self.credentials.get("twitter4j.oauth.accessToken", ""),
            token_secret=self.credentials.get("twitter4j.oauth.accessTokenSecret", ""),
        )
        # the 90 s read timeout: the stream sends a keep-alive every ~30 s,
        # so 90 s of silence is a stall and raises into the supervisor
        return open_stream(self.url, headers={"Authorization": auth})

    def _backoff(self, exc: Exception, restarts: int) -> float:
        """Seconds before reconnect ``restarts`` (1-based), by the Twitter
        streaming rules: 420/429 exponential from 60 s (capped at 960 s),
        other HTTP errors exponential from 5 s (capped at 320 s), transport
        errors linear in 250 ms steps (capped at 16 s)."""
        n = min(restarts - 1, 16)
        if isinstance(exc, RateLimitedError):
            return min(60.0 * (2 ** n), 960.0)
        if isinstance(exc, StreamHTTPError):
            return min(5.0 * (2 ** n), 320.0)
        return min(0.25 * restarts, 16.0)

    def produce(self) -> Iterator[Status]:
        for line in self._connect():
            line = line.strip()
            if not line:
                continue  # keep-alive
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                log.debug("skipping non-JSON stream line")
                continue
            if "text" not in obj:
                continue  # delete and limit notices
            yield Status.from_json(obj)
        if self._connect_fn is None:
            # a live stream never ends on purpose: the server's close is a
            # disconnect, and the supervisor reconnects (an injected test
            # stream does end)
            raise ConnectionError("stream ended by server; reconnecting")


class BlockTwitterSource(BlockParserMixin, TwitterSource):
    """The live stream through the native block parser (``--source twitter
    --ingest block``): raw JSON lines from the connection gather into byte
    blocks, and each block goes through the block parser
    (``BlockParserMixin``: the same C scanner and filter as the replay
    block source), yielding ParsedBlocks with no per-tweet Python object
    between the socket and the featurizer.

    A block parses when the buffer reaches ``block_bytes``, or at the
    first stream activity (a line or a keep-alive) ``flush_seconds`` after
    its first buffered line. The clock is read when the line iterator
    yields, so on a quiet stream the latency bound is the protocol's ~30 s
    keep-alive, not ``flush_seconds``."""

    name = "twitter-block"

    def __init__(self, credentials: dict[str, str], num_retweet_begin: int = 100,
                 num_retweet_end: int = 1000, block_bytes: int = 1 << 18,
                 flush_seconds: float = 0.5, wire: bool = False, **kw):
        super().__init__(credentials, **kw)
        self.begin = num_retweet_begin
        self.end = num_retweet_end
        self.block_bytes = block_bytes
        self.flush_seconds = flush_seconds
        self.wire = wire

    @classmethod
    def from_properties(cls, **kw) -> "BlockTwitterSource":
        """``TwitterSource.from_properties``'s credentials and endpoint."""
        src = TwitterSource.from_properties()
        kw.setdefault("url", src.url)
        return cls(src.credentials, **kw)

    def _parse_block(self, data: bytes):
        """The merged ParsedBlock of ``data``, or None when no row passed."""
        blocks = self.parse_buffer(data)
        if not blocks:
            return None
        merged = merge_blocks(blocks)
        return merged if merged.rows else None

    def produce(self) -> Iterator:
        buf: list[bytes] = []
        nbytes = 0
        first_t = 0.0
        for line in self._connect():
            line = line.strip()
            now = time.monotonic()
            if line:
                if not buf:
                    first_t = now
                raw = line.encode("utf-8") + b"\n"
                buf.append(raw)
                nbytes += len(raw)
            if buf and (nbytes >= self.block_bytes or now - first_t >= self.flush_seconds):
                block = self._parse_block(b"".join(buf))
                buf, nbytes = [], 0
                if block is not None:
                    yield block
        if buf:
            block = self._parse_block(b"".join(buf))
            if block is not None:
                yield block
        if self._connect_fn is None:
            raise ConnectionError("stream ended by server; reconnecting")
