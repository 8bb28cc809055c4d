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
tests.
"""

from __future__ import annotations

import json
from typing import Callable, Iterator

from .. import config as _config
from ..features.featurizer import Status
from ..utils import get_logger
from .httpstream import RateLimitedError, StreamHTTPError, open_stream
from .oauth1 import authorization_header
from .sources import Source

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


class BlockTwitterSource(TwitterSource):
    """The live stream through the native block parser (``--source twitter
    --ingest block``), which needs block ingest (ROADMAP A12)."""

    name = "twitter-block"

    def __init__(self, *args, **kw):
        raise NotImplementedError(
            "the live stream's block parser needs block ingest, which the port has "
            "not ported (ROADMAP A12); use --ingest object")

    @classmethod
    def from_properties(cls, **kw) -> "BlockTwitterSource":
        return cls(**kw)
