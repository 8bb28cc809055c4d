"""The port's live Twitter source (``twtml_tpu_torch/streaming/{oauth1,
httpstream,twitter}.py``) against the JAX package's: OAuth1 signatures on
the published vectors, both sources reading one loopback v1.1 stream
(chunked delimited JSON, keep-alive lines, a mid-stream disconnect, 420 and
401), the Twitter backoff ladder, and ``--source twitter`` with its
credentials from an ``application.conf`` giving the JAX app's lines. No
egress: the server is an in-process ``http.server`` on 127.0.0.1."""

import contextlib
import dataclasses
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import unquote

import jax
import numpy as np
import pytest

from twtml_tpu import config as jax_config
from twtml_tpu.apps import linear_regression as jax_app
from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu.streaming import httpstream as jax_httpstream
from twtml_tpu.streaming import oauth1 as jax_oauth1
from twtml_tpu.streaming import twitter as jax_twitter
from twtml_tpu_torch import config
from twtml_tpu_torch.apps import common
from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.streaming import httpstream, oauth1, twitter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "tweets.jsonl")
PACKAGES = {"port": (oauth1, httpstream, twitter), "jax": (jax_oauth1, jax_httpstream, jax_twitter)}

# ---- OAuth 1.0a signatures --------------------------------------------------------

VECTORS = {
    # RFC 5849 section 1.2, the temporary-credentials request
    "rfc5849": ("POST", "https://photos.example.net/initiate", [
        ("oauth_consumer_key", "dpf43f3p2l4k3l03"), ("oauth_signature_method", "HMAC-SHA1"),
        ("oauth_timestamp", "137131200"), ("oauth_nonce", "wIjqoS"),
        ("oauth_callback", "http://printer.example.com/ready"),
    ], "kd94hf93k423kf44", "", "74KNZJeDHnMBp0EMJ9ZHt/XKycU="),
    # Twitter's "Creating a signature" developer doc
    "twitter-docs": ("POST", "https://api.twitter.com/1.1/statuses/update.json", [
        ("status", "Hello Ladies + Gentlemen, a signed OAuth request!"),
        ("include_entities", "true"), ("oauth_consumer_key", "xvz1evFS4wEEPTGEFPHBog"),
        ("oauth_nonce", "kYjzVBB8Y0ZFabxSWbWovY3uYSQ2pTgmZeNu2VS4cg"),
        ("oauth_signature_method", "HMAC-SHA1"), ("oauth_timestamp", "1318622958"),
        ("oauth_token", "370773112-GmHxMAgYyLbNEtIKZeRNFsMKPR9EyMZeS9weJAEb"),
        ("oauth_version", "1.0"),
    ], "kAcSOqF21Fu85e7zjz7ZN2U4ZRhfV3WpwPAoE3Z7kBw",
        "LswwdoUaIvS8ltyTt5jkRh4J50vUPVVHtR2YPi5kE", "hCtSmYh+iHYCEqBWrE7C7hYmtUk="),
}


@pytest.mark.parametrize("name", sorted(VECTORS))
def test_signature_vectors_equal_the_jax_packages(name):
    method, url, params, cs, ts, want = VECTORS[name]
    assert oauth1.sign(method, url, params, cs, ts) == want
    assert jax_oauth1.sign(method, url, params, cs, ts) == want
    assert (oauth1.signature_base_string(method, url, params)
            == jax_oauth1.signature_base_string(method, url, params))


@pytest.mark.parametrize("text", ["Ladies + Gentlemen", "safe-chars_are.kept~", "☃", "a/b?c=d&e"])
def test_percent_encoding_equals_the_jax_packages(text):
    assert oauth1.percent_encode(text) == jax_oauth1.percent_encode(text)


@pytest.mark.parametrize("url", [
    "https://stream.twitter.com/1.1/statuses/sample.json",
    "http://example.com/stream.json?delimited=length&x=a%20b",
    "http://127.0.0.1:8080/1.1/statuses/sample.json?stall_warnings=true",
])
def test_authorization_headers_equal_the_jax_packages(url):
    kw = dict(consumer_key="ck", consumer_secret="cs", token="tk", token_secret="ts",
              nonce="fixednonce", timestamp=1700000000)
    assert oauth1.authorization_header("GET", url, **kw) == jax_oauth1.authorization_header(
        "GET", url, **kw)


# ---- a loopback v1.1 stream ---------------------------------------------------------

TWEETS = [
    json.dumps({"text": f"RT @u: tweet {i}", "id": 1000 + i,
                "retweeted_status": {"text": f"tweet {i} ÄÖ", "retweet_count": 100 + i,
                                     "user": {"followers_count": 10 * i},
                                     "timestamp_ms": str(1_600_000_000_000 + i)}})
    for i in range(40)
]


class StreamHandler(BaseHTTPRequestHandler):
    """The v1.1 stream's shape, chunks cut across lines:

    - /stream: 20 tweets with keep-alive lines and two notices, a clean end
    - /drop: 10 tweets then a hard disconnect; the next request the next 10
    - /calm: HTTP 420; /forbidden: HTTP 401
    - /fixture: the replay fixture's lines three times over, a clean end
    """

    protocol_version = "HTTP/1.1"
    state: dict = {}

    def log_message(self, *a):
        pass

    def _send(self, data: bytes, chunk: int = 37):
        for i in range(0, len(data), chunk):
            piece = data[i:i + chunk]
            self.wfile.write(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
        self.wfile.flush()

    def do_GET(self):
        self.state.setdefault("auth", []).append(self.headers.get("Authorization", ""))
        if self.path in ("/calm", "/forbidden"):
            code, reason = (420, "Enhance Your Calm") if self.path == "/calm" else (401, "Unauthorized")
            self.send_response(code, reason)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        if self.path == "/stream":
            notices = [json.dumps({"delete": {"status": {"id": 1}}}), "not json"]
            lines = TWEETS[:10] + ["", *notices, ""] + TWEETS[10:20]
            self._send(("\r\n".join(lines) + "\r\n\r\n").encode())
        elif self.path == "/drop":
            n = self.state.get(self.path, 0)
            self.state[self.path] = n + 1
            if n == 0:
                self._send(("\r\n".join(TWEETS[:10]) + "\r\n").encode())
                self.connection.close()
                raise ConnectionAbortedError  # no terminating chunk
            self._send(("\r\n".join(TWEETS[10:20]) + "\r\n").encode())
        elif self.path == "/fixture":
            with open(DATA, "rb") as fh:
                self._send(fh.read() * 3, chunk=101)
        self.wfile.write(b"0\r\n\r\n")
        self.close_connection = True


@pytest.fixture()
def stream_server():
    StreamHandler.state = {}
    server = ThreadingHTTPServer(("127.0.0.1", 0), StreamHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()


CREDS = {k: "secret-" + k.rsplit(".", 1)[1] for k in twitter.OAUTH_KEYS}


def collect(src, expect: int, timeout: float = 15.0) -> list:
    got = []
    src.start(got.append)
    deadline = time.time() + timeout
    while len(got) < expect and not src.exhausted and time.time() < deadline:
        time.sleep(0.01)
    src.stop()
    return [dataclasses.asdict(s) for s in got]


@pytest.mark.parametrize("path,expect", [("/stream", 20), ("/drop", 20)])
def test_both_sources_read_the_same_statuses(stream_server, path, expect):
    """Across keep-alive lines, notices and a mid-stream disconnect (the
    supervisor reconnects after the transport backoff)."""
    ours = collect(twitter.TwitterSource(CREDS, url=stream_server + path), expect)
    StreamHandler.state.pop(path, None)
    theirs = collect(jax_twitter.TwitterSource(CREDS, url=stream_server + path), expect)
    assert ours == theirs
    assert [s["retweeted_status"]["retweet_count"] for s in ours] == list(range(100, 120))


def test_the_server_verifies_the_ports_signature(stream_server):
    url = stream_server + "/stream"
    collect(twitter.TwitterSource(CREDS, url=url), 20)
    auth = StreamHandler.state["auth"][0]
    fields = {k: unquote(v.strip('"'))
              for k, v in (p.split("=", 1) for p in auth[len("OAuth "):].split(", "))}
    claimed = fields.pop("oauth_signature")
    assert claimed == jax_oauth1.sign(
        "GET", url, sorted(fields.items()),
        consumer_secret=CREDS["twitter4j.oauth.consumerSecret"],
        token_secret=CREDS["twitter4j.oauth.accessTokenSecret"])


@pytest.mark.parametrize("kind", sorted(PACKAGES))
def test_420_raises_rate_limited(stream_server, kind):
    stream = PACKAGES[kind][1]
    with pytest.raises(stream.RateLimitedError) as exc:
        list(stream.open_stream(stream_server + "/calm"))
    assert (exc.value.status, exc.value.reason) == (420, "Enhance Your Calm")


@pytest.mark.parametrize("kind", sorted(PACKAGES))
def test_401_raises_a_stream_error(stream_server, kind):
    stream = PACKAGES[kind][1]
    with pytest.raises(stream.StreamHTTPError) as exc:
        list(stream.open_stream(stream_server + "/forbidden"))
    assert exc.value.status == 401 and not isinstance(exc.value, stream.RateLimitedError)


@pytest.mark.parametrize("error", ["rate-limited", "http", "transport"])
def test_the_backoff_ladder_equals_the_jax_packages(error):
    def exc(pkg):
        stream = PACKAGES[pkg][1]
        return {"rate-limited": stream.RateLimitedError(420), "http": stream.StreamHTTPError(503),
                "transport": ConnectionError()}[error]

    ours = twitter.TwitterSource(CREDS)
    theirs = jax_twitter.TwitterSource(CREDS)
    ladder = [ours._backoff(exc("port"), n) for n in range(1, 80)]
    assert ladder == [theirs._backoff(exc("jax"), n) for n in range(1, 80)]
    assert ladder[0] == {"rate-limited": 60.0, "http": 5.0, "transport": 0.25}[error]
    assert ladder[-1] == {"rate-limited": 960.0, "http": 320.0, "transport": 16.0}[error]
    assert ours.max_restarts == theirs.max_restarts == 1_000_000


def noisy_stream():
    yield json.dumps({"text": "RT @x: hello world",
                      "retweeted_status": {"text": "hello world", "retweet_count": 500,
                                           "user": {"followers_count": 10}}})
    yield ""
    yield "not json"
    yield json.dumps({"delete": {"status": {"id": 1}}})
    yield json.dumps({"text": "plain tweet", "user": {}})


def test_an_injected_stream_parses_as_in_the_jax_package():
    ours = list(twitter.TwitterSource({}, connect_fn=noisy_stream).produce())
    theirs = list(jax_twitter.TwitterSource({}, connect_fn=noisy_stream).produce())
    assert [dataclasses.asdict(s) for s in ours] == [dataclasses.asdict(s) for s in theirs]
    assert len(ours) == 2


@pytest.fixture()
def properties():
    """Both packages' property tables, emptied for the test."""
    saved = dict(config._SYSTEM_PROPERTIES), dict(jax_config._SYSTEM_PROPERTIES)
    config._SYSTEM_PROPERTIES.clear()
    jax_config._SYSTEM_PROPERTIES.clear()
    yield
    for table, old in zip((config._SYSTEM_PROPERTIES, jax_config._SYSTEM_PROPERTIES), saved):
        table.clear()
        table.update(old)


def test_missing_credentials_exit_naming_them(properties):
    config.set_property("twitter4j.oauth.consumerKey", "ck")
    with pytest.raises(SystemExit, match="accessTokenSecret"):
        twitter.TwitterSource.from_properties()


def test_stream_base_url_overrides_the_endpoint(properties):
    for key, value in CREDS.items():
        config.set_property(key, value)
    assert twitter.TwitterSource.from_properties().url == twitter.STREAM_URL
    config.set_property("twitter4j.streamBaseURL", "http://127.0.0.1:9/x.json")
    src = twitter.TwitterSource.from_properties()
    assert src.url == "http://127.0.0.1:9/x.json" and src.credentials == CREDS


def test_block_ingest_of_the_live_stream_names_a12(properties):
    """``--source twitter --ingest block``: the port builds its block
    source from the property table as the JAX package does, and its blocks
    from the same stream lines are the JAX package's."""
    from twtml_tpu.streaming.twitter import BlockTwitterSource as JaxBlockTwitter

    for key, value in CREDS.items():
        config.set_property(key, value)
    conf = ConfArguments().parse(["--source", "twitter", "--ingest", "block"])
    common.select_backend(conf)
    src = common.build_source(conf, allow_block=True)
    assert isinstance(src, twitter.BlockTwitterSource) and src.credentials == CREDS
    assert (src.begin, src.end, src.wire) == (100, 1000, False)  # --seconds 5: padded
    lines = open("tests/data/tweets.jsonl", encoding="utf-8").read().splitlines()
    ours = list(twitter.BlockTwitterSource(CREDS, connect_fn=lambda: iter(lines),
                                           wire=True).produce())
    theirs = list(JaxBlockTwitter(CREDS, connect_fn=lambda: iter(lines), wire=True).produce())
    assert len(ours) == len(theirs) >= 1
    for a, b in zip(ours, theirs):
        for f in ("numeric", "units", "offsets", "ascii"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert getattr(a, f).dtype == getattr(b, f).dtype


def test_source_twitter_from_application_conf_gives_the_jax_apps_lines(
        stream_server, properties, tmp_path, monkeypatch, capsys):
    """``--source twitter`` with the four credentials in the file
    TWTML_CONFIG names and ``twitter4j.streamBaseURL`` at the loopback
    stream: the port's app on the CPU prints the JAX app's lines."""
    conf_file = tmp_path / "site.conf"
    conf_file.write_text("".join(f'{k.rsplit(".", 1)[1]}="{v}"\n' for k, v in CREDS.items()))
    monkeypatch.setenv("TWTML_CONFIG", str(conf_file))
    monkeypatch.setenv("TWTML_NOW_MS", "1700000000000")
    url = stream_server + "/fixture"
    config.set_property("twitter4j.streamBaseURL", url)
    jax_config.set_property("twitter4j.streamBaseURL", url)
    argv = ["--source", "twitter", "--seconds", "0", "--batchBucket", "4",
            "--twtweb", "http://127.0.0.1:9", "--lightning", "http://127.0.0.1:9",
            "--blackbox", "off"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        totals = app.run(ConfArguments().parse([*argv, "--backend", "cpu"]), max_batches=4)
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("count:")]
    assert config.get_property("twitter4j.oauth.accessToken") == CREDS["twitter4j.oauth.accessToken"]
    jax.devices()
    jax_app.run(JaxConf().parse([*argv, "--master", "local[1]"]), max_batches=4)
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("count:")]
    assert lines == jax_lines and len(lines) == 4 and totals["batches"] == 4
    # every request the two sources made was signed with the file's keys
    assert all(a.startswith("OAuth ") and 'oauth_consumer_key="secret-consumerKey"' in a
               for a in StreamHandler.state["auth"])
