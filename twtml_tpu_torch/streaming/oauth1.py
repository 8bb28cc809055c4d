"""OAuth 1.0a request signing (HMAC-SHA1) on the standard library
(counterpart of ``twtml_tpu/streaming/oauth1.py``).

The reference delegates OAuth to Twitter4j, which signs every streaming
request with the four ``twitter4j.oauth.*`` credentials. This module does
the same: RFC 5849 parameter normalization, the signature base string, the
HMAC-SHA1 signature and the ``Authorization: OAuth ...`` header, pinned by
the RFC 5849 §1.2 and Twitter developer-docs vectors
(tests/test_torch_twitter.py). Nonce and timestamp are injectable, so a
signature is deterministic under test.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import secrets
import time
from urllib.parse import parse_qsl, quote, urlsplit

__all__ = ["percent_encode", "signature_base_string", "sign", "authorization_header"]


def percent_encode(value: str) -> str:
    """RFC 5849 §3.6 encoding: unreserved chars (RFC 3986 §2.3) stay, all
    else becomes uppercase %XX over the UTF-8 bytes. ``quote`` with
    ``safe=""`` implements exactly this (it never encodes ``-._~``)."""
    return quote(value.encode("utf-8"), safe="")


def _normalized_params(params: list[tuple[str, str]]) -> str:
    """RFC 5849 §3.4.1.3.2: encode each key and value, sort by encoded key
    then encoded value, join with ``&``/``=``."""
    encoded = sorted(
        (percent_encode(k), percent_encode(v)) for k, v in params
    )
    return "&".join(f"{k}={v}" for k, v in encoded)


def _base_uri(url: str) -> str:
    """RFC 5849 §3.4.1.2: lowercase scheme/host, strip default ports, drop
    query and fragment."""
    parts = urlsplit(url)
    scheme = parts.scheme.lower()
    host = (parts.hostname or "").lower()
    port = parts.port
    if port and not (
        (scheme == "http" and port == 80) or (scheme == "https" and port == 443)
    ):
        host = f"{host}:{port}"
    return f"{scheme}://{host}{parts.path or '/'}"


def signature_base_string(
    method: str, url: str, params: list[tuple[str, str]]
) -> str:
    """RFC 5849 §3.4.1.1. ``params`` must already contain the oauth_*
    protocol params and every query/form param (NOT oauth_signature)."""
    return "&".join((
        method.upper(),
        percent_encode(_base_uri(url)),
        percent_encode(_normalized_params(params)),
    ))


def sign(
    method: str,
    url: str,
    params: list[tuple[str, str]],
    consumer_secret: str,
    token_secret: str = "",
) -> str:
    """HMAC-SHA1 signature (RFC 5849 §3.4.2), base64 text."""
    key = f"{percent_encode(consumer_secret)}&{percent_encode(token_secret)}"
    digest = hmac.new(
        key.encode("ascii"),
        signature_base_string(method, url, params).encode("ascii"),
        hashlib.sha1,
    ).digest()
    return base64.b64encode(digest).decode("ascii")


def authorization_header(
    method: str,
    url: str,
    consumer_key: str,
    consumer_secret: str,
    token: str,
    token_secret: str,
    extra_params: list[tuple[str, str]] | None = None,
    nonce: str | None = None,
    timestamp: int | None = None,
) -> str:
    """Build the ``OAuth ...`` Authorization header value for a request.

    ``extra_params`` = query-string and form-body params that participate in
    the signature (RFC 5849 §3.4.1.3.1) but are NOT emitted in the header.
    The query component of ``url`` is folded in automatically.
    """
    oauth_params = [
        ("oauth_consumer_key", consumer_key),
        ("oauth_nonce", nonce if nonce is not None else secrets.token_hex(16)),
        ("oauth_signature_method", "HMAC-SHA1"),
        ("oauth_timestamp", str(timestamp if timestamp is not None else int(time.time()))),
        ("oauth_token", token),
        ("oauth_version", "1.0"),
    ]
    signed: list[tuple[str, str]] = list(oauth_params)
    query = urlsplit(url).query
    if query:
        # query strings arrive form-urlencoded; decode to raw values (incl.
        # '+' as space, RFC 5849 §3.4.1.3.1 mandates W3C form decoding) so
        # the signature re-encodes them exactly once
        signed.extend(parse_qsl(query, keep_blank_values=True))
    if extra_params:
        signed.extend(extra_params)
    signature = sign(method, url, signed, consumer_secret, token_secret)
    header_params = oauth_params + [("oauth_signature", signature)]
    return "OAuth " + ", ".join(
        f'{percent_encode(k)}="{percent_encode(v)}"' for k, v in header_params
    )
