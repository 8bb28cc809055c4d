"""Last-value API cache with Config persistence (counterpart of
``twtml_tpu/web/cache.py``; the reference's ApiCache.scala).

It holds the newest message of each ``jsonClass`` and a rolling window of
``Series`` messages. Only Config survives a restart: every cached Config is
backed up to ``{tmpdir}/twtml-web.json`` and restored at boot unless the
server runs with ``-nocache``. The file is the JAX package's, byte for
byte, so either package's server restores the other's backup.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
from dataclasses import asdict

from ..telemetry.api_types import (
    Config, Fleet, Freshness, History, Hosts, Metrics, ModelHealth, Series,
    Serving, Stats, Tenants, decode, encode,
)
from ..utils import get_logger

log = get_logger("web.cache")

BACKUP_FILE = os.path.join(tempfile.gettempdir(), "twtml-web.json")

# rolling chart history: a few minutes of batches for a dashboard that
# connects mid-run
SERIES_WINDOW = 64

# the views kept as the newest message of their type (in memory only)
_VIEWS = (Stats, Metrics, Hosts, Tenants, ModelHealth, Serving, Fleet,
          Freshness, History)


class ApiCache:
    def __init__(self, backup_file: str = BACKUP_FILE):
        self.backup_file = backup_file
        self._config = Config()
        self._views = {cls: cls() for cls in _VIEWS}
        self._series: collections.deque[Series] = collections.deque(maxlen=SERIES_WINDOW)

    def config(self) -> str:
        return encode(self._config)

    def stats(self) -> str:
        return encode(self._views[Stats])

    def metrics(self) -> str:
        return encode(self._views[Metrics])

    def hosts(self) -> str:
        return encode(self._views[Hosts])

    def tenants(self) -> str:
        return encode(self._views[Tenants])

    def model(self) -> str:
        return encode(self._views[ModelHealth])

    def serving(self) -> str:
        return encode(self._views[Serving])

    def fleet(self) -> str:
        return encode(self._views[Fleet])

    def freshness(self) -> str:
        return encode(self._views[Freshness])

    def history(self) -> str:
        return encode(self._views[History])

    def series(self) -> str:
        """The recent Series messages as one JSON array (the chart's
        backfill for a dashboard that connects mid-run)."""
        return json.dumps([{"jsonClass": s.json_class, **asdict(s)} for s in self._series])

    def cache(self, json_text: str) -> None:
        """Keep a message by its ``jsonClass``. A malformed or unknown
        payload is logged and dropped: it never fails a POST or closes a
        websocket."""
        try:
            data = decode(json_text)
        except (ValueError, TypeError, AttributeError):
            log.error("json not recognized: %s", json_text)
            return
        if isinstance(data, Series):
            self._series.append(data)
        elif isinstance(data, Config):
            log.debug("caching config")
            self._config = data
            self.backup()
        else:
            self._views[type(data)] = data

    def backup(self) -> None:
        with open(self.backup_file, "w", encoding="utf-8") as fh:
            fh.write(self.config())

    def restore(self) -> None:
        """Cache the backed-up Config, if there is a readable one."""
        try:
            with open(self.backup_file, encoding="utf-8") as fh:
                text = fh.read()
        except OSError:
            return
        self.cache(text)
