"""Standalone web-server entry (counterpart of ``twtml_tpu/web/main.py``;
the reference's Main.scala).

``python -m twtml_tpu_torch.web.main [-nocache]``: restores the backed-up
Config unless ``-nocache`` is given, listens on ``PORT`` (default 8888, the
Heroku convention) on every interface, and stops cleanly on SIGINT or
SIGTERM. Host-only: the server has no device.
"""

from __future__ import annotations

import os
import signal
import sys

from ..utils import get_logger
from .cache import ApiCache
from .server import Server

log = get_logger("web.main")


def main(argv: list[str] | None = None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    cache = ApiCache()
    if "-nocache" not in args:
        cache.restore()

    port = int(os.environ.get("PORT", "8888"))
    server = Server(port=port, cache=cache)

    def shutdown(_sig, _frame):
        log.info("shutting down")
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, shutdown)
    try:
        server.run_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
