"""Fleet front door: N serve replicas behind one router (counterpart of
``twtml_tpu/apps/router.py``).

Boots the port's dashboard web server with a ``FleetRouter`` attached in
place of a model: ``POST /api/predict`` forwards each request to a replica
by ``--routePolicy`` (least-p99 or consistent hash), a failing replica is
ejected behind a jittered backoff while its traffic retries on the others,
and ``GET /api/fleet`` answers with the live fleet view (also published
every 2 s beside a Metrics snapshot carrying ``router.retries`` and
``fleet.replica_ejections``).

One trainer writes verified checkpoints; N replicas each poll that
directory through their own promoter; this process owns the front door
and holds no model, so it imports no torch:

    python -m twtml_tpu_torch.apps.serve --checkpointDir ck --servePort 8888
    python -m twtml_tpu_torch.apps.serve --checkpointDir ck --servePort 8889
    python -m twtml_tpu_torch.apps.router --routerPort 8899 \\
        --replicas http://127.0.0.1:8888,http://127.0.0.1:8889

    curl -s localhost:8899/api/predict -d '{"rows": [{"text": "hello"}]}'
"""

from __future__ import annotations

import sys
import threading
import time

from ..config import ConfArguments
from ..utils import get_logger

log = get_logger("apps.router")

PUBLISH_EVERY_S = 2.0


def run(conf: ConfArguments, started=None, stop_event=None, max_seconds: float = 0.0) -> dict:
    """Router, web server; route until ``stop_event``, SIGINT or
    ``max_seconds``. ``started(server, router)`` fires once the front door
    is live. Returns the final fleet view."""
    urls = [u.strip() for u in (conf.replicas or "").split(",") if u.strip()]
    if not urls:
        raise SystemExit("--replicas is required: the router fronts serve replicas "
                         "(comma-separated base URLs, e.g. "
                         "--replicas http://127.0.0.1:8888,http://127.0.0.1:8889)")
    from ..serving.fleet import FleetRouter
    from ..telemetry import metrics as _metrics
    from ..telemetry.web_client import WebClient
    from ..web.server import Server

    router = FleetRouter(
        urls, policy=conf.routePolicy,
        # a forward must outlive a replica's own watchdog-bounded fetch path
        timeout=max(float(conf.webTimeout), 30.0),
    ).start()
    server = Server(port=conf.routerPort).attach_fleet(router)
    try:
        server.start_background()
    except OSError:
        router.stop()
        raise
    web = WebClient(f"http://127.0.0.1:{server.port}", timeout=float(conf.webTimeout))
    log.info("fleet front door live: POST /api/predict on port %d over %d replica(s), "
             "policy=%s", server.port, len(urls), router.policy)
    if started is not None:
        started(server, router)

    t0 = time.monotonic()
    stop_event = stop_event or threading.Event()
    try:
        while not stop_event.is_set():
            if max_seconds and time.monotonic() - t0 >= max_seconds:
                break
            stop_event.wait(PUBLISH_EVERY_S)
            try:
                web.fleet(router.stats())
                snap = _metrics.get_registry().snapshot()
                web.metrics(snap.get("counters", {}), snap.get("gauges", {}), {},
                            snap.get("histograms", {}))
            except Exception:
                log.debug("fleet publish failed", exc_info=True)
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()
        stats = router.stats()
        server.stop()
    log.info("router session done: %s requests, %s retries, %s ejections",
             stats["requests"], stats["retries"], stats["ejections"])
    return stats


def main(argv=None) -> None:
    conf = (ConfArguments().setAppName("twitter-stream-ml-router")
            .parse(list(sys.argv[1:] if argv is None else argv)))
    run(conf)


if __name__ == "__main__":
    main()
