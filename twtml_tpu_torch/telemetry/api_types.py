"""Wire schema of the dashboard's JSON API (counterpart of
``twtml_tpu/telemetry/api_types.py``), byte for byte.

The reference serializes its case classes with json4s ``ShortTypeHints``,
which adds a ``jsonClass`` discriminator field; the same shape is kept, so
the reference's dashboards, the JAX package's and this port's are
interchangeable:

  {"jsonClass": "Config", "id": "...", "host": "...", "viz": ["..."]}
  {"jsonClass": "Stats", "count": 0, "batch": 0, "mse": 0, "realStddev": 0, "predStddev": 0}

The other types are the JAX package's additive ones, which legacy
dashboards ignore: ``Series`` (the live chart), ``Metrics`` (the
observability panel), ``Hosts``, ``Tenants``, ``ModelHealth``, ``Serving``,
``Freshness``, ``Fleet`` and ``History`` (their tiles). The port's app
publishes Series, Metrics, ModelHealth, Freshness and History; its web
server caches and answers all of them (the producers of Hosts, Tenants,
Serving and Fleet are the multi-host, tenant and serving planes).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field


@dataclass
class Config:
    id: str = ""
    host: str = ""
    viz: list[str] = field(default_factory=list)

    json_class = "Config"


@dataclass
class Stats:
    count: int = 0
    batch: int = 0
    mse: int = 0
    realStddev: int = 0
    predStddev: int = 0

    json_class = "Stats"


@dataclass
class Series:
    """One batch's real/predicted values for the built-in live chart."""

    real: list[float] = field(default_factory=list)
    pred: list[float] = field(default_factory=list)
    realStddev: float = 0.0
    predStddev: float = 0.0

    json_class = "Series"


@dataclass
class Metrics:
    """A pipeline-metrics snapshot for the dashboard's observability panel:
    flat counter and gauge maps, the health monitor's summary, and per
    histogram its count/mean/p50/p95/p99."""

    counters: dict = field(default_factory=dict)
    gauges: dict = field(default_factory=dict)
    health: dict = field(default_factory=dict)
    histograms: dict = field(default_factory=dict)

    json_class = "Metrics"


@dataclass
class Hosts:
    """The per-host lockstep view of a multi-host run: one row a host, the
    straggler (host, stage, skew), the elastic epoch and membership counts,
    and the current lead's uid (-1 when not elastic)."""

    hosts: list = field(default_factory=list)
    straggler: int = -1
    stage: str = ""
    skewMs: float = 0.0
    epoch: int = -1
    liveHosts: int = 0
    departed: int = 0
    rejoined: int = 0
    leadUid: int = -1

    json_class = "Hosts"


@dataclass
class Tenants:
    """The multi-tenant model plane's view: one row a tenant, the gating
    tenant (most rows this tick) and the active-tenant count."""

    tenants: list = field(default_factory=list)
    gating: int = -1
    active: int = 0

    json_class = "Tenants"


@dataclass
class ModelHealth:
    """The model-health view (telemetry/modelwatch.py): level, drift score,
    loss trend, the weight/update/gradient norms, the rolling mse window and
    the drift episodes."""

    level: str = "ok"
    driftScore: float = 0.0
    lossTrend: float = 0.0
    weightNorm: float = 0.0
    updateNorm: float = 0.0
    gradNorm: float = 0.0
    mse: list = field(default_factory=list)
    tenants: list = field(default_factory=list)
    episodes: int = 0

    json_class = "ModelHealth"


@dataclass
class Serving:
    """The serving plane's view: QPS and latency percentiles over the serve
    window, the active snapshot (age, step, quality level), request, row
    and error totals, per-tenant rows, and the champion/challenger state."""

    qps: float = 0.0
    rowsPerSec: float = 0.0
    p50Ms: float = 0.0
    p95Ms: float = 0.0
    p99Ms: float = 0.0
    snapshotAgeS: float = -1.0
    snapshotStep: int = -1
    level: str = ""
    requests: int = 0
    rows: int = 0
    errors: int = 0
    tenants: list = field(default_factory=list)
    champion: int = -1
    shadows: list = field(default_factory=list)
    promotions: int = 0
    refusedPromotions: int = 0

    json_class = "Serving"


@dataclass
class Freshness:
    """The end-to-end freshness view (telemetry/freshness.py): event-time
    lag percentiles to delivery and to publish, the low-watermark
    sparkline, the critical edge with its tick counts, and the SLO state."""

    batches: int = 0
    rows: int = 0
    eventLagMs: float = -1.0
    eventLagP50Ms: float = -1.0
    eventLagP95Ms: float = -1.0
    eventLagP99Ms: float = -1.0
    publishLagP95Ms: float = -1.0
    watermarkLagMs: float = -1.0
    watermark: list = field(default_factory=list)
    critical: str = ""
    criticalTicks: dict = field(default_factory=dict)
    sloMs: float = 0.0
    breachRun: int = 0
    breaches: int = 0

    json_class = "Freshness"


@dataclass
class Fleet:
    """The read fleet's router view: the route policy, per-replica tiles,
    request, retry and ejection totals, and the fleet's champion tenant."""

    policy: str = ""
    replicas: list = field(default_factory=list)
    requests: int = 0
    retries: int = 0
    ejections: int = 0
    champion: int = -1

    json_class = "Fleet"


@dataclass
class History:
    """The telemetry historian's view (telemetry/historian.py ``view``):
    the tail's RSS, fetch-RTT and per-sample stage-cost series, the RSS
    slope, the health phase, the historian's disk use and the perfGuard
    regression count."""

    samples: int = 0
    runId: int = 0
    phase: str = ""
    rssMb: float = 0.0
    rssSlopeMbPerMin: float = 0.0
    rttMs: float = 0.0
    diskMb: float = 0.0
    regressions: int = 0
    rss: list = field(default_factory=list)
    rtt: list = field(default_factory=list)
    stageMs: list = field(default_factory=list)

    json_class = "History"


TYPES = {"Config": Config, "Stats": Stats, "Series": Series,
         "Metrics": Metrics, "Hosts": Hosts, "Tenants": Tenants,
         "ModelHealth": ModelHealth, "Serving": Serving, "Fleet": Fleet,
         "Freshness": Freshness, "History": History}


def encode(obj) -> str:
    payload = {"jsonClass": obj.json_class}
    payload.update(asdict(obj))
    return json.dumps(payload)


def decode(text: str):
    """Dispatch on the ``jsonClass`` hint; raises on unknown types."""
    payload = json.loads(text)
    kind = payload.pop("jsonClass", None)
    cls = TYPES.get(kind)
    if cls is None:
        raise ValueError(f"json not recognized: {text!r}")
    fields = {k: payload[k] for k in cls.__dataclass_fields__ if k in payload}
    return cls(**fields)
