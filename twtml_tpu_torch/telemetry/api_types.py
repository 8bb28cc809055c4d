"""Wire schema of the dashboard's JSON API (counterpart of
``twtml_tpu/telemetry/api_types.py``), byte for byte.

The reference serializes its case classes with json4s ``ShortTypeHints``,
which adds a ``jsonClass`` discriminator field; the same shape is kept, so
the reference's dashboards, the JAX package's and this port's are
interchangeable:

  {"jsonClass": "Config", "id": "...", "host": "...", "viz": ["..."]}
  {"jsonClass": "Stats", "count": 0, "batch": 0, "mse": 0, "realStddev": 0, "predStddev": 0}

``Series``, ``Metrics``, ``ModelHealth`` and ``Freshness`` are the JAX
package's additive types (the live chart, the observability panel, the
model-health and freshness tiles); legacy dashboards ignore them. The other
additive types (hosts, tenants, serving, fleet, history) belong to planes
the port has not ported.
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


TYPES = {"Config": Config, "Stats": Stats, "Series": Series, "Metrics": Metrics,
         "ModelHealth": ModelHealth, "Freshness": Freshness}


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
