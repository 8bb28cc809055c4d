"""The per-tenant view of the tenant plane (counterpart of
``twtml_tpu/telemetry/tenants.py``).

The tenant delivery wrapper (apps/common.py ``attach_super_batcher``)
records one row a tenant a delivered tick from the already-fetched
[M]-leading StepOutput: host bookkeeping, no added copy from the card.
``last_tenants`` is the dashboard's ``Tenants`` view (published by
telemetry/session_stats.py). The registry carries ``tenants.active``
(tenants with rows this tick), ``tenants.configured``, and a
``tenant.<m>.rows`` counter and ``tenant.<m>.mse`` gauge a tenant.

The gating tenant is the one with the most rows this tick: the one that
fills the shared row bucket first.
"""

from __future__ import annotations

import threading

import numpy as np

from . import metrics as _metrics

_lock = threading.Lock()
_state: "dict | None" = None


def reset_for_tests() -> None:
    global _state
    with _lock:
        _state = None


def record_tick(counts, mses) -> None:
    """One delivered tick's per-tenant (row count, mse), host arrays."""
    global _state
    counts = np.asarray(counts, np.int64)
    mses = np.asarray(mses, np.float64)
    m = counts.shape[0]
    with _lock:
        st = _state
        if st is None or st["rows"].shape[0] != m:
            st = {
                "rows": np.zeros((m,), np.int64),
                "ticks": 0,
                "last_counts": np.zeros((m,), np.int64),
                "last_mses": np.zeros((m,), np.float64),
            }
        st["rows"] += counts
        st["ticks"] += 1
        st["last_counts"] = counts
        st["last_mses"] = mses
        _state = st
    reg = _metrics.get_registry()
    reg.gauge("tenants.active").set(int((counts > 0).sum()))
    reg.gauge("tenants.configured").set(m)
    for i in range(m):
        if counts[i]:
            reg.counter(f"tenant.{i}.rows").inc(int(counts[i]))
            if np.isfinite(mses[i]):
                reg.gauge(f"tenant.{i}.mse").set(round(float(mses[i]), 3))


def last_tenants() -> "dict | None":
    """The dashboard view: a row a tenant (rows in all, rows and mse of
    the last tick), the gating tenant (-1 when every tenant was dry) and
    the active count; None before the first tenant tick."""
    with _lock:
        st = _state
        if st is None:
            return None
        counts = st["last_counts"]
        return {
            "tenants": [
                {
                    "tenant": i,
                    "rows": int(st["rows"][i]),
                    "batch": int(counts[i]),
                    "mse": (round(float(st["last_mses"][i]), 3)
                            if np.isfinite(st["last_mses"][i]) else -1.0),
                }
                for i in range(st["rows"].shape[0])
            ],
            "gating": int(np.argmax(counts)) if counts.any() else -1,
            "active": int((counts > 0).sum()),
            "ticks": int(st["ticks"]),
        }
