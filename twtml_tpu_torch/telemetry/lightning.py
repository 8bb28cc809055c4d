"""Lightning visualization-server client, streaming charts (counterpart of
``twtml_tpu/telemetry/lightning.py``).

``Lightning(host)`` creates its session lazily; ``line_streaming(series,
size, color)`` creates a ``line-streaming`` visualization seeded with the
series, and ``line_streaming(series, viz=viz)`` appends to it;
``scatter_streaming(x, y, label)`` does the same for the k-means app's
``scatter-streaming`` cluster chart. Endpoints
follow the public Lightning REST protocol: ``POST /sessions/``,
``POST /sessions/{id}/visualizations/``, ``POST /visualizations/{id}/data/``.
Callers keep the reference's best-effort ``Try`` semantics.
"""

from __future__ import annotations

import json
import urllib.request
from dataclasses import dataclass

# per-batch cap on chart points shipped to a streaming chart
CHART_MAX_POINTS = 200


@dataclass
class Visualization:
    id: str
    session: str
    host: str


@dataclass
class Lightning:
    host: str = "http://localhost:3000"
    session: str = ""
    timeout: float = 2.0

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.host.rstrip("/") + path,
            data=json.dumps(payload).encode("utf-8"),
            headers={"content-type": "application/json", "accept": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            body = resp.read().decode("utf-8")
        return json.loads(body) if body else {}

    def create_session(self, name: str = "") -> str:
        out = self._post("/sessions/", {"name": name} if name else {})
        self.session = str(out.get("id", ""))
        return self.session

    def _create_or_append(self, viz_type: str, data: dict,
                          viz: Visualization | None) -> Visualization:
        """``viz=None`` creates a ``viz_type`` visualization seeded with
        ``data`` (and the session, lazily); else appends ``data`` to it."""
        if viz is not None:
            self._post(f"/visualizations/{viz.id}/data/", {"data": data})
            return viz
        if not self.session:
            self.create_session()
        out = self._post(
            f"/sessions/{self.session}/visualizations/",
            {"type": viz_type, "data": data},
        )
        return Visualization(id=str(out.get("id", "")), session=self.session,
                             host=self.host)

    def line_streaming(self, series, size=None, color=None,
                       viz: Visualization | None = None) -> Visualization:
        """Create (``viz=None``) or append to a streaming line chart."""
        data: dict = {"series": [list(map(float, s)) for s in series]}
        if size is not None:
            data["size"] = list(map(float, size))
        if color is not None:
            data["color"] = [list(map(float, c)) for c in color]
        return self._create_or_append("line-streaming", data, viz)

    def scatter_streaming(self, x, y, label=None,
                          viz: Visualization | None = None) -> Visualization:
        """Create (``viz=None``) or append to a streaming scatter plot, with
        per-point integer labels (the cluster chart)."""
        data: dict = {"x": list(map(float, x)), "y": list(map(float, y))}
        if label is not None:
            data["label"] = list(map(int, label))
        return self._create_or_append("scatter-streaming", data, viz)
