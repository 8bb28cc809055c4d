"""Champion/challenger serving on the tenant stack (counterpart of
``twtml_tpu/serving/abtest.py``).

- **one wire, M variants, one fetch**: the engine is the predict engine over
  the zero-iteration tenant stack, but every variant sees the SAME rows:
  the coalesced batch is mirrored to all M tenants
  (``prepare_wire_from_parts([batch] * M)``), so the challengers ride the
  champion's H2D copy and fetch. On the card a served batch is M launches
  of B1's predict-only mode and one D2H copy.
- **the champion answers**: a response takes the champion's row of the
  fetched [M, B] predictions. The champion index is taken at DISPATCH and
  rides beside the output through ``fetch_output``, so a batch in flight
  across a champion swap answers with the tenant it was dispatched under.
- **challengers are shadow-scored** on the host: each one's mean
  |challenger - champion| over the fetched predictions, an EWMA a tenant.
  The ranking score is the trainer's per-tenant quality stamp in every
  verified checkpoint (``meta["quality"]["tenants"]``,
  telemetry/modelwatch.py).
- **promotion through the one gate**: when a snapshot installs, a strictly
  better-scored challenger becomes the champion only if
  ``serving/snapshot.is_promotable`` passes its stamp; an alert-stamped one
  is refused and counted (``abtest.promotions_refused``). One decision a
  stamped step, a pure function of the stamps, so every replica of a read
  fleet picks the same champion.
"""

from __future__ import annotations

import numpy as np

from ..telemetry import metrics as _metrics
from ..utils import get_logger
from .engine import PredictEngine
from .snapshot import is_promotable

log = get_logger("serving.abtest")

# smoothing of the shadow divergence EWMA (host telemetry only)
_SHADOW_ALPHA = 0.2


def _score(entry: "dict | None") -> float:
    """The A/B ranking metric of a per-tenant stamp, smaller is better: the
    trainer's online loss EWMA (``loss``). Loss only: whether a winner may
    serve is ``is_promotable``'s call, so an alert-stamped best loss is
    refused there and counted. A missing or invalid stamp scores worst."""
    if not isinstance(entry, dict):
        return float("inf")
    try:
        loss = float(entry.get("loss", -1.0))
    except (TypeError, ValueError):
        loss = -1.0
    return loss if loss >= 0 else float("inf")


class ChampionSelector:
    """The champion index and the promotion rule. ``consider`` runs when a
    snapshot installs (the serve loop, between dispatches) and returns the
    new champion, or None when nothing changes."""

    def __init__(self, num_tenants: int, champion: int = 0):
        if not 0 <= champion < num_tenants:
            raise ValueError(f"champion {champion} out of range for {num_tenants} tenants")
        self.num_tenants = num_tenants
        self.champion = champion
        self._last_step: "int | None" = None
        reg = _metrics.get_registry()
        self._promotions = reg.counter("abtest.promotions")
        self._refused = reg.counter("abtest.promotions_refused")

    def consider(self, meta: "dict | None", step: int) -> "int | None":
        """One decision a stamped step: every strictly better challenger
        goes through ``is_promotable`` (an alert stamp is refused and
        counted), then the best survivor becomes the champion."""
        if self._last_step is not None and step == self._last_step:
            return None
        self._last_step = step
        tenants = ((meta or {}).get("quality") or {}).get("tenants") or []
        entries: dict = {}
        for i, e in enumerate(tenants):
            if isinstance(e, dict):
                entries[int(e.get("tenant", i))] = e
        if len(entries) < 2:
            return None  # no per-tenant stamps: nothing to compare
        best, best_entry = self.champion, entries.get(self.champion)
        for m in sorted(entries):
            if m == self.champion or not 0 <= m < self.num_tenants:
                continue
            entry = entries[m]
            if _score(entry) >= _score(best_entry):
                continue
            ok, reason = is_promotable({"finite": True, "quality": entry})
            if not ok:
                self._refused.inc()
                log.warning("challenger tenant %d REFUSED promotion at step %d (champion "
                            "stays %d): %s", m, step, self.champion, reason)
                continue
            best, best_entry = m, entry
        if best == self.champion:
            return None
        prev, self.champion = self.champion, best
        self._promotions.inc()
        log.info("champion AUTO-promoted: tenant %d -> %d at snapshot step %d (stamp %s "
                 "beats %s)", prev, best, step, _score(best_entry), _score(entries.get(prev)))
        return best


class _ShadowTrack:
    """A challenger's shadow score: rows mirrored, and the EWMA of the mean
    |challenger - champion| prediction divergence."""

    __slots__ = ("rows", "divergence")

    def __init__(self):
        self.rows = 0
        self.divergence: "float | None" = None

    def observe(self, diff_mean: float, rows: int) -> None:
        self.rows += rows
        if self.divergence is None:
            self.divergence = diff_mean
        else:
            self.divergence += _SHADOW_ALPHA * (diff_mean - self.divergence)


class _ChampionFetch:
    """A pending fetch of the mirrored output with the champion it was
    dispatched under: ``result()`` is (StepOutput, champion)."""

    __slots__ = ("_pending", "_champion")

    def __init__(self, pending, champion: int):
        self._pending = pending
        self._champion = champion

    def done(self) -> bool:
        return self._pending.done()

    def wait(self) -> None:
        self._pending.wait()

    def result(self):
        return self._pending.result(), self._champion


class ChampionEngine(PredictEngine):
    """A ``PredictEngine`` over the tenant stack whose live traffic the
    champion tenant answers, mirrored in shadow to every challenger. It
    takes ``ServingPlane``'s engine seat (the surface the FetchPipeline
    drives)."""

    def __init__(self, *args, champion: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        if self.num_tenants < 2:
            raise ValueError("champion/challenger needs a tenant stack (num_tenants >= 2), "
                             f"got {self.num_tenants} — train with --tenants M")
        self.selector = ChampionSelector(self.num_tenants, champion)
        self._shadows = [_ShadowTrack() for _ in range(self.num_tenants)]
        self._live_rows = np.zeros((self.num_tenants,), np.int64)

    @property
    def champion(self) -> int:
        return self.selector.champion

    # -- snapshot install and promotion --------------------------------------
    def set_snapshot(self, snapshot) -> None:
        """Install the stack AND run the promotion rule on its per-tenant
        stamps, both on the serve loop between dispatches
        (``ServingPlane._install``): the (weights, champion) swap is one
        event to the dispatches."""
        super().set_snapshot(snapshot)
        self.selector.consider(getattr(snapshot, "meta", None), int(snapshot.step))

    # -- FetchPipeline surface -------------------------------------------------
    def pack_for_wire(self, batch):
        """The mirrored tenant wire: every variant sees the batch's rows."""
        return self.model.prepare_wire_from_parts([batch] * self.num_tenants)

    def step(self, wire):
        """Dispatch the mirrored stack; the champion at dispatch rides with
        the output, so delivery answers with it even across a swap."""
        return self.model.step(wire), int(self.champion)

    def fetch_output(self, out):
        """The ONE fetch of the mirrored [M]-leading output, carrying the
        dispatch-time champion (the watchdog re-issues it with the same
        pair)."""
        dev_out, champion = out
        return _ChampionFetch(self.model.fetch_output(dev_out), champion)

    # -- result extraction ---------------------------------------------------
    def step_output(self, host_out):
        return host_out[0]

    def predictions_for(self, host_out, batch) -> np.ndarray:
        """The champion's row of the fetched [M, B] predictions (the mirror
        keeps every tenant in the batch's row order), and the shadow scores
        of the challengers."""
        out, champ = host_out
        mask = np.asarray(batch.mask) > 0
        tenant_preds = np.asarray(out.predictions)
        live = tenant_preds[champ][mask]
        rows = int(mask.sum())
        self._live_rows[champ] += rows
        if rows:
            for m in range(self.num_tenants):
                if m != champ:
                    self._shadows[m].observe(
                        float(np.abs(tenant_preds[m][mask] - live).mean()), rows)
        return live

    def tenant_row_counts(self, batch) -> "np.ndarray | None":
        """The answered rows, all the champion's (the challengers' exposure
        is the shadow view)."""
        counts = np.zeros((self.num_tenants,), np.int64)
        counts[self.champion] = int((np.asarray(batch.mask) > 0).sum())
        return counts

    # -- telemetry -----------------------------------------------------------
    def abtest_view(self) -> dict:
        """The A/B slice of the Serving view: the champion, and a tenant's
        live and shadow rows and divergence each."""
        reg = _metrics.get_registry()
        shadows = []
        for m in range(self.num_tenants):
            track = self._shadows[m]
            shadows.append({
                "tenant": m,
                "live": m == self.champion,
                "liveRows": int(self._live_rows[m]),
                "shadowRows": int(track.rows),
                "divergence": round(track.divergence or 0.0, 4),
            })
        return {
            "champion": int(self.champion),
            "shadows": shadows,
            "promotions": int(reg.counter("abtest.promotions").snapshot()),
            "refusedPromotions": int(reg.counter("abtest.promotions_refused").snapshot()),
        }
