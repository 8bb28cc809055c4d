"""The port's model watcher (``twtml_tpu_torch/telemetry/modelwatch.py``)
against the JAX package's: the same quality and mse sequences give equal
verdicts, views and checkpoint stamps from both (host numpy, so exact); the
quality layout is the same; the app posts a ModelHealth view whose level
and episodes equal the JAX app's."""

import numpy as np
import pytest

from twtml_tpu.ops.quality import QUALITY_FIELDS as JAX_FIELDS
from twtml_tpu.telemetry import metrics as jax_metrics
from twtml_tpu.telemetry.modelwatch import ModelWatch as JaxWatch
from twtml_tpu_torch.ops.quality import QUALITY_FIELDS, QUALITY_INDEX, QUALITY_WIDTH
from twtml_tpu_torch.telemetry import metrics as _metrics
from twtml_tpu_torch.telemetry import modelwatch
from twtml_tpu_torch.telemetry.modelwatch import ModelWatch


@pytest.fixture(autouse=True)
def fresh():
    _metrics.reset_for_tests()
    jax_metrics.reset_for_tests()
    modelwatch.reset_for_tests()
    yield
    modelwatch.reset_for_tests()
    _metrics.reset_for_tests()


def _ticks(kind, n=160, seed=0):
    """(quality [Q], count, mse) ticks of a seeded stream: stationary, a
    sustained shift of the label mean, a rising loss, a NaN entry, empty
    batches, or a shift that recovers."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        q = rng.normal(size=QUALITY_WIDTH) * 0.05 + 1.0
        mse = 1000.0 + rng.normal() * 20.0
        count = 16.0
        if kind == "shift" and i >= 100:
            q[QUALITY_INDEX["label_mean"]] += 3.0
        if kind == "recover" and 100 <= i < 120:
            q[QUALITY_INDEX["pred_mean"]] += 5.0
        if kind == "trend" and i >= 60:
            mse *= 1.0 + (i - 60) * 0.1
        if kind == "nan" and i in (50, 51):
            q[3] = np.nan
        if kind == "empty" and i % 7 == 0:
            count = 0.0
        out.append((q, count, mse))
    return out


KINDS = ["stationary", "shift", "recover", "trend", "nan", "empty"]


def test_quality_layout_equals_the_jax_packages():
    assert QUALITY_FIELDS == JAX_FIELDS


@pytest.mark.parametrize("kind", KINDS)
def test_verdicts_views_and_stamps_equal_the_jax_watchers(kind):
    ours, theirs = ModelWatch(), JaxWatch()
    for i, (q, count, mse) in enumerate(_ticks(kind, seed=KINDS.index(kind))):
        assert ours.observe(q, count, mse) == theirs.observe(q, count, mse), i
    assert ours.view() == theirs.view()
    assert ours.checkpoint_snapshot() == theirs.checkpoint_snapshot()


def test_levels_move_as_the_stream_does():
    watch = ModelWatch()
    levels = [watch.observe(q, c, m)["level"] for q, c, m in _ticks("shift")]
    assert set(levels[:100]) == {"ok"} and levels[-1] == "alert"
    watch = ModelWatch()
    levels = [watch.observe(q, c, m)["level"] for q, c, m in _ticks("nan")]
    assert levels[50] == "alert" and levels[-1] == "ok"


def test_custom_thresholds_equal_the_jax_watchers():
    kw = dict(ref_window=20, recent_window=4, min_ref=5, warn_z=2.0, alert_z=3.0,
              trend_warn=0.1, trend_alert=0.3)
    ours, theirs = ModelWatch(**kw), JaxWatch(**kw)
    for q, count, mse in _ticks("trend", n=80, seed=9):
        assert ours.observe(q, count, mse) == theirs.observe(q, count, mse)


def test_width_mismatch_raises():
    with pytest.raises(ValueError, match="quality vector width"):
        ModelWatch().observe(np.zeros(3), 16.0, 1.0)


def test_module_face_and_gauges():
    assert modelwatch.last_model() is None and modelwatch.snapshot_for_checkpoint() is None
    for q, count, mse in _ticks("stationary", n=3):
        modelwatch.record_tick(q, count, mse)
    view = modelwatch.last_model()
    assert view["ticks"] == 3 and view["level"] == "ok" and len(view["mse"]) == 3
    gauges = _metrics.get_registry().snapshot()["gauges"]
    assert gauges["model.health_level"] == 0
    assert gauges["model.weight_norm"] == round(view["weight_norm"], 4)
