"""The port's logistic learner, its kernel mode's twin, its sentiment labels
and its app, on the CPU, against the JAX package's on the same inputs.

Tolerances: weights and raw margins within rtol/atol 2e-3 of the JAX
learner (the port's fused route stores X in bf16, as the Pallas kernel
does, the JAX main path in f32); hard 0/1 predictions equal except where
|margin| < 1e-3 (the two margins may fall on either side of 0 there); the
twin's logistic mode within 1e-5 of the JAX loop on a bf16-exact design;
labels, lines and counts exactly."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.features.featurizer import Status as JaxStatus
from twtml_tpu.features.sentiment import sentiment_label as jax_sentiment_label
from twtml_tpu.features.sentiment import sentiment_labels as jax_sentiment_labels
from twtml_tpu.models.logistic import StreamingLogisticRegressionWithSGD as JaxLogistic
from twtml_tpu.models.sgd import sgd_inner_loop as jax_sgd_inner_loop
from twtml_tpu.streaming.sources import ReplayFileSource as JaxReplay
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic

from twtml_tpu_torch.apps import logistic_regression as app
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features import native
from twtml_tpu_torch.features.featurizer import Featurizer, Status
from twtml_tpu_torch.features.sentiment import sentiment_label, sentiment_labels
from twtml_tpu_torch.models.logistic import (
    StreamingLogisticRegressionWithSGD,
    threshold_prediction,
)
from twtml_tpu_torch.models.sgd import dense_route
from twtml_tpu_torch.ops import fused_sgd
from twtml_tpu_torch.streaming.sources import ReplayFileSource, SyntheticSource

NOW_MS = 1_700_000_000_000
FIXTURE = "tests/data/tweets.jsonl"
CLOSED = "http://127.0.0.1:9"
QUIET = ["--lightning", CLOSED, "--twtweb", CLOSED, "--webTimeout", "0.2"]
TOL = 2e-3
MARGIN = 1e-3


def two_class_batches(size, n=4, seed=7):
    """(port batches, JAX batches): ``n`` chunks of ``size`` synthetic tweets
    on the padded units wire, the labels replaced by the same seeded 0/1
    draw (the synthetic texts hold no lexicon word, so their sentiment is
    all 1)."""
    ours = list(SyntheticSource(total=n * size, seed=3, base_ms=NOW_MS).produce())
    ref = list(JaxSynthetic(total=n * size, seed=3, base_ms=NOW_MS).produce())
    f, jf = Featurizer(now_ms=NOW_MS), JaxFeaturizer(now_ms=NOW_MS)
    rng = np.random.default_rng(seed)
    out, jout = [], []
    for i in range(n):
        b = f.featurize_batch_units(ours[i * size:(i + 1) * size], row_bucket=size)
        jb = jf.featurize_batch_units(ref[i * size:(i + 1) * size], row_bucket=size)
        labels = (rng.random(size) < 0.6).astype(np.float32) * b.mask
        out.append(b._replace(label=labels))
        jout.append(jb._replace(label=labels.copy()))
    return out, jout


@pytest.mark.parametrize("fraction", [1.0, 0.5], ids=["fused twin", "torch loop -b 0.5"])
def test_step_matches_the_jax_logistic_step(fraction):
    ours, ref = two_class_batches(128)
    port = StreamingLogisticRegressionWithSGD(device="cpu", quality=True,
                                              mini_batch_fraction=fraction)
    assert port.route == ("fused_dense_sgd" if fraction == 1.0 else "torch_loop")
    jax_model = JaxLogistic(quality=True, mini_batch_fraction=fraction)
    for i, (b, jb) in enumerate(zip(ours, ref)):
        w_before = port.latest_weights
        out = port.step(b)
        jout = jax_model.step(jb)
        np.testing.assert_allclose(port.latest_weights, np.asarray(jax_model.latest_weights),
                                   rtol=TOL, atol=TOL)
        assert float(out.count) == float(jout.count) == b.num_valid
        preds, jpreds = out.predictions.numpy(), np.asarray(jout.predictions)
        assert set(np.unique(preds)) <= {0.0, 1.0}
        # the margins X·w0 of the step: equal predictions wherever |margin|
        # is clear of 0
        raw = port_margins(port, b, w_before)
        clear = np.abs(raw) >= MARGIN
        np.testing.assert_array_equal(preds[clear], jpreds[clear])
        for stat in ("mse", "real_stdev", "pred_stdev"):
            np.testing.assert_allclose(float(getattr(out, stat)), float(getattr(jout, stat)),
                                       rtol=TOL, atol=TOL if clear.all() else 0.05)
        np.testing.assert_allclose(out.quality.numpy(), np.asarray(jout.quality),
                                   rtol=TOL, atol=TOL)
        if i == 0:  # zero weights: every margin 0, σ(0) = 0.5, class 0
            np.testing.assert_array_equal(preds, np.zeros_like(preds))


def port_margins(model, batch, w):
    """The raw margins X·w of a host padded units batch, as the step sees X."""
    from twtml_tpu_torch.models.sgd import batch_to_device
    from twtml_tpu_torch.ops.sparse import densify_text
    from twtml_tpu_torch.ops.text_hash import hash_bigrams_device

    b = batch_to_device(batch, "cpu")
    idx, val = hash_bigrams_device(b.units, b.length, 1000)
    x = torch.cat([densify_text(idx, val, 1000), b.numeric], dim=1)
    return (x @ torch.from_numpy(w)).numpy()


def design(rng, rows, features, n_valid):
    x = np.zeros((rows, features), np.float32)
    cols = rng.integers(0, features - 4, size=(rows, 12))
    np.add.at(x, (np.arange(rows)[:, None], cols), rng.integers(1, 3, size=(rows, 12)))
    x[:, -4:] = rng.integers(-3, 4, size=(rows, 4)) / 8  # bf16-exact
    y = (rng.random(rows) < 0.5).astype(np.float32)
    mask = (rng.permutation(rows) < n_valid).astype(np.float32)
    return x, y, mask


@pytest.mark.parametrize("kw", [
    dict(num_iterations=50, step_size=0.1),
    dict(num_iterations=20, step_size=1.0, l2_reg=0.05),
    dict(num_iterations=30, step_size=0.5, convergence_tol=0.2),
], ids=["default", "l2", "converges"])
def test_twin_logistic_mode_matches_the_jax_loop(kw):
    """The twin's logistic mode (the kernel's function, torch.sigmoid) and
    the JAX package's ``sgd_inner_loop`` with ``jax.nn.sigmoid(raw) - y``
    over the same bf16-exact design agree within 1e-5."""
    rng = np.random.default_rng(11)
    x, y, mask = design(rng, 96, 64, 80)
    w0 = (rng.normal(size=64) * 0.01).astype(np.float32)
    w, preds = fused_sgd.fused_dense_sgd(
        *(torch.from_numpy(a) for a in (x, y, mask, w0)),
        residual_fn=fused_sgd.logistic_residual, **kw)
    xj, yj, mj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)

    def grad_and_count(wj, sel):
        r = (jax.nn.sigmoid(xj @ wj) - yj) * sel
        return xj.T @ r, jnp.sum(sel)

    wj = jax_sgd_inner_loop(
        jnp.asarray(w0), num_iterations=kw["num_iterations"], step_size=kw["step_size"],
        mini_batch_fraction=1.0, l2_reg=kw.get("l2_reg", 0.0),
        convergence_tol=kw.get("convergence_tol", 0.001), mask=mj,
        sample_key=jax.random.PRNGKey(42), grad_and_count=grad_and_count)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(preds.numpy(), (x * mask[:, None]) @ w0, rtol=1e-5, atol=1e-6)


def test_logistic_masked_rows_add_nothing():
    """A masked row's residual is σ(0) - 0 = 0.5 after the zeroing, but its
    row of X is 0: NaN/Inf in masked rows change nothing, bitwise."""
    rng = np.random.default_rng(5)
    x, y, mask = design(rng, 64, 40, 50)
    dirty_x, dirty_y = x.copy(), y.copy()
    dirty_x[mask == 0] = np.nan
    dirty_y[mask == 0] = np.inf
    kw = dict(num_iterations=30, step_size=0.1, residual_fn=fused_sgd.logistic_residual)
    w0 = torch.zeros(40)
    clean = fused_sgd.fused_dense_sgd(torch.from_numpy(x * mask[:, None]),
                                      torch.from_numpy(y * mask), torch.from_numpy(mask), w0, **kw)
    dirty = fused_sgd.fused_dense_sgd(torch.from_numpy(dirty_x), torch.from_numpy(dirty_y),
                                      torch.from_numpy(mask), w0, **kw)
    for a, b in zip(clean, dirty):
        assert torch.equal(a, b)


def test_residual_modes_and_routes():
    assert fused_sgd.residual_mode(None) == 0
    assert fused_sgd.residual_mode(fused_sgd.least_squares_residual) == 0
    assert fused_sgd.residual_mode(fused_sgd.logistic_residual) == 1
    other = lambda raw, label: raw - 2 * label  # noqa: E731
    assert fused_sgd.residual_mode(other) is None
    assert dense_route(1.0, torch.float32, fused_sgd.logistic_residual) == "fused_dense_sgd"
    assert dense_route(1.0, torch.float32, other) == "torch_loop"
    assert dense_route(1.0, torch.bfloat16, fused_sgd.logistic_residual) == "torch_loop"
    with pytest.raises(ValueError, match="no residual mode"):
        fused_sgd.fused_dense_sgd(torch.zeros(2, 8), torch.zeros(2), torch.ones(2),
                                  torch.zeros(8), num_iterations=1, step_size=0.1,
                                  residual_fn=other)
    assert StreamingLogisticRegressionWithSGD(device="cpu", dtype=torch.bfloat16).route == \
        "torch_loop"


def test_kernel_arguments_carry_the_residual_mode():
    plan = fused_sgd.launch_plan(64, 1004, sm_count=132, shared_limit=232448)
    t = torch.zeros(1)
    x = torch.zeros(64, 1004)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "current_stream", lambda: type("S", (), {"cuda_stream": 0})())
        args = fused_sgd.kernel_args(plan, x, t, t, t, t, t, t, t, num_iterations=50,
                                     step_size=0.1, l2_reg=0.0, convergence_tol=0.001, mode=1)
    assert len(args) == len(fused_sgd.KERNEL_ARGTYPES)
    assert args[-2] == 1


def test_threshold_is_sigmoid_not_sign():
    """σ of a tiny positive margin rounds to exactly 0.5: class 0, as the
    JAX package's ``sigmoid(raw) > 0.5``, where ``raw > 0`` would say 1."""
    raw = np.array([1e-9, 1e-7, 0.0, -1e-9, 3.0, -3.0], np.float32)
    ours = threshold_prediction(torch.from_numpy(raw)).numpy()
    theirs = np.asarray((jax.nn.sigmoid(jnp.asarray(raw)) > 0.5).astype(jnp.float32))
    np.testing.assert_array_equal(ours, theirs)
    assert ours[0] == 0.0 and (raw[0] > 0)


# ---- sentiment labels -----------------------------------------------------------

CASES = [  # tests/test_secondary_apps.py TestBatchSentiment's cases
    "good vibes only",
    "this is BAD, really TERRIBLE stuff",
    "GREAT!!! but the problem... isn't awful?",
    "don't hate, it's the best",
    "goodness gracious",
    "café terrible",
    "ΣΙΓΜΑ bad",
    "",
    "x" * 500,
    "win-win fail/fail",
]


def statuses(cls):
    return [cls(text="RT", retweeted_status=cls(text=t, retweet_count=200)) for t in CASES]


@pytest.mark.parametrize("native_lib", [True, False], ids=["C scan", "python"])
def test_sentiment_labels_equal_the_jax_packages(native_lib, monkeypatch):
    if not native_lib:
        monkeypatch.setattr(native, "lexicon_scores", lambda *a, **k: None)
    ours = sentiment_labels(statuses(Status))
    theirs = jax_sentiment_labels(statuses(JaxStatus))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        [sentiment_label(s) for s in statuses(Status)],
        [jax_sentiment_label(s) for s in statuses(JaxStatus)])
    np.testing.assert_array_equal(ours, [sentiment_label(s) for s in statuses(Status)])


def test_the_c_scan_runs_on_ascii_rows():
    from twtml_tpu_torch.features import sentiment

    got = native.lexicon_scores(
        (np.frombuffer("good bad great".encode("utf-16-le"), np.uint16), np.array([0, 4, 14])),
        2, sentiment._POS_PACKED, sentiment._NEG_PACKED)
    assert got is not None
    np.testing.assert_array_equal(got[0], [1, 0])
    np.testing.assert_array_equal(got[1], [1, 1])


@pytest.mark.parametrize("path", ["featurize_batch_units", "featurize_batch_ragged",
                                  "featurize_batch"])
@pytest.mark.parametrize("hooks", ["label_fn", "both"])
def test_every_featurize_path_honours_the_label_hooks(path, hooks):
    """The featurizer's label_fn alone and label_fn + batch_label_fn give
    the JAX featurizer's labels on the fixture (looped, with the
    lexicon's cases mixed in), on every wire."""
    ours = _fixture(ReplayFileSource, 40)
    ref = _fixture(JaxReplay, 40)
    ours += [s for s in statuses(Status)]
    ref += [s for s in statuses(JaxStatus)]
    batch_fn = (sentiment_labels, jax_sentiment_labels) if hooks == "both" else (None, None)
    f = Featurizer(now_ms=1, label_fn=sentiment_label, batch_label_fn=batch_fn[0],
                   num_retweet_begin=0)
    jf = JaxFeaturizer(now_ms=1, label_fn=jax_sentiment_label, batch_label_fn=batch_fn[1],
                       num_retweet_begin=0)
    got = getattr(f, path)(ours, row_bucket=64)
    want = getattr(jf, path)(ref, row_bucket=64)
    np.testing.assert_array_equal(np.asarray(got.label), np.asarray(want.label))
    assert 0 < float(np.asarray(got.label)[:got.num_valid].mean()) < 1


def _fixture(cls, n):
    import itertools

    return list(itertools.islice(cls(FIXTURE, loop=True).produce(), n))


# ---- the app ----------------------------------------------------------------------

def test_app_on_the_fixture_prints_the_jax_apps_lines(monkeypatch, capsys):
    from twtml_tpu.apps import logistic_regression as jax_app

    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    argv = ["--source", "replay", "--replayFile", FIXTURE, "--seconds", "0",
            "--batchBucket", "4", *QUIET]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        totals = app.run(ConfArguments().parse(["--backend", "cpu", *argv]))
    lines = out.getvalue().splitlines()
    jax.devices()
    capsys.readouterr()
    jax_app.run(JaxConf().parse([*argv, "--master", "local[1]"]))
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("count:")]
    assert lines == jax_lines
    assert totals["count"] == 6 and totals["batches"] == 3
    assert all("errRate:" in ln and "posRate (real, pred):" in ln for ln in lines)


def test_app_publishes_percent_stats_and_checkpoints(tmp_path, monkeypatch):
    """The session update gets the error rate and stdevs x100, whole, and
    ``--checkpointDir`` saves the logistic weights (one vector) that a
    second run restores."""
    from twtml_tpu_torch.telemetry import session_stats

    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    updates = []
    monkeypatch.setattr(session_stats.SessionStats, "update",
                        lambda self, *a: updates.append(a))
    argv = ["--backend", "cpu", "--source", "replay", "--replayFile", FIXTURE,
            "--seconds", "0", "--batchBucket", "4", "--checkpointDir", str(tmp_path),
            "--checkpointEvery", "1", *QUIET]
    with contextlib.redirect_stdout(io.StringIO()):
        totals = app.run(ConfArguments().parse(argv))
    assert totals["batches"] == 3 and len(updates) == 3
    for count, b, err, real, pred, *_ in updates:
        assert all(float(v).is_integer() for v in (err, real, pred)) and 0 <= err <= 100
    from twtml_tpu_torch.checkpoint import Checkpointer

    state, meta = Checkpointer(str(tmp_path)).restore()
    assert state.shape == (1004,) and meta["batches"] == 3


@pytest.mark.parametrize("argv,item", [(["--master", "local[2]"], "A10"),
                                       (["--elastic", "on"], "A10")])
def test_app_refuses_the_multi_host_values(argv, item):
    """``--elastic on`` raises naming ROADMAP A10b (the rest of ``item``);
    ``local[2]``, refused until the lockstep runtime (A10a) was ported,
    resolves to one data shard and trains."""
    conf = ConfArguments().parse(["--backend", "cpu", "--source", "synthetic", "--seconds",
                                  "0", "--batchBucket", "4", *argv, *QUIET])
    if conf.elastic == "on":
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}b"):
            app.run(conf)
        return
    assert app.run(conf, max_batches=1)["batches"] == 1
