"""Streaming logistic-regression entry point (counterpart of
``twtml_tpu/apps/logistic_regression.py``; BASELINE config #3: binary
sentiment on the tweet stream).

The flagship app's pipeline (apps/linear_regression.py ``run_learner``:
the same streaming context, wires, fetch pipeline or superbatch, runtime
guards, checkpoint, journal and historian) with the label swapped for the
lexicon sentiment of the original tweet (features/sentiment.py: the
featurizer's ``label_fn`` and, on the hot path, ``batch_label_fn``; under
``--ingest block`` ``unit_label_fn`` over the parsed blocks' raw units) and the
logistic learner (models/logistic.py), whose step runs the fused kernel in
its logistic mode at ``-b 1`` in float32. The reported ``mse`` over hard
0/1 predictions is the misclassification rate: each batch prints
``count: … batch: … errRate: … posRate (real, pred): (…, …)`` and
publishes the error rate and both stdevs ×100 to the int dashboard.
Across hosts (``--master twtml://``) it trains in lockstep as the flagship
app does; ``--elastic on`` raises naming ROADMAP A10b.

Run: ``python -m twtml_tpu_torch.apps.logistic_regression --backend cpu \\
      --source replay --replayFile tests/data/tweets.jsonl --seconds 0 \\
      --batchBucket 4 --twtweb http://localhost:8899 \\
      --lightning http://localhost:3000``
"""

from __future__ import annotations

import sys

from ..config import ConfArguments
from ..features.sentiment import (
    sentiment_label, sentiment_labels, sentiment_labels_from_units,
)
from ..models.logistic import StreamingLogisticRegressionWithSGD
from ..utils import round_half_up
from ..utils.tracing import annotate
from . import linear_regression
from .common import FETCH_DEPTH


def report_logistic(out, totals: dict, b: int, session, real, pred) -> str:
    """The logistic app's line of one batch, and its session update: the
    error rate and both stdevs as percent for the int dashboard."""
    err_rate = float(out.mse)  # 0/1 predictions: the MSE is the error rate
    rates = f"({real.mean():.2f}, {pred.mean():.2f})" if real.size else "(-, -)"
    with annotate("twtml.publish"):
        session.update(
            totals["count"], b, round_half_up(err_rate * 100),
            round_half_up(float(out.real_stdev) * 100),
            round_half_up(float(out.pred_stdev) * 100), real, pred,
        )
    return (f"count: {totals['count']}  batch: {b}  errRate: {err_rate:.3f}  "
            f"posRate (real, pred): {rates}")


def run(conf: ConfArguments, max_batches: int = 0, fetch_depth: int = FETCH_DEPTH) -> dict:
    """Train the logistic learner on the configured source (the flagship
    app's ``run_learner``, with the same totals and the same aborts)."""
    return linear_regression.run_learner(
        conf, max_batches, fetch_depth, learner=StreamingLogisticRegressionWithSGD,
        report=report_logistic,
        label_fns=(sentiment_label, sentiment_labels, sentiment_labels_from_units),
    )


def main(argv=None) -> None:
    conf = (
        ConfArguments()
        .setAppName("twitter-stream-ml-logistic-regression")
        .parse(list(sys.argv[1:] if argv is None else argv))
    )
    totals = run(conf)
    print(f"done: {totals['count']} tweets in {totals['batches']} batches", file=sys.stderr)


if __name__ == "__main__":
    main()
