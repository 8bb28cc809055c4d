"""One rank of a port lockstep group on the CPU, for the multi-process tests
(tests/test_torch_lockstep.py, tests/test_torch_parallel.py). Not a test
module.

Usage: python tests/torch_lockstep_worker.py <mode> <rank> <world> <port> [args]

- ``app``: the linear app (``apps.linear_regression.run``) with ``args`` and
  the group's ``--master``; prints, as its last line, a JSON object of the
  run's totals, the host-side collective counts
  (parallel/distributed.py ``COUNTERS``) and the registry's counters. Under
  ``--elastic on`` the app leaves through ``elastic_exit``'s hard exit, so
  the record prints just before it.
- ``abort``: a lockstep stream of synthetic tweets whose handler raises on
  rank 1's third batch; prints the ticks and batches each rank saw.
- ``parallel``: one ``ParallelSGDModel`` step on this rank's rows of the
  batch in ``args[0]`` (an .npz), with the options in ``args[1]`` (JSON);
  prints the weights and the stats.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _app(rank: int, world: int, port: int, args: list) -> None:
    from twtml_tpu_torch.apps import linear_regression
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.parallel import distributed
    from twtml_tpu_torch.telemetry import metrics

    argv = args + ["--master", f"twtml://127.0.0.1:{port}", "--numProcesses", str(world),
                   "--processId", str(rank)]
    # the totals the app counts into (an elastic run never returns them)
    kept: list = []
    checkpoint = linear_regression.AppCheckpoint

    def keeping(conf, get_state, set_state, totals: dict, lead: bool = True):
        kept.append(totals)
        return checkpoint(conf, get_state, set_state, totals, lead=lead)

    def report(failed: bool) -> None:
        if getattr(report, "done", False):
            return
        report.done = True
        totals = kept[0] if kept else {}
        snap = metrics.get_registry().snapshot()
        print(json.dumps({
            "rank": rank, "failed": failed, "count": totals.get("count"),
            "batches": totals.get("batches"), "collectives": dict(distributed.COUNTERS),
            "counters": snap["counters"], "gauges": snap["gauges"],
        }), flush=True)

    elastic_exit = linear_regression.elastic_exit

    def exit_reporting(failed: bool = False) -> None:
        report(failed)
        elastic_exit(failed)

    linear_regression.AppCheckpoint = keeping
    linear_regression.elastic_exit = exit_reporting
    failed = False
    try:
        linear_regression.run(ConfArguments().parse(argv))
    except RuntimeError:
        failed = True
    report(failed)


def _abort(rank: int, world: int, port: int) -> None:
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.parallel import distributed
    from twtml_tpu_torch.parallel.sharding import ParallelSGDModel
    from twtml_tpu_torch.streaming.context import StreamingContext
    from twtml_tpu_torch.streaming.sources import ShardedSource, SyntheticSource

    distributed.initialize(f"127.0.0.1:{port}", world, rank, "cpu")
    model = ParallelSGDModel(distributed.mesh(), distributed.Collectives.from_group(),
                             num_iterations=5, step_size=0.005, device="cpu")
    ssc = StreamingContext(batch_interval=0)
    stream = ssc.source_stream(
        ShardedSource(SyntheticSource(total=256, seed=7, base_ms=1785320000000), rank, world),
        Featurizer(now_ms=1785320000000), row_bucket=16, token_bucket=64)
    seen = {"n": 0}

    def on_batch(batch, _t):
        seen["n"] += 1
        model.step(batch)  # the step's collectives ran on every rank
        if rank == 1 and seen["n"] == 3:
            raise RuntimeError("injected handler failure on rank 1")

    stream.foreach_batch(on_batch)
    ssc.start(lockstep=True)
    terminated = ssc.await_termination(timeout=60)
    ssc.stop()
    print(json.dumps({"rank": rank, "terminated": bool(terminated), "failed": ssc.failed,
                      "batches_seen": seen["n"], "ticks": ssc.ticks}), flush=True)


def _parallel(rank: int, world: int, port: int, npz: str, opts: str) -> None:
    from twtml_tpu_torch.features.batch import FeatureBatch, UnitBatch
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
    from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD
    from twtml_tpu_torch.parallel import distributed
    from twtml_tpu_torch.parallel.sharding import ParallelSGDModel

    kw = json.loads(opts)
    wire = kw.pop("wire")
    steps = kw.pop("steps", 1)
    residual = kw.pop("residual", "least_squares")
    if "dtype" in kw:
        from twtml_tpu_torch.models.sgd import DTYPES

        kw["dtype"] = DTYPES[kw["dtype"]]
    data = np.load(npz)
    cls = UnitBatch if wire == "unit" else FeatureBatch
    fields = [data[f] for f in cls._fields]
    local = cls(*(a.reshape((world, -1) + a.shape[1:])[rank] for a in fields))
    distributed.initialize(f"127.0.0.1:{port}", world, rank, "cpu")
    learner = (StreamingLogisticRegressionWithSGD if residual == "logistic"
               else StreamingLinearRegressionWithSGD)
    model = ParallelSGDModel(
        distributed.mesh(), distributed.Collectives.from_group(), device="cpu",
        residual_fn=learner.residual_fn, prediction_fn=learner.prediction_fn,
        round_predictions=learner.round_predictions, **kw)
    for _ in range(steps):
        out = model.step(local)
    print(json.dumps({
        "rank": rank, "route": model.route, "weights": model.latest_weights.tolist(),
        "count": float(out.count), "mse": float(out.mse),
        "real_stdev": float(out.real_stdev), "pred_stdev": float(out.pred_stdev),
    }), flush=True)
    distributed.shutdown()


def main() -> None:
    mode, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    rest = sys.argv[5:]
    if mode == "app":
        _app(rank, world, port, rest)
    elif mode == "abort":
        _abort(rank, world, port)
    elif mode == "parallel":
        _parallel(rank, world, port, rest[0], rest[1])
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
