"""One rank of a port group over a mesh at the library level, for the
multi-process tests (tests/test_torch_modelaxis.py,
tests/test_torch_tenant_fleet.py, tests/test_torch_kmeans_mesh.py) and
chip_smoke.py's ``modelaxis`` phase. Not a test module.

Usage: python tests/torch_mesh_worker.py <rank> <world> <port> <spec.json>

The rank joins the group (``distributed.initialize`` on the spec's
``device``, ``cpu`` or ``cuda``), lays it out as ``make_mesh(num_data,
num_model)`` and makes the spec's ``runs`` in order, each a dict with its
``mode`` (below) and ``name``; it writes each run's arrays to
``<out>/<name>-rank<r>.npz`` and prints, as its last line, a JSON object
with each run's record under ``runs``: its scalars, the host-side
collective counts and seconds it added (``distributed.COUNTERS``,
``SECONDS``) and the hand kernels' launches it made.

Modes (a run's keys):

- ``sgd``: a ``ParallelSGDModel`` on the mesh trains the ``K`` global
  batches of ``batches`` (an .npz of FeatureBatch or UnitBatch fields with
  a leading [K] axis), each rank on its data shard's rows, with ``model``
  (the constructor's arguments) and ``residual``; the arrays: the gathered
  weights after every step (``w``, [K, F + 4]) and each step's predictions
  (``preds``); the record: each step's stats, device ms (CUDA events on the
  card), host wall and the ms of each kind of collective in it. With ``checkpoint`` (a directory): after the K
  steps the lead saves the gathered weights with the port's Checkpointer,
  every rank restores them into a fresh model, and both models step once
  more on batch 0: ``resumed`` and ``uninterrupted``.
- ``tenants``: a ``TenantStackModel`` of ``num_tenants`` on the mesh steps
  the same global batches (each rank routing its data shard's rows); the
  arrays: the gathered stack (``w``, [M, F + 4]) and this rank's tenants'
  counts (``counts``).
- ``kmeans``: a ``StreamingKMeans`` (k 3, half-life 5 batches, random 2-d
  centers) on the mesh updates on each of ``points`` ([K, B, 2]) and
  ``mask`` ([K, B]), the global batches: this rank's assignments
  (``assign``), and the final centers and weights.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _rows(a: np.ndarray, index: int, shards: int) -> np.ndarray:
    """Shard ``index`` of ``shards`` of the rows (axis 0) of ``a``."""
    n = a.shape[0] // shards
    return a[index * n:(index + 1) * n]


def _batches(path: str, wire: str, mesh):
    """The .npz's K global batches as this rank's host batches."""
    from twtml_tpu_torch.features.batch import FeatureBatch, UnitBatch

    cls = UnitBatch if wire == "unit" else FeatureBatch
    data = np.load(path)
    k = data["mask"].shape[0]
    return [cls(*(_rows(data[f][i], mesh.data_index, mesh.num_data) for f in cls._fields))
            for i in range(k)]


def _model_kw(spec: dict) -> dict:
    """The constructor's arguments: the spec's ``model`` (its ``dtype`` a
    ``--dtype`` name), device and learner."""
    from twtml_tpu_torch.models.sgd import DTYPES

    kw = dict(spec["model"], device=spec["device"], **_learner(spec.get("residual", "")))
    if "dtype" in kw:
        kw["dtype"] = DTYPES[kw["dtype"]]
    return kw


def _learner(residual: str) -> dict:
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
    from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD

    cls = (StreamingLogisticRegressionWithSGD if residual == "logistic"
           else StreamingLinearRegressionWithSGD)
    return dict(residual_fn=cls.residual_fn, prediction_fn=cls.prediction_fn,
                round_predictions=cls.round_predictions)


def _launches() -> dict:
    from twtml_tpu_torch.ops import fused_gram, fused_sgd

    out = {fn.__name__: fn.launches for fn in fused_gram.KERNELS}
    for name in ("fused_dense_sgd", "fused_dense_grad", "fused_dense_update"):
        out[name] = getattr(fused_sgd, name).launches
    return out


class _Clock:
    """Each step's device ms (CUDA events, on the card only), host wall ms
    (to the end of its device work) and the ms of each kind of collective
    inside it (``distributed.SECONDS``'s keys)."""

    def __init__(self, device: str):
        import torch

        from twtml_tpu_torch.parallel import distributed

        self.cuda = device == "cuda"
        self.torch = torch
        self.seconds = distributed.SECONDS
        self.device_ms: list = []
        self.wall_ms: list = []
        self.collective_ms: list = []

    def run(self, fn):
        torch = self.torch
        if self.cuda:
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        before = dict(self.seconds)
        t0 = time.perf_counter()
        out = fn()
        if self.cuda:
            ev[1].record()
            torch.cuda.synchronize()
            self.device_ms.append(ev[0].elapsed_time(ev[1]))
        self.wall_ms.append((time.perf_counter() - t0) * 1e3)
        self.collective_ms.append({k: 1e3 * (v - before[k]) for k, v in self.seconds.items()
                                   if v > before[k]})
        return out


def _sgd(spec: dict, mesh, group) -> tuple:
    import torch

    from twtml_tpu_torch.checkpoint import Checkpointer
    from twtml_tpu_torch.parallel import distributed
    from twtml_tpu_torch.parallel.sharding import ParallelSGDModel

    kw = _model_kw(spec)
    batches = _batches(spec["batches"], spec.get("wire", "host"), mesh)
    model = ParallelSGDModel(mesh, group, **kw)
    clock = _Clock(spec["device"])
    ws, preds, stats = [], [], []
    for b in batches:
        out = clock.run(lambda b=b: model.step(b))
        preds.append(out.predictions.float().cpu().numpy())
        stats.append({k: float(getattr(out, k)) for k in
                      ("count", "mse", "real_stdev", "pred_stdev")})
        ws.append(model.latest_weights)
    rec = {"route": model.route, "stats": stats, "step_device_ms": clock.device_ms,
           "step_wall_ms": clock.wall_ms, "step_collective_ms": clock.collective_ms}
    arrays = {"w": np.stack(ws), "preds": np.stack(preds)}
    ck = spec.get("checkpoint")
    if ck:
        w = model.latest_weights
        if mesh.process_index == 0:
            Checkpointer(ck).save(len(batches), w, {"count": 0, "batches": 0})
        # every rank past the save before any restores it
        distributed.Collectives.from_group().allreduce_(torch.zeros(1))
        fresh = ParallelSGDModel(mesh, group, **kw)
        fresh.set_initial_weights(Checkpointer(ck).restore()[0])
        fresh.step(batches[0])
        model.step(batches[0])
        arrays["resumed"] = fresh.latest_weights
        arrays["uninterrupted"] = model.latest_weights
    return rec, arrays


def _tenants(spec: dict, mesh, group) -> tuple:
    from twtml_tpu_torch.parallel.tenants import TenantStackModel

    kw = _model_kw(spec)
    batches = _batches(spec["batches"], spec.get("wire", "host"), mesh)
    model = TenantStackModel(spec["num_tenants"], mesh=mesh, group=group, **kw)
    clock = _Clock(spec["device"])
    counts = []
    for b in batches:
        out = clock.run(lambda b=b: model.step(b))
        counts.append(out.count.float().cpu().numpy())
    rec = {"route": model.route, "tenants": [model.tenant0, model.num_local],
           "step_device_ms": clock.device_ms, "step_wall_ms": clock.wall_ms}
    return rec, {"w": model.latest_weights, "counts": np.stack(counts)}


def _kmeans(spec: dict, mesh, group) -> tuple:
    from twtml_tpu_torch.models.kmeans import StreamingKMeans

    data = np.load(spec["batches"])
    model = (StreamingKMeans(mesh=mesh, group=group, device=spec["device"]).set_k(3)
             .set_half_life(5, "batches").set_random_centers(2, 0.0))
    assign = [model.update(p, m) for p, m in zip(data["points"], data["mask"])]
    return {}, {"assign": np.stack(assign), "centers": model.latest_centers,
                "weights": model.latest_weights}


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def main() -> None:
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    with open(sys.argv[4]) as fh:
        spec = json.load(fh)
    from twtml_tpu_torch.parallel import distributed
    from twtml_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    distributed.initialize(f"127.0.0.1:{port}", world, rank, spec["device"])
    mesh = make_mesh(spec.get("num_data"), spec.get("num_model", 1), num_processes=world,
                     process_index=rank)
    group = (distributed.MeshCollectives.from_group(mesh) if mesh.num_model > 1
             else distributed.Collectives.from_group())
    modes = {"sgd": _sgd, "tenants": _tenants, "kmeans": _kmeans}
    runs = {}
    for run in spec["runs"]:
        before = (dict(distributed.COUNTERS), dict(distributed.SECONDS), _launches())
        t_run = time.perf_counter()
        rec, arrays = modes[run["mode"]](dict(spec, **run), mesh, group)
        np.savez(os.path.join(spec["out"], f"{run['name']}-rank{rank}.npz"), **arrays)
        rec.update(collectives=_delta(distributed.COUNTERS, before[0]),
                   seconds=_delta(distributed.SECONDS, before[1]),
                   launches=_delta(_launches(), before[2]),
                   wall_s=time.perf_counter() - t_run)
        runs[run["name"]] = rec
    print(json.dumps({"rank": rank, "data_index": mesh.data_index,
                      "model_index": mesh.model_index, "runs": runs,
                      "wall_s": time.perf_counter() - t0}), flush=True)
    distributed.shutdown()


if __name__ == "__main__":
    main()
