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
``SECONDS``) and the hand kernels' launches it made (with the tenant forms'
library G products, ``tenant_gram_products``).

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
- ``tenants``: a ``TenantStackModel`` of ``num_tenants`` on the mesh, in
  the run's ``mapping`` ("scan" by default, or "vmap"), steps the same
  global batches (each rank routing its data shard's rows) or, with
  ``parts`` (an .npz of FeatureBatch fields with a leading [K, M] axis: K
  ticks of M tenant parts of B rows), each tick's parts as routed there,
  each rank taking its data shard's rows of its own tenants' parts
  (``prepare_wire_from_parts``); ``init`` (an .npy [M, F + 4]) sets the
  start weights. With ``hold_forms`` every call the step makes of B4's,
  B7's and B8's tenant forms is held against its plain version on the
  same inputs (the record's ``forms``: each call's form, bitwise flag, max
  abs error and the plain version's largest magnitude); with ``profile``
  (a directory) the ticks after the first run under ``torch.profiler``,
  whose Chrome trace lands in ``<profile>/rank<r>``. The arrays: the
  gathered stack (``w``, [M, F + 4]), this rank's tenants' counts
  (``counts``), mse (``mse``), its rows' predictions (``preds``) and, with
  the quality vector, quality (``quality``); the record: whether the stack
  built a batched step (``batched``), each tick's device ms, host wall,
  collective ms by kind and collectives (``tick_collectives``,
  ``distributed.COUNTERS``' deltas).
- ``tenant_split``: the split with a tenant grid
  (``fused_sgd.fused_dense_sgd_tenants_split``) against its plain version
  on this rank's rows over the group's all-reduce: ``tenants`` parts of
  ``rows`` rows and ``features`` columns made from ``seed`` + the rank (40
  bigram counts of 1-2 a row, rank r's tenant t valid up to ``valid[r][t]``,
  97 % of those rows unmasked), ``iterations`` and per-tenant
  ``step_sizes`` / ``l2_regs``, the ``residual`` learner (logistic: 0/1
  labels), every rank from the same small w0 (``seed``). The record: the max abs errors of the weights and predictions
  against the plain version where it is finite, its NaN/Inf patterns equal,
  the run with NaN in masked rows (+Inf in every third one's X) bitwise the
  clean run, each tenant's iterations run, and one tenant with every row
  valid bitwise the split (``fused_dense_sgd_split``); the arrays: the
  kernel's and the plain version's weights (``w``, ``w_plain``).
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
    out["tenant_gram_products"] = fused_gram.tenant_gram_blocks.products
    for name in ("fused_dense_sgd", "fused_dense_grad", "fused_dense_update",
                 "fused_dense_sgd_tenants", "fused_dense_sgd_tenants_split"):
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


def _tenant_parts(path: str, model, mesh) -> list:
    """Each tick's M tenant parts of the .npz as this rank's wires: its data
    shard's rows of its own tenants' parts."""
    from twtml_tpu_torch.features.batch import FeatureBatch

    data = np.load(path)
    mine = range(model.tenant0, model.tenant0 + model.num_local)
    return [model.prepare_wire_from_parts([
        FeatureBatch(*(_rows(data[f][k][t], mesh.data_index, mesh.num_data)
                       for f in FeatureBatch._fields)) for t in mine])
        for k in range(data["mask"].shape[0])]


def _held_forms(record: list):
    """A stand-in for ``models.sgd``'s ``fused_gram`` whose tenant forms
    each hold their result against their plain version on the same inputs,
    appending one entry a call to ``record``; every other name is the
    module's own (the launches count on the real wrappers)."""
    import types

    import torch

    from twtml_tpu_torch.ops import fused_gram as fg

    def entry(form, got, want, exact=None):
        err = float((got.float() - want.float().to(got.device)).abs().max()) if got.numel() else 0.0
        record.append({"form": form, "bitwise": bool(torch.equal(got, want.to(got.device))),
                       "max_abs_err": err, "scale": float(want.float().abs().max())
                       if want.numel() else 0.0, **(exact or {})})

    def count_build_tenants(*a, **kw):
        counts, at = fg.count_build_tenants(*a, **kw)
        plain, plain_at = fg.count_build_tenants_reference(*a, cols_out=counts.shape[1], **kw)
        entry("count_build_tenants", counts, plain, {"at_equal": plain_at == at,
                                                      "rows": list(counts.shape)})
        return counts, at

    def dual_sgd_tenants(*a, **kw):
        c, alpha, its = fg.dual_sgd_tenants(*a, **kw)
        c_r, alpha_r, its_r = fg.dual_sgd_tenants_reference(*a, **kw)
        entry("dual_sgd_tenants", torch.cat([c, alpha.reshape(-1)]),
              torch.cat([c_r, alpha_r.reshape(-1)]), {
                  "iterations": [int(i) for i in its.tolist()],
                  "iterations_equal": bool(torch.equal(its, its_r.to(its.device))),
                  "valid_rows": [int(v) for v in kw["valid_rows"]],
                  "tenant_draws": kw.get("masks") is not None and kw["masks"].dim() == 3})
        return c, alpha, its

    def dual_writeback_tenants(*a, out=None, **kw):
        got = fg.dual_writeback_tenants(*a, out=out, **kw)
        want = fg.dual_writeback_tenants_reference(*a, **kw)
        rows = list(kw.get("tenants") or range(a[2].shape[0]))  # default: every part of alpha
        entry("dual_writeback_tenants", got[rows], want[rows],
              {"first_rows": list(kw.get("first_rows") or ()),
               "token_rows": list(kw.get("token_rows") or ())})
        return got

    proxy = types.SimpleNamespace(**{k: getattr(fg, k) for k in dir(fg) if not k.startswith("__")})
    proxy.count_build_tenants = count_build_tenants
    proxy.dual_sgd_tenants = dual_sgd_tenants
    proxy.dual_writeback_tenants = dual_writeback_tenants
    return proxy


def _tenants(spec: dict, mesh, group) -> tuple:
    from twtml_tpu_torch.models import sgd
    from twtml_tpu_torch.ops import fused_gram

    forms: list = []
    if spec.get("hold_forms"):
        sgd.fused_gram = _held_forms(forms)
    try:
        rec, arrays = _tenant_ticks(spec, mesh, group)
    finally:
        sgd.fused_gram = fused_gram
    if spec.get("hold_forms"):
        rec["forms"] = forms
    return rec, arrays


def _tenant_ticks(spec: dict, mesh, group) -> tuple:
    from twtml_tpu_torch.parallel import distributed
    from twtml_tpu_torch.parallel.tenants import TenantStackModel

    kw = _model_kw(spec)
    model = TenantStackModel(spec["num_tenants"], mesh=mesh, group=group,
                             mapping=spec.get("mapping", "scan"), **kw)
    if spec.get("init"):
        model.set_initial_weights(np.load(spec["init"]))
    ticks = (_tenant_parts(spec["parts"], model, mesh) if spec.get("parts")
             else _batches(spec["batches"], spec.get("wire", "host"), mesh))
    clock = _Clock(spec["device"])
    counts, mse, preds, quality, tick_collectives = [], [], [], [], []
    prof = None
    for k, b in enumerate(ticks):
        if k == 1 and spec.get("profile"):
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        before = dict(distributed.COUNTERS)
        out = clock.run(lambda b=b: model.step(b))
        tick_collectives.append(_delta(distributed.COUNTERS, before))
        counts.append(out.count.float().cpu().numpy())
        mse.append(out.mse.double().cpu().numpy())
        preds.append(out.predictions.float().cpu().numpy())
        if out.quality is not None:
            quality.append(out.quality.float().cpu().numpy())
    if prof is not None:
        prof.__exit__(None, None, None)
        where = os.path.join(spec["profile"], f"rank{mesh.process_index}")
        os.makedirs(where, exist_ok=True)
        prof.export_chrome_trace(os.path.join(where, "ticks.pt.trace.json"))
    rec = {"route": model.route, "tenants": [model.tenant0, model.num_local],
           "batched": model._batched is not None, "step_device_ms": clock.device_ms,
           "step_wall_ms": clock.wall_ms, "step_collective_ms": clock.collective_ms,
           "tick_collectives": tick_collectives}
    arrays = {"w": model.latest_weights, "counts": np.stack(counts), "mse": np.stack(mse),
              "preds": np.stack(preds)}
    if quality:
        arrays["quality"] = np.stack(quality)
    return rec, arrays


def _split_parts(rng, tenants: int, rows: int, features: int, valid) -> tuple:
    """``tenants`` parts of ``rows`` rows: part t's first ``valid[t]`` rows
    tweet-like (40 bigram counts of 1-2, 4 small numeric columns), 97 % of
    them unmasked, the rest zero and masked."""
    x = np.zeros((tenants, rows, features), np.float32)
    mask = np.zeros((tenants, rows), np.float32)
    for t, v in enumerate(valid):
        cols = rng.integers(0, features - 4, (v, 40))
        np.add.at(x[t], (np.arange(v)[:, None], cols), rng.integers(1, 3, (v, 40)))
        x[t, :v, -4:] = rng.normal(size=(v, 4)) * 1e-3
        mask[t, :v] = rng.random(v) < 0.97
    return x, rng.uniform(50, 900, (tenants, rows)).astype(np.float32), mask


def _finite_err(got, want) -> float:
    """The max abs error where ``want`` is finite; raises when the NaN/Inf
    patterns differ."""
    import torch

    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(test(got), test(want)):
            raise AssertionError(f"{test.__name__} patterns differ: {int(test(got).sum())} "
                                 f"against {int(test(want).sum())}")
    fin = torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def _tenant_split(spec: dict, mesh, group) -> tuple:
    import torch

    from twtml_tpu_torch.features.batch import tenant_valid_rows
    from twtml_tpu_torch.ops import fused_sgd
    from twtml_tpu_torch.utils.device import resolve_device

    dev = resolve_device(spec["device"])
    rng = np.random.default_rng(spec["seed"] + mesh.data_index)
    m, rows, f = spec["tenants"], spec["rows"], spec["features"]
    x, y, mask = _split_parts(rng, m, rows, f, spec["valid"][mesh.data_index])
    logistic = spec.get("residual") == "logistic"
    if logistic:
        y = (rng.random(y.shape) < 0.5).astype(np.float32)
    # the replicated weights: alike on every rank
    w0 = (np.random.default_rng(spec["seed"]).normal(size=(m, f)) * 1e-3).astype(np.float32)
    rf = fused_sgd.logistic_residual if logistic else fused_sgd.least_squares_residual
    kw = dict(num_iterations=spec["iterations"], step_sizes=spec["step_sizes"],
              l2_regs=spec["l2_regs"], convergence_tol=0.001, residual_fn=rf)
    valid = tenant_valid_rows(mask)
    x, y, mask, w0 = (torch.from_numpy(a).to(dev) for a in (x, y, mask, w0))
    reduce = group.allreduce_
    w, p = fused_sgd.fused_dense_sgd_tenants_split(x, y, mask, w0, valid_rows=valid,
                                                   allreduce=reduce, **kw)
    iterations = fused_sgd.fused_dense_sgd_tenants_split.last_iterations
    iterations = [int(v) for v in (iterations.tolist() if iterations is not None else [])]
    w_ref, p_ref = fused_sgd.fused_dense_sgd_tenants_split_reference(
        x, y, mask, w0, allreduce=reduce, **kw)
    off = mask == 0
    x_d = torch.where(off[..., None], float("nan"), x)
    x_d[off & (torch.arange(rows, device=dev) % 3 == 0)] = float("inf")
    y_d = torch.where(off, float("nan"), y)
    w_d, p_d = fused_sgd.fused_dense_sgd_tenants_split(x_d, y_d, mask, w0, valid_rows=valid,
                                                       allreduce=reduce, **kw)
    # one tenant whose every row is read: the split's weights and margins
    x1, y1, m1 = (torch.from_numpy(a).to(dev) for a in _split_parts(rng, 1, rows, f, [rows]))
    if logistic:
        y1 = (y1 > 475).float()
    one = dict(kw, step_sizes=kw["step_sizes"][:1], l2_regs=kw["l2_regs"][:1])
    w1, p1 = fused_sgd.fused_dense_sgd_tenants_split(x1, y1, m1, w0[:1], valid_rows=[rows],
                                                     allreduce=reduce, **one)
    ws, ps = fused_sgd.fused_dense_sgd_split(
        x1[0], y1[0], m1[0], w0[0], allreduce=reduce, num_iterations=kw["num_iterations"],
        step_size=one["step_sizes"][0], l2_reg=one["l2_regs"][0], convergence_tol=0.001,
        residual_fn=rf)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rec = {"valid": valid, "iterations": iterations,
           "w_err": _finite_err(w, w_ref), "p_err": _finite_err(p, p_ref),
           "w_scale": float(w_ref.abs().max()), "p_scale": float(p_ref.abs().max()),
           "within": bool(torch.allclose(w, w_ref, rtol=1e-4, atol=1e-5, equal_nan=True)
                          and torch.allclose(p, p_ref, rtol=1e-4, atol=1e-5, equal_nan=True)),
           "dirty_bitwise": bool(torch.equal(w_d, w) and torch.equal(p_d, p)),
           "one_tenant_bitwise": bool(torch.equal(w1[0], ws) and torch.equal(p1[0], ps))}
    return rec, {"w": w.cpu().numpy(), "w_plain": w_ref.cpu().numpy()}


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
    modes = {"sgd": _sgd, "tenants": _tenants, "tenant_split": _tenant_split,
             "kmeans": _kmeans}
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
