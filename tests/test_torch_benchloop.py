"""The port's benchmark loop and entry (``twtml_tpu_torch/utils/benchloop.py``,
``twtml_tpu_torch/bench.py``) against the JAX package's
(``twtml_tpu/utils/benchloop.py`` and the root ``bench.py``), on the CPU.

- ``measure_passes``: scripted pass times under a fake clock go through both
  functions; the best, the pass times and the stopping pass are equal.
- ``measure`` at 1024 tweets in batches of 256, ``tenants`` 1 and 2, on the
  same tweets (``TWTML_NOW_MS`` pinned): the final mse within rtol 2e-3,
  the tolerance the port's superbatch tests hold a batch's mse to against
  the JAX package (``tests/test_torch_superbatch.py``, ``TOL``); batches,
  passes and the record's keys equal.
- The port alone: prefetch on against off and 1 pass against 3 give the same
  final mse and weights bit for bit; every lease a pass stepped retires after
  its completion fetch, none before; without a card the entry exits non-zero
  and prints no rate.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
from twtml_tpu.utils import benchloop as jax_benchloop
from twtml_tpu_torch import bench
from twtml_tpu_torch.features.arena import WireArena
from twtml_tpu_torch.utils import benchloop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW_MS = "1700000000000"
MSE_RTOL = 2e-3  # tests/test_torch_superbatch.py's TOL on a batch's mse


class FakeClock:
    """``time.perf_counter`` that moves only when a scripted pass runs."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def scripted(clock, times):
    """A ``run_pass`` that takes ``times[i]`` seconds on ``clock`` and
    returns its index as its output."""
    calls = iter(enumerate(times))

    def run_pass():
        i, dt = next(calls)
        clock.now += dt
        return dt, i

    return run_pass


STALL = [1.0, 6.0, 6.5, 6.2, 0.9, 0.95, 0.93, 0.92, 0.91, 0.9] + [1.0] * 20
SETTLE = [1.0, 0.99, 0.985, 0.97, 0.975, 0.972] + [0.98] * 20  # gains under 2 %
PASS_CASES = [
    # (repeats, time_budget_s, settled_after, pass times)
    (1, None, 0, [1.0] * 5),
    (3, None, 0, [1.0, 0.5, 2.0, 0.1]),
    (0, None, 0, [2.0, 1.0]),
    (2, 10.0, 0, STALL),
    (6, 600.0, 0, [30.0] * 40),
    (2, 100.0, 3, STALL),
    (1, 100.0, 2, SETTLE),
    (4, 100.0, 2, SETTLE),
    (1, 3.0, 5, STALL),
    (1, 0.0, 0, [1.0, 1.0]),
]


@pytest.mark.parametrize("repeats,budget,settle,times", PASS_CASES)
def test_measure_passes_decides_as_the_jax_loop(monkeypatch, repeats, budget, settle, times):
    results = []
    for fn in (jax_benchloop.measure_passes, benchloop.measure_passes):
        clock = FakeClock()
        monkeypatch.setattr("time.perf_counter", clock)
        results.append(fn(scripted(clock, times), repeats=repeats, time_budget_s=budget,
                          settled_after=settle))
    (jbest, jlast, jtimes), (best, last, got) = results
    assert best == jbest
    assert got == jtimes
    assert last == jlast == len(got) - 1
    assert len(got) >= max(1, repeats)


def spied(monkeypatch, module):
    """Wrap ``module.measure_pipeline`` so a test can read the model it was
    given and the record before ``measure`` drops its ``batches``."""
    seen = {}
    real = module.measure_pipeline

    def spy(model, *args, **kw):
        out = real(model, *args, **kw)
        seen.update(model=model, batches=out["batches"], prefetch=kw.get("prefetch"))
        return out

    monkeypatch.setattr(module, "measure_pipeline", spy)
    return seen


@pytest.fixture()
def pinned(monkeypatch):
    monkeypatch.setenv("TWTML_NOW_MS", NOW_MS)
    monkeypatch.delenv("TWTML_BENCH_TENANTS", raising=False)


@pytest.mark.parametrize("tenants", [1, 2])
def test_measure_agrees_with_the_root_bench(monkeypatch, pinned, tenants):
    kw = dict(n_tweets=1024, batch_size=256, repeats=2, time_budget_s=None, tenants=tenants)
    jseen = spied(monkeypatch, jax_benchloop)
    want = jax_bench.measure(**kw)
    seen = spied(monkeypatch, bench)
    got = bench.measure(device="cpu", **kw)
    assert sorted(got) == sorted(want)
    assert got["final_mse"] == pytest.approx(want["final_mse"], rel=MSE_RTOL)
    assert np.isfinite(got["final_mse"]) and got["final_mse"] > 0
    assert (seen["batches"], got["passes"], got["tenants"]) == (
        jseen["batches"], want["passes"], want["tenants"]) == (4, 2, tenants)
    assert sorted(got["health"]) == sorted(want["health"])
    assert seen["model"].device.type == "cpu"


def final_state(monkeypatch, **kw):
    seen = spied(monkeypatch, bench)
    rec = bench.measure(n_tweets=1024, batch_size=256, time_budget_s=None, device="cpu", **kw)
    return rec, seen["model"].latest_weights


@pytest.mark.parametrize("tenants", [1, 2])
def test_prefetch_on_and_off_end_bitwise_equal(monkeypatch, pinned, tenants):
    on, w_on = final_state(monkeypatch, tenants=tenants, repeats=2, prefetch=True)
    off, w_off = final_state(monkeypatch, tenants=tenants, repeats=2, prefetch=False)
    assert np.float64(on["final_mse"]).tobytes() == np.float64(off["final_mse"]).tobytes()
    assert w_on.tobytes() == w_off.tobytes()
    assert w_on.any()


@pytest.mark.parametrize("tenants", [1, 2])
def test_one_pass_and_three_end_bitwise_equal(monkeypatch, pinned, tenants):
    one, w_one = final_state(monkeypatch, tenants=tenants, repeats=1)
    three, w_three = final_state(monkeypatch, tenants=tenants, repeats=3)
    assert (one["passes"], three["passes"]) == (1, 3)
    assert np.float64(one["final_mse"]).tobytes() == np.float64(three["final_mse"]).tobytes()
    assert w_one.tobytes() == w_three.tobytes()


class Out:
    def __init__(self, mse):
        self.mse = torch.tensor([mse], dtype=torch.float32)


class LeaseModel:
    """Steps a leased batch and records which of this pass's leases were
    already retired when it stepped."""

    device = torch.device("cpu")

    def __init__(self):
        self.pass_leases, self.early = [], []

    def reset(self):
        self.pass_leases = []

    def step(self, batch):
        self.pass_leases.append(batch.lease)
        self.early += [le for le in self.pass_leases if le._done]
        return Out(float(len(self.pass_leases)))


class Leased:
    def __init__(self, lease):
        self.lease = lease


@pytest.mark.parametrize("prefetch", [True, False])
def test_a_pass_retires_its_leases_after_its_completion_fetch(prefetch):
    arena = WireArena()
    model = LeaseModel()
    fetched = []
    real_fetch = benchloop._fetch_mse

    def featurize(chunk):
        return Leased(arena.lease(64 * len(chunk)))

    def fetch(out):
        fetched.append(arena.stats()["in_use"])
        return real_fetch(out)

    chunks = [[0] * 3, [0] * 5, [0] * 3, [0] * 7]
    benchloop._fetch_mse = fetch
    try:
        out = benchloop.measure_pipeline(model, featurize, chunks, repeats=3, prefetch=prefetch)
    finally:
        benchloop._fetch_mse = real_fetch
    assert model.early == []
    # the warm-up's fetches hold its one lease; each pass's fetch holds 4
    assert fetched[:2] == [1, 1] and fetched[2:5] == [4, 4, 4]
    stats = arena.stats()
    assert stats["in_use"] == 0
    assert stats["recycled"] > 0
    assert out["passes"] == 3 and out["batches"] == 4 and out["final_mse"] == 4.0


def test_prefetch_defaults_to_inline_on_one_cpu(monkeypatch):
    taken = []
    real = benchloop._run_once_timed

    def spy(model, featurize, chunks, prefetch):
        taken.append(prefetch)
        return real(model, featurize, chunks, prefetch)

    monkeypatch.setattr(benchloop, "_run_once_timed", spy)
    arena = WireArena()
    for cpus in (1, 4):
        monkeypatch.setattr(benchloop, "_usable_cpus", lambda cpus=cpus: cpus)
        benchloop.measure_pipeline(LeaseModel(), lambda c: Leased(arena.lease(8)), [[0], [0]])
    assert taken == [False, True]


def test_the_entry_without_a_card_exits_nonzero_and_prints_no_rate(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry measures there")
    env = {k: v for k, v in os.environ.items() if k != "TWTML_BENCH_CHILD"}
    env.update(TWTML_RUN_ID_FILE=str(tmp_path / "run-id"), TWTML_BENCH_TIMEOUT="120")
    proc = subprocess.run([sys.executable, "-m", "twtml_tpu_torch.bench"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        assert "value" not in rec and "tweets_per_sec" not in rec, line
    assert "the device measurement failed" in proc.stderr
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not (tmp_path / "run-id").exists()
