"""The port's flagship app as a user runs it, on the CPU: its stats lines
equal the lines the JAX package's learner gives on the same chunks of the
replay fixture, and without a GPU the default ``--backend cuda`` fails loudly
instead of running on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.models.linear import StreamingLinearRegressionWithSGD as JaxLinear
from twtml_tpu.streaming.sources import ReplayFileSource as JaxReplay
from twtml_tpu.utils import round_half_up

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = "tests/data/tweets.jsonl"
NOW_MS = "1700000000000"
ARGS = ["--source", "replay", "--replayFile", FIXTURE, "--batchBucket", "4"]


def run_app(*extra):
    env = dict(os.environ, TWTML_NOW_MS=NOW_MS)
    return subprocess.run(
        [sys.executable, "-m", "twtml_tpu_torch.apps.linear_regression", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )


def expected_lines():
    """The JAX app's ``handle`` line for each 4-tweet chunk of the fixture."""
    statuses = list(JaxReplay(os.path.join(REPO, FIXTURE)).produce())
    featurizer = JaxFeaturizer(now_ms=int(NOW_MS))
    model = JaxLinear(quality=True)
    total, lines = 0, []
    for lo in range(0, len(statuses), 4):
        out = model.step(featurizer.featurize_batch_units(statuses[lo:lo + 4], row_bucket=4))
        b = int(out.count)
        total += b
        mse = round_half_up(float(out.mse))
        real = round_half_up(float(out.real_stdev))
        pred = round_half_up(float(out.pred_stdev))
        lines.append(
            f"count: {total}  batch: {b}  mse: {mse}  "
            f"stdev (real, pred): ({int(real)}, {int(pred)})"
        )
    return lines


def test_app_on_cpu_prints_the_jax_models_stats_lines():
    proc = run_app("--backend", "cpu", *ARGS)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == expected_lines()
    assert "done: 6 tweets in 3 batches" in proc.stderr


def test_default_backend_without_a_gpu_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default backend runs there")
    proc = run_app(*ARGS)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert "--backend cpu" in proc.stderr


def test_bad_flags_print_usage_and_exit_1():
    proc = run_app("--backend", "tpu", *ARGS)
    assert proc.returncode == 1
    assert "--backend <cuda|cpu>" in proc.stderr
    np.testing.assert_equal(proc.stdout, "")
