"""The port's headline measurement: tweets a second featurized and trained
end to end (counterpart of the root ``bench.py``'s headline entry).

    python -m twtml_tpu_torch.bench                        # on the card
    TWTML_BENCH_CHILD=cpu python -m twtml_tpu_torch.bench  # the CPU point alone

It measures the main path: the synthetic tweets featurized on the host into
the ragged packed wire (one native fill and pack a batch), one H2D copy,
then the device step (decode, hash, densify, the 50 SGD iterations, the
stats); on the card the iterations are B1 (``csrc/fused_sgd.cu``).
``utils/benchloop.py`` holds the measurement policy.

``main()`` runs the device measurement and the CPU operating point, each in
a subprocess under the ``TWTML_BENCH_TIMEOUT`` watchdog (seconds), and
prints ONE JSON line:

  {"metric": "tweets_per_sec_e2e", "value": N, "unit": "tweets/s",
   "vs_baseline": N / cpu_tweets_per_sec, "passes": P, "best": N,
   "median": M, ...}

A device measurement that fails or times out is printed on stderr and
``main()`` exits non-zero: no CPU rate ever stands in for the device's.
``TWTML_BENCH_TENANTS`` > 1 measures the tenant plane with that many
tenants (``parallel/tenants.py``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from .utils.benchloop import measure_pipeline

# the package's parent: ``python -m twtml_tpu_torch.bench`` runs from there
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_TWEETS = 524288  # 32 batches a pass: the one completion fetch of a pass is
# measurement cost, and a long pass amortizes it toward steady streaming
BATCH = 16384
WARMUP_BATCHES = 2
# best-of over a fixed time budget, no early settle: a settle check
# converges on whatever slow phase it lands in, and the median in the
# output shows when the budget sat in one
REPEATS = 6
TIME_BUDGET_S = 600.0
SETTLED_AFTER = 0
NOW_MS = 1785320000000  # the featurizer's clock, as the root bench.py pins it


def measure(
    n_tweets: int = N_TWEETS,
    batch_size: int = BATCH,
    repeats: int = REPEATS,
    time_budget_s: float | None = TIME_BUDGET_S,
    settled_after: int = SETTLED_AFTER,
    tenants: int | None = None,
    device="cuda",
    prefetch: bool | None = None,
) -> dict:
    """One measurement of the pipeline on ``device`` (``cuda`` unless the
    caller asks for ``cpu``; it raises where there is no card). Returns
    {"tweets_per_sec", "median_tweets_per_sec", "seconds", "final_mse",
    "passes", "health", "tenants"}. ``prefetch`` None is the loop's own
    choice (``measure_pipeline``)."""
    from .features.arena import get_arena
    from .features.featurizer import Featurizer
    from .models.linear import StreamingLinearRegressionWithSGD
    from .streaming.sources import SyntheticSource
    from .utils.device import resolve_device

    dev = resolve_device(device)
    tenants = (
        int(os.environ.get("TWTML_BENCH_TENANTS", "1") or 1)
        if tenants is None else tenants
    )
    if tenants > 1:
        from .parallel.tenants import TenantStackModel

        model = TenantStackModel(tenants, device=dev)
    else:
        model = StreamingLinearRegressionWithSGD(device=dev)
    # the dispatching thread runs on the model's device and stream, and the
    # wire buffers are page-locked for a card, as the app builds them
    model.bind_thread()
    get_arena().use_device(model.device)

    statuses = list(SyntheticSource(total=n_tweets, seed=3).produce())
    feat = Featurizer(now_ms=NOW_MS)
    chunks = [statuses[i : i + batch_size] for i in range(0, n_tweets, batch_size)]

    def featurize(chunk):
        # the ragged wire, packed into one buffer for the single model; the
        # tenant plane builds its own routed wire at the model boundary
        return feat.featurize_batch_ragged(
            chunk, row_bucket=batch_size, pre_filtered=True,
            pack=(tenants == 1),
        )

    out = measure_pipeline(
        model, featurize, chunks, warmup_steps=WARMUP_BATCHES, repeats=repeats,
        prefetch=prefetch, time_budget_s=time_budget_s, settled_after=settled_after,
    )
    del out["batches"]
    out["tenants"] = tenants
    return out


def _run_child(kind: str, timeout: float) -> tuple[dict | None, str]:
    """Run one measurement in a subprocess (``TWTML_BENCH_CHILD=kind``),
    killed at ``timeout`` seconds. Returns (record, failure detail): the
    record None on any failure, the detail telling a timeout from a crash
    (the end of its stderr)."""
    env = dict(os.environ, TWTML_BENCH_CHILD=kind)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "twtml_tpu_torch.bench"], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        return None, f"timeout after {timeout:.0f} s"
    if proc.returncode == 0:
        try:
            return json.loads(proc.stdout.strip().splitlines()[-1]), ""
        except (ValueError, IndexError):
            pass
    detail = (proc.stderr or proc.stdout).strip()[-400:]
    return None, detail or f"exit code {proc.returncode}"


def main() -> int:
    child = os.environ.get("TWTML_BENCH_CHILD")
    if child == "cpu":
        # two plain passes at the CPU's own operating point (b2048): padding
        # a 4096-tweet sample to 16384-row batches would 4x its work
        print(json.dumps(measure(n_tweets=4096, batch_size=2048, repeats=2,
                                 time_budget_s=None, device="cpu")))
        return 0
    if child == "device":
        import torch

        rec = measure()
        rec["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(rec))
        return 0
    if child:
        print(f"bench: TWTML_BENCH_CHILD must be 'device' or 'cpu', got {child!r}",
              file=sys.stderr)
        return 2

    timeout = float(os.environ.get("TWTML_BENCH_TIMEOUT", "1200"))
    device_result, device_err = _run_child("device", timeout)
    if device_result is None:
        print(f"bench: the device measurement failed: {device_err}", file=sys.stderr)
        return 1
    cpu_result, cpu_err = _run_child("cpu", timeout)
    if cpu_result is None:
        print(f"bench: the CPU operating point failed: {cpu_err}", file=sys.stderr)
    cpu_rate = cpu_result["tweets_per_sec"] if cpu_result else None
    value = device_result["tweets_per_sec"]
    tenants = device_result["tenants"]
    from .utils.runid import config_fingerprint, next_run_id

    record = {
        "metric": "tweets_per_sec_e2e",
        "value": round(value, 1),
        "unit": "tweets/s",
        "vs_baseline": round(value / cpu_rate, 2) if cpu_rate else None,
        # operating points, not only backends: each arm at its own batch
        "vs_baseline_basis": "device b16384 vs cpu b2048 (per-backend operating points)",
        "passes": device_result["passes"],
        "best": round(value, 1),
        "median": round(device_result["median_tweets_per_sec"], 1),
        "health": device_result["health"],
        "tenants": tenants,
        "device": device_result["device"],
        "run_id": next_run_id(),
        "config_fingerprint": config_fingerprint({
            "bench": "headline", "package": "twtml_tpu_torch", "n_tweets": N_TWEETS,
            "batch": BATCH, "time_budget_s": TIME_BUDGET_S, "tenants": tenants,
        }),
    }
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
