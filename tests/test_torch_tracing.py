"""``--profileDir`` in the port (``twtml_tpu_torch/utils/tracing.py``): the
app on the CPU writes a ``torch.profiler`` Chrome trace holding its
annotated regions (featurize, dispatch, publish, from the scheduler thread
and the app's), and prints the lines of an unprofiled run; a disabled
tracer does nothing; start and stop are idempotent; a tracer for a card
that records no CUDA activity raises and writes nothing."""

import contextlib
import io
import json
import os

import pytest
import torch

from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.utils.tracing import Tracer, annotate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "tweets.jsonl")
ARGV = ["--backend", "cpu", "--source", "replay", "--replayFile", FIXTURE, "--seconds", "0",
        "--batchBucket", "4", "--twtweb", "http://127.0.0.1:9", "--lightning",
        "http://127.0.0.1:9", "--blackbox", "off"]
REGIONS = ("twtml.featurize", "twtml.dispatch", "twtml.publish")


def run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        totals = app.run(ConfArguments().parse(argv))
    return totals, [ln for ln in out.getvalue().splitlines() if ln.startswith("count:")]


def trace_names(path) -> list:
    with open(path) as fh:
        return [e.get("name", "") for e in json.load(fh)["traceEvents"]]


@pytest.mark.parametrize("hash_on", ["device", "host"])
def test_profile_dir_writes_a_trace_with_the_apps_regions(tmp_path, monkeypatch, hash_on):
    monkeypatch.setenv("TWTML_NOW_MS", "1700000000000")
    prof = tmp_path / "prof"
    totals, lines = run([*ARGV, "--hashOn", hash_on, "--profileDir", str(prof)])
    files = list(prof.glob("*.pt.trace.json"))
    assert [str(f) for f in files] == [totals["profile"]]
    names = trace_names(files[0])
    # 3 batches: a featurize, a dispatch and a publish each; the warm-up
    # runs before the trace starts
    assert [names.count(r) for r in REGIONS] == [3, 3, 3]
    assert any(n.startswith("aten::") for n in names)
    _, plain = run([*ARGV, "--hashOn", hash_on])
    assert lines == plain and len(lines) == 3


def test_without_profile_dir_the_app_writes_no_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    totals, _ = run(ARGV)
    assert totals["profile"] == "" and not list(tmp_path.rglob("*.json"))


def test_a_disabled_tracer_is_a_no_op(tmp_path):
    t = Tracer("")
    assert not t.enabled
    t.start()
    assert t._prof is None
    assert t.stop() == ""
    with Tracer("") as t2:
        pass
    assert t2.path == ""


def test_start_and_stop_are_idempotent(tmp_path):
    t = Tracer(str(tmp_path / "p"))
    t.start()
    prof = t._prof
    t.start()
    assert t._prof is prof
    with annotate("twtml.region"):
        torch.ones(4).sum()
    path = t.stop()
    assert t.stop() == path and len(list((tmp_path / "p").iterdir())) == 1
    assert "twtml.region" in trace_names(path)


def test_a_region_on_another_thread_is_recorded(tmp_path):
    import threading

    def work():
        with annotate("twtml.worker"):
            torch.ones(3).sum()

    with Tracer(str(tmp_path)) as t:
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=10)
    assert not th.is_alive() and "twtml.worker" in trace_names(t.path)


def test_a_card_tracer_without_cuda_profiling_raises_at_start(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    t = Tracer(str(tmp_path / "p"), device="cuda")
    with pytest.raises(RuntimeError, match="cannot record CUDA"):
        t.start()
    assert not (tmp_path / "p").exists()


def test_a_card_trace_without_cuda_activity_raises_and_writes_nothing(tmp_path, monkeypatch):
    """A profile that recorded no device event (here: the CPU build) is not
    written as if it were the card's."""
    t = Tracer(str(tmp_path / "p"), device="cuda")
    t.cuda = False  # start a host-only profile, as a card's that saw nothing
    t.start()
    torch.ones(4).sum()
    t.cuda = True
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        t.stop()
    assert not (tmp_path / "p").exists()
    assert t._prof is None  # stopped all the same

