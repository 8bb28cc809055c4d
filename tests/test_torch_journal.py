"""The port's intake journal (``twtml_tpu_torch/streaming/journal.py``)
against the JAX package's: a journal either package writes replays in the
other with equal records (the segment bytes are equal), and the cases of
tests/test_journal.py run on the port: frame round trip, torn tail, mid-
history corruption, rotation, retirement and the disk ceiling, replay
suppression, the committed cursor, the cursor stamp and ``--journal off``,
and a SIGKILL'd run's restart equal to an unfailed one."""

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

from tools.bench_suite import _status_json
from twtml_tpu.features.featurizer import Status as JaxStatus
from twtml_tpu.streaming.journal import IntakeJournal as JaxJournal
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic
from twtml_tpu.telemetry import metrics as jax_metrics
from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.checkpoint import Checkpointer
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features.featurizer import Status
from twtml_tpu_torch.streaming import journal as journal_mod
from twtml_tpu_torch.streaming.journal import IntakeJournal
from twtml_tpu_torch.telemetry import metrics as _metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOSED = "http://127.0.0.1:9"
NOW_MS = "1785320000000"


@pytest.fixture(autouse=True)
def _clean_metrics():
    _metrics.reset_for_tests()
    jax_metrics.reset_for_tests()
    yield
    journal_mod.uninstall()
    _metrics.reset_for_tests()


def _statuses(n, tag="t", rt_every=3, cls=Status):
    out = []
    for i in range(n):
        rs = None
        if rt_every and i % rt_every == 0:
            rs = cls(text=f"original {tag} {i} é", retweet_count=i * 2,
                     followers_count=100 + i, created_at_ms=1785310000000 + i,
                     lang="fr", id=900000 + i)
        out.append(cls(text=f"tweet {tag} {i} ünïcode", retweet_count=i,
                       followers_count=10 + i, favourites_count=i % 7,
                       friends_count=i % 5, created_at_ms=1785320000000 + i,
                       retweeted_status=rs, lang="en", id=1000000 + i))
    return out


def _fields(s):
    if s is None:
        return None
    return (s.text, s.retweet_count, s.followers_count, s.favourites_count,
            s.friends_count, s.created_at_ms, s.lang, s.id, _fields(s.retweeted_status))


def _segments(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".twj"))


# ---- journals across the packages -----------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_in_the_other_package(tmp_path, writer):
    d = str(tmp_path / "j")
    w_cls, r_cls, st = ((JaxJournal, IntakeJournal, JaxStatus) if writer == "jax"
                        else (IntakeJournal, JaxJournal, Status))
    batches = [_statuses(16, "a", cls=st), _statuses(7, "b", rt_every=2, cls=st)]
    w = w_cls(d)
    for b in batches:
        w.append(b)
        w.push_dispatch()
    w.pop_dispatch()
    w.note_delivered()
    assert w.snapshot_for_checkpoint() == {"cursor": 1, "rows": 16}
    w.close()
    r = r_cls(d)
    assert (r.next_id, r.rows_total) == (2, 23)
    got = [[_fields(s) for s in items] for _id, items in r.records_from(0)]
    assert got == [[_fields(s) for s in b] for b in batches]
    items, rows = r.replay_from(1)
    assert rows == 7 and [_fields(s) for s in items] == [_fields(s) for s in batches[1]]
    r.close()


def test_segment_bytes_equal_the_jax_packages(tmp_path):
    a, b = IntakeJournal(str(tmp_path / "a")), JaxJournal(str(tmp_path / "b"))
    a.append(_statuses(16, "x"))
    b.append(_statuses(16, "x", cls=JaxStatus))
    a.close()
    b.close()
    (sa,), (sb,) = _segments(tmp_path / "a"), _segments(tmp_path / "b")
    assert sa == sb
    assert (tmp_path / "a" / sa).read_bytes() == (tmp_path / "b" / sb).read_bytes()


def test_block_records_of_the_jax_package_raise_naming_the_roadmap_item(tmp_path):
    from twtml_tpu.features.blocks import ParsedBlock

    d = str(tmp_path / "j")
    j = JaxJournal(d)
    numeric = np.arange(10, dtype=np.int64).reshape(2, 5)
    j.append([ParsedBlock(numeric, np.arange(6, dtype=np.uint8),
                          np.array([0, 3, 6], np.int64), np.ones(2, np.uint8))])
    j.close()
    ours = IntakeJournal(d)
    assert (ours.next_id, ours.rows_total, ours.rows_from(0)) == (1, 2, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        list(ours.records_from(0))
    ours.close()


# ---- framing and disk (tests/test_journal.py) -------------------------------

def test_object_records_roundtrip_bit_parity(tmp_path):
    j = IntakeJournal(str(tmp_path / "j"))
    batches = [_statuses(16, "a"), _statuses(7, "b", rt_every=2)]
    for b in batches:
        j.append(b)
    j.close()
    j2 = IntakeJournal(str(tmp_path / "j"))
    assert (j2.next_id, j2.rows_total) == (2, 23)
    assert [items for _id, items in j2.records_from(0)] == batches


def test_torn_tail_truncated_loudly(tmp_path):
    d = str(tmp_path / "j")
    j = IntakeJournal(d)
    for i in range(3):
        j.append(_statuses(4, f"k{i}"))
    j.close()
    (seg,) = _segments(d)
    path = os.path.join(d, seg)
    size_before = os.path.getsize(path)
    with open(path, "ab") as fh:
        fh.write(b"TWJL" + (9999).to_bytes(4, "little") + b"\x00" * 40)
    j2 = IntakeJournal(d)
    assert (j2.next_id, j2.rows_total) == (3, 12)
    assert os.path.getsize(path) == size_before
    assert _metrics.get_registry().counter("journal.torn_tails").snapshot() == 1
    assert sum(len(it) for _i, it in j2.records_from(0)) == 12


def test_mid_history_corruption_raises(tmp_path):
    d = str(tmp_path / "j")
    j = IntakeJournal(d, max_mb=4)
    for i in range(8):
        j.append([Status(text="x" * 300000, id=i)])
    segs = _segments(d)
    assert len(segs) >= 2
    first = os.path.join(d, segs[0])
    with open(first, "r+b") as fh:
        fh.seek(os.path.getsize(first) // 2)
        b = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(RuntimeError, match="corrupt mid-history"):
        list(j.records_from(0))
    j.close()


def test_rotation_retirement_and_disk_ceiling(tmp_path):
    d = str(tmp_path / "j")
    j = IntakeJournal(d, max_mb=4)
    for i in range(30):
        j.append([Status(text="y" * 200000, id=i)])
    assert _metrics.get_registry().counter("journal.segments_dropped").snapshot() >= 1
    assert j.disk_bytes() <= 5 * 1024 * 1024
    segs = _segments(d)
    assert len(segs) >= 2
    first_alive, cursor_past_first = (int(re.match(r"seg-(\d+)\.twj", s).group(1))
                                      for s in segs[:2])
    assert j.retire_covered(cursor_past_first) == 1
    assert first_alive not in [int(re.match(r"seg-(\d+)\.twj", s).group(1))
                               for s in _segments(d)]
    j.retire_covered(j.next_id)
    assert _segments(d)
    j.close()


def test_replay_suppression_and_mixed_batch(tmp_path):
    j = IntakeJournal(str(tmp_path / "j"))
    a, b = _statuses(16, "a"), _statuses(16, "b")
    j.append(a)
    j.append(b)
    items, rows = j.replay_from(1)
    assert rows == 16 and [s.id for s in items] == [s.id for s in b]
    fresh = _statuses(4, "c")
    j.append(b[:10])
    assert j.rows_total == 32
    j.append(b[10:] + fresh)
    assert (j.rows_total, j.next_id) == (36, 3)
    tail = list(j.records_from(2))
    assert [s.id for s in tail[0][1]] == [s.id for s in fresh]
    j.close()


# ---- the dispatch-token cursor ----------------------------------------------

def test_committed_cursor_advances_on_delivery_not_dispatch(tmp_path):
    j = IntakeJournal(str(tmp_path / "j"))
    j.append(_statuses(16, "a"))
    j.push_dispatch()
    j.append(_statuses(16, "b"))
    j.push_dispatch()
    assert j.snapshot_for_checkpoint() == {"cursor": 0, "rows": 0}
    j.pop_dispatch()
    j.note_delivered()
    assert j.snapshot_for_checkpoint() == {"cursor": 1, "rows": 16}
    j.pop_dispatch()  # a skipped delivery pops without committing
    assert j.snapshot_for_checkpoint() == {"cursor": 1, "rows": 16}
    j.close()


def test_replay_rebases_cursor_and_defers_saves(tmp_path):
    j = IntakeJournal(str(tmp_path / "j"))
    for tag in "abc":
        j.append(_statuses(8, tag))
        j.push_dispatch()
        j.pop_dispatch()
        j.note_delivered()
    assert j.snapshot_for_checkpoint() == {"cursor": 3, "rows": 24}
    items, rows = j.replay_from(1)
    assert rows == 16
    assert j.snapshot_for_checkpoint() == {"cursor": 1, "rows": 8}
    assert not j.save_allowed
    j.append(items[:8])
    j.push_dispatch()
    j.pop_dispatch()
    j.note_delivered()
    assert not j.save_allowed
    assert j.snapshot_for_checkpoint() == {"cursor": 1, "rows": 8}
    j.append(items[8:])
    j.push_dispatch()
    j.pop_dispatch()
    j.note_delivered()
    assert j.save_allowed
    assert j.snapshot_for_checkpoint() == {"cursor": 3, "rows": 24}
    j.close()


def test_shed_token_hygiene(tmp_path):
    j = IntakeJournal(str(tmp_path / "j"))
    j.append(_statuses(8, "a"))
    j.push_dispatch()
    j.drop_newest()  # shed before dispatch: un-push
    j.append(_statuses(8, "b"))
    j.push_dispatch()
    j.pop_dispatch()
    j.note_delivered()
    assert j.snapshot_for_checkpoint()["cursor"] == 2
    j.pop_dispatch()  # a stray pop finds an empty FIFO: no commit
    j.note_delivered()
    assert j.snapshot_for_checkpoint()["cursor"] == 2
    j.close()


def test_cancel_pending_replay_returns_the_stale_rows(tmp_path):
    j = IntakeJournal(str(tmp_path / "j"))
    j.append(_statuses(8, "a"))
    j.append(_statuses(8, "b"))
    j.replay_from(0)
    j.append(_statuses(8, "a"))  # half the replay re-crossed
    assert j.cancel_pending_replay() == 8
    assert j.cancel_pending_replay() == 0
    j.close()


# ---- the app ----------------------------------------------------------------

def _write_corpus(path, total, seed):
    with open(path, "w") as fh:
        for s in JaxSynthetic(total=total, seed=seed, base_ms=int(NOW_MS)).produce():
            fh.write(json.dumps(_status_json(s)) + "\n")


BASE = ["--source", "replay", "--seconds", "0", "--backend", "cpu",
        "--batchBucket", "16", "--tokenBucket", "64", "--history", "off",
        "--lightning", CLOSED, "--twtweb", CLOSED, "--webTimeout", "0.2"]


def _counting_run(argv):
    """app.run with every host fetch the pipeline starts counted."""
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD as L

    calls = {"n": 0}
    base = L.fetch_output

    def counting(out):
        calls["n"] += 1
        return base(out)

    with mock.patch.object(L, "fetch_output", staticmethod(counting)), \
            contextlib.redirect_stdout(io.StringIO()):
        totals = app.run(ConfArguments().parse(argv))
    return totals, calls["n"]


def test_checkpoint_stamp_roundtrip_and_journal_off_bit_exact(tmp_path, monkeypatch):
    monkeypatch.setenv("TWTML_NOW_MS", NOW_MS)
    path = tmp_path / "tweets.jsonl"
    _write_corpus(path, 6 * 16, seed=71)

    def run(ckdir, *extra):
        return _counting_run(BASE + ["--replayFile", str(path), "--checkpointDir",
                                     ckdir, "--checkpointEvery", "2", *extra])

    d_on, d_off = str(tmp_path / "on"), str(tmp_path / "off")
    totals_on, fetches_on = run(d_on)
    assert Checkpointer(d_on).latest_meta()["journal"] == {"cursor": 6, "rows": 6 * 16}
    assert journal_mod.get() is None  # run() uninstalls on the way out
    _metrics.reset_for_tests()
    totals_off, fetches_off = run(d_off, "--journal", "off")
    assert "journal" not in Checkpointer(d_off).latest_meta()
    assert (totals_on["count"], totals_on["batches"]) == (
        totals_off["count"], totals_off["batches"]) == (6 * 16, 6)
    assert fetches_on == fetches_off == 6 + 1  # a fetch a batch, and the warm-up's
    np.testing.assert_array_equal(Checkpointer(d_on).restore()[0],
                                  Checkpointer(d_off).restore()[0])


def test_journal_on_without_a_checkpoint_dir_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="--journal on requires --checkpointDir"):
        app.run(ConfArguments().parse(BASE + ["--replayFile", str(tmp_path / "x"),
                                              "--journal", "on"]))


_KILL_RUNNER = """
import os, signal, sys
sys.path.insert(0, {repo!r})
from twtml_tpu_torch.checkpoint.checkpointer import Checkpointer
orig = Checkpointer.save
state = {{"n": 0}}
def save(self, step, weights, metadata=None):
    out = orig(self, step, weights, metadata)
    state["n"] += 1
    if state["n"] == 3:
        os.kill(os.getpid(), signal.SIGKILL)
    return out
Checkpointer.save = save
from twtml_tpu_torch.apps import linear_regression as app
app.main(sys.argv[1:])
"""


def test_sigkill_restart_weights_equal_unfailed_control(tmp_path):
    """A run SIGKILL'd right after its 3rd save and restarted ends with the
    weights of a run that never failed: the restore, the journal's boot
    replay and the source's fast-forward lose and double-train nothing."""
    corpus = tmp_path / "tweets.jsonl"
    _write_corpus(corpus, 12 * 16, seed=72)
    env = dict(os.environ, PYTHONPATH=REPO, TWTML_NOW_MS=NOW_MS)
    runner = tmp_path / "kill_runner.py"
    runner.write_text(_KILL_RUNNER.format(repo=REPO))

    def args(ckdir):
        return BASE + ["--replayFile", str(corpus), "--checkpointDir", ckdir,
                       "--checkpointEvery", "1"]

    def launch(*argv):
        return subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                              timeout=240, env=env, cwd=REPO)

    ck_kill, ck_ctrl = str(tmp_path / "ck_kill"), str(tmp_path / "ck_ctrl")
    proc = launch(str(runner), *args(ck_kill))
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-3000:]
    assert Checkpointer(ck_kill).latest_meta()["batches"] < 12
    proc2 = launch("-m", "twtml_tpu_torch.apps.linear_regression", *args(ck_kill))
    assert proc2.returncode == 0, proc2.stderr[-3000:]
    assert "journal: boot resume" in proc2.stderr
    proc3 = launch("-m", "twtml_tpu_torch.apps.linear_regression", *args(ck_ctrl))
    assert proc3.returncode == 0, proc3.stderr[-3000:]
    w_kill, meta_kill = Checkpointer(ck_kill).restore()
    w_ctrl, meta_ctrl = Checkpointer(ck_ctrl).restore()
    assert meta_kill["count"] == meta_ctrl["count"] == 12 * 16
    assert meta_kill["batches"] == meta_ctrl["batches"] == 12
    np.testing.assert_array_equal(w_kill, w_ctrl)
