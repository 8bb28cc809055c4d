"""The port's checkpoint (``twtml_tpu_torch/checkpoint``, ``apps/common.py``
``AppCheckpoint``) against the JAX package's: an archive either package
saves restores in the other with equal arrays and meta; the integrity cases
of tests/test_checkpoint_integrity.py run on the port's class; and a run
checkpointed by one app continues in the other to the same lines, both
ways (the JAX app at ``--master local[1]``, the port's on the CPU)."""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest

from tools.bench_suite import _status_json
from twtml_tpu.checkpoint import Checkpointer as JaxCheckpointer
from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic
from twtml_tpu.telemetry import metrics as jax_metrics
from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.apps.common import AppCheckpoint, state_checksum
from twtml_tpu_torch.checkpoint import Checkpointer
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.telemetry import metrics as _metrics

CLOSED = "http://127.0.0.1:9"
NOW_MS = "1785320000000"


@pytest.fixture(autouse=True)
def clean_metrics():
    _metrics.reset_for_tests()
    yield
    _metrics.reset_for_tests()


def _weights(seed, shape=(32,)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---- archives across the packages ------------------------------------------

STATES = [
    ("vector", lambda: _weights(1, (1004,))),
    ("dict", lambda: {"centers": _weights(2, (4, 8)), "counts": np.arange(4)}),
]


@pytest.mark.parametrize("name,make", STATES, ids=[n for n, _ in STATES])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_archive_restores_in_the_other_package(tmp_path, name, make, writer):
    state = make()
    meta = {"count": 48, "batches": 3, "journal": {"cursor": 3, "rows": 48},
            "quality": {"level": "ok", "ticks": 3}}
    w_cls, r_cls = (JaxCheckpointer, Checkpointer) if writer == "jax" else (
        Checkpointer, JaxCheckpointer)
    path = w_cls(str(tmp_path)).save(3, state, meta)
    assert os.path.basename(path) == "ckpt-000000000003.npz"
    got, got_meta = r_cls(str(tmp_path)).restore()
    theirs, theirs_meta = w_cls(str(tmp_path)).restore()
    assert got_meta == theirs_meta
    assert got_meta["journal"] == meta["journal"] and got_meta["finite"] is True
    if isinstance(state, dict):
        assert sorted(got) == sorted(state)
        for k in state:
            np.testing.assert_array_equal(got[k], state[k])
            assert got[k].dtype == state[k].dtype
    else:
        np.testing.assert_array_equal(got, state)
        assert got.dtype == np.float32


def test_archive_bytes_equal_the_jax_packages(tmp_path):
    """The same state and meta make the same archive bytes."""
    meta = {"count": 16, "batches": 1}
    a = Checkpointer(str(tmp_path / "a")).save(1, _weights(3), meta)
    b = JaxCheckpointer(str(tmp_path / "b")).save(1, _weights(3), meta)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_quarantine_is_invisible_to_the_other_package(tmp_path, writer):
    w_cls, r_cls = (JaxCheckpointer, Checkpointer) if writer == "jax" else (
        Checkpointer, JaxCheckpointer)
    ck = w_cls(str(tmp_path))
    ck.save(1, _weights(1))
    bad = _weights(2)
    bad[4] = np.nan
    assert os.path.basename(ck.save(2, bad)).startswith("quarantine-")
    state, meta = r_cls(str(tmp_path)).restore()
    assert meta["step"] == 1
    np.testing.assert_array_equal(state, _weights(1))


# ---- the integrity cases (tests/test_checkpoint_integrity.py) ---------------

def test_malformed_ckpt_names_are_tolerated(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _weights(0))
    for stray in ("ckpt-backup.npz", "ckpt-.npz", "ckpt-12a4.npz",
                  "ckpt-000000000003.npz.orig", "ckpt-old-000000000002.npz"):
        (tmp_path / stray).write_bytes(b"not a checkpoint")
    assert ck.latest_step() == 3
    state, _ = ck.restore()
    np.testing.assert_array_equal(state, _weights(0))
    for step in (4, 5, 6, 7):
        ck.save(step, _weights(step))
    assert ck.latest_step() == 7
    assert (tmp_path / "ckpt-backup.npz").exists()


def _tamper(path, mutate):
    """Rewrite an archive with its arrays mutated and its meta unchanged."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    with open(path, "wb") as fh:
        np.savez(fh, **mutate(arrays))


def test_crc_mismatch_falls_back_to_older(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _weights(1))
    ck.save(2, _weights(2))

    def flip(arrays):
        w = arrays["w"].copy()
        w[5] += 1.0
        return {**arrays, "w": w}

    _tamper(str(tmp_path / "ckpt-000000000002.npz"), flip)
    state, meta = ck.restore()
    assert meta["step"] == 1
    np.testing.assert_array_equal(state, _weights(1))
    assert _metrics.get_registry().counter("checkpoint.restore_corrupt").snapshot() == 1


def test_shape_and_dtype_mismatch_fall_back(tmp_path):
    ck = Checkpointer(str(tmp_path))
    for step in (1, 2, 3):
        ck.save(step, _weights(step))
    _tamper(str(tmp_path / "ckpt-000000000003.npz"), lambda a: {**a, "w": a["w"][:16]})
    _tamper(str(tmp_path / "ckpt-000000000002.npz"),
            lambda a: {**a, "w": a["w"].astype(np.float64)})
    _, meta = ck.restore()
    assert meta["step"] == 1
    assert _metrics.get_registry().counter("checkpoint.restore_corrupt").snapshot() == 2


def test_dict_state_verifies_per_array(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"centers": _weights(1, (4, 8)), "counts": np.arange(4)})
    ck.save(2, {"centers": _weights(2, (4, 8)), "counts": np.arange(4)})

    def corrupt_one(arrays):
        c = arrays["w__centers"].copy()
        c[0, 0] = 999.0
        return {**arrays, "w__centers": c}

    _tamper(str(tmp_path / "ckpt-000000000002.npz"), corrupt_one)
    state, meta = ck.restore()
    assert meta["step"] == 1
    np.testing.assert_array_equal(state["centers"], _weights(1, (4, 8)))


def test_missing_key_is_corrupt(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": _weights(1), "b": _weights(2)})
    ck.save(2, {"a": _weights(3), "b": _weights(4)})
    _tamper(str(tmp_path / "ckpt-000000000002.npz"),
            lambda arrays: {k: v for k, v in arrays.items() if k != "w__b"})
    _, meta = ck.restore()
    assert meta["step"] == 1


def test_nonfinite_save_quarantines_instead_of_overwriting(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=3)
    ck.save(1, _weights(1))
    bad = _weights(9)
    bad[3] = np.nan
    for step in (2, 3, 4, 5):
        assert os.path.basename(ck.save(step, bad)).startswith("quarantine-")
    state, meta = ck.restore()
    assert meta["step"] == 1 and ck.latest_step() == 1
    np.testing.assert_array_equal(state, _weights(1))
    assert _metrics.get_registry().counter("checkpoint.quarantined").snapshot() == 4
    assert len([n for n in os.listdir(tmp_path) if n.startswith("quarantine-")]) == 4


def test_inf_counts_as_nonfinite_and_int_arrays_are_fine(tmp_path):
    ck = Checkpointer(str(tmp_path))
    bad = _weights(1)
    bad[0] = np.inf
    assert os.path.basename(ck.save(1, bad)).startswith("quarantine-")
    path = ck.save(2, {"counts": np.arange(5, dtype=np.int64)})
    assert os.path.basename(path) == "ckpt-000000000002.npz"


def _legacy(path, w, meta):
    with open(path, "wb") as fh:
        np.savez(fh, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), w=w)


def test_restore_skips_legacy_nonfinite_archives(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _weights(1))
    bad = _weights(2)
    bad[0] = np.nan
    _legacy(tmp_path / "ckpt-000000000002.npz", bad, {"step": 2})
    _, meta = ck.restore()
    assert meta["step"] == 1
    assert _metrics.get_registry().counter("checkpoint.restore_nonfinite").snapshot() == 1


def test_legacy_finite_archive_still_restores(tmp_path):
    w = _weights(4)
    _legacy(tmp_path / "ckpt-000000000009.npz", w, {"step": 9, "count": 123})
    state, got = Checkpointer(str(tmp_path)).restore()
    np.testing.assert_array_equal(state, w)
    assert got["count"] == 123


def test_unreadable_archive_still_falls_back(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _weights(1))
    (tmp_path / "ckpt-000000000002.npz").write_bytes(b"torn write")
    _, meta = ck.restore()
    assert meta["step"] == 1


def test_stale_temp_files_are_swept(tmp_path):
    (tmp_path / "abc.tmp").write_bytes(b"half a save")
    Checkpointer(str(tmp_path))
    assert not (tmp_path / "abc.tmp").exists()


# ---- AppCheckpoint -----------------------------------------------------------

def _conf(*argv):
    return ConfArguments().parse(["--history", "off", *argv])


def test_app_checkpoint_cadence_and_final_save(tmp_path):
    w = {"v": _weights(5, (8,))}
    totals = {"count": 0, "batches": 0}
    ck = AppCheckpoint(_conf("--checkpointDir", str(tmp_path), "--checkpointEvery", "2"),
                       get_state=lambda: w["v"], set_state=None, totals=totals)
    for b in range(1, 6):
        totals.update(count=16 * b, batches=b)
        ck.maybe_save(totals, at_boundary=b != 3)
    # cadence points 2 and 4 saved (a save waits for a drained boundary)
    assert Checkpointer(str(tmp_path)).latest_step() == 4
    ck.final_save(totals)
    state, meta = Checkpointer(str(tmp_path)).restore()
    assert (meta["step"], meta["count"], meta["batches"]) == (5, 80, 5)
    np.testing.assert_array_equal(state, w["v"])


def test_app_checkpoint_restores_state_and_counters(tmp_path):
    Checkpointer(str(tmp_path)).save(3, _weights(6), {"count": 48, "batches": 3})
    got = []
    totals = {"count": 0, "batches": 0}
    ck = AppCheckpoint(_conf("--checkpointDir", str(tmp_path)), get_state=None,
                       set_state=got.append, totals=totals)
    np.testing.assert_array_equal(got[0], _weights(6))
    assert totals == {"count": 48, "batches": 3} and ck.restored_meta["step"] == 3
    assert state_checksum(_weights(6)) == state_checksum(got[0])


def test_state_checksum_equals_the_jax_packages():
    from twtml_tpu.apps.common import state_checksum as jax_checksum

    for state in (_weights(1), {"a": _weights(2), "b": np.arange(3)}):
        assert state_checksum(state) == jax_checksum(state)


def test_app_checkpoint_without_a_directory_is_inert():
    ck = AppCheckpoint(_conf(), get_state=None, set_state=None, totals={"count": 0,
                                                                      "batches": 0})
    assert ck.rollback_to_verified() is None
    assert ck.save_now({"count": 1, "batches": 1}) is False


@pytest.mark.parametrize("call", ["follower", "promote", "resync"])
def test_multi_host_parts_raise_naming_the_roadmap_item(tmp_path, call):
    """The elastic parts these cases found refused (ROADMAP A10b) are
    ported; on one host each does what the JAX package's ``AppCheckpoint``
    does with the same archive: a follower restores but writes no archive
    and has nothing to resync from; ``promote`` makes it the writer; a
    lead's ``resync_from_verified`` restores its newest verified archive
    and takes its counters, counting the rows rolled back."""
    from twtml_tpu.apps.common import AppCheckpoint as JaxAppCheckpoint

    def run(package):
        directory = tmp_path / package
        cls, ckpt_cls, conf, metrics = (
            (AppCheckpoint, Checkpointer, _conf, _metrics) if package == "port" else
            (JaxAppCheckpoint, JaxCheckpointer,
             lambda *a: JaxConf().parse(["--history", "off", *a]), jax_metrics))
        ckpt_cls(str(directory)).save(3, _weights(6), {"count": 48, "batches": 3})
        metrics.reset_for_tests()
        got, totals = [], {"count": 0, "batches": 0}
        ck = cls(conf("--checkpointDir", str(directory)), lambda: _weights(7), got.append,
                 totals, lead=call == "resync")
        if call == "promote":
            ck.promote()
            ck.promote()  # idempotent
        totals["count"], totals["batches"] = 100, 5
        resynced = ck.resync_from_verified(totals)
        after = dict(totals)
        totals["count"], totals["batches"] = 120, 6
        ck.save_now(totals)
        rolled = metrics.get_registry().snapshot()["counters"].get("elastic.rows_rolled_back")
        return (resynced, after, [state_checksum(g) for g in got], rolled,
                sorted(f for f in os.listdir(directory) if f.startswith("ckpt-")))

    ours, theirs = run("port"), run("jax")
    assert ours == theirs
    resynced, after, states, rolled, files = ours
    if call == "follower":
        assert (resynced, after, rolled) == (False, {"count": 100, "batches": 5}, None)
        assert files == ["ckpt-000000000003.npz"]
    else:
        assert (resynced, after, rolled) == (True, {"count": 48, "batches": 3}, 52)
        assert states == [state_checksum(_weights(6))] * 2
        assert files == ["ckpt-000000000003.npz", "ckpt-000000000006.npz"]


# ---- cross-restore: one app's checkpoint continued by the other --------------

def _replay(path, total, seed):
    with open(path, "w") as fh:
        for s in JaxSynthetic(total=total, seed=seed, base_ms=int(NOW_MS)).produce():
            fh.write(json.dumps(_status_json(s)) + "\n")


def _argv(replay, ckdir):
    return ["--source", "replay", "--replayFile", str(replay), "--seconds", "0",
            "--backend", "cpu", "--batchBucket", "16", "--tokenBucket", "64",
            "--checkpointDir", str(ckdir), "--checkpointEvery", "1", "--history", "off",
            "--lightning", CLOSED, "--twtweb", CLOSED, "--webTimeout", "0.2"]


def _port(argv, max_batches):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        totals = app.run(ConfArguments().parse(argv), max_batches=max_batches)
    return totals, out.getvalue().splitlines()


def _jax(argv, max_batches, capsys):
    from twtml_tpu.apps import linear_regression as jax_app

    jax.devices()
    jax_metrics.reset_for_tests()
    capsys.readouterr()
    totals = jax_app.run(JaxConf().parse([*argv, "--master", "local[1]"]),
                         max_batches=max_batches)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("count:")]
    return totals, lines


@pytest.mark.parametrize("first", ["jax", "port"])
def test_cross_restore_continues_to_the_same_lines(tmp_path, monkeypatch, capsys, first):
    """3 batches in one package, then 3 more from its checkpoint (and
    journal) in the other: the 6 lines equal one package's 6-batch run, and
    the final archives agree within the learners' 2e-3."""
    monkeypatch.setenv("TWTML_NOW_MS", NOW_MS)
    replay = tmp_path / "tweets.jsonl"
    _replay(replay, 6 * 16, seed=61)
    ref_totals, ref_lines = _jax(_argv(replay, tmp_path / "ref"), 6, capsys)
    handoff = tmp_path / "handoff"
    runs = (("jax", 3), ("port", 6)) if first == "jax" else (("port", 3), ("jax", 6))
    lines = []
    for who, cap in runs:
        if who == "jax":
            _, got = _jax(_argv(replay, handoff), cap, capsys)
        else:
            _, got = _port(_argv(replay, handoff), cap)
        lines += got
    assert lines == ref_lines and len(lines) == 6
    w, meta = Checkpointer(str(handoff)).restore()
    w_ref, meta_ref = JaxCheckpointer(str(tmp_path / "ref")).restore()
    assert (meta["count"], meta["batches"]) == (meta_ref["count"], meta_ref["batches"])
    np.testing.assert_allclose(w, w_ref, rtol=2e-3, atol=2e-3)
