"""The port's lockstep multi-host runtime on the CPU: two gloo processes run
the port's linear app with ``--master twtml://`` over a replay file, held
against the JAX app's single-process run of the same file, as
tests/test_distributed_multiprocess.py holds the JAX package's group: the
same batch boundaries, the cumulative count and batch size exact, the
rounded stats within 2, one printer; the final checkpoints within rtol 1e-4
and atol 1e-7 of the port's own single-process run, and within the port's
single-device tolerance of the JAX run's. Each process runs under its own
timeout."""

from __future__ import annotations

import numpy as np
import pytest
from torch_group import (
    assert_lines_match,
    common_args,
    run_jax_single,
    run_torch_group,
    run_torch_single,
    stat_lines,
    write_replay,
)

from twtml_tpu.checkpoint import Checkpointer as JaxCheckpointer
from twtml_tpu_torch.checkpoint import Checkpointer


def _ok(results) -> list:
    for rc, _out, err in results:
        assert rc == 0, err[-3000:]
    return [out for _rc, out, _err in results]


def _hold(tmp_path, total: int, seed: int, extra: "list[str]", min_lines: int):
    """The group's run against the single-process runs of the same file with
    ``extra``: the JAX app's (its lines by the JAX multi-host test's rule,
    its weights within the port's single-device tolerance of the JAX model,
    rtol and atol 2e-3 as tests/test_torch_step.py holds it: B1 stores X in
    bf16, which rounds the numeric features) and the port's own (the lines
    again, the weights within the JAX multi-host test's rtol 1e-4 and atol
    1e-7). Returns (the group's checkpoint dir, the common arguments)."""
    path = write_replay(tmp_path / "tweets.jsonl", total, seed)
    common = common_args(path, *extra)
    d_jax, d_port, d_multi = (str(tmp_path / n) for n in ("ck_jax", "ck_port", "ck_multi"))
    jax_out = run_jax_single(common + ["--batchBucket", "32", "--checkpointDir", d_jax])
    port_out = run_torch_single(common + ["--batchBucket", "32", "--checkpointDir", d_port])
    lead, follower = _ok(run_torch_group(common + ["--batchBucket", "16", "--checkpointDir",
                                                   d_multi]))
    ref = stat_lines(jax_out)
    assert stat_lines(follower) == []  # one printer a run
    assert len(ref) >= min_lines
    assert_lines_match(stat_lines(lead), ref)
    assert_lines_match(stat_lines(lead), stat_lines(port_out))
    w_multi, meta_m = Checkpointer(d_multi).restore()
    for ckpt, rtol, atol in ((JaxCheckpointer(d_jax), 2e-3, 2e-3),
                             (Checkpointer(d_port), 1e-4, 1e-7)):
        w_single, meta_s = ckpt.restore()
        assert meta_s["count"] == meta_m["count"]
        assert meta_s["batches"] == meta_m["batches"] == len(ref)
        np.testing.assert_allclose(np.asarray(w_multi), np.asarray(w_single), rtol=rtol,
                                   atol=atol)
    return d_multi, common


def test_lockstep_app_trains_like_the_jax_single_process_run(tmp_path):
    """The default (ragged) wire, then the two resumes of the JAX test: a
    second run on the same directory trains nothing (the journal resumes
    exactly), and ``--journal off`` retrains the file on top of the
    restored counters."""
    d_multi, common = _hold(tmp_path, 200, 5, [], min_lines=5)
    again = _ok(run_torch_group(common + ["--batchBucket", "16", "--checkpointDir", d_multi]))
    assert stat_lines(again[0]) == []
    assert Checkpointer(d_multi).restore()[1]["count"] == 200
    off = _ok(run_torch_group(common + ["--batchBucket", "16", "--checkpointDir", d_multi,
                                        "--journal", "off"]))
    lead3 = stat_lines(off[0])
    assert lead3, "journal-off resume produced no batches"
    first = [int(x) for x in lead3[0].replace(":", " ").split() if x.lstrip("-").isdigit()]
    assert first[0] == 200 + first[1]
    assert Checkpointer(d_multi).restore()[1]["count"] == 400


@pytest.mark.parametrize("extra", [
    ["--wire", "padded"],
    ["--wireCodec", "dict"],
    ["--superBatch", "2"],
    ["--superBatch", "2", "--wirePack", "group", "--wireCodec", "dict"],
], ids=["padded", "codec", "superbatch", "superbatch-group-codec"])
def test_lockstep_wires_train_like_the_jax_single_process_run(tmp_path, extra):
    """The padded wire, the digram-coded shard-segment wire (the codec
    bucket agreed on the alignment all-gather) and ``--superBatch`` groups
    (stacked, and the coded group wire), each against the JAX app's
    single-process run with the same flags."""
    _hold(tmp_path, 128, 9, extra, min_lines=3)


def test_lockstep_block_ingest_parses_byte_range_shards(tmp_path):
    """``--ingest block``: each rank parses its own byte range of the file
    (``BlockReplayFileSource`` from the rank), lockstep drains cut blocks at
    the bucket, and the run matches the JAX package's emulation of the same
    per-host intake (tick k's two 16-row buckets, host 0's then host 1's,
    through one single-device model), as its multi-host block test does."""
    from twtml_tpu.features.batch import UnitBatch
    from twtml_tpu.features.blocks import empty_block, iter_row_chunks
    from twtml_tpu.features.featurizer import Featurizer
    from twtml_tpu.models import StreamingLinearRegressionWithSGD
    from twtml_tpu.streaming.sources import BlockReplayFileSource

    path = write_replay(tmp_path / "tweets.jsonl", 200, 21)
    d_multi = str(tmp_path / "ck")
    lead, follower = _ok(run_torch_group(
        common_args(path, "--ingest", "block", "--batchBucket", "16", "--checkpointDir",
                    d_multi), env={"TWTML_NOW_MS": "1785320000000"}))
    assert stat_lines(follower) == []
    feat = Featurizer(now_ms=1785320000000)
    chunks = [list(iter_row_chunks(
        BlockReplayFileSource(path, shard_index=i, shard_count=2).produce(), 16))
        for i in range(2)]
    ticks = max(len(c) for c in chunks)
    model = StreamingLinearRegressionWithSGD(num_iterations=50, step_size=0.005)
    for k in range(ticks):
        parts = [feat.featurize_parsed_block(c[k] if k < len(c) else empty_block(),
                                             row_bucket=16, unit_bucket=64) for c in chunks]
        model.step(UnitBatch(*(np.concatenate([getattr(b, f) for b in parts])
                               for f in UnitBatch._fields)))
    w_multi, meta = Checkpointer(d_multi).restore()
    assert meta["count"] == 200
    assert len(stat_lines(lead)) == ticks
    np.testing.assert_allclose(np.asarray(w_multi), model.latest_weights, rtol=1e-4, atol=1e-7)


def test_lockstep_sentinel_rolls_both_ranks_back(tmp_path):
    """``--chaos source.nan@2`` poisons each rank's rows of the second global
    batch; both ranks see the same non-finite global stats at the same
    delivery and roll back: the lead from disk, the follower from its
    broadcast; the rollback count rides the cadence all-gather without a
    disagreement, the journal replays the rows on both, and all 3 batches
    train (the JAX multi-host sentinel test's assertions)."""
    path = write_replay(tmp_path / "tweets.jsonl", 96, 33)
    d_ck = str(tmp_path / "ck")
    results = run_torch_group(common_args(
        path, "--batchBucket", "16", "--checkpointDir", d_ck, "--checkpointEvery", "1",
        "--chaos", "source.nan@2"))
    outs = _ok(results)
    for _rc, _out, err in results:
        assert "rolled back to verified checkpoint" in err, err[-2000:]
        assert "disagree on sentinel rollback counts" not in err
        assert "journal: replayed" in err, err[-2000:]
    lead = stat_lines(outs[0])
    assert stat_lines(outs[1]) == []
    assert len(lead) == 3 and "count: 96" in lead[-1]
    state, meta = Checkpointer(d_ck).restore()
    assert meta["count"] == 96 and meta["batches"] == 3
    assert np.isfinite(np.asarray(state)).all()
