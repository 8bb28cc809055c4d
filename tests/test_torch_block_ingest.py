"""Block ingest (``--ingest block``) of the port against the JAX package's,
on the CPU, tolerance 0 throughout: the native parsers (the legacy C
parser and the zero-copy wire emitter) and the Python ground truth give
the JAX package's arrays and bad-line counts on the fixture and on a
seeded file with non-ASCII, malformed, filtered and oversized lines; the
block helpers, ``featurize_parsed_block`` (ragged, padded, packed; native
fill on and off; ``normalize_accents``; ``unit_label_fn``), the block
sources (and a 3-way byte-range shard), kind-2 journal records (byte for
byte, each package replaying the other's), the parse degrade chain and its
counters, the streaming seams (a capped drain cutting a block, block rows
in the crash counter, ``source.garbage``), the source rules and exits, and
the linear (with and without ``--wireCodec dict``), logistic and k-means
apps' lines on the fixture.
"""

import contextlib
import io
import json
import os
import shutil
import warnings

import jax
import numpy as np
import pytest

from twtml_tpu.apps import kmeans as jax_kmeans
from twtml_tpu.apps import linear_regression as jax_linear
from twtml_tpu.apps import logistic_regression as jax_logistic
from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu.features import blocks as jax_blocks
from twtml_tpu.features import featurize_native as jax_ffz
from twtml_tpu.features import native as jax_native
from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.features.sentiment import sentiment_labels_from_units as jax_unit_labels
from twtml_tpu.streaming.journal import IntakeJournal as JaxJournal
from twtml_tpu.streaming.sources import BlockReplayFileSource as JaxBlockReplay

from twtml_tpu_torch.apps import common
from twtml_tpu_torch.apps import kmeans as port_kmeans
from twtml_tpu_torch.apps import linear_regression as port_linear
from twtml_tpu_torch.apps import logistic_regression as port_logistic
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features import blocks, featurize_native, native
from twtml_tpu_torch.features.batch import PackedBatch, RaggedUnitBatch, UnitBatch
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.features.sentiment import sentiment_labels_from_units
from twtml_tpu_torch.streaming import faults
from twtml_tpu_torch.streaming.context import StreamingContext, _RowCountQueue
from twtml_tpu_torch.streaming.journal import IntakeJournal
from twtml_tpu_torch.streaming.sources import BlockReplayFileSource, QueueSource
from twtml_tpu_torch.streaming.twitter import BlockTwitterSource
from twtml_tpu_torch.telemetry import lineage, metrics

FIXTURE = "tests/data/tweets.jsonl"
NOW_MS = 1785320000000
CLOSED = "http://127.0.0.1:9"
QUIET = ["--lightning", CLOSED, "--twtweb", CLOSED, "--webTimeout", "0.2"]
BLOCK_FIELDS = ("numeric", "units", "offsets", "ascii")
WIRE_FIELDS = ("units", "offsets", "numeric", "label", "mask")


@pytest.fixture(autouse=True)
def port_native():
    if shutil.which("g++") is None:
        pytest.skip("g++ not on PATH: the native host path cannot be built")
    assert native.get_lib().parse_tweet_block is not None and native.wire_available()


def _rt(text, count=500, key="text", **extra):
    rt = {key: text, "retweet_count": count,
          "user": {"followers_count": 11, "favourites_count": 22, "friends_count": 33},
          "timestamp_ms": "1785313333333"}
    rt.update(extra)
    return {"text": "RT", "retweeted_status": rt}


def seeded_lines(seed=20261017, n=300):
    """JSON lines from a numpy seed: ASCII retweets, non-ASCII ones (BMP,
    astral, a lowercase that changes length), extended tweets (full_text),
    retweets outside the interval, plain tweets, malformed lines, JSON that
    is not a tweet object, and an oversized text (a counted bad line)."""
    rng = np.random.default_rng(seed)
    words = ["stream", "LOVE", "tpu", "bad", "great", "t.co/x", "the", "of", "RT"]
    uni = ["café", "你好", "İstanbul", "\U0001f600", "ÀÉÎ", "ẞ"]
    lines = []
    for i in range(n):
        kind = int(rng.integers(0, 10))
        text = " ".join(rng.choice(words, size=int(rng.integers(1, 12))))
        count = int(rng.integers(80, 1100))
        if kind <= 4:
            obj = _rt(text, count, **{"user": {"followers_count": int(rng.integers(0, 10**9)),
                                                "favourites_count": i, "friends_count": 7}})
        elif kind == 5:
            obj = _rt(text + " " + str(rng.choice(uni)), count)
        elif kind == 6:
            obj = _rt(text, count, key="full_text")
        elif kind == 7:
            obj = {"text": text, "retweet_count": count, "user": {"followers_count": 1}}
        elif kind == 8:
            lines.append(rng.choice(['{"text": "RT", "retweeted_status": {', "garbage",
                                     "[1, 2, 3]", '"just a string"', "{}"]))
            continue
        else:
            obj = _rt(text, count, created_at="Wed Aug 27 13:08:45 +0000 2008")
        lines.append(json.dumps(obj, ensure_ascii=bool(rng.integers(0, 2))))
    lines.append(json.dumps(_rt("x" * (native.MAX_TEXT_UNITS + 1))))
    return lines


@pytest.fixture
def seeded_file(tmp_path):
    path = tmp_path / "seeded.jsonl"
    path.write_text("\n".join(seeded_lines()) + "\n", encoding="utf-8")
    return str(path)


def assert_blocks_equal(got, want):
    for f in BLOCK_FIELDS:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def assert_wire_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    if isinstance(got, PackedBatch):
        assert got.layout == want.layout
        np.testing.assert_array_equal(np.asarray(got.buffer), np.asarray(want.buffer))
        return
    fields = WIRE_FIELDS if isinstance(got, RaggedUnitBatch) else (
        "units", "length", "numeric", "label", "mask")
    for f in fields:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    if isinstance(got, RaggedUnitBatch):
        assert got.row_len == want.row_len


# ---- the parsers ------------------------------------------------------------------

@pytest.mark.parametrize("which", ["fixture", "seeded"])
@pytest.mark.parametrize("parser", ["parse_tweet_block", "parse_tweet_block_wire"])
@pytest.mark.parametrize("interval", [(100, 1000), (0, 2**62)])
def test_native_parsers_are_byte_equal_to_the_jax_packages(which, parser, interval,
                                                           seeded_file):
    data = open(FIXTURE if which == "fixture" else seeded_file, "rb").read()
    got = getattr(native, parser)(data, *interval)
    want = getattr(jax_native, parser)(data, *interval)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[4:] == want[4:]  # consumed bytes, bad lines
    if which == "seeded":
        assert got[5] > 0 and got[0].shape[0] > 50


def test_the_wire_emitter_is_narrow_exactly_when_every_row_is_ascii(seeded_file, tmp_path):
    ascii_path = tmp_path / "ascii.jsonl"
    ascii_path.write_text("\n".join(json.dumps(_rt(f"row {i} text")) for i in range(40)) + "\n")
    narrow = native.parse_tweet_block_wire(ascii_path.read_bytes(), 100, 1000)
    wide = native.parse_tweet_block_wire(open(seeded_file, "rb").read(), 100, 1000)
    assert narrow[1].dtype == np.uint8 and narrow[3].all()
    assert wide[1].dtype == np.uint16 and not wide[3].all()
    legacy = native.parse_tweet_block(open(seeded_file, "rb").read(), 100, 1000)
    np.testing.assert_array_equal(wide[1], legacy[1])


@pytest.mark.parametrize("which", ["fixture", "seeded"])
def test_the_python_ground_truth_is_the_jax_packages(which, seeded_file):
    path = FIXTURE if which == "fixture" else seeded_file
    data = open(path, "rb").read()
    got, got_rest = BlockReplayFileSource(path)._py_parse(data)
    want, want_rest = JaxBlockReplay(path)._py_parse(data)
    assert_blocks_equal(got, want)
    assert got_rest == want_rest
    c_block = native.parse_tweet_block(data, 100, 1000)
    np.testing.assert_array_equal(got.numeric, c_block[0])
    np.testing.assert_array_equal(got.units, c_block[1])


@pytest.mark.parametrize("wire", [False, True])
@pytest.mark.parametrize("block_bytes", [1 << 20, 700])
def test_block_sources_yield_the_jax_packages_blocks(wire, block_bytes, seeded_file):
    got = list(BlockReplayFileSource(seeded_file, wire=wire, block_bytes=block_bytes).produce())
    want = list(JaxBlockReplay(seeded_file, wire=wire, block_bytes=block_bytes).produce())
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert_blocks_equal(g, w)


def test_a_three_way_byte_range_shard_places_every_line_once(seeded_file):
    whole = blocks.merge_blocks(list(BlockReplayFileSource(seeded_file).produce()))
    parts, ranges = [], []
    for i in range(3):
        src = BlockReplayFileSource(seeded_file, shard_index=i, shard_count=3)
        jsrc = JaxBlockReplay(seeded_file, shard_index=i, shard_count=3)
        assert src._shard_range() == jsrc._shard_range()
        ranges.append(src._shard_range())
        got = blocks.merge_blocks(list(src.produce()))
        assert_blocks_equal(got, jax_blocks.merge_blocks(list(jsrc.produce())))
        parts.append(got)
    assert ranges[0][0] == 0 and ranges[-1][1] == os.path.getsize(seeded_file)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(2))
    assert_blocks_equal(blocks.merge_blocks(parts), whole)
    with pytest.raises(ValueError, match="out of range"):
        BlockReplayFileSource(seeded_file, shard_index=3, shard_count=3)


# ---- the degrade chain --------------------------------------------------------------

def test_the_parse_degrades_wire_then_c_then_python_counted_and_warned_once(
        seeded_file, monkeypatch):
    want = blocks.merge_blocks(list(BlockReplayFileSource(seeded_file, wire=True).produce()))
    native.reset_counters()
    list(BlockReplayFileSource(seeded_file, wire=True).produce())
    assert native.PARSE_COUNTERS["parses_wire"] >= 1
    assert native.PARSE_COUNTERS["wire_degraded"] == native.PARSE_COUNTERS[
        "native_degraded"] == 0
    monkeypatch.setattr(native, "_warned_parse", set())
    monkeypatch.setattr(native, "parse_tweet_block_wire", lambda *a, **k: None)
    native.reset_counters()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy = blocks.merge_blocks(list(BlockReplayFileSource(
            seeded_file, wire=True, block_bytes=2000).produce()))
    degraded = native.PARSE_COUNTERS["wire_degraded"]
    assert degraded > 1 and native.PARSE_COUNTERS["parses_native"] == degraded
    assert sum("degraded (wire)" in str(w.message) for w in caught) == 1
    np.testing.assert_array_equal(legacy.units, want.units.astype(np.uint16))
    monkeypatch.setattr(native, "parse_tweet_block", lambda *a, **k: None)
    native.reset_counters()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        python = blocks.merge_blocks(list(BlockReplayFileSource(
            seeded_file, wire=True).produce()))
    assert native.PARSE_COUNTERS["native_degraded"] == native.PARSE_COUNTERS[
        "parses_python"] >= 1
    assert sum("degraded (native)" in str(w.message) for w in caught) == 1
    assert_blocks_equal(python, legacy)


def test_parse_metrics_and_dropped_lines_are_counted(seeded_file):
    metrics.reset_for_tests()
    data = open(seeded_file, "rb").read()
    list(BlockReplayFileSource(seeded_file).produce())
    reg = metrics.get_registry()
    assert reg.counter("ingest.parse_bytes").value == len(data)
    assert reg.gauge("ingest.parse_tweets_per_s").value > 0
    assert reg.counter("ingest.rows_dropped_parse").value == native.parse_tweet_block(
        data, 100, 1000)[5]


# ---- the block helpers ------------------------------------------------------------

def _parsed(path, wire, port=True):
    cls = BlockReplayFileSource if port else JaxBlockReplay
    return list(cls(path, wire=wire, block_bytes=900).produce())


@pytest.mark.parametrize("wire", [False, True])
def test_slice_merge_and_row_chunks_are_the_jax_packages(wire, seeded_file):
    ours, theirs = _parsed(seeded_file, wire), _parsed(seeded_file, wire, port=False)
    assert len(ours) > 3
    assert_blocks_equal(blocks.merge_blocks(ours), jax_blocks.merge_blocks(theirs))
    assert_blocks_equal(blocks.merge_blocks([]), jax_blocks.merge_blocks([]))
    merged = blocks.merge_blocks(ours)
    for lo, hi in ((0, 0), (0, 5), (3, 17), (merged.rows - 2, merged.rows)):
        assert_blocks_equal(blocks.slice_block(merged, lo, hi),
                            jax_blocks.slice_block(jax_blocks.merge_blocks(theirs), lo, hi))
    for rows in (1, 7, 64, 1000):
        got = list(blocks.iter_row_chunks(iter(ours), rows))
        want = list(jax_blocks.iter_row_chunks(iter(theirs), rows))
        assert [b.rows for b in got] == [b.rows for b in want]
        for g, w in zip(got, want):
            assert_blocks_equal(g, w)
    assert blocks.empty_block().rows == 0 and blocks.COL_CREATED_MS == jax_blocks.COL_CREATED_MS
    np.testing.assert_array_equal(featurize_native.block_col_order(),
                                  jax_ffz.block_col_order())


# ---- featurize_parsed_block ---------------------------------------------------------

@contextlib.contextmanager
def fills(port: str, ref: str):
    with featurize_native.forced(port), jax_ffz.forced(ref):
        yield


@pytest.mark.parametrize("which", ["fixture", "seeded", "ascii"])
@pytest.mark.parametrize("form", ["ragged", "padded", "packed"])
@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("wire", [False, True])
def test_featurize_parsed_block_is_the_jax_packages(which, form, mode, wire, seeded_file,
                                                    tmp_path):
    if which == "ascii":
        path = tmp_path / "ascii.jsonl"
        path.write_text("\n".join(json.dumps(_rt(f"Row {i} of ASCII text https://t.co/q"))
                                  for i in range(50)) + "\n")
        path = str(path)
    else:
        path = FIXTURE if which == "fixture" else seeded_file
    block = blocks.merge_blocks(_parsed(path, wire))
    jblock = jax_blocks.merge_blocks(_parsed(path, wire, port=False))
    kw = dict(row_bucket=0, unit_bucket=0, ragged=form != "padded", pack=form == "packed")
    with fills(mode, mode):
        got = Featurizer(now_ms=NOW_MS).featurize_parsed_block(block, **kw)
        want = JaxFeaturizer(now_ms=NOW_MS).featurize_parsed_block(jblock, **kw)
    assert_wire_equal(got, want)
    if which == "ascii" and form == "ragged" and mode == "on":
        assert got.lease is not None  # the native fill built it


@pytest.mark.parametrize("form", ["ragged", "padded"])
def test_normalize_accents_and_unit_labels_are_the_jax_packages(form, seeded_file):
    block = blocks.merge_blocks(_parsed(seeded_file, True))
    jblock = jax_blocks.merge_blocks(_parsed(seeded_file, True, port=False))
    ours = Featurizer(now_ms=NOW_MS, normalize_accents=True,
                      unit_label_fn=sentiment_labels_from_units)
    theirs = JaxFeaturizer(now_ms=NOW_MS, normalize_accents=True, unit_label_fn=jax_unit_labels)
    kw = dict(row_bucket=512, ragged=form == "ragged")
    assert_wire_equal(ours.featurize_parsed_block(block, **kw),
                      theirs.featurize_parsed_block(jblock, **kw))
    np.testing.assert_array_equal(sentiment_labels_from_units(block.units, block.offsets),
                                  jax_unit_labels(jblock.units, jblock.offsets))


def test_a_status_labeler_is_refused_on_blocks():
    block = blocks.merge_blocks(_parsed(FIXTURE, True))
    with pytest.raises(ValueError, match="unit_label_fn"):
        Featurizer(label_fn=lambda s: 1.0).featurize_parsed_block(block, ragged=True)


def test_the_block_path_equals_the_object_path_on_the_fixture():
    """The semantic ground truth: the fixture's retweets through Status
    objects and through blocks give one ragged batch."""
    from twtml_tpu_torch.streaming.sources import ReplayFileSource

    feat = Featurizer(now_ms=NOW_MS)
    statuses = list(ReplayFileSource(FIXTURE).produce())
    obj = feat.featurize_batch_ragged(statuses, row_bucket=8)
    blk = feat.featurize_parsed_block(blocks.merge_blocks(_parsed(FIXTURE, True)),
                                      row_bucket=8, ragged=True)
    assert_wire_equal(blk, obj)


# ---- the journal --------------------------------------------------------------------

def _segment_bytes(directory):
    return [open(os.path.join(directory, f), "rb").read()
            for f in sorted(os.listdir(directory)) if f.endswith(".twj")]


@pytest.mark.parametrize("wire", [False, True])
def test_kind_2_records_are_byte_equal_and_replay_across_packages(wire, seeded_file,
                                                                  tmp_path):
    ours, theirs = _parsed(seeded_file, wire), _parsed(seeded_file, wire, port=False)
    ours_dir, theirs_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    j, jj = IntakeJournal(ours_dir), JaxJournal(theirs_dir)
    for i in range(0, len(ours), 2):
        j.append(ours[i:i + 2])
        jj.append(theirs[i:i + 2])
    j.close(), jj.close()
    assert _segment_bytes(ours_dir) == _segment_bytes(theirs_dir)
    for reader_cls, directory in ((IntakeJournal, theirs_dir), (JaxJournal, ours_dir)):
        reader = reader_cls(directory)
        got = [b for _id, items in reader.records_from(0) for b in items]
        reader.close()
        assert_blocks_equal(blocks.merge_blocks(got), blocks.merge_blocks(ours))
        # a record is its batch's merged block, in the merge's dtype
        assert [b.units.dtype for b in got] == [
            blocks.merge_blocks(ours[i:i + 2]).units.dtype for i in range(0, len(ours), 2)]


def test_a_replayed_block_head_is_not_journaled_twice(seeded_file, tmp_path):
    ours = blocks.merge_blocks(_parsed(seeded_file, True))
    j = IntakeJournal(str(tmp_path / "j"))
    j.append([blocks.slice_block(ours, 0, 40)])
    items, rows = j.replay_from(0)
    assert rows == 40 and items[0].rows == 40
    # a drain of the 40 replayed rows and 10 fresh ones appends the 10
    j.append([items[0], blocks.slice_block(ours, 40, 50)])
    assert j.rows_total == 50
    got = blocks.merge_blocks([b for _, it in j.records_from(0) for b in it])
    assert_blocks_equal(got, blocks.slice_block(ours, 0, 50))
    j.close()


# ---- the streaming seams ------------------------------------------------------------

def test_a_capped_drain_cuts_a_block_and_keeps_its_tail(seeded_file):
    block = blocks.merge_blocks(_parsed(seeded_file, True))
    ssc = StreamingContext(batch_interval=0)
    ssc._queue.put(blocks.slice_block(block, 0, 30))
    ssc._queue.put(blocks.slice_block(block, 30, 100))
    assert ssc._queue.rows_queued == 100
    first = ssc._drain(64)
    assert [b.rows for b in first] == [30, 34] and ssc._queue.rows_queued == 36
    assert_blocks_equal(blocks.merge_blocks(first), blocks.slice_block(block, 0, 64))
    ssc._putback(first)
    assert ssc._queue.rows_queued == 100
    rest = ssc._drain(0)
    assert_blocks_equal(blocks.merge_blocks(rest), blocks.slice_block(block, 0, 100))


def test_fault_injection_counts_block_rows():
    block = blocks.merge_blocks(_parsed(FIXTURE, True))  # 6 rows
    inner = QueueSource()
    for _ in range(4):
        inner.push(block)
    inner.close()
    src = faults.FaultInjectingSource(inner, crash_every=10, max_crashes=1)
    got = []
    with pytest.raises(faults.InjectedFault, match="after 12 tweets"):
        for item in src.produce():
            got.append(item)
    assert len(got) == 1


def test_source_garbage_damages_block_bytes_and_the_parser_counts_it(seeded_file):
    metrics.reset_for_tests()
    faults.install_chaos("source.garbage@1")
    try:
        got = blocks.merge_blocks(list(BlockReplayFileSource(seeded_file).produce()))
    finally:
        faults.uninstall_chaos()
    clean = blocks.merge_blocks(list(BlockReplayFileSource(seeded_file).produce()))
    assert got.rows < clean.rows
    assert metrics.get_registry().counter("ingest.rows_dropped_parse").value > 0


def test_lineage_counts_a_block_batch_by_its_rows():
    block = blocks.merge_blocks(_parsed(FIXTURE, True))
    assert lineage._event_span([block]) == (int(block.numeric[:, 4].min()),
                                            int(block.numeric[:, 4].max()))


def test_the_live_block_source_parses_stream_lines_into_blocks():
    lines = open(FIXTURE, encoding="utf-8").read().splitlines() + [""]
    src = BlockTwitterSource({}, connect_fn=lambda: iter(lines), block_bytes=1 << 30,
                             flush_seconds=3600, wire=True)
    got = blocks.merge_blocks(list(src.produce()))
    assert_blocks_equal(got, blocks.merge_blocks(_parsed(FIXTURE, True)))


# ---- the source rules -----------------------------------------------------------------

SOURCE_RULES = [
    (["--ingest", "block", "--source", "synthetic"], True),
    (["--ingest", "block", "--source", "replay", "--replayFile", FIXTURE, "--hashOn", "host",
      "--wire", "padded"], True),
    (["--ingest", "block", "--source", "replay", "--replayFile", FIXTURE,
      "--replaySpeed", "2"], True),
    (["--ingest", "block", "--source", "replay"], True),
    (["--ingest", "block", "--source", "replay", "--replayFile", FIXTURE], False),
    (["--ingest", "block", "--source", "replay", "--replayFile", FIXTURE, "--seconds", "0",
      "--wire", "ragged", "--hashOn", "host"], True),
]


def _exit_text(fn):
    try:
        fn()
    except SystemExit as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("argv,allow", SOURCE_RULES, ids=lambda v: " ".join(v)
                         if isinstance(v, list) else str(v))
def test_source_rules_exit_as_in_the_jax_package(argv, allow, monkeypatch):
    from twtml_tpu.apps import common as jax_common

    got = _exit_text(lambda: common.build_source(ConfArguments().parse(argv), allow_block=allow))
    want = _exit_text(lambda: jax_common.build_source(JaxConf().parse(argv), allow_block=allow))
    assert got == want
    if not allow:
        assert "not wired for this entry point" in got


@pytest.mark.parametrize("argv,wire", [
    (["--seconds", "0"], True), (["--seconds", "5"], False),
    (["--seconds", "5", "--blockWire", "on"], True), (["--seconds", "0", "--blockWire", "off"],
                                                      False)])
def test_the_block_source_takes_the_wire_emitter_by_the_jax_rule(argv, wire):
    argv = ["--ingest", "block", "--source", "replay", "--replayFile", FIXTURE, *argv]
    conf = ConfArguments().parse(argv)
    assert conf.effective_block_wire() == JaxConf().parse(argv).effective_block_wire() == wire
    src = common.build_source(conf, allow_block=True)
    assert isinstance(src, BlockReplayFileSource) and src.wire == wire
    assert (src.begin, src.end) == (100, 1000)
    kmeans_src = common.build_source(conf, allow_block=True, block_interval=(0, 2**62))
    assert (kmeans_src.begin, kmeans_src.end) == (0, 2**62)


# ---- the apps -------------------------------------------------------------------------

def _lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("count:")]


def _both(port_app, jax_app, argv, monkeypatch, capsys):
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    lineage.reset_for_tests()  # the FIFOs outlive a run (ROADMAP C)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_app.run(ConfArguments().parse(["--backend", "cpu", *argv]))
    jax.devices()
    capsys.readouterr()
    jax_app.run(JaxConf().parse(argv))
    return _lines(out.getvalue()), _lines(capsys.readouterr().out)


APP_ARGV = ["--source", "replay", "--replayFile", FIXTURE, "--seconds", "0",
            "--batchBucket", "4", "--ingest", "block", *QUIET]


@pytest.mark.parametrize("extra", [[], ["--wireCodec", "dict"], ["--blockWire", "off"],
                                   ["--wireCodec", "dict", "--superBatch", "2",
                                    "--tokenBucket", "256"]],
                         ids=["block", "block-codec", "legacy-parser", "codec-superbatch"])
def test_the_linear_app_prints_the_jax_apps_lines(extra, monkeypatch, capsys, tmp_path):
    monkeypatch.chdir(tmp_path)
    argv = [a if a != FIXTURE else os.path.join(os.path.dirname(__file__), "data",
                                                  "tweets.jsonl") for a in APP_ARGV] + extra
    ours, theirs = _both(port_linear, jax_linear, argv, monkeypatch, capsys)
    assert ours == theirs and len(ours) == 2 and ours[-1].startswith("count: 6 ")


def test_the_logistic_app_prints_the_jax_apps_lines(monkeypatch, capsys):
    ours, theirs = _both(port_logistic, jax_logistic, APP_ARGV, monkeypatch, capsys)
    assert ours == theirs and len(ours) == 2 and "errRate" in ours[0]


def test_the_kmeans_app_prints_the_jax_apps_lines(monkeypatch, capsys):
    argv = ["--source", "replay", "--replayFile", FIXTURE, "--seconds", "0",
            "--ingest", "block", *QUIET]
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    lineage.reset_for_tests()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_kmeans.run(ConfArguments().parse(["--backend", "cpu", *argv]), wall_clock=False)
    jax.devices()
    capsys.readouterr()
    jax_kmeans.run(JaxConf().parse(argv), wall_clock=False)
    ours, theirs = _lines(out.getvalue()), _lines(capsys.readouterr().out)
    assert ours == theirs and ours and ours[0].startswith("count: 8 ")


def test_a_padded_block_stream_trains_as_the_jax_app(monkeypatch, capsys):
    """``--seconds 0 --wire padded``: the legacy parser (``--blockWire``
    auto follows the wire) and the padded units batch."""
    argv = [*APP_ARGV, "--wire", "padded"]
    ours, theirs = _both(port_linear, jax_linear, argv, monkeypatch, capsys)
    assert ours == theirs and len(ours) == 2


def test_queue_rows_count_block_rows():
    q = _RowCountQueue()
    block = blocks.merge_blocks(_parsed(FIXTURE, True))
    q.put(block)
    q.putback(blocks.slice_block(block, 0, 2))
    assert q.rows_queued == block.rows + 2
