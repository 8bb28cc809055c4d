"""Host hashing (``--hashOn host``) in the port against the JAX package:
``Featurizer.featurize_batch`` (``native/fasthash.cpp`` through the port's
own native library, and the Python per-tweet fallback) bitwise equal to
the JAX package's in every field, on both packages' native and Python
paths; the step on a host-hashed ``FeatureBatch`` equal to the device-hash
step; the app's ``--hashOn host`` lines equal to the JAX app's and to the
port's own ``--hashOn device`` lines; ``--wire ragged`` with host hashing
refused as in the JAX package."""

import contextlib
import io
import os
import shutil
import subprocess
import warnings

import jax
import numpy as np
import pytest
import torch

from twtml_tpu.apps import linear_regression as jax_app
from twtml_tpu.config import ConfArguments as JaxConf
from twtml_tpu.features import native as jax_native
from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.features.featurizer import Status as JaxStatus
from twtml_tpu.streaming.sources import ReplayFileSource as JaxReplay
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic
from twtml_tpu_torch.apps import linear_regression as app
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features import native
from twtml_tpu_torch.features.batch import FeatureBatch, compact_tokens, pad_feature_batch
from twtml_tpu_torch.features.featurizer import Featurizer, Status
from twtml_tpu_torch.models.sgd import batch_to_device, make_sgd_train_step, zero_weights
from twtml_tpu_torch.streaming.context import FeatureStream
from twtml_tpu_torch.streaming.sources import ReplayFileSource, SyntheticSource

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "tweets.jsonl")
NOW_MS = 1_700_000_000_000
QUIET = ["--twtweb", "http://127.0.0.1:9", "--lightning", "http://127.0.0.1:9",
         "--blackbox", "off"]


@pytest.fixture
def port_native():
    if shutil.which("g++") is None:
        pytest.skip("g++ not on PATH: the native host path cannot be built")
    assert native.hash_available(), "the native library did not build or lacks fasthash_batch"


def pair(text, count=500, **extra):
    fields = dict(followers_count=1234, favourites_count=77, friends_count=450,
                  created_at_ms=NOW_MS - 86_400_000)
    fields.update(extra)
    return (Status(text="RT", retweet_count=1,
                   retweeted_status=Status(text=text, retweet_count=count, **fields)),
            JaxStatus(text="RT", retweet_count=1,
                      retweeted_status=JaxStatus(text=text, retweet_count=count, **fields)))


def corpus(*pairs):
    return [p for p, _ in pairs], [j for _, j in pairs]


def unicode_corpus():
    return corpus(
        pair("plain ascii tweet with CAPS and a link https://t.co/x"),
        pair("astral emoji \U0001f98a pair rides two UTF-16 units"),
        pair("lone surrogate \ud83e stays a unit like the JVM"),
        pair("İstanbul lowercases to MORE units (i + combining dot)"),
        pair("café naïve résumé — accents ΣΊΣΥΦΟΣ"),
        pair(""), pair("x"), pair("boundary low", count=100), pair("boundary high", count=1000),
        pair("dropped: below interval", count=99), pair("dropped: above interval", count=1001),
        pair("big numbers", followers_count=2**40, favourites_count=10**15, created_at_ms=0),
        (Status(text="not a retweet"), JaxStatus(text="not a retweet")),
    )


SOURCES = {
    "replay": lambda: (list(ReplayFileSource(FIXTURE).produce()),
                       list(JaxReplay(FIXTURE).produce())),
    "synthetic": lambda: (list(SyntheticSource(total=300, seed=3, base_ms=NOW_MS).produce()),
                          list(JaxSynthetic(total=300, seed=3, base_ms=NOW_MS).produce())),
    "unicode": unicode_corpus,
    "empty": lambda: ([], []),
    # one bigram 39,999 times: a count past int16, exact in uint16
    "repeated": lambda: corpus(pair("a" * 40_000), pair("ab" * 50)),
}
BUCKETS = [(0, 0), (16, 0), (512, 64), (3, 8)]


@contextlib.contextmanager
def paths(port: str, ref: str):
    """Run the port's and the JAX package's featurize_batch on their native
    ("native") or Python ("python") path."""
    with pytest.MonkeyPatch.context() as mp:
        if port == "python":
            mp.setattr(native, "hash_available", lambda: False)
        if ref == "python":
            mp.setattr(jax_native, "available", lambda: False)
        yield


def assert_batches_equal(got, want):
    assert type(got).__name__ == type(want).__name__ == "FeatureBatch"
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def dense(batch, f=1000):
    """A FeatureBatch's text counts as a dense [B, f] float64 matrix."""
    out = np.zeros((batch.mask.shape[0], f))
    rows = np.repeat(np.arange(out.shape[0]), batch.token_idx.shape[1])
    np.add.at(out, (rows, batch.token_idx.astype(np.int64).ravel()),
              batch.token_val.astype(np.float64).ravel())
    return out


def assert_same_features(got, want):
    """The same features, whatever the token bucket: the native path sizes
    it from the rows' units, the Python path from their distinct terms (in
    both packages), so the padding width may differ between the paths."""
    for name in ("numeric", "label", "mask"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes(), name
    assert (got.token_idx.dtype, got.token_val.dtype) == (want.token_idx.dtype,
                                                          want.token_val.dtype)
    np.testing.assert_array_equal(dense(got), dense(want))


@pytest.mark.parametrize("port_path,ref_path", [("native", "native"), ("python", "python"),
                                                 ("native", "python"), ("python", "native")])
@pytest.mark.parametrize("rows,tokens", BUCKETS)
@pytest.mark.parametrize("source", sorted(SOURCES))
def test_featurize_batch_is_bitwise_the_jax_packages(port_native, source, rows, tokens,
                                                     port_path, ref_path):
    ours, theirs = SOURCES[source]()
    native.reset_counters()
    with paths(port_path, ref_path):
        got = Featurizer(now_ms=NOW_MS).featurize_batch(ours, row_bucket=rows, token_bucket=tokens)
        want = JaxFeaturizer(now_ms=NOW_MS).featurize_batch(
            theirs, row_bucket=rows, token_bucket=tokens)
    if port_path == ref_path:
        assert_batches_equal(got, want)
    else:
        assert_same_features(got, want)
    assert native.HASH_COUNTERS == {"hashes_native": int(port_path == "native"),
                                    "hashes_degraded": int(port_path == "python")}


def test_a_row_past_the_c_table_takes_the_python_path_in_both(port_native):
    """More than the C hasher's 1024 distinct terms in one row (numTextFeatures
    4096): both packages' native calls refuse and the Python path runs."""
    rng = np.random.default_rng(11)
    text = "".join(map(chr, rng.integers(0x4E00, 0x9FFF, size=1500)))
    ours, theirs = corpus(pair(text), pair("short"))
    native.reset_counters()
    got = Featurizer(num_text_features=4096, now_ms=NOW_MS).featurize_batch(ours)
    want = JaxFeaturizer(num_text_features=4096, now_ms=NOW_MS).featurize_batch(theirs)
    assert_batches_equal(got, want)
    assert native.HASH_COUNTERS == {"hashes_native": 0, "hashes_degraded": 1}


def test_sub_stages_name_the_path(port_native):
    sts, _ = SOURCES["synthetic"]()
    f = Featurizer(now_ms=NOW_MS)
    f.featurize_batch(sts)
    assert [name for name, _, _ in f.last_substages] == ["encode", "hash", "numeric"]
    with paths("python", "native"):
        f.featurize_batch(sts)
    assert [name for name, _, _ in f.last_substages] == ["python"]


@pytest.mark.parametrize("counts", [True, False])
def test_compact_tokens_and_padding_equal_the_jax_packages(counts):
    from twtml_tpu.features.batch import compact_tokens as jax_compact
    from twtml_tpu.features.batch import pad_feature_batch as jax_pad

    rng = np.random.default_rng(4)
    rows = [({int(i): float(rng.integers(1, 5)) for i in rng.integers(0, 1000, size=k)},
             rng.random(4).astype(np.float32), float(rng.integers(100, 1000)))
            for k in (3, 17, 0, 40)]
    got = pad_feature_batch(rows, row_bucket=8, num_features=1000, counts=counts)
    want = jax_pad(rows, row_bucket=8, num_features=1000, counts=counts)
    assert_batches_equal(got, want)
    idx, val = got.token_idx.astype(np.int32), got.token_val.astype(np.float32)
    for a, b in zip(compact_tokens(idx, val, 1000, counts=counts),
                    jax_compact(idx, val, 1000, counts=counts)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        compact_tokens(idx + 1000, val, 1000)
    with pytest.raises(ValueError):
        compact_tokens(idx, val + 0.5, 1000, counts=True)


def test_a_stale_library_without_the_hasher_warns_once_and_degrades(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("g++ not on PATH: the native host path cannot be built")
    src = tmp_path / "stale.cpp"
    src.write_text('extern "C" int stale_entry() { return 0; }\n')
    so = tmp_path / "stale.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(so), str(src)], check=True,
                   capture_output=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the wire path's entries are missing too
        lib = native.NativeLibrary(so)
    assert lib.fasthash_batch is None
    monkeypatch.setattr(native, "get_lib", lambda: lib)
    monkeypatch.setattr(native, "_warned_no_hash", [])
    sts, theirs = SOURCES["synthetic"]()
    with pytest.warns(RuntimeWarning, match="lacks fasthash_batch") as record:
        got = Featurizer(now_ms=NOW_MS).featurize_batch(sts)
        Featurizer(now_ms=NOW_MS).featurize_batch(sts)
    assert len(record) == 1
    with paths("native", "python"):
        assert_batches_equal(got, JaxFeaturizer(now_ms=NOW_MS).featurize_batch(theirs))


def step(batch, weights):
    train = make_sgd_train_step(num_text_features=1000, num_iterations=50, step_size=0.005,
                                quality=True)
    return train(weights, batch_to_device(batch, "cpu"))


@pytest.mark.parametrize("source", ["synthetic", "replay", "unicode"])
def test_the_step_on_host_tokens_equals_the_device_hash_step(port_native, source):
    """The same rows as a host-hashed FeatureBatch and as a padded
    UnitBatch: the densified design matrix is the same, so weights,
    predictions, stats and quality are bitwise equal over 3 steps."""
    sts, _ = SOURCES[source]()
    f = Featurizer(now_ms=NOW_MS)
    host = f.featurize_batch(sts, row_bucket=512)
    units = f.featurize_batch_units(sts, row_bucket=512)
    w_host = w_units = zero_weights(1000, device="cpu")
    for _ in range(3):
        w_host, out_host = step(host, w_host)
        w_units, out_units = step(units, w_units)
        bitwise = dict(rtol=0, atol=0, equal_nan=True)  # the unicode rows diverge to NaN
        torch.testing.assert_close(w_host, w_units, **bitwise)
        for k in ("predictions", "quality", "count", "mse", "real_stdev", "pred_stdev"):
            torch.testing.assert_close(getattr(out_host, k), getattr(out_units, k), **bitwise)


def test_counts_past_int16_reach_the_device_as_counts():
    # 40960 = 5 << 13: past int16, and exact in the kernel's bf16 design matrix
    batch = FeatureBatch(np.array([[3, 0]], np.int16), np.array([[40_960, 0]], np.uint16),
                         np.zeros((1, 4), np.float32), np.ones(1, np.float32),
                         np.ones(1, np.float32))
    dev = batch_to_device(batch, "cpu")
    assert dev.token_val.dtype == torch.int16  # the wire's bits
    train = make_sgd_train_step(num_text_features=8, num_iterations=0, step_size=0.005)
    w = torch.zeros(12)
    w[3] = 1.0
    _, out = train(w, dev)
    assert float(out.predictions[0]) == 40_960.0


def app_lines(pkg: str, argv) -> list:
    out = io.StringIO()
    if pkg == "port":
        with contextlib.redirect_stdout(out):
            app.run(ConfArguments().parse([*argv, "--backend", "cpu", *QUIET]), max_batches=3)
    else:
        jax.devices()
        with contextlib.redirect_stdout(out):
            jax_app.run(JaxConf().parse([*argv, "--master", "local[1]", *QUIET]), max_batches=3)
    return [ln for ln in out.getvalue().splitlines() if ln.startswith("count:")]


@pytest.mark.parametrize("argv", [
    ["--source", "replay", "--replayFile", FIXTURE, "--seconds", "0", "--batchBucket", "4"],
    ["--source", "synthetic", "--seconds", "0", "--batchBucket", "64"],
], ids=["replay", "synthetic"])
def test_the_apps_host_hash_lines_equal_the_jax_apps_and_device_hashings(monkeypatch, argv):
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    ours = app_lines("port", [*argv, "--hashOn", "host"])
    theirs = app_lines("jax", [*argv, "--hashOn", "host"])
    device = app_lines("port", [*argv, "--hashOn", "device"])
    assert ours == theirs == device and len(ours) == 3


@pytest.mark.parametrize("seconds", ["0", "5"])
def test_host_hashing_resolves_the_wire_to_padded_as_in_the_jax_package(seconds):
    argv = ["--hashOn", "host", "--seconds", seconds]
    assert ConfArguments().parse(argv).effective_wire() == "padded"
    assert JaxConf().parse(argv).effective_wire() == "padded"


def test_ragged_with_host_hashing_is_refused_as_in_the_jax_package(monkeypatch):
    argv = ["--source", "replay", "--replayFile", FIXTURE, "--seconds", "0", "--hashOn", "host",
            "--wire", "ragged"]
    with pytest.raises(SystemExit) as ours:
        app.run(ConfArguments().parse([*argv, "--backend", "cpu", *QUIET]))
    jax.devices()
    with pytest.raises(SystemExit) as theirs:
        jax_app.run(JaxConf().parse([*argv, "--master", "local[1]", *QUIET]))
    assert str(ours.value) == str(theirs.value)
    assert "requires --hashOn device" in str(ours.value)
    with pytest.raises(ValueError, match="requires --hashOn device"):
        FeatureStream(Featurizer(), ragged=True, device_hash=False)
