"""The port's host featurizer against the JAX package's: the padded units
wire must be array-equal (values and dtypes), and the hashing ground truth
must be the same function."""

import numpy as np
import pytest

from twtml_tpu.features import hashing as jax_hashing
from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.features.featurizer import Status as JaxStatus
from twtml_tpu.streaming.sources import ReplayFileSource as JaxReplay
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic

from twtml_tpu_torch.features import hashing
from twtml_tpu_torch.features.featurizer import Featurizer, Status
from twtml_tpu_torch.streaming.sources import ReplayFileSource, SyntheticSource

FIXTURE = "tests/data/tweets.jsonl"
NOW_MS = 1_700_000_000_000


def assert_batches_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def both_featurizers(**kw):
    return Featurizer(now_ms=NOW_MS, **kw), JaxFeaturizer(now_ms=NOW_MS, **kw)


@pytest.mark.parametrize("row_bucket", [0, 4, 16])
def test_replay_fixture_units_batches_equal(row_bucket):
    ours, ref = both_featurizers()
    statuses = list(ReplayFileSource(FIXTURE))
    ref_statuses = list(JaxReplay(FIXTURE).produce())
    assert statuses == [Status(**vars_of(s)) for s in ref_statuses]
    for lo in range(0, len(statuses), 4):
        assert_batches_equal(
            ours.featurize_batch_units(statuses[lo:lo + 4], row_bucket=row_bucket),
            ref.featurize_batch_units(ref_statuses[lo:lo + 4], row_bucket=row_bucket),
        )


def vars_of(status):
    """A JAX Status as keyword arguments for the port's (nested too)."""
    out = {f: getattr(status, f) for f in JaxStatus.__dataclass_fields__}
    if out["retweeted_status"] is not None:
        out["retweeted_status"] = Status(**vars_of(out["retweeted_status"]))
    return out


@pytest.mark.parametrize("seed,n", [(3, 256), (7, 100)])
def test_synthetic_batches_equal(seed, n):
    ours, ref = both_featurizers()
    statuses = list(SyntheticSource(total=n, seed=seed, base_ms=NOW_MS))
    ref_statuses = list(JaxSynthetic(total=n, seed=seed, base_ms=NOW_MS).produce())
    assert statuses == [Status(**vars_of(s)) for s in ref_statuses]
    assert_batches_equal(
        ours.featurize_batch_units(statuses, row_bucket=n),
        ref.featurize_batch_units(ref_statuses, row_bucket=n),
    )


def test_non_ascii_batch_equal():
    texts = [
        "Ce CAFÉ est incroyable ☕😀",
        "ASCII Only Text",
        "ΣΊΣΥΦΟΣ and İstanbul",
        "x",
        "",
        "emoji 🚀🚀 rocket \ud800 lone",
    ]
    statuses = [
        Status(text="RT", retweeted_status=Status(
            text=t, retweet_count=100 + 50 * i, followers_count=10 * i,
            favourites_count=i, friends_count=3 * i, created_at_ms=NOW_MS - i,
        ))
        for i, t in enumerate(texts)
    ]
    ref_statuses = [
        JaxStatus(text="RT", retweeted_status=JaxStatus(**{
            k: v for k, v in vars_of(s.retweeted_status).items()
        }))
        for s in statuses
    ]
    ours, ref = both_featurizers()
    got = ours.featurize_batch_units(statuses)
    assert got.units.dtype == np.uint16
    assert_batches_equal(got, ref.featurize_batch_units(ref_statuses))
    np.testing.assert_array_equal(
        ours.featurize_numbers(statuses[2]), ref.featurize_numbers(ref_statuses[2])
    )


def test_filter_matches():
    ours, ref = both_featurizers(num_retweet_begin=200, num_retweet_end=600)
    statuses = list(ReplayFileSource(FIXTURE))
    ref_statuses = list(JaxReplay(FIXTURE).produce())
    assert [ours.filtrate(s) for s in statuses] == [
        ref.filtrate(s) for s in ref_statuses
    ]
    assert_batches_equal(
        ours.featurize_batch_units(statuses),
        ref.featurize_batch_units(ref_statuses),
    )


@pytest.mark.parametrize("text", [
    "", "a", "ab", "hello world", "Ce café ☕😀", "\ud83d", "mixed ΣΊΣΥΦΟΣ 🚀",
])
def test_hashing_ground_truth_equal(text):
    assert hashing.utf16_units(text) == jax_hashing.utf16_units(text)
    assert hashing.char_bigrams(text) == jax_hashing.char_bigrams(text)
    assert hashing.java_string_hashcode(text) == jax_hashing.java_string_hashcode(text)
    for f in (1000, 2**18):
        assert hashing.hashing_tf_counts(hashing.char_bigrams(text), f) == (
            jax_hashing.hashing_tf_counts(jax_hashing.char_bigrams(text), f)
        )
