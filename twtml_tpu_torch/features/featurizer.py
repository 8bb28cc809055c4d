"""Tweet filter + padded units-wire batch assembly (counterpart of a subset of
``twtml_tpu/features/featurizer.py``; reference: MllibHelper.scala:11-96).

Semantics kept from the JAX package:
- filter: only retweets whose original's retweetCount lies in
  [numRetweetBegin, numRetweetEnd] pass;
- text: the *original* tweet's text, lowercased, shipped as UTF-16 code
  units; the device hashes its character bigrams (ops/text_hash.py);
- numeric features: followers/favourites/friends scaled by 1e-12 and tweet
  age in milliseconds scaled by 1e-14;
- label: the original tweet's retweetCount, unless the featurizer's
  ``label_fn`` (one status) or ``batch_label_fn`` (a batch, the hot path;
  it wins) gives it: the logistic app's sentiment labels
  (features/sentiment.py). Every featurize path honours both.

Three batch assemblers, byte-equal to the JAX package's of the same name: the
units wires ``featurize_batch_units`` (padded, numpy) and
``featurize_batch_ragged`` (ragged, filled by one native C pass when it
loads, else by numpy, and optionally packed into one buffer), and the host
hashing of ``--hashOn host``, ``featurize_batch`` (a padded ``FeatureBatch``
of hashed bigram counts from ``native/fasthash.cpp``; the Python per-tweet
hasher of ``features/hashing.py`` is its fallback, byte-equal to the JAX
package's Python path: the same features, with the token bucket sized by
the rows' distinct terms where the native path sizes it by their units).
"""

from __future__ import annotations

import datetime
import functools
import inspect
import itertools
import operator
import os
import time
from dataclasses import dataclass, field
from email.utils import parsedate_to_datetime
from typing import Any, Callable

import numpy as np

from . import featurize_native
from .batch import (
    NUM_NUMBER_FEATURES,
    FeatureBatch,
    PackedBatch,
    RaggedUnitBatch,
    UnitBatch,
    _bucket,
    compact_tokens,
    pack_batch,
    pad_feature_batch,
    pad_row_count,
    ragged_wire_arrays,
)
from .hashing import char_bigrams, hashing_tf_counts

_NUMERIC_COLS = operator.attrgetter(
    "followers_count", "favourites_count", "friends_count",
    "created_at_ms", "retweet_count",
)

# hand-scaling constants of the reference (MllibHelper.scala:64-67)
COUNT_SCALE = 1e-12  # followers / favourites / friends
AGE_SCALE = 1e-14  # tweet age in milliseconds


def _parse_created_at_ms(value: Any) -> int:
    """Twitter timestamps: epoch ms int, ``timestamp_ms`` string, or the
    classic ``Wed Aug 27 13:08:45 +0000 2008`` format; unparsable is 0."""
    if value is None:
        return 0
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value)
    if s.isdigit():
        return int(s)
    try:
        dt = datetime.datetime.strptime(s, "%a %b %d %H:%M:%S %z %Y")
        return int(dt.timestamp() * 1000)
    except ValueError:
        try:
            return int(parsedate_to_datetime(s).timestamp() * 1000)
        except (TypeError, ValueError):
            return 0


def encode_texts(texts: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """One-pass UTF-16-LE encode of a batch: (units uint16, offsets int64).
    One join and one encode; per-text unit counts split the joined buffer
    (one unit per char unless a text holds astral characters)."""
    joined = "".join(texts)
    units = np.frombuffer(
        joined.encode("utf-16-le", "surrogatepass"), dtype=np.uint16
    )
    offsets = np.zeros(len(texts) + 1, dtype=np.int64)
    if units.size == len(joined):
        counts = [len(t) for t in texts]
    else:
        counts = [
            len(t) if t.isascii()
            else len(t.encode("utf-16-le", "surrogatepass")) >> 1
            for t in texts
        ]
    np.cumsum(counts, out=offsets[1:])
    if units.size == 0:
        units = np.zeros(1, dtype=np.uint16)
    return units, offsets


def _pad_ragged_units(
    units: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    n: int,
    b: int,
    lu: int,
    narrow: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Ragged UTF-16 units -> ([b, lu] buffer, [b] int32 lengths) with ASCII
    case folded. ``narrow`` ships the buffer as uint8, for batches whose
    rows are all ASCII."""
    buf = np.zeros((b, lu), dtype=np.uint16)
    length = np.zeros((b,), dtype=np.int32)
    if n:
        cols = np.arange(lu, dtype=np.int64)[None, :]
        valid = cols < lengths[:, None]
        pos = offsets[:-1, None] + cols
        buf[:n][valid] = units[pos[valid]]
        length[:n] = lengths
        upper = (buf >= 65) & (buf <= 90)
        buf[upper] += 32
    if narrow:
        buf = buf.astype(np.uint8)
    return buf, length


@functools.lru_cache(maxsize=16)
def _accepts_encoded(fn) -> bool:
    """Whether a batch labeler takes the featurizer's encoded texts
    (an ``encoded`` keyword)."""
    try:
        return "encoded" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


@dataclass(slots=True)
class Status:
    """Minimal tweet model: the Twitter4j Status surface the reference reads."""

    text: str = ""
    retweet_count: int = 0
    followers_count: int = 0
    favourites_count: int = 0
    friends_count: int = 0
    created_at_ms: int = 0
    retweeted_status: "Status | None" = None
    lang: str = ""
    id: int = 0

    @property
    def is_retweet(self) -> bool:
        return self.retweeted_status is not None

    @classmethod
    def from_json(cls, obj: dict[str, Any]) -> "Status":
        """Parse a (standard-API) tweet JSON object, including the nested
        ``retweeted_status``."""
        user = obj.get("user") or {}
        rs = obj.get("retweeted_status")
        return cls(
            text=obj.get("text") or obj.get("full_text") or "",
            retweet_count=int(obj.get("retweet_count") or 0),
            followers_count=int(user.get("followers_count") or 0),
            favourites_count=int(user.get("favourites_count") or 0),
            friends_count=int(user.get("friends_count") or 0),
            created_at_ms=_parse_created_at_ms(
                obj.get("timestamp_ms") or obj.get("created_at")
            ),
            retweeted_status=cls.from_json(rs) if rs else None,
            lang=obj.get("lang") or "",
            id=int(obj.get("id") or 0),
        )


@dataclass
class Featurizer:
    """Configured featurizer for the padded and ragged units wires.
    ``last_substages`` holds the last batch's (name, start, seconds) spans."""

    num_text_features: int = 1000  # MllibHelper.scala:17
    num_retweet_begin: int = 100  # MllibHelper.scala:15
    num_retweet_end: int = 1000  # MllibHelper.scala:16
    now_ms: int | None = None  # fixed clock for deterministic replay; None=wall
    label_fn: "Callable[[Status], float] | None" = None  # default: retweetCount
    # batched form of label_fn (same labels, one call a batch): the hot path
    batch_label_fn: "Callable[[list[Status]], np.ndarray] | None" = None
    num_number_features: int = field(default=NUM_NUMBER_FEATURES, init=False)
    last_substages: list = field(
        default_factory=list, init=False, repr=False, compare=False
    )

    @classmethod
    def from_conf(cls, conf) -> "Featurizer":
        """``TWTML_NOW_MS`` (env) pins the age-feature clock, the same
        deterministic-replay seam as the JAX package's featurizer."""
        now_env = os.environ.get("TWTML_NOW_MS", "")
        return cls(
            num_text_features=conf.numTextFeatures,
            num_retweet_begin=conf.numRetweetBegin,
            num_retweet_end=conf.numRetweetEnd,
            now_ms=int(now_env) if now_env else None,
        )

    @property
    def num_features(self) -> int:
        return self.num_text_features + self.num_number_features

    def _now(self) -> int:
        return self.now_ms if self.now_ms is not None else int(time.time() * 1000)

    # -- filter (MllibHelper.scala:84-95) -----------------------------------
    def retweet_interval(self, status: Status) -> bool:
        n = status.retweeted_status.retweet_count
        return self.num_retweet_begin <= n <= self.num_retweet_end

    def filtrate(self, status: Status) -> bool:
        return status.is_retweet and self.retweet_interval(status)

    # -- features (MllibHelper.scala:58-82) ----------------------------------
    def featurize_numbers(self, status: Status) -> np.ndarray:
        original = status.retweeted_status
        time_left = self._now() - original.created_at_ms
        return np.array(
            [
                original.followers_count * COUNT_SCALE,
                original.favourites_count * COUNT_SCALE,
                original.friends_count * COUNT_SCALE,
                time_left * AGE_SCALE,
            ],
            dtype=np.float32,
        )

    def featurize_text(self, status: Status) -> dict[int, float]:
        """The original's lowercased text as hashed bigram counts."""
        text = status.retweeted_status.text.lower()
        return hashing_tf_counts(char_bigrams(text), self.num_text_features)

    def featurize(self, status: Status) -> tuple[dict[int, float], np.ndarray, float]:
        """One tweet's text counts, numeric features and label
        (``label_fn``'s when set)."""
        label = (float(status.retweeted_status.retweet_count) if self.label_fn is None
                 else float(self.label_fn(status)))
        return (self.featurize_text(status), self.featurize_numbers(status), label)

    def _apply_label_fns(self, label: np.ndarray, keep: list, encoded=None) -> bool:
        """Write a configured labeler's labels over ``label[:n]``:
        ``batch_label_fn`` (given ``encoded``, the batch's (units, offsets)
        of the originals' texts, when it takes them), else ``label_fn``
        row by row. False when neither is set (the label stays the retweet
        count the caller filled)."""
        n = len(keep)
        if self.batch_label_fn is not None:
            if encoded is not None and _accepts_encoded(self.batch_label_fn):
                label[:n] = self.batch_label_fn(keep, encoded=encoded)
            else:
                label[:n] = self.batch_label_fn(keep)
            return True
        if self.label_fn is not None:
            label[:n] = [self.label_fn(s) for s in keep]
            return True
        return False

    def featurize_batch(self, statuses: list[Status], row_bucket: int = 0,
                        token_bucket: int = 0) -> FeatureBatch:
        """Filter + hash + pad a micro-batch on the host (``--hashOn
        host``): the bigram counts are hashed by ``native/fasthash.cpp``
        into the padded buffers, the numeric and label columns assembled
        vectorized; the Python per-tweet path is the fallback (the same
        features; its token bucket follows the distinct terms). Sub-stages:
        ``encode``, ``hash`` and ``numeric`` (native), or ``python``."""
        from . import native

        self.last_substages = []
        t0 = time.perf_counter()
        keep = [s for s in statuses if self.filtrate(s)]
        fast = self._featurize_batch_native(keep, row_bucket, token_bucket, t0)
        if fast is not None:
            native.HASH_COUNTERS["hashes_native"] += 1
            return fast
        native.HASH_COUNTERS["hashes_degraded"] += 1
        self.last_substages = []
        if self.batch_label_fn is not None:
            rows = [(self.featurize_text(s), self.featurize_numbers(s), float(lab))
                    for s, lab in zip(keep, self.batch_label_fn(keep))]
        else:
            rows = [self.featurize(s) for s in keep]
        batch = pad_feature_batch(
            rows, row_bucket=row_bucket,
            token_bucket=token_bucket, num_features=self.num_text_features, counts=True,
        )
        self._sub("python", t0)
        return batch

    def _featurize_batch_native(self, keep: list[Status], row_bucket: int,
                                token_bucket: int, t0: float) -> FeatureBatch | None:
        from . import native

        if not native.hash_available():
            return None
        n = len(keep)
        originals = [s.retweeted_status for s in keep]
        texts = [o.text.lower() for o in originals]
        units, offsets = encode_texts(texts)
        t0 = self._sub("encode", t0)
        # distinct bigrams of a text never exceed its UTF-16 units - 1, so
        # this token bucket overflows only past the C table's 1024 terms
        max_tok = int(np.maximum(np.diff(offsets) - 1, 1).max()) if n else 1
        b = pad_row_count(n, row_bucket)
        lt = token_bucket if token_bucket >= max_tok and token_bucket > 0 else _bucket(max_tok)
        token_idx = np.zeros((b, lt), dtype=np.int32)
        token_val = np.zeros((b, lt), dtype=np.float32)
        if native.hash_texts(units, offsets, n, self.num_text_features,
                             token_idx, token_val) is None:
            return None
        token_idx, token_val = compact_tokens(
            token_idx, token_val, self.num_text_features, counts=True, validate=False)
        t0 = self._sub("hash", t0)
        numeric, label, mask = self._numeric_label_mask(
            originals, b, keep=keep, encoded=(units, offsets))
        self._sub("numeric", t0)
        return FeatureBatch(token_idx, token_val, numeric, label, mask)

    def _numeric_label_mask(self, originals, b: int, cols=None, keep=None, encoded=None):
        """Padded numeric/label/mask columns. ``cols``: the float64 [n, 5]
        columns already gathered by ``_gather_rows``; None gathers them from
        ``originals``. ``keep`` (the kept statuses) and ``encoded`` feed a
        configured labeler (``_apply_label_fns``)."""
        n = len(originals)
        numeric = np.zeros((b, NUM_NUMBER_FEATURES), dtype=np.float32)
        label = np.zeros((b,), dtype=np.float32)
        mask = np.zeros((b,), dtype=np.float32)
        if not n:
            return numeric, label, mask
        if cols is None:
            cols = np.fromiter(
                itertools.chain.from_iterable(map(_NUMERIC_COLS, originals)),
                np.float64, n * 5,
            ).reshape(n, 5)
        numeric[:n, :3] = cols[:, :3] * COUNT_SCALE
        numeric[:n, 3] = (self._now() - cols[:, 3]) * AGE_SCALE
        if keep is None or not self._apply_label_fns(label, keep, encoded):
            label[:n] = cols[:, 4]
        mask[:n] = 1.0
        return numeric, label, mask

    def _gather_rows(self, statuses: list[Status], pre_filtered: bool = False):
        """Filter (unless the caller did: ``pre_filtered``), then extract
        the kept statuses, their originals' raw texts and the originals'
        five numeric columns (float64 [n, 5], ``_NUMERIC_COLS`` order)."""
        keep = statuses if pre_filtered else [s for s in statuses if self.filtrate(s)]
        originals = [s.retweeted_status for s in keep]
        texts = [o.text for o in originals]
        cols = np.fromiter(
            itertools.chain.from_iterable(map(_NUMERIC_COLS, originals)),
            np.float64, len(originals) * 5,
        ).reshape(len(originals), 5)
        return keep, originals, texts, cols

    def _encode_batch_texts(self, statuses: list[Status], pre_filtered: bool = False):
        """Filter + UTF-16 encode: (keep, originals, cols, units, offsets,
        all_ascii). Texts with non-ASCII characters take Python's Unicode
        ``lower()``; ASCII texts are case-folded during the pad copy."""
        keep, originals, texts, cols = self._gather_rows(statuses, pre_filtered)
        joined = "".join(texts)
        if not joined.isascii():
            texts = [t if t.isascii() else t.lower() for t in texts]
            units, offsets = encode_texts(texts)
            return keep, originals, cols, units, offsets, False
        units = np.frombuffer(
            joined.encode("utf-16-le", "surrogatepass"), dtype=np.uint16
        )
        n = len(texts)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.fromiter(map(len, texts), np.int64, n), out=offsets[1:])
        if units.size == 0:
            units = np.zeros(1, dtype=np.uint16)
        return keep, originals, cols, units, offsets, True

    def _sub(self, name: str, t0: float) -> float:
        """Record one featurize sub-stage span in ``last_substages`` as
        (name, start, seconds); returns the stage's end (the next t0)."""
        t1 = time.perf_counter()
        self.last_substages.append((name, t0, t1 - t0))
        return t1

    @staticmethod
    def _row_len_bucket(max_len: int, unit_bucket: int) -> int:
        """The padded row length L for a batch's longest row: the ONE
        policy both units wires and the native fill share. L >= 2 so the
        device's bigram windows are non-empty."""
        return (
            unit_bucket
            if unit_bucket >= max(max_len, 2) and unit_bucket > 0
            else _bucket(max(max_len, 2))
        )

    def featurize_batch_units(
        self, statuses: list[Status], row_bucket: int = 0, unit_bucket: int = 0
    ) -> UnitBatch:
        """Filter + encode + pad a micro-batch for on-device featurization:
        the text ships as lowercased UTF-16 code units and the learner
        hashes bigrams on its device."""
        self.last_substages = []
        t0 = time.perf_counter()
        keep, originals, cols, units, offsets, all_ascii = self._encode_batch_texts(
            statuses
        )
        t0 = self._sub("encode", t0)
        n = len(originals)
        lengths = np.diff(offsets).astype(np.int32)
        b = pad_row_count(n, row_bucket)
        lu = self._row_len_bucket(int(lengths.max()) if n else 0, unit_bucket)
        buf, length = _pad_ragged_units(
            units, offsets, lengths, n, b, lu, narrow=all_ascii
        )
        t0 = self._sub("wire_build", t0)
        numeric, label, mask = self._numeric_label_mask(
            originals, b, cols=cols, keep=keep, encoded=(units, offsets))
        self._sub("numeric", t0)
        return UnitBatch(buf, length, numeric, label, mask)

    def featurize_batch_ragged(
        self,
        statuses: list[Status],
        row_bucket: int = 0,
        unit_bucket: int = 0,
        pack: bool = False,
        pre_filtered: bool = False,
    ) -> RaggedUnitBatch | PackedBatch:
        """Filter + encode a micro-batch for the RAGGED wire: the units ship
        concatenated (the total rounded up to RAGGED_UNIT_MULTIPLE) with row
        offsets, and the step re-pads them to [B, L] and folds ASCII case on
        its device, giving the padded wire's features bit for bit.
        ``unit_bucket`` pins the rebuilt row length L as on the padded wire.
        The arrays come from one native C pass when it loads
        (features/featurize_native.py), else from numpy, byte-equal.

        ``pack=True`` returns the batch packed into one buffer
        (``pack_batch``); the fill's lease then goes straight back to the
        arena, since the packed buffer holds copies of its bytes.
        ``pre_filtered`` skips the retweet filter: every status is a row
        (the serving plane's requests, each a retweet wrapper of the
        original it scores)."""
        self.last_substages = []
        t0 = time.perf_counter()
        keep, originals, cols, units, offsets, all_ascii = self._encode_batch_texts(
            statuses, pre_filtered
        )
        t0 = self._sub("encode", t0)
        n = len(originals)
        b = pad_row_count(n, row_bucket)
        fast = featurize_native.try_fill(
            units, offsets, cols, featurize_native.object_col_order(), n, b,
            narrow=all_ascii, now_ms=self._now(),
        )
        if fast is not None:
            flat, offs, numeric, label, mask, max_len, lease = fast
            batch = RaggedUnitBatch(
                flat, offs, numeric, label, mask,
                row_len=self._row_len_bucket(max_len, unit_bucket),
            )
            featurize_native.attach_lease(batch, lease)
            t0 = self._sub("wire_build", t0)
            if n and self._apply_label_fns(label, keep, (units, offsets)):
                t0 = self._sub("numeric", t0)
        else:
            lengths = np.diff(offsets)
            lu = self._row_len_bucket(int(lengths.max()) if n else 0, unit_bucket)
            flat, offs = ragged_wire_arrays(units, offsets, n, b, narrow=all_ascii)
            t0 = self._sub("wire_build", t0)
            numeric, label, mask = self._numeric_label_mask(
                originals, b, cols=cols, keep=keep, encoded=(units, offsets))
            t0 = self._sub("numeric", t0)
            batch = RaggedUnitBatch(flat, offs, numeric, label, mask, row_len=lu)
        if not pack:
            return batch
        packed = pack_batch(batch)
        if batch.lease is not None:
            batch.lease.retire()
        self._sub("pack", t0)
        return packed
