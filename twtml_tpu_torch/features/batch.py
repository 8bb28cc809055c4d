"""Fixed-shape padded micro-batches (counterpart of a subset of
``twtml_tpu/features/batch.py``).

A micro-batch is a struct of padded host arrays: the text half (hashed tokens,
or raw UTF-16 code units on the units wire), the 4 dense numeric features,
labels, and a validity mask. Row counts are padded up to bucket sizes so a
stream of varying batch sizes reuses a few shapes. These are plain
NamedTuples of numpy arrays; the learner moves them to its device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

NUM_NUMBER_FEATURES = 4  # MllibHelper.scala:13


class FeatureBatch(NamedTuple):
    """One padded micro-batch of host-hashed tokens.

    Shapes (B = padded rows, L = padded tokens/tweet):
      token_idx: int  [B, L] — hashed bigram indices into [0, numTextFeatures)
      token_val: num  [B, L] — term-frequency counts (0 where padded)
      numeric:   float32[B, 4] — scaled followers/favourites/friends/age
      label:     float32[B]    — retweet count of the retweeted status
      mask:      float32[B]    — 1.0 for real rows, 0.0 for padding
    """

    token_idx: np.ndarray
    token_val: np.ndarray
    numeric: np.ndarray
    label: np.ndarray
    mask: np.ndarray

    @property
    def num_valid(self) -> int:
        return int(self.mask.sum())


class UnitBatch(NamedTuple):
    """A padded micro-batch carrying raw UTF-16 code units; the learner
    hashes the bigrams on its device (ops/text_hash.py).

    Shapes (B = padded rows, L = padded units/tweet, L >= 2):
      units:   uint8|uint16 [B, L] — lowercased text as UTF-16-LE code units;
               uint8 when every row is ASCII
      length:  int32  [B]      — real unit count per row (0 for padding)
      numeric: float32[B, 4], label: float32[B], mask: float32[B] — as in
      FeatureBatch.
    """

    units: np.ndarray
    length: np.ndarray
    numeric: np.ndarray
    label: np.ndarray
    mask: np.ndarray

    @property
    def num_valid(self) -> int:
        return int(self.mask.sum())


def _bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two bucket >= n (>= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_row_count(n: int, row_bucket: int, row_multiple: int = 1) -> int:
    """Padded row count: the requested bucket when it fits, else the
    power-of-two bucket, then rounded up to ``row_multiple``."""
    b = row_bucket if row_bucket >= n and row_bucket > 0 else _bucket(max(n, 1))
    if row_multiple > 1:
        b += (-b) % row_multiple
    return b
