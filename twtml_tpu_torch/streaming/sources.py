"""Tweet sources as plain generators (counterpart of a subset of
``twtml_tpu/streaming/sources.py``).

- ``ReplayFileSource`` replays a tweets .jsonl fixture as fast as it parses
  (no pacing, no trace hooks);
- ``SyntheticSource`` generates tweets whose retweet counts follow a known
  linear function of the features, with the same numpy draws in the same
  order as the JAX package's, so one seed gives the same tweets in both.
"""

from __future__ import annotations

import json
import time
from typing import Iterator

import numpy as np

from ..features.featurizer import Status


class ReplayFileSource:
    """Replay a .jsonl file of tweet objects; ``loop`` starts over at the
    end of the file."""

    def __init__(self, path: str, loop: bool = False):
        self.path = path
        self.loop = loop

    def __iter__(self) -> Iterator[Status]:
        while True:
            with open(self.path, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        yield Status.from_json(json.loads(line))
            if not self.loop:
                return


class SyntheticSource:
    """Synthetic retweets with analytically checkable labels. ``total`` = stop
    after n (0 = unbounded); ``base_ms`` pins the created_at base (wall clock
    when None)."""

    _WORDS = (
        "tpu stream learn fast jax pallas shard mesh grad psum tweet viral "
        "scale batch online model predict train news data"
    ).split()

    def __init__(self, total: int = 0, seed: int = 0, base_ms: int | None = None):
        self.total = total
        self.seed = seed
        self.base_ms = base_ms

    def __iter__(self) -> Iterator[Status]:
        rng = np.random.default_rng(self.seed)
        count = 0
        while self.total <= 0 or count < self.total:
            n_words = int(rng.integers(3, 9))
            words = rng.choice(self._WORDS, size=n_words)
            text = " ".join(words)
            followers = int(rng.integers(100, 2_000_000))
            # ground truth: label correlates with followers + text length
            label = int(
                np.clip(100 + followers * 4e-4 + len(text) * 2 + rng.normal(0, 20),
                        100, 1000)
            )
            original = Status(
                text=text,
                retweet_count=label,
                followers_count=followers,
                favourites_count=int(rng.integers(0, 50_000)),
                friends_count=int(rng.integers(0, 10_000)),
                created_at_ms=(
                    self.base_ms
                    if self.base_ms is not None
                    else int(time.time() * 1000)
                ) - int(rng.integers(0, 86_400_000)),
            )
            yield Status(text="RT " + text, retweeted_status=original)
            count += 1
