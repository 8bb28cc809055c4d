"""Hashing-trick text features, bit-compatible with MLlib's HashingTF
(counterpart of ``twtml_tpu/features/hashing.py``).

MLlib 1.6's HashingTF maps a term to ``nonNegativeMod(term.##, numFeatures)``
where ``.##`` on a String is Java ``String.hashCode``: a 31-ary polynomial over
UTF-16 code units in 32-bit signed arithmetic. This pure-Python version is the
host ground truth the port's tests hold the device hash against.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable


def utf16_units(s: str) -> list[int]:
    """The string as JVM chars: UTF-16 code units (surrogates split)."""
    b = s.encode("utf-16-le", errors="surrogatepass")
    return [b[i] | (b[i + 1] << 8) for i in range(0, len(b), 2)]


def java_string_hashcode(s: str) -> int:
    """Java ``String.hashCode``: h = 31*h + c over UTF-16 code units,
    wrapping in 32-bit signed arithmetic (lone surrogates accepted)."""
    h = 0
    for cu in utf16_units(s):
        h = (31 * h + cu) & 0xFFFFFFFF
    if h >= 0x80000000:
        h -= 0x100000000
    return h


def non_negative_mod(x: int, mod: int) -> int:
    """MLlib Utils.nonNegativeMod; equals Python's ``%`` for positive mod."""
    return x % mod


def char_bigrams(text: str) -> list[str]:
    """Scala ``text.sliding(2)`` over UTF-16 code units: a string shorter
    than 2 units yields itself as the single window, empty yields nothing.
    Returned strings may hold lone surrogates."""
    units = utf16_units(text)
    if not units:
        return []
    if len(units) < 2:
        return [text]
    return [chr(units[i]) + chr(units[i + 1]) for i in range(len(units) - 1)]


def hashing_tf_counts(terms: Iterable[str], num_features: int) -> dict[int, float]:
    """HashingTF.transform: term-frequency counts keyed by hashed index;
    distinct terms colliding on an index accumulate, like MLlib."""
    counts: Counter[int] = Counter()
    for term in terms:
        counts[non_negative_mod(java_string_hashcode(term), num_features)] += 1
    return {idx: float(c) for idx, c in counts.items()}
