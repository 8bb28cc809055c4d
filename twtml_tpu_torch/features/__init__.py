from .batch import (
    NUM_NUMBER_FEATURES,
    FeatureBatch,
    PackedBatch,
    RaggedUnitBatch,
    UnitBatch,
    pack_batch,
    unpack_batch,
)
from .featurizer import Featurizer, Status
from .hashing import char_bigrams, hashing_tf_counts, java_string_hashcode

__all__ = [
    "NUM_NUMBER_FEATURES",
    "FeatureBatch",
    "PackedBatch",
    "RaggedUnitBatch",
    "UnitBatch",
    "pack_batch",
    "unpack_batch",
    "Featurizer",
    "Status",
    "char_bigrams",
    "hashing_tf_counts",
    "java_string_hashcode",
]
