"""The shard-segment wire of a multi-host rank, held byte for byte against
the JAX package: ``ragged_shard_bucket``, ``align_ragged_shards``,
``pack_ragged_sharded`` (numpy and the native assembler, raw and
digram-coded, at its own or an agreed codec bucket), the shard-major
``pack_ragged_group``, the cross-host alignment agreement, and the decode:
``unpack_batch`` on numpy and on tensors, the multi-segment
``offsets_from_deltas`` and ``ragged_repad``."""

from __future__ import annotations

import itertools

import jax
import numpy as np
import pytest
import torch

from twtml_tpu.features import assemble as jax_assemble
from twtml_tpu.features import batch as jb
from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.ops import ragged as jax_ragged
from twtml_tpu.parallel import distributed as jax_distributed
from twtml_tpu.parallel import make_mesh as jax_make_mesh
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic
from twtml_tpu_torch.features import assemble
from twtml_tpu_torch.features import batch as pb
from twtml_tpu_torch.ops import ragged
from twtml_tpu_torch.parallel import distributed

NOW_MS = 1785320000000
FIELDS = ("units", "offsets", "numeric", "label", "mask")


def jax_batch(rows: int, seed: int, wide: bool = False):
    """A ragged batch of the JAX featurizer (uint8 units, or uint16 with
    ``wide``: a non-ASCII tail on every row)."""
    statuses = list(JaxSynthetic(total=rows, seed=seed, base_ms=NOW_MS).produce())
    if wide:
        for s in statuses:
            s.retweeted_status.text += " é"
    return JaxFeaturizer(now_ms=NOW_MS).featurize_batch_ragged(
        statuses, row_bucket=rows, unit_bucket=64, pre_filtered=True)


def as_port(rb) -> pb.RaggedUnitBatch:
    return pb.RaggedUnitBatch(*(np.asarray(getattr(rb, f)) for f in FIELDS),
                              row_len=rb.row_len, num_shards=rb.num_shards)


def same_batch(ours, theirs) -> None:
    for f in FIELDS:
        got = getattr(ours, f)
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        want = np.asarray(getattr(theirs, f))
        if got.dtype == np.int16 and want.dtype == np.uint16:
            got = got.view(np.uint16)
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (ours.row_len, ours.num_shards) == (theirs.row_len, theirs.num_shards)


def same_pack(ours, theirs) -> None:
    assert ours.layout == theirs.layout
    np.testing.assert_array_equal(np.asarray(ours.buffer), np.asarray(theirs.buffer))


@pytest.mark.parametrize("shards,bucket,wide", [
    (1, 0, False), (2, 0, False), (4, 0, False), (2, 8192, False), (4, 0, True),
])
def test_alignment_and_bucket_match_the_jax_package(shards, bucket, wide):
    rb = jax_batch(64, 3 + shards, wide)
    theirs = jb.align_ragged_shards(rb, shards, unit_bucket=bucket)
    ours = pb.align_ragged_shards(as_port(rb), shards, unit_bucket=bucket)
    assert pb.ragged_shard_bucket(as_port(rb), shards) == jb.ragged_shard_bucket(rb, shards)
    same_batch(ours, theirs)
    # an aligned batch grows to a larger agreed bucket
    grown = ours.units.shape[0] // shards + 4096
    same_batch(pb.align_ragged_shards(ours, shards, unit_bucket=grown),
               jb.align_ragged_shards(theirs, shards, unit_bucket=grown))


CASES = list(itertools.product((1, 2, 4), (None, "dict"), ("auto", "off"), (None, True)))


@pytest.mark.parametrize("shards,codec,native,narrow", CASES,
                         ids=lambda v: str(v))
def test_pack_ragged_sharded_is_byte_equal(shards, codec, native, narrow):
    """Each package's pack (its native assembler on or off) of the same
    aligned rows: the same bytes and layout; the decode round-trips."""
    aligned = jb.align_ragged_shards(jax_batch(64, 11), shards)
    with assemble.forced(native), jax_assemble_mode(native):
        theirs = jb.pack_ragged_sharded(aligned, num_shards_out=8, codec=codec,
                                        narrow_offsets=narrow)
        ours = pb.pack_ragged_sharded(as_port(aligned), num_shards_out=8, codec=codec,
                                      narrow_offsets=narrow)
    same_pack(ours, theirs)
    same_batch(pb.unpack_batch(ours.buffer, ours.layout),
               jb.unpack_batch(np.asarray(theirs.buffer), theirs.layout))
    same_batch(pb.unpack_batch(torch.from_numpy(np.array(ours.buffer)), ours.layout),
               jb.unpack_batch(np.asarray(theirs.buffer), theirs.layout))


class jax_assemble_mode:
    """The JAX package's ``--wireAssemble`` mode for a block (its
    ``configure`` is process-wide, like the port's)."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        self.prev = jax_assemble.mode()
        jax_assemble.configure(self.mode)

    def __exit__(self, *exc):
        jax_assemble.configure(self.prev)


@pytest.mark.parametrize("native", ["auto", "off"])
def test_agreed_codec_bucket_and_groups_are_byte_equal(native):
    """A forced (cross-host agreed) codec bucket, and the shard-major group
    wire of K = 3 batches at S = 2, raw and coded."""
    batches = [jb.align_ragged_shards(jax_batch(32, s), 2, unit_bucket=4096)
               for s in (5, 6, 7)]
    with assemble.forced(native), jax_assemble_mode(native):
        bucket = 4096 // 2 + 64
        same_pack(pb.pack_ragged_sharded(as_port(batches[0]), codec="dict",
                                         codec_bucket=bucket),
                  jb.pack_ragged_sharded(batches[0], codec="dict", codec_bucket=bucket))
        for codec in (None, "dict"):
            ours = pb.pack_ragged_group([as_port(b) for b in batches], num_shards_out=4,
                                        codec=codec)
            theirs = jb.pack_ragged_group(batches, num_shards_out=4, codec=codec)
            same_pack(ours, theirs)
            want = jb.unpack_batch(np.asarray(theirs.buffer), theirs.layout)
            same_batch(pb.unpack_batch(ours.buffer, ours.layout), want)
            same_batch(pb.unpack_batch(torch.from_numpy(np.array(ours.buffer)), ours.layout),
                       want)


@pytest.mark.parametrize("codec,wide", [("", False), ("dict", False), ("dict", True)])
def test_the_alignment_agreement_matches_the_jax_package(codec, wide):
    """One process: the agreement's aligned batch and codec bucket equal the
    JAX package's ``_ragged_local_aligned_codec`` on a one-device mesh (no
    codec: its uint16-harmonized ``_ragged_local_aligned``)."""
    rb = jax_batch(64, 21, wide)
    mesh = jax_make_mesh(num_data=1, devices=jax.devices()[:1])
    if codec:
        theirs, their_bucket = jax_distributed._ragged_local_aligned_codec(rb, mesh, codec)
    else:
        theirs, their_bucket = jax_distributed._ragged_local_aligned(rb, mesh), 0
    ours, bucket = distributed.ragged_local_aligned_codec(as_port(rb), codec)
    assert bucket == their_bucket
    same_batch(ours, theirs)


@pytest.mark.parametrize("segments", [1, 2, 4])
def test_multi_segment_decode_matches_the_jax_ops(segments):
    aligned = jb.align_ragged_shards(jax_batch(64, 31), segments)
    deltas = jb._offsets_to_deltas(aligned.offsets, segments)
    got = ragged.offsets_from_deltas(torch.from_numpy(deltas.astype(np.int32)), segments)
    want = jax_ragged.offsets_from_deltas(jax.numpy.asarray(deltas), segments)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    units, lens = ragged.ragged_repad(torch.from_numpy(np.asarray(aligned.units).astype(np.int32)),
                                      got, aligned.row_len, segments)
    j_units, j_lens = jax_ragged.ragged_repad(
        jax.numpy.asarray(aligned.units), jax.numpy.asarray(aligned.offsets), aligned.row_len,
        rows=aligned.mask.shape[0])
    np.testing.assert_array_equal(units.numpy(), np.asarray(j_units))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(j_lens))
