"""The port's digram wire codec (``--wireCodec dict``) against the JAX
package's, on the CPU, tolerance 0 throughout: the frozen tables, the three
encoders (numpy, C, bucketed) on seeded ASCII buffers, the host decode and
the torch device decode (``ops/ragged.units_from_codes``) against the JAX
``units_from_codes``, the coded packs (flat and group, numpy and native
assembler, in all four pairings with the JAX package's paths) byte for byte
with their layouts, the raw fallbacks (uint16 units, an incompressible
batch), the unpack back to the raw batch, the wire composition and codec
telemetry, the steps (a coded wire steps bitwise as the raw one), and the
flag rules.
"""

import contextlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twtml_tpu import config as jax_config
from twtml_tpu.features import assemble as jax_assemble
from twtml_tpu.features import batch as jax_batch
from twtml_tpu.features import wirecodec as jax_codec
from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.ops import ragged as jax_ragged
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic

from twtml_tpu_torch.apps import common
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features import assemble, native, wirecodec
from twtml_tpu_torch.features.batch import (
    PackedBatch,
    RaggedUnitBatch,
    pack_batch,
    pack_ragged_group,
    stack_batches,
    unpack_batch,
    wire_composition,
)
from twtml_tpu_torch.features.featurizer import Featurizer, Status
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
from twtml_tpu_torch.ops.ragged import units_from_codes
from twtml_tpu_torch.parallel.tenants import TenantStackModel
from twtml_tpu_torch.streaming.sources import SyntheticSource
from twtml_tpu_torch.telemetry import metrics

NOW_MS = 1_700_000_000_000
FIELDS = ("units", "offsets", "numeric", "label", "mask")
# (port mode, JAX mode) of the native assembler
PAIRINGS = [("on", "on"), ("off", "off"), ("on", "off"), ("off", "on")]


@pytest.fixture(autouse=True)
def port_native():
    """The port's native library: skipped only where there is no g++; a
    failed build fails the test."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not on PATH: the native host path cannot be built")
    assert native.get_lib() is not None and native.get_lib().digram_encode is not None


@contextlib.contextmanager
def assemblers(port: str, ref: str):
    with assemble.forced(port), jax_assemble.forced(ref):
        yield


def _tweetish(rng, n_bytes: int) -> np.ndarray:
    words = [b"the ", b"https://t.co/Ab9 ", b"hello ", b"RT @user: ", b"love ",
             b"stream ", b"x", b"of ", b", ", b". ", b"'s "]
    out = b""
    while len(out) < n_bytes:
        out += words[int(rng.integers(len(words)))]
    return np.frombuffer(out[:n_bytes], np.uint8).copy()


def buffers():
    """Seeded ASCII buffers: lengths 0, 1 and 2, tweet-like text, random
    ASCII, a run of one digram (maximal munch) and an incompressible buffer
    (bytes whose pairs are in no digram)."""
    rng = np.random.default_rng(7)
    out = {
        "empty": np.zeros((0,), np.uint8),
        "one": np.array([ord("t")], np.uint8),
        "two_hit": np.frombuffer(b"th", np.uint8).copy(),
        "two_miss": np.frombuffer(b"qz", np.uint8).copy(),
        "tweetish": _tweetish(rng, 9000),
        "random_ascii": rng.integers(0, 128, 5000).astype(np.uint8),
        "run": np.frombuffer(b"ththththt", np.uint8).copy(),
        "incompressible": np.frombuffer(b"qzxj" * 1500, np.uint8).copy(),
    }
    zero_tail = np.zeros((8192,), np.uint8)
    zero_tail[:3000] = _tweetish(rng, 3000)
    out["bucketed_zero_tail"] = zero_tail
    return out


BUFFERS = buffers()


def test_the_tables_are_the_jax_packages():
    assert wirecodec.CODE_BASE == jax_codec.CODE_BASE == 128
    assert wirecodec.CODEC_UNIT_MULTIPLE == jax_codec.CODEC_UNIT_MULTIPLE
    assert wirecodec._DIGRAMS == jax_codec._DIGRAMS
    np.testing.assert_array_equal(wirecodec.decode_table(), jax_codec.decode_table())
    np.testing.assert_array_equal(wirecodec.pair_lut(), jax_codec.pair_lut())
    assert wirecodec.decode_table().dtype == np.uint8 and wirecodec.pair_lut().shape == (65536,)


@pytest.mark.parametrize("name", list(BUFFERS))
def test_encoders_are_byte_equal_to_the_jax_packages(name):
    buf = BUFFERS[name]
    want = jax_codec.encode_np(buf)
    np.testing.assert_array_equal(wirecodec.encode_np(buf), want)
    np.testing.assert_array_equal(wirecodec.encode(buf), want)  # the C encoder
    np.testing.assert_array_equal(jax_codec.encode(buf), want)
    got, ref = wirecodec.encode_bucketed(buf), jax_codec.encode_bucketed(buf)
    assert (got is None) == (ref is None)
    if ref is not None:
        np.testing.assert_array_equal(got, ref)
        assert got.shape[0] == wirecodec.encoded_bucket(want.shape[0])
    if name == "incompressible":
        assert want.shape == buf.shape and ref is None  # the raw fallback


@pytest.mark.parametrize("name", [n for n in BUFFERS if BUFFERS[n].size])
def test_host_decode_gives_the_raw_buffer(name):
    buf = BUFFERS[name]
    codes = wirecodec.encode(buf)
    np.testing.assert_array_equal(wirecodec.decode_np(codes, buf.shape[0]), buf)
    np.testing.assert_array_equal(jax_codec.decode_np(codes, buf.shape[0]), buf)


def test_host_decode_refuses_a_short_stream():
    with pytest.raises(ValueError, match="expands to"):
        wirecodec.decode_np(np.zeros((4,), np.uint8), 9)


@pytest.mark.parametrize("name", ["tweetish", "random_ascii", "run", "bucketed_zero_tail",
                                  "two_hit", "one"])
def test_device_decode_equals_the_jax_decode_on_a_stream(name):
    buf = BUFFERS[name]
    codes = wirecodec.encode(buf)
    got = units_from_codes(torch.from_numpy(codes), buf.shape[0])
    want = np.asarray(jax_ragged.units_from_codes(jnp.asarray(codes), buf.shape[0]))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), buf)


def test_device_decode_equals_the_jax_decode_on_stacked_streams():
    """[K, M] codes (a group's segments, one shared bucket) decode to
    [K, out_len] in one call, each row its own stream."""
    rng = np.random.default_rng(3)
    raws = np.zeros((3, 4096), np.uint8)
    for k, n in enumerate((4000, 1200, 0)):
        raws[k, :n] = _tweetish(rng, n)
    enc = [wirecodec.encode(r) for r in raws]
    codes = np.zeros((3, wirecodec.encoded_bucket(max(e.shape[0] for e in enc))), np.uint8)
    for k, e in enumerate(enc):
        codes[k, : e.shape[0]] = e
    got = units_from_codes(torch.from_numpy(codes), 4096).numpy()
    want = np.asarray(jax_ragged.units_from_codes(jnp.asarray(codes), 4096))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, raws)
    assert units_from_codes(torch.from_numpy(codes), 0).shape == (3, 0)


# ---- the packs ------------------------------------------------------------------

def ragged_pair(n, seed, rows=64, unicode_row=False):
    """One ragged batch of ``n`` synthetic retweets featurized by each
    package (the same tweets); ``unicode_row`` appends a non-ASCII text to
    one original, which widens the units to uint16."""
    ours = list(SyntheticSource(total=n, seed=seed, base_ms=NOW_MS).produce())
    theirs = list(JaxSynthetic(total=n, seed=seed, base_ms=NOW_MS).produce())
    if unicode_row:
        ours[0].retweeted_status.text += " café"
        theirs[0].retweeted_status.text += " café"
    rb = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(ours, row_bucket=rows)
    jrb = JaxFeaturizer(now_ms=NOW_MS).featurize_batch_ragged(theirs, row_bucket=rows)
    return rb, jrb


def assert_same_pack(got: PackedBatch, want):
    assert got.layout == want.layout
    np.testing.assert_array_equal(np.asarray(got.buffer), np.asarray(want.buffer))


def assert_raw_batch(got, rb):
    for f in FIELDS:
        g = getattr(got, f)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        want = np.asarray(getattr(rb, f))
        if want.dtype == np.uint16:
            g = g.view(np.uint16)
        np.testing.assert_array_equal(g, want, err_msg=f)
    assert got.row_len == rb.row_len


@pytest.mark.parametrize("port,ref", PAIRINGS)
def test_flat_coded_pack_is_the_jax_packages(port, ref):
    rb, jrb = ragged_pair(40, 1)
    with assemblers(port, ref):
        got = pack_batch(rb, codec="dict")
        want = jax_batch.pack_batch(jrb, codec="dict")
    assert_same_pack(got, want)
    extra = got.layout[2]
    assert extra[3] == ("dict", (rb.units.shape[0],)) and isinstance(extra[3][1], tuple)
    assert got.layout[1][0][1] == "|u1" and got.buffer.nbytes < pack_batch(rb).buffer.nbytes
    assert_raw_batch(unpack_batch(np.asarray(got.buffer), got.layout), rb)
    assert_raw_batch(unpack_batch(torch.from_numpy(np.asarray(got.buffer).copy()), got.layout),
                     rb)


@pytest.mark.parametrize("port,ref", PAIRINGS)
def test_group_coded_pack_is_the_jax_packages(port, ref):
    pairs = [ragged_pair(n, seed) for n, seed in ((40, 1), (64, 2), (3, 5))]
    ours, theirs = [p[0] for p in pairs], [p[1] for p in pairs]
    with assemblers(port, ref):
        got = pack_ragged_group(ours, codec="dict")
        want = jax_batch.pack_ragged_group(theirs, codec="dict")
    assert_same_pack(got, want)
    assert got.layout[2][4] == ("dict", ours[0].units.shape[0])
    stacked = stack_batches(ours)
    assert_raw_batch(unpack_batch(np.asarray(got.buffer), got.layout), stacked)
    assert_raw_batch(unpack_batch(torch.from_numpy(np.asarray(got.buffer).copy()), got.layout),
                     stacked)


@pytest.mark.parametrize("port,ref", PAIRINGS)
def test_uint16_units_ship_raw_with_the_jax_layout(port, ref):
    rb, jrb = ragged_pair(40, 1, unicode_row=True)
    assert rb.units.dtype == np.uint16
    with assemblers(port, ref):
        got = pack_batch(rb, codec="dict")
        want = jax_batch.pack_batch(jrb, codec="dict")
        group = pack_ragged_group([rb, rb], codec="dict")
        jgroup = jax_batch.pack_ragged_group([jrb, jrb], codec="dict")
    assert_same_pack(got, want)
    assert_same_pack(group, jgroup)
    assert len(got.layout[2]) == 3 and len(group.layout[2]) == 4  # no codec entry
    assert_raw_batch(unpack_batch(torch.from_numpy(np.asarray(got.buffer).copy()), got.layout),
                     rb)


@pytest.mark.parametrize("port,ref", PAIRINGS)
def test_an_incompressible_batch_ships_raw_as_in_the_jax_package(port, ref):
    """Texts of pairs in no digram: the coded bucket is not smaller than the
    raw 4096 units, so both packages ship the raw layout."""
    text = "qzxj" * 100
    ours = [Status(text="RT", retweeted_status=Status(text=text, retweet_count=500))] * 9
    from twtml_tpu.features.featurizer import Status as JaxStatus

    theirs = [JaxStatus(text="RT", retweeted_status=JaxStatus(text=text, retweet_count=500))] * 9
    rb = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(ours, row_bucket=16)
    jrb = JaxFeaturizer(now_ms=NOW_MS).featurize_batch_ragged(theirs, row_bucket=16)
    with assemblers(port, ref):
        got = pack_batch(rb, codec="dict")
        want = jax_batch.pack_batch(jrb, codec="dict")
    assert_same_pack(got, want)
    assert len(got.layout[2]) == 3


def test_an_unknown_codec_raises_as_in_the_jax_package():
    rb, jrb = ragged_pair(8, 1)
    for mode in ("on", "off"):
        with assemble.forced(mode), pytest.raises(ValueError, match="unknown wire codec"):
            pack_batch(rb, codec="zstd")
    with pytest.raises(ValueError, match="unknown wire codec"):
        jax_batch.pack_batch(jrb, codec="zstd")


def test_an_empty_batch_codes_its_zero_buffer():
    """The warm-up's all-padding batch: 4096 zero units code to 2048 zero
    pairs (dictionary entry 0), one bucket of 2048."""
    rb = Featurizer(now_ms=NOW_MS).featurize_batch_ragged([], row_bucket=8)
    jrb = JaxFeaturizer(now_ms=NOW_MS).featurize_batch_ragged([], row_bucket=8)
    got = pack_batch(rb, codec="dict")
    assert_same_pack(got, jax_batch.pack_batch(jrb, codec="dict"))
    assert got.layout[1][0] == ((2048,), "|u1")


@pytest.mark.parametrize("codec", [None, "dict"])
def test_wire_composition_is_the_jax_packages(codec):
    rb, jrb = ragged_pair(40, 1)
    got, want = pack_batch(rb, codec=codec), jax_batch.pack_batch(jrb, codec=codec)
    assert wire_composition(got) == jax_batch.wire_composition(want)
    group = pack_ragged_group([rb, rb], codec=codec)
    jgroup = jax_batch.pack_ragged_group([jrb, jrb], codec=codec)
    assert wire_composition(group) == jax_batch.wire_composition(jgroup)
    assert wire_composition(rb) == jax_batch.wire_composition(jrb)
    assert ("units_compressed" in wire_composition(got)) == (codec == "dict")


def test_codec_gauges_and_the_fallback_counter():
    metrics.reset_for_tests()
    rb, _ = ragged_pair(40, 1)
    wide, _ = ragged_pair(40, 1, unicode_row=True)
    coded = pack_batch(rb, codec="dict")
    comp = common._record_wire_codec(coded, "dict")
    reg = metrics.get_registry()
    assert reg.gauge("wire.units_compressed_bytes").value == comp["units_compressed"]
    assert reg.gauge("wire.codec_ratio").value == round(comp["units"] / comp["units_compressed"],
                                                         3)
    assert reg.counter("wire.codec_fallbacks").value == 0
    common._record_wire_codec(pack_batch(wide, codec="dict"), "dict")
    assert reg.counter("wire.codec_fallbacks").value == 1
    assert reg.gauge("wire.codec_ratio").value == 1.0
    assert common._record_wire_codec(coded, "") is None


# ---- the steps ------------------------------------------------------------------

def _outputs(out):
    return [np.asarray(f) for f in out if f is not None]


def test_a_coded_wire_steps_bitwise_as_the_raw_wire():
    batches = [ragged_pair(n, seed)[0] for n, seed in ((40, 1), (64, 2), (17, 3))]
    raw = StreamingLinearRegressionWithSGD(device="cpu", num_iterations=10)
    coded = StreamingLinearRegressionWithSGD(device="cpu", num_iterations=10)
    for rb in batches:
        a = raw.fetch_output(raw.step(pack_batch(rb)))
        b = coded.fetch_output(coded.step(pack_batch(rb, codec="dict")))
        a.wait(), b.wait()
        for x, y in zip(_outputs(a.result()), _outputs(b.result())):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(raw.latest_weights, coded.latest_weights)


def test_a_coded_group_steps_bitwise_as_the_raw_group():
    batches = [ragged_pair(40, seed)[0] for seed in range(4)]
    raw = StreamingLinearRegressionWithSGD(device="cpu", num_iterations=10)
    coded = StreamingLinearRegressionWithSGD(device="cpu", num_iterations=10)
    a = raw.fetch_output(raw.step_many(pack_ragged_group(batches)))
    wire = pack_ragged_group(batches, codec="dict")
    assert wire.layout[2][4][0] == "dict"
    b = coded.fetch_output(coded.step_many(wire))
    a.wait(), b.wait()
    for x, y in zip(_outputs(a.result()), _outputs(b.result())):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(raw.latest_weights, coded.latest_weights)


def test_the_tenant_group_wire_with_the_codec_is_bitwise_the_raw_one():
    rb, _ = ragged_pair(64, 4)
    models = [TenantStackModel(3, num_iterations=10, wire_pack="group", wire_codec=codec,
                               device="cpu") for codec in ("", "dict")]
    wires = [m.pack_for_wire(rb) for m in models]
    assert len(wires[0].layout[2]) == 4 and wires[1].layout[2][4][0] == "dict"
    outs = []
    for m, w in zip(models, wires):
        pending = m.fetch_output(m.step(w))
        pending.wait()
        outs.append(_outputs(pending.result()))
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(models[0].latest_weights, models[1].latest_weights)


# ---- the flags --------------------------------------------------------------------

FLAG_CASES = [
    [], ["--wireCodec", "dict", "--seconds", "0"], ["--wireCodec", "off", "--seconds", "0"],
    ["--wireCodec", "auto", "--seconds", "0"],
    ["--wireCodec", "dict", "--seconds", "5"],
    ["--wireCodec", "dict", "--seconds", "0", "--hashOn", "host"],
    ["--wireCodec", "dict", "--seconds", "0", "--wirePack", "stacked"],
    ["--wireCodec", "dict", "--seconds", "0", "--wirePack", "group"],
    ["--wireCodec", "dict", "--seconds", "0", "--wire", "padded"],
    ["--wirePack", "stacked"], ["--wirePack", "group"],
]


def _resolve(conf):
    out = []
    for name in ("effective_wire_codec", "effective_wire_pack"):
        try:
            out.append(getattr(conf, name)())
        except ValueError as exc:
            out.append(("ValueError", str(exc)))
    return out


@pytest.mark.parametrize("argv", FLAG_CASES, ids=lambda a: " ".join(a) or "defaults")
def test_codec_flags_resolve_as_in_the_jax_package(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    conf = ConfArguments().parse(argv)
    assert _resolve(conf) == _resolve(jax_config.ConfArguments().parse(argv))
    conf.check_ported()  # the codec is ported: no value of it is refused
