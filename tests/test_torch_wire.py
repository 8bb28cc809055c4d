"""The port's default wire against the JAX package's, on the CPU.

The ragged units wire (``featurize_batch_ragged``), its one-buffer packed
form (``pack_batch``), the unpack (numpy and torch) and the device decode
(``offsets_from_deltas``, ``ragged_repad``) must be byte-equal to the JAX
package's, tolerance 0, whichever path fills them: each package's native
fill and pack are forced on and off (``featurize_native.forced``,
``assemble.forced``), in all four pairings. Then the step: four packed
batches through the port's learner against the JAX learner on the same
packed batches (the tolerances of tests/test_torch_step.py), and the port's
packed run bitwise equal to its padded run.
"""

import contextlib
import itertools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twtml_tpu.features import assemble as jax_assemble
from twtml_tpu.features import batch as jax_batch
from twtml_tpu.features import featurize_native as jax_ffz
from twtml_tpu.features.featurizer import Featurizer as JaxFeaturizer
from twtml_tpu.features.featurizer import Status as JaxStatus
from twtml_tpu.models.linear import StreamingLinearRegressionWithSGD as JaxLinear
from twtml_tpu.ops import ragged as jax_ragged
from twtml_tpu.streaming.sources import ReplayFileSource as JaxReplay
from twtml_tpu.streaming.sources import SyntheticSource as JaxSynthetic

from twtml_tpu_torch.apps.linear_regression import run
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.features import assemble, featurize_native, native
from twtml_tpu_torch.features.batch import (
    OFFSET_DELTA_MAX,
    PackedBatch,
    RaggedUnitBatch,
    UnitBatch,
    pack_batch,
    unpack_batch,
)
from twtml_tpu_torch.features.featurizer import Featurizer, Status
from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
from twtml_tpu_torch.ops.ragged import offsets_from_deltas, ragged_repad
from twtml_tpu_torch.streaming.sources import ReplayFileSource, SyntheticSource
from twtml_tpu_torch.utils.rounding import round_half_up

FIXTURE = "tests/data/tweets.jsonl"
NOW_MS = 1_700_000_000_000
FIELDS = ("units", "offsets", "numeric", "label", "mask")
STATS = ("count", "mse", "real_stdev", "pred_stdev")
# (port mode, JAX mode) of the native fill and pack
PAIRINGS = [("on", "on"), ("off", "off"), ("on", "off"), ("off", "on")]


@pytest.fixture
def port_native():
    """The port's native library: skipped only where there is no g++; a
    failed build fails the test."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not on PATH: the native host path cannot be built")
    assert native.get_lib() is not None, "the native library did not build or load"
    assert native.featurize_available() and native.assemble_available()


@contextlib.contextmanager
def modes(port: str, ref: str):
    with featurize_native.forced(port), assemble.forced(port), \
            jax_ffz.forced(ref), jax_assemble.forced(ref):
        yield


def pair(text, count=500, **extra):
    """One retweet as a (port Status, JAX Status) pair of the same fields."""
    fields = dict(
        followers_count=1234, favourites_count=77, friends_count=450,
        created_at_ms=NOW_MS - 86_400_000,
    )
    fields.update(extra)
    return (
        Status(text="RT", retweet_count=1,
               retweeted_status=Status(text=text, retweet_count=count, **fields)),
        JaxStatus(text="RT", retweet_count=1,
                  retweeted_status=JaxStatus(text=text, retweet_count=count, **fields)),
    )


def unicode_corpus():
    """Every shape the units wire special-cases, and filtered rows."""
    pairs = [
        pair("plain ascii tweet with CAPS and a link https://t.co/x"),
        pair("astral emoji \U0001f98a pair rides two UTF-16 units"),
        pair("lone surrogate \ud83e stays a unit like the JVM"),
        pair("\udc00 trailing lone low surrogate \ud800"),
        pair("İstanbul lowercases to MORE units (i + combining dot)"),
        pair("café naïve résumé — accents ΣΊΣΥΦΟΣ"),
        pair(""),
        pair("x"),
        pair("boundary low", count=100),
        pair("boundary high", count=1000),
        pair("dropped: below interval", count=99),
        pair("dropped: above interval", count=1001),
        pair("big numbers", followers_count=2**40, favourites_count=10**15,
             created_at_ms=0),
    ]
    pairs.append((Status(text="not a retweet"), JaxStatus(text="not a retweet")))
    return [p for p, _ in pairs], [j for _, j in pairs]


def synthetic(n, seed):
    return (
        list(SyntheticSource(total=n, seed=seed, base_ms=NOW_MS).produce()),
        list(JaxSynthetic(total=n, seed=seed, base_ms=NOW_MS).produce()),
    )


def replay():
    return list(ReplayFileSource(FIXTURE).produce()), list(JaxReplay(FIXTURE).produce())


def long_row():
    """A row longer than uint16 deltas can carry: row_len 131072 > 65535."""
    text = "Long ROW " * (OFFSET_DELTA_MAX // 9 + 40)
    pairs = [pair("short"), pair(text), pair("tail")]
    return [p for p, _ in pairs], [j for _, j in pairs]


SOURCES = {
    "synthetic": lambda: synthetic(200, 3),
    "unicode": unicode_corpus,
    "replay": replay,
    "empty": lambda: ([], []),
    "long_row": long_row,
}


def featurize_both(ours, ref, port_mode, ref_mode, **kw):
    """(port batch, JAX batch) of one featurize call each; the port's
    native counters must show the path its mode asked for."""
    before = dict(native.COUNTERS)
    with modes(port_mode, ref_mode):
        got = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(ours, **kw)
        want = JaxFeaturizer(now_ms=NOW_MS).featurize_batch_ragged(ref, **kw)
    fills = native.COUNTERS["fills_native"] - before["fills_native"]
    packs = native.COUNTERS["packs_native"] - before["packs_native"]
    assert fills == (port_mode == "on")
    assert packs == (port_mode == "on" and kw.get("pack", False))
    assert native.COUNTERS["fills_degraded"] == before["fills_degraded"]
    assert native.COUNTERS["packs_degraded"] == before["packs_degraded"]
    return got, want


def assert_ragged_equal(got, want):
    assert isinstance(got, RaggedUnitBatch)
    for name in FIELDS:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.row_len == want.row_len


def assert_packed_equal(got, want):
    assert isinstance(got, PackedBatch)
    assert got.layout == want.layout
    np.testing.assert_array_equal(got.buffer, np.asarray(want.buffer))


# ---- ragged arrays ----------------------------------------------------------

@pytest.mark.parametrize("port_mode,ref_mode", PAIRINGS)
@pytest.mark.parametrize("row_bucket", [0, 4, 16])
def test_replay_fixture_ragged_arrays_equal(port_native, row_bucket, port_mode, ref_mode):
    ours, ref = replay()
    for lo in range(0, len(ours), 4):
        assert_ragged_equal(*featurize_both(
            ours[lo:lo + 4], ref[lo:lo + 4], port_mode, ref_mode, row_bucket=row_bucket
        ))


@pytest.mark.parametrize("port_mode,ref_mode", PAIRINGS)
@pytest.mark.parametrize("seed,n", [(1, 100), (3, 256), (7, 64), (11, 1), (19, 300), (23, 129)])
def test_synthetic_ragged_arrays_equal(port_native, seed, n, port_mode, ref_mode):
    got, want = featurize_both(*synthetic(n, seed), port_mode, ref_mode, row_bucket=n)
    assert_ragged_equal(got, want)
    assert got.units.dtype == np.uint8  # synthetic text is ASCII: the narrow wire


@pytest.mark.parametrize("port_mode,ref_mode", PAIRINGS)
def test_unicode_ragged_arrays_equal(port_native, port_mode, ref_mode):
    got, want = featurize_both(*unicode_corpus(), port_mode, ref_mode, row_bucket=16)
    assert_ragged_equal(got, want)
    assert got.units.dtype == np.uint16
    assert got.num_valid == 11


@pytest.mark.parametrize("port_mode,ref_mode", PAIRINGS)
def test_empty_batch_ragged_arrays_equal(port_native, port_mode, ref_mode):
    got, want = featurize_both([], [], port_mode, ref_mode, row_bucket=8)
    assert_ragged_equal(got, want)
    assert got.num_valid == 0 and got.row_len == 8


# ---- the packed buffer ------------------------------------------------------

@pytest.mark.parametrize("port_mode,ref_mode", PAIRINGS)
@pytest.mark.parametrize("source", sorted(SOURCES))
def test_packed_buffer_and_layout_equal(port_native, source, port_mode, ref_mode):
    got, want = featurize_both(*SOURCES[source](), port_mode, ref_mode,
                               row_bucket=16, pack=True)
    assert_packed_equal(got, want)
    offsets_form = got.layout[2][2]
    assert offsets_form == ("i32" if source == "long_row" else "u16delta")


@pytest.mark.parametrize("port_mode,ref_mode", [("on", "on"), ("off", "off")])
@pytest.mark.parametrize("row_bucket", [3, 5, 17, 255])
def test_odd_row_bucket_packed_equal(port_native, row_bucket, port_mode, ref_mode):
    ours, ref = synthetic(row_bucket, row_bucket)
    got, want = featurize_both(ours, ref, port_mode, ref_mode,
                               row_bucket=row_bucket, pack=True)
    assert_packed_equal(got, want)
    # uint16 deltas of an odd B leave the f32 sideband 2 bytes off a word
    units_bytes = int(np.prod(got.layout[1][0][0])) * np.dtype(got.layout[1][0][1]).itemsize
    assert (units_bytes + 2 * row_bucket) % 4 == 2


@pytest.mark.parametrize("narrow", [None, True, False])
def test_pack_batch_of_jax_batch_equals_jax_pack(port_native, narrow):
    """The packer alone, fed the JAX featurizer's own arrays, both native."""
    _, ref = synthetic(96, 5)
    with modes("on", "on"):
        rb = JaxFeaturizer(now_ms=NOW_MS).featurize_batch_ragged(ref, row_bucket=97)
        want = jax_batch.pack_batch(rb, narrow_offsets=narrow)
        port_rb = RaggedUnitBatch(*(np.asarray(getattr(rb, f)) for f in FIELDS),
                                  row_len=rb.row_len)
        got = pack_batch(port_rb, narrow_offsets=narrow)
    assert_packed_equal(got, want)


def test_mismatched_narrow_offsets_raise_like_jax():
    """A delta past uint16 under a forced narrow wire raises, never wraps."""
    units = np.zeros(4096, np.uint8)
    offsets = np.array([0, 70_000, 70_000], np.int32)
    rb = RaggedUnitBatch(units, offsets, np.zeros((2, 4), np.float32),
                         np.zeros(2, np.float32), np.ones(2, np.float32), row_len=8)
    with assemble.forced("off"), pytest.raises(ValueError, match="uint16"):
        pack_batch(rb, narrow_offsets=True)


def test_operating_point_batch_packed_equal(port_native):
    """One full batch of bench.py's operating point, B = 16384."""
    ours, ref = synthetic(16384, 3)
    for port_mode, ref_mode in [("on", "on"), ("off", "off")]:
        got, want = featurize_both(ours, ref, port_mode, ref_mode,
                                   row_bucket=16384, pack=True)
        assert_packed_equal(got, want)


# ---- unpack -----------------------------------------------------------------

def packed_cases():
    cases = {}
    with modes("on", "on"):
        feat = Featurizer(now_ms=NOW_MS)
        cases["even_u16delta"] = feat.featurize_batch_ragged(
            synthetic(64, 2)[0], row_bucket=64, pack=True)
        cases["odd_u16delta"] = feat.featurize_batch_ragged(
            synthetic(33, 4)[0], row_bucket=33, pack=True)
        cases["uint16_units"] = feat.featurize_batch_ragged(
            unicode_corpus()[0], row_bucket=13, pack=True)
        cases["i32_offsets"] = feat.featurize_batch_ragged(
            long_row()[0], row_bucket=5, pack=True)
        cases["padded_units"] = pack_batch(feat.featurize_batch_units(
            synthetic(9, 6)[0], row_bucket=9))
    return cases


@pytest.mark.parametrize("case", ["even_u16delta", "odd_u16delta", "uint16_units",
                                  "i32_offsets", "padded_units"])
def test_unpack_tensor_equals_numpy_and_jax(port_native, case):
    packed = packed_cases()[case]
    host = unpack_batch(packed.buffer, packed.layout)
    ref = jax_batch.unpack_batch(np.asarray(packed.buffer), packed.layout)
    dev = unpack_batch(torch.from_numpy(packed.buffer.copy()), packed.layout)
    assert type(host).__name__ == type(ref).__name__ == type(dev).__name__
    names = FIELDS if isinstance(host, RaggedUnitBatch) else UnitBatch._fields
    for name in names:
        h, r, d = getattr(host, name), np.asarray(getattr(ref, name)), getattr(dev, name)
        assert h.dtype == r.dtype, name
        np.testing.assert_array_equal(h, r, err_msg=name)
        # uint16 travels as int16 bits on the torch side
        d = d.numpy().view(h.dtype) if h.dtype == np.uint16 else d.numpy()
        np.testing.assert_array_equal(d, h, err_msg=name)
    if isinstance(host, RaggedUnitBatch):
        assert host.row_len == ref.row_len == dev.row_len


def test_misaligned_sideband_is_copied_not_misread():
    """B odd: the f32 numeric field starts 2 bytes off a word; torch refuses
    such a dtype view, so the unpack copies those fields to aligned storage."""
    b = 5
    rb = RaggedUnitBatch(
        np.arange(4096, dtype=np.uint8), np.array([0, 3, 3, 9, 12, 12], np.int32),
        np.arange(b * 4, dtype=np.float32).reshape(b, 4) + 0.5,
        np.arange(b, dtype=np.float32) * 3, np.ones(b, np.float32), row_len=16)
    with assemble.forced("off"):
        packed = pack_batch(rb)
    buf = torch.from_numpy(packed.buffer.copy())
    with pytest.raises(RuntimeError, match="storage_offset"):
        buf[4096 + 2 * b:4096 + 2 * b + 16 * b].view(torch.float32)
    got = unpack_batch(buf, packed.layout)
    np.testing.assert_array_equal(got.numeric.numpy(), rb.numeric)
    np.testing.assert_array_equal(got.label.numpy(), rb.label)
    np.testing.assert_array_equal(got.offsets.numpy(), rb.offsets)


RAGGED_FIELDS = (((4096,), "|u1"), ((2,), "<u2"), ((2, 4), "<f4"), ((2,), "<f4"), ((2,), "<f4"))


@pytest.mark.parametrize("layout,item", [
    # the shard-aligned layouts the port refused until ROADMAP A10(a)
    # ported them: a multi-host group's count in a group or shard-segment
    # layout, and a flat pack of a 2-shard batch
    (("RaggedGroupSegments", RAGGED_FIELDS, (8, 2, 1, "u16delta")), "A10"),
    (("RaggedShardSegments", RAGGED_FIELDS, (8, 2, "u16delta")), "A10"),
    (("RaggedUnitBatch", RAGGED_FIELDS, (8, 2, "u16delta")), "A10"),
])
def test_unpack_refuses_layouts_not_ported(layout, item):
    """Since ROADMAP ``item`` these layouts unpack (none refuses any more):
    the port's numpy and torch unpacks give the JAX package's host unpack
    of the same bytes, field for field."""
    from twtml_tpu.features.batch import unpack_batch as jax_unpack

    buf = np.random.default_rng(3).integers(0, 200, 4096 + 4 + 48).astype(np.uint8)
    buf[4096:4100] = (1, 0, 2, 0)  # two small length deltas
    want = jax_unpack(buf, layout)
    for got in (unpack_batch(buf, layout), unpack_batch(torch.from_numpy(buf), layout)):
        fields = [getattr(got, f) for f in ("units", "offsets", "numeric", "label", "mask")]
        for g, w in zip(fields, (want.units, want.offsets, want.numeric, want.label,
                                 want.mask)):
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            np.testing.assert_array_equal(g.view(np.uint16) if g.dtype == np.int16 else g,
                                          np.asarray(w))
        assert got.num_shards == want.num_shards and got.row_len == want.row_len


CODED_FIELDS = (((2048,), "|u1"),) + RAGGED_FIELDS[1:]


@pytest.mark.parametrize("layout", [
    ("RaggedGroupSegments", CODED_FIELDS, (8, 1, 1, "u16delta", ("dict", 4096))),
    ("RaggedUnitBatch", CODED_FIELDS, (8, 1, "u16delta", ("dict", (4096,)))),
], ids=["group", "flat"])
def test_coded_layouts_unpack_as_the_jax_package_does(layout):
    """The digram-coded layouts (an all-zero units buffer codes to 2048
    codes of the zero pair, dictionary entry 0): the port's numpy and torch
    unpacks give the JAX package's host unpack, the 4096 raw zero units
    decoded."""
    rng = np.random.default_rng(5)
    buf = np.zeros(2048 + 4 + 48, np.uint8)
    buf[:2048] = 128  # CODE_BASE + 0
    buf[2048:] = rng.integers(0, 4, 52).astype(np.uint8)  # small deltas, numeric bytes
    want = jax_batch.unpack_batch(buf, layout)
    for got in (unpack_batch(buf, layout), unpack_batch(torch.from_numpy(buf.copy()), layout)):
        for f in FIELDS:
            g = getattr(got, f)
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            np.testing.assert_array_equal(g, np.asarray(getattr(want, f)), err_msg=f)
        assert np.asarray(got.units).shape[-1] == 4096


# ---- device decode ----------------------------------------------------------

@pytest.mark.parametrize("seed,shape", [(0, (1,)), (1, (16,)), (2, (257,)),
                                        (3, (4, 33)), (4, (2, 3, 8)), (5, (0,))])
def test_offsets_from_deltas_matches_jax(seed, shape):
    rng = np.random.default_rng(seed)
    deltas = rng.integers(0, OFFSET_DELTA_MAX + 1, size=shape).astype(np.uint16)
    deltas.reshape(-1)[:1] = OFFSET_DELTA_MAX  # the widest delta
    want = np.asarray(jax_ragged.offsets_from_deltas(deltas))
    for t in (torch.from_numpy(deltas.view(np.int16)), torch.from_numpy(deltas)):
        got = offsets_from_deltas(t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("unit_dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("seed,rows,row_len", [(0, 1, 2), (1, 8, 16), (2, 33, 64), (3, 50, 8)])
def test_ragged_repad_matches_jax(unit_dtype, seed, rows, row_len):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, row_len + 1, size=rows)
    lens[rng.random(rows) < 0.2] = 0  # pad rows and empty texts
    total = int(lens.sum())
    high = 256 if unit_dtype == np.uint8 else 65536
    units = np.zeros(max(4096, -(-total // 4096) * 4096), unit_dtype)
    units[:total] = rng.integers(0, high, size=total)
    units[:total:7] = rng.integers(65, 91, size=len(units[:total:7]))  # 'A'-'Z'
    offsets = np.zeros(rows + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    want_buf, want_len = jax_ragged.ragged_repad(
        jnp.asarray(units), jnp.asarray(offsets), row_len)
    t_units = torch.from_numpy(units.view(np.int16) if unit_dtype == np.uint16 else units)
    got_buf, got_len = ragged_repad(t_units, torch.from_numpy(offsets), row_len)
    assert got_buf.dtype == torch.int32 and got_len.dtype == torch.int32
    np.testing.assert_array_equal(got_buf.numpy(), np.asarray(want_buf))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


# ---- the step ---------------------------------------------------------------

def packed_chunks(source_name, size):
    """4 consecutive chunks of ``size`` tweets, each featurized and packed
    by each package (both native)."""
    if source_name == "synthetic":
        ours, ref = synthetic(4 * size, 3)
    else:
        ours = list(itertools.islice(ReplayFileSource(FIXTURE, loop=True).produce(), 40))
        ref = list(itertools.islice(JaxReplay(FIXTURE, loop=True).produce(), 40))
    f, jf = Featurizer(now_ms=NOW_MS), JaxFeaturizer(now_ms=NOW_MS)
    with modes("on", "on"):
        return (
            [f.featurize_batch_ragged(ours[i:i + size], row_bucket=size, pack=True)
             for i in range(0, 4 * size, size)],
            [jf.featurize_batch_ragged(ref[i:i + size], row_bucket=size, pack=True)
             for i in range(0, 4 * size, size)],
        )


CASES = [("synthetic", 256), ("replay", 10)]


@pytest.mark.parametrize("source_name,size", CASES)
def test_packed_steps_match_jax_model(port_native, source_name, size):
    ours, ref = packed_chunks(source_name, size)
    port = StreamingLinearRegressionWithSGD(device="cpu", quality=True)
    jax_model = JaxLinear(quality=True)
    for i, (b, jb) in enumerate(zip(ours, ref)):
        assert_packed_equal(b, jb)
        out, jout = port.step(b), jax_model.step(jb)
        if i == 0:
            for k in STATS:
                got, want = float(getattr(out, k)), float(getattr(jout, k))
                assert round_half_up(got) == round_half_up(want), k
                assert got == pytest.approx(want, rel=1e-6), k
        assert float(out.count) == float(jout.count)
        np.testing.assert_allclose(
            port.latest_weights, jax_model.latest_weights, rtol=2e-3, atol=2e-3,
            err_msg=f"weights after batch {i + 1}",
        )


@pytest.mark.parametrize("source_name,size", CASES + [("synthetic", 33)])
def test_packed_run_bitwise_equals_padded_run(port_native, source_name, size):
    packed, _ = packed_chunks(source_name, size)
    if source_name == "synthetic":
        statuses = synthetic(4 * size, 3)[0]
    else:
        statuses = list(itertools.islice(ReplayFileSource(FIXTURE, loop=True).produce(), 40))
    f = Featurizer(now_ms=NOW_MS)
    padded = [f.featurize_batch_units(statuses[i:i + size], row_bucket=size)
              for i in range(0, 4 * size, size)]
    # the unpacked ragged batch too: the step takes a host RaggedUnitBatch
    ragged = [unpack_batch(pb.buffer, pb.layout) for pb in packed]
    models = [StreamingLinearRegressionWithSGD(device="cpu", quality=True)
              for _ in range(3)]
    for batches in zip(packed, ragged, padded):
        outs = [m.step(b) for m, b in zip(models, batches)]
        for out in outs[:2]:
            for k in ("predictions", "quality") + STATS:
                assert torch.equal(getattr(out, k), getattr(outs[2], k)), k
        for m in models[:2]:
            np.testing.assert_array_equal(m.latest_weights, models[2].latest_weights)


# ---- the app and its flags --------------------------------------------------

CLOSED = "http://127.0.0.1:9"  # a closed loopback port: publishing fails fast


def app(*argv, batches=0):
    conf = ConfArguments().parse([
        "--backend", "cpu", "--seconds", "0", "--lightning", CLOSED,
        "--twtweb", CLOSED, "--webTimeout", "0.2", *argv,
    ])
    return run(conf, max_batches=batches)


def test_app_default_wire_is_ragged_packed_native(port_native, monkeypatch, capsys):
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    args = ["--source", "synthetic", "--batchBucket", "64"]
    native.reset_counters()
    ragged = app(*args, batches=3)
    # fills: the warm-up's all-padding batch, 3 trained batches and the 4th,
    # featurized before the pipeline's cap check refused it; packs happen
    # at dispatch: the warm-up and the 3 trained batches
    assert native.COUNTERS == {"fills_native": 5, "fills_degraded": 0,
                               "packs_native": 4, "packs_degraded": 0}
    ragged_lines = capsys.readouterr().out
    padded = app(*args, "--wire", "padded", batches=3)
    assert capsys.readouterr().out == ragged_lines
    for r, p in zip(ragged["steps"], padded["steps"]):
        assert (r["wire"], r["native_fill"], r["native_pack"]) == ("ragged", True, True)
        assert (p["wire"], p["native_fill"], p["native_pack"]) == ("padded", False, False)
        assert 0 < r["wire_bytes"] < p["wire_bytes"]
        assert set(r["featurize_substages_ms"]) == {"encode", "wire_build", "pack"}
        assert set(p["featurize_substages_ms"]) == {"encode", "wire_build", "numeric"}
        assert {k: r[k] for k in STATS} == {k: p[k] for k in STATS}
        assert r["quality"] == p["quality"]


@pytest.mark.parametrize("flags", [
    ("--featurizeNative", "off"), ("--wireAssemble", "off"),
    ("--featurizeNative", "off", "--wireAssemble", "off"),
])
def test_app_numpy_paths_print_the_same_lines(port_native, monkeypatch, capsys, flags):
    monkeypatch.setenv("TWTML_NOW_MS", str(NOW_MS))
    args = ["--source", "replay", "--replayFile", FIXTURE, "--batchBucket", "4"]
    try:
        native_run = app(*args)
        lines = capsys.readouterr().out
        numpy_run = app(*args, *flags)
        assert capsys.readouterr().out == lines
    finally:
        featurize_native.configure("auto")
        assemble.configure("auto")
    assert all(s["native_fill"] and s["native_pack"] for s in native_run["steps"])
    assert [s["native_fill"] for s in numpy_run["steps"]] == [
        "--featurizeNative" not in flags] * 3
    assert [s["native_pack"] for s in numpy_run["steps"]] == [
        "--wireAssemble" not in flags] * 3


@pytest.mark.parametrize("wire,effective", [("auto", "ragged"), ("ragged", "ragged"),
                                            ("padded", "padded")])
def test_wire_flag_resolves(wire, effective):
    conf = ConfArguments().parse(["--seconds", "0", "--wire", wire])
    assert conf.effective_wire() == effective


def test_flag_defaults_and_usage():
    conf = ConfArguments()
    assert (conf.wire, conf.featurizeNative, conf.wireAssemble) == ("auto", "auto", "auto")
    usage = conf.usage()
    for flag in ("--wire <auto|ragged|padded>", "--featurizeNative <auto|on|off>",
                 "--wireAssemble <auto|on|off>"):
        assert flag in usage


@pytest.mark.parametrize("flag,value", [("--wire", "stacked"), ("--featurizeNative", "yes"),
                                        ("--wireAssemble", "1")])
def test_bad_wire_flags_exit_1(flag, value, capsys):
    with pytest.raises(SystemExit) as exc:
        ConfArguments().parse([flag, value])
    assert exc.value.code == 1
    assert flag in capsys.readouterr().err
