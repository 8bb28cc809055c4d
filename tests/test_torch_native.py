"""The port's native host library and its arena (features/native.py,
features/arena.py): concurrent builds, the degrade seam of a stale library,
the native counters, and the lease lifetime of the wire buffers.

The tests that need the library skip only where there is no g++; a build
that fails fails them."""

import gc
import hashlib
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from twtml_tpu_torch.features import arena, assemble, featurize_native, native
from twtml_tpu_torch.features.batch import PackedBatch, RaggedUnitBatch
from twtml_tpu_torch.features.featurizer import Featurizer
from twtml_tpu_torch.streaming.sources import SyntheticSource

REPO = Path(__file__).resolve().parents[1]
NOW_MS = 1_700_000_000_000
FIELDS = ("units", "offsets", "numeric", "label", "mask")


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ not on PATH: the native host path cannot be built")


@pytest.fixture
def port_native(gxx):
    assert native.get_lib() is not None, "the native library did not build or load"


def statuses(n=48, seed=3):
    return list(SyntheticSource(total=n, seed=seed, base_ms=NOW_MS).produce())


def numpy_batch(sts, **kw):
    with featurize_native.forced("off"), assemble.forced("off"):
        return Featurizer(now_ms=NOW_MS).featurize_batch_ragged(sts, **kw)


def assert_same(got, want):
    if isinstance(want, PackedBatch):
        assert got.layout == want.layout
        np.testing.assert_array_equal(got.buffer, want.buffer)
        return
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.row_len == want.row_len


# ---- the build ----------------------------------------------------------------

BUILD_AND_FILL = textwrap.dedent("""
    import hashlib, json, sys
    from pathlib import Path
    sys.path.insert(0, sys.argv[2])
    from twtml_tpu_torch.features import native
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.streaming.sources import SyntheticSource
    native.BUILD_DIR = Path(sys.argv[1])
    sts = list(SyntheticSource(total=300, seed=5, base_ms=1_700_000_000_000).produce())
    packed = Featurizer(now_ms=1_700_000_000_000).featurize_batch_ragged(
        sts, row_bucket=301, pack=True)
    print(json.dumps({"lib": str(native.get_lib().path), "counters": native.COUNTERS,
                      "sha": hashlib.sha256(packed.buffer.tobytes()).hexdigest()}))
""")


def test_two_processes_build_at_once_and_fill_byte_equal(gxx, tmp_path):
    build_dir = tmp_path / "build"
    procs = [
        subprocess.Popen([sys.executable, "-c", BUILD_AND_FILL, str(build_dir), str(REPO)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    results = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        assert "unavailable" not in err and "lacks" not in err, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert results[0] == results[1]
    assert results[0]["counters"] == {"fills_native": 1, "fills_degraded": 0,
                                      "packs_native": 1, "packs_degraded": 0}
    lib = Path(results[0]["lib"])
    assert lib == native.library_path(build_dir) and lib.exists()
    # no temporary left behind: each build wrote its own name, then replaced
    assert sorted(p.name for p in build_dir.iterdir()) == [lib.name, lib.name + ".lock"]
    want = numpy_batch(statuses(300, 5), row_bucket=301, pack=True)
    assert results[0]["sha"] == hashlib.sha256(want.buffer.tobytes()).hexdigest()


def test_library_is_named_by_sources_and_flags(tmp_path, monkeypatch):
    first = native.library_path(tmp_path)
    assert first.parent == tmp_path and first.name.startswith("libtwtml_native-")
    assert native.library_path(tmp_path) == first
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("-DTWTML_TEST_FLAG",))
    assert native.library_path(tmp_path) != first
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "elsewhere")
    assert native.library_path().parent == tmp_path / "elsewhere"


def test_failed_build_raises_with_the_compiler_error(gxx, tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(tmp_path / "build")
    # no library and no temporary: only the lock file
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        native.library_path(tmp_path / "build").name + ".lock"]


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build(tmp_path)


# ---- the degrade seam ----------------------------------------------------------

STALE = {
    "featurize_wire": """
        #include <cstdint>
        extern "C" int64_t wire_assemble(const void* const*, const void* const*,
            const void* const*, const void* const*, const void* const*, int64_t,
            int64_t, int64_t, int64_t, int64_t, int64_t, const uint8_t*, int64_t,
            uint8_t*, int64_t*, uint8_t*, int64_t, int64_t* e) { *e = 0; return -1; }
    """,
    "wire_assemble": """
        #include <cstdint>
        extern "C" int64_t featurize_wire(const void*, int64_t, const void*,
            const void*, const void*, const void*, int64_t, int64_t, int64_t,
            int64_t, int64_t, void*, void*, void*, void*, void*) { return -1; }
    """,
}


def stale_library(tmp_path, missing):
    src = tmp_path / "stale.cpp"
    src.write_text(STALE[missing])
    so = tmp_path / "stale.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(so), str(src)],
                   check=True, capture_output=True)
    return so


@pytest.mark.parametrize("missing", ["featurize_wire", "wire_assemble"])
def test_stale_library_warns_once_and_degrades_byte_equal(gxx, tmp_path, monkeypatch, missing):
    with pytest.warns(RuntimeWarning, match=f"lacks {missing}") as record:
        lib = native.NativeLibrary(stale_library(tmp_path, missing))
    assert len(record) == 1
    assert getattr(lib, missing) is None
    monkeypatch.setattr(native, "get_lib", lambda: lib)
    sts = statuses()
    want = numpy_batch(sts, row_bucket=48, pack=True)
    native.reset_counters()
    with featurize_native.forced("on"), assemble.forced("on"):
        got = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(sts, row_bucket=48, pack=True)
    assert_same(got, want)
    degraded = "fills_degraded" if missing == "featurize_wire" else "packs_degraded"
    assert native.COUNTERS[degraded] == 1
    # the entry the stale library has still runs, and here refuses its input
    assert native.COUNTERS["fills_native"] == native.COUNTERS["packs_native"] == 0


def test_no_library_warns_once_and_runs_numpy(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    native.get_lib.cache_clear()
    try:
        with pytest.warns(RuntimeWarning, match="native library unavailable") as record:
            assert native.get_lib() is None
            assert native.get_lib() is None
        assert len(record) == 1
        sts = statuses(20)
        native.reset_counters()
        got = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(sts, row_bucket=20, pack=True)
        assert native.COUNTERS == {"fills_native": 0, "fills_degraded": 1,
                                   "packs_native": 0, "packs_degraded": 1}
    finally:
        native.get_lib.cache_clear()
    assert_same(got, numpy_batch(sts, row_bucket=20, pack=True))


# ---- counters and modes --------------------------------------------------------

@pytest.mark.parametrize("fill_mode,pack_mode", [("auto", "auto"), ("on", "off"),
                                                 ("off", "on"), ("off", "off")])
def test_counters_follow_the_modes(port_native, fill_mode, pack_mode):
    sts = statuses()
    native.reset_counters()
    with featurize_native.forced(fill_mode), assemble.forced(pack_mode):
        got = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(sts, row_bucket=48, pack=True)
    assert native.COUNTERS == {
        "fills_native": int(fill_mode != "off"), "fills_degraded": 0,
        "packs_native": int(pack_mode != "off"), "packs_degraded": 0,
    }
    assert_same(got, numpy_batch(sts, row_bucket=48, pack=True))


@pytest.mark.parametrize("module", [featurize_native, assemble])
def test_configure_validates(module):
    prev = module.mode()
    with pytest.raises(ValueError, match="auto"):
        module.configure("fast")
    with module.forced("off"):
        assert module.mode() == "off" and not module.available()
    assert module.mode() == prev


def test_lease_views_keep_every_word_field_aligned():
    for b in (1, 3, 16, 16385):
        lease, units, offsets, numeric, label, mask, ptrs = featurize_native._lease_views(
            b, 4096, np.uint8)
        base = lease.buf.ctypes.data
        for arr, ptr in zip((units, offsets, numeric, label, mask), ptrs):
            assert arr.ctypes.data == ptr and (ptr - base) % 4 == 0
        assert offsets.shape == (b + 1,) and numeric.shape == (b, 4)
        lease.retire()


# ---- the arena -----------------------------------------------------------------

def test_retired_lease_is_recycled():
    a = arena.WireArena()
    first = a.lease(1000)
    first.retire()
    first.retire()  # idempotent
    second = a.lease(1000)
    assert second.buf is first.buf
    assert a.stats()["recycled"] == 1 and a.stats()["misses"] == 1


def test_discarded_lease_is_never_reused():
    a = arena.WireArena()
    lease = a.lease(64)
    lease.discard()
    lease.retire()  # already closed: no effect
    assert a.lease(64).buf is not lease.buf
    assert a.stats()["free_buffers"] == 0


def test_pool_cap_bounds_free_bytes():
    a = arena.WireArena(max_pool_bytes=1500)
    leases = [a.lease(1000) for _ in range(3)]
    for lease in leases:
        lease.retire()
    assert a.stats() == {"in_use": 0, "free_buffers": 1, "free_bytes": 1000,
                         "recycled": 0, "misses": 3}


def test_unpacked_fill_lease_is_discarded_by_the_gc_backstop(port_native):
    gc.collect()
    in_use = arena.get_arena().stats()["in_use"]
    with featurize_native.forced("on"):
        rb = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(statuses(), row_bucket=48)
    assert isinstance(rb, RaggedUnitBatch) and rb.lease is not None
    assert arena.get_arena().stats()["in_use"] == in_use + 1
    buf = rb.lease.buf
    del rb
    gc.collect()
    assert arena.get_arena().stats()["in_use"] == in_use
    assert all(b is not buf for bufs in arena.get_arena()._free.values() for b in bufs)


def test_packing_returns_the_fill_lease_and_keeps_the_wire_lease(port_native):
    """pack=True copies the fill into the wire buffer, so the fill's lease
    goes straight back to the pool; the wire buffer's lease stays out until
    the step's copy has read it (the app retires it then)."""
    want = numpy_batch(statuses(), row_bucket=48, pack=True)
    gc.collect()
    in_use = arena.get_arena().stats()["in_use"]
    featurizer = Featurizer(now_ms=NOW_MS)
    packed = featurizer.featurize_batch_ragged(statuses(), row_bucket=48, pack=True)
    assert arena.get_arena().stats()["in_use"] == in_use + 1
    assert packed.lease is not None and packed.buffer.base is packed.lease.buf
    packed.lease.retire()
    again = featurizer.featurize_batch_ragged(statuses(), row_bucket=48, pack=True)
    assert again.lease.buf is packed.lease.buf  # recycled, same size
    assert_same(again, want)
    again.lease.retire()
    assert arena.get_arena().stats()["in_use"] == in_use
