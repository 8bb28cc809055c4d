"""Model checkpoint/resume (counterpart of
``twtml_tpu/checkpoint/checkpointer.py``), archive for archive.

One ``ckpt-<step:012d>.npz`` a save, written to a temporary file and
renamed into place; the weights under ``w`` (one array) or ``w__<key>`` (a
flat dict), and the meta JSON under ``__meta__`` as uint8 bytes. The names,
keys and meta are the JAX package's, so each package restores the other's
archives. ``keep_last`` bounds the disk.

Integrity, as the sentinel's rollback target needs it:

- the meta records each array's CRC32, dtype and shape; ``restore``
  re-hashes and falls back past an archive whose bytes no longer match;
- the meta records whether every float array was finite. ``save`` writes
  non-finite weights under a ``quarantine-`` name that ``restore`` never
  reads, so a diverged model cannot rotate good archives out of
  ``keep_last``; ``restore`` also skips an archive holding non-finite
  weights. A rollback therefore lands on a verified, finite state.
"""

from __future__ import annotations

import io
import json
import os
import re
import tempfile
import zipfile
import zlib

import numpy as np

from ..telemetry import metrics as _metrics
from ..utils import get_logger

log = get_logger("checkpoint")

# finished archives only: a stray name with the prefix must not break the
# step parse
_CKPT_RE = re.compile(r"^ckpt-(\d+)\.npz$")

# what a torn, truncated or foreign archive raises on load
_UNREADABLE = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile,
               zlib.error)


def _array_crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def _is_finite(a: np.ndarray) -> bool:
    """Whether an array holds only finite values (non-float dtypes are)."""
    if not (np.issubdtype(a.dtype, np.floating)
            or np.issubdtype(a.dtype, np.complexfloating)):
        return True
    return bool(np.isfinite(a).all())


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._sweep_stale_tmp()

    def _sweep_stale_tmp(self) -> None:
        """A kill between the temporary write and the rename leaves a
        ``*.tmp``: sweep them (this process is the directory's only
        writer)."""
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                try:
                    os.unlink(os.path.join(self.directory, name))
                    log.info("swept stale checkpoint temp file %s", name)
                except OSError:
                    log.warning("could not sweep %s", name)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step:012d}.npz")

    @staticmethod
    def _as_arrays(weights) -> "dict[str, np.ndarray]":
        if isinstance(weights, dict):
            return {f"w__{key}": np.asarray(value) for key, value in weights.items()}
        return {"w": np.asarray(weights)}

    def save(self, step: int, weights, metadata: "dict | None" = None) -> str:
        """Write the weights (an array or a flat dict of arrays) and the
        meta at ``step``, atomically; prune beyond ``keep_last``. Non-finite
        weights go to a ``quarantine-`` name instead (counted)."""
        arrays = self._as_arrays(weights)
        meta = dict(metadata or {})
        meta["step"] = int(step)
        finite = all(_is_finite(a) for a in arrays.values())
        meta["finite"] = finite
        meta["arrays"] = {
            key: {"crc": _array_crc(a), "dtype": str(a.dtype), "shape": list(a.shape)}
            for key, a in arrays.items()
        }
        buf = io.BytesIO()
        np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode("utf-8"),
                                             dtype=np.uint8), **arrays)
        final = (os.path.join(self.directory, f"quarantine-ckpt-{int(step):012d}.npz")
                 if not finite else self._path(step))
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(buf.getvalue())
            os.replace(tmp, final)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        if not finite:
            _metrics.get_registry().counter("checkpoint.quarantined").inc()
            log.error("weights at step %d are NON-FINITE: quarantined to %s instead "
                      "of overwriting good history (restore ignores it)", step, final)
            return final
        self._prune()
        log.info("checkpoint saved: %s", final)
        return final

    def _checkpoints(self) -> "list[str]":
        try:
            return sorted(n for n in os.listdir(self.directory) if _CKPT_RE.match(n))
        except FileNotFoundError:
            return []

    def _prune(self) -> None:
        for name in self._checkpoints()[: -self.keep_last]:
            try:
                os.unlink(os.path.join(self.directory, name))
            except OSError:
                log.warning("could not prune %s", name)

    def latest_step(self) -> "int | None":
        names = self._checkpoints()
        if not names:
            return None
        return int(_CKPT_RE.match(names[-1]).group(1))

    def _read_meta(self, name: str) -> "dict | None":
        """One archive's meta, its arrays untouched (np.load is lazy)."""
        try:
            with np.load(os.path.join(self.directory, name)) as data:
                return json.loads(bytes(data["__meta__"]).decode("utf-8"))
        except _UNREADABLE:
            log.warning("unreadable checkpoint meta in %s; skipped", name)
            return None

    def latest_meta(self) -> "dict | None":
        """The newest readable archive's meta (unverified)."""
        for name in reversed(self._checkpoints()):
            meta = self._read_meta(name)
            if meta is not None:
                return meta
        return None

    def oldest_meta(self) -> "dict | None":
        """The oldest retained archive's meta: journal segments retire only
        once every archive a fallback restore could land on covers them."""
        for name in self._checkpoints():
            meta = self._read_meta(name)
            if meta is not None:
                return meta
        return None

    @staticmethod
    def _verify(path: str, meta: dict, arrays: "dict[str, np.ndarray]") -> bool:
        """Integrity and finiteness of one loaded archive; False sends the
        caller to an older one. An archive without the integrity meta
        verifies by recomputed finiteness alone."""
        reg = _metrics.get_registry()
        declared = meta.get("arrays")
        if declared is not None:
            if sorted(declared) != sorted(arrays):
                log.warning("corrupt checkpoint %s: archive keys %s do not match the "
                            "declared meta %s; trying older",
                            path, sorted(arrays), sorted(declared))
                reg.counter("checkpoint.restore_corrupt").inc()
                return False
            for key, spec in declared.items():
                a = arrays[key]
                if (str(a.dtype) != spec["dtype"] or list(a.shape) != list(spec["shape"])
                        or _array_crc(a) != spec["crc"]):
                    log.warning("corrupt checkpoint %s: array %r failed CRC/shape/dtype "
                                "verification; trying older", path, key)
                    reg.counter("checkpoint.restore_corrupt").inc()
                    return False
        finite = meta.get("finite")
        if finite is None:
            finite = all(_is_finite(a) for a in arrays.values())
        if not finite:
            log.warning("checkpoint %s holds NON-FINITE weights (a diverged save); "
                        "trying older", path)
            reg.counter("checkpoint.restore_nonfinite").inc()
            return False
        return True

    def restore(self, step: "int | None" = None):
        """(weights, meta) of the given or the newest VERIFIED archive, or
        None: falls back past unreadable, corrupt and non-finite archives,
        each with its own warning."""
        names = self._checkpoints()
        if step is not None:
            names = [n for n in names if n == os.path.basename(self._path(step))]
        for name in reversed(names):
            path = os.path.join(self.directory, name)
            try:
                with np.load(path) as data:
                    meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
                    arrays = {k: data[k] for k in data.files if k != "__meta__"}
            except _UNREADABLE:
                log.warning("unreadable checkpoint %s; trying older", path)
                continue
            if not self._verify(path, meta, arrays):
                continue
            if sorted(arrays) == ["w"]:
                return arrays["w"], meta
            return {k[len("w__"):]: a for k, a in arrays.items()}, meta
        return None
