"""Monotonic run ids and config fingerprints (counterpart of
``twtml_tpu/utils/runid.py``).

- ``next_run_id()``: a machine-local increasing integer, kept in a small
  counter file that is read, incremented and rewritten under an exclusive
  ``flock``, so concurrent launches get distinct ids. The file is the JAX
  package's (``TWTML_RUN_ID_FILE``, else ``twtml-run-id`` in the temporary
  directory), so runs of both packages draw from one sequence.
- ``config_fingerprint(conf_or_dict)``: a 12-hex-digit hash over the scalar
  config values; the historian's run header and baseline carry it.
"""

from __future__ import annotations

import hashlib
import os
import tempfile

ENV_RUN_ID_FILE = "TWTML_RUN_ID_FILE"


def _counter_path() -> str:
    override = os.environ.get(ENV_RUN_ID_FILE, "")
    if override:
        return override
    return os.path.join(tempfile.gettempdir(), "twtml-run-id")


def next_run_id() -> int:
    """Allocate the next run id (1, 2, 3, ...). An unreadable counter file
    restarts at 1 rather than failing the run: ids are a join key, not a
    correctness invariant."""
    path = _counter_path()
    try:
        import fcntl

        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            raw = os.read(fd, 64).decode("ascii", "replace").strip()
            try:
                current = int(raw)
            except ValueError:
                current = 0
            nxt = current + 1
            os.lseek(fd, 0, os.SEEK_SET)
            os.ftruncate(fd, 0)
            os.write(fd, str(nxt).encode("ascii"))
            return nxt
        finally:
            os.close(fd)  # releases the flock too
    except OSError:
        return 1


def config_fingerprint(conf) -> str:
    """12-hex-digit stable hash over the scalar config values of a config
    object (``vars()`` is taken) or a dict; private attributes, callables
    and non-scalars are skipped."""
    d = conf if isinstance(conf, dict) else vars(conf)
    items = sorted(
        (k, v) for k, v in d.items()
        if not k.startswith("_") and isinstance(v, (str, int, float, bool))
    )
    blob = "\n".join(f"{k}={v!r}" for k, v in items).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:12]
