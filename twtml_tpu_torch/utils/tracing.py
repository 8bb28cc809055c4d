"""Profiler hooks of ``--profileDir`` (counterpart of
``twtml_tpu/utils/tracing.py``, which wraps ``jax.profiler``).

``Tracer(profile_dir, device)`` wraps ``torch.profiler`` with a no-op mode
when ``profile_dir`` is empty, so the app calls it unconditionally:

    tracer = Tracer(conf.profileDir, model.device)
    tracer.start()
    ... the stream ...
    tracer.stop()

The trace is a Chrome-trace JSON file (``chrome://tracing``, Perfetto)
named ``twtml-<pid>-<ms>.pt.trace.json`` under ``profile_dir``, where the
JAX package writes TensorBoard xplane files. It records the host's ops and
``annotate`` regions on every thread (the stream runs on its scheduler
thread) and, for a model on ``cuda``, the card's kernels and copies: a
tracer that cannot record CUDA activity there raises rather than write a
host-only trace. ``start`` and ``stop`` are idempotent.
"""

from __future__ import annotations

import os
import time

from torch.profiler import record_function

from . import get_logger

log = get_logger("tracing")


class Tracer:
    def __init__(self, profile_dir: str = "", device="cpu"):
        self.profile_dir = profile_dir
        self.cuda = str(device).startswith("cuda")
        self.path = ""
        self._prof = None

    @property
    def enabled(self) -> bool:
        return bool(self.profile_dir)

    def start(self) -> None:
        if not self.enabled or self._prof is not None:
            return
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile, supported_activities

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            if ProfilerActivity.CUDA not in supported_activities():
                raise RuntimeError("--profileDir: torch.profiler cannot record CUDA "
                                   "activity in this build; no trace written")
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(
            activities=activities,
            experimental_config=_ExperimentalConfig(profile_all_threads=True),
        )
        self._prof.start()
        log.info("torch.profiler trace started -> %s", self.profile_dir)

    def stop(self) -> str:
        """End the trace and write it; returns its path ("" when off)."""
        prof, self._prof = self._prof, None
        if prof is None:
            return self.path
        prof.stop()
        if self.cuda and not any(
                getattr(ev, "device_type", None) is not None and ev.device_type.name == "CUDA"
                for ev in prof.events()):
            raise RuntimeError("--profileDir: the profiler recorded no CUDA activity on "
                               "the card; no trace written")
        os.makedirs(self.profile_dir, exist_ok=True)
        self.path = os.path.join(
            self.profile_dir, f"twtml-{os.getpid()}-{int(time.time() * 1e3)}.pt.trace.json")
        prof.export_chrome_trace(self.path)
        log.info("torch.profiler trace written -> %s", self.path)
        return self.path

    def __enter__(self) -> "Tracer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def annotate(name: str):
    """A named region in the trace's timeline (``record_function``); some
    10 us when no trace runs."""
    return record_function(name)
