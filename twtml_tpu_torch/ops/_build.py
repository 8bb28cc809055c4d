"""Build and load the port's CUDA kernels.

Each kernel source in ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, from the sources in the checkout
only, into ``build/twtml_tpu_torch/`` at the repository root; a library is
named by a hash of its source and flags, so an edited source rebuilds. All
requested sources compile in parallel, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from . import fused_sgd

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "twtml_tpu_torch"
# library name -> (source, extra nvcc flags)
SOURCES = {
    "fused_sgd": ("fused_sgd.cu", fused_sgd.NVCC_DEFINES),
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    source, flags = SOURCES[name]
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS + flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every named kernel library that is not built yet, all
    ``nvcc`` processes at once; returns name -> library path. The compiler's
    register and shared-memory report lands beside each library as
    ``<library>.log``. Raises with the compiler's output when one fails."""
    names = list(SOURCES if names is None else names)
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        source, flags = SOURCES[name]
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC / source)]
        procs[name] = (
            tmp,
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
        )
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            continue
        Path(str(paths[name]) + ".log").write_text(out)
        os.replace(tmp, paths[name])  # atomic: a reader never sees a partial .so
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if needed (cached per process)."""
    return ctypes.CDLL(str(build([name])[name]))
