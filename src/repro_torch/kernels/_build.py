"""Build the port's CUDA sources at first use and load them with ``ctypes``.

Each ``kernels/<name>/csrc/<name>.cu`` exposes a plain C entry point that
launches its kernel on a given stream and returns ``cudaGetLastError()``.
It is compiled by ``nvcc`` for ``sm_90a`` into one shared library per
source, under ``build/kernels`` at the repository root (git-ignored).  A
library's file name carries a
hash of its sources and flags, so an edited source is rebuilt and never
loaded stale.  Nothing here runs at import time: the CPU tests import
every module without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["KERNEL_SOURCES", "NVCC_FLAGS", "build", "load", "check"]

_KERNELS_DIR = Path(__file__).resolve().parent

#: Every CUDA source of the port, one shared library each.
KERNEL_SOURCES = (
    _KERNELS_DIR / "spmm_blocked" / "csrc" / "spmm_blocked.cu",
    _KERNELS_DIR / "spmm_ema" / "csrc" / "spmm_ema.cu",
    _KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention.cu",
    _KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention_sm90.cu",
)

#: Headers every source may include (part of each library's hash).
_HEADERS = tuple(sorted((_KERNELS_DIR / "csrc").glob("*.cuh")))

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)

_LOCK = threading.Lock()
_LOADED: Dict[Path, ctypes.CDLL] = {}


def _build_dir() -> Path:
    # src/repro_torch/kernels/_build.py -> repository root
    return _KERNELS_DIR.parents[2] / "build" / "kernels"


def _library_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (source,) + _HEADERS:
        h.update(path.read_bytes())
    return _build_dir() / f"{source.stem}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(sources: Sequence[Path] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{source stem: seconds}`` for the sources compiled by this
    call (libraries already built cost nothing).  Raises ``RuntimeError``
    with the compiler's output if any compilation fails.
    """
    pending = []
    for source in sources:
        lib = _library_path(Path(source))
        if not lib.exists():
            pending.append((Path(source), lib))
    if not pending:
        return {}
    _build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    started = time.perf_counter()
    procs = []
    for source, lib in pending:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
        procs.append((source, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    seconds, failures = {}, []
    for source, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        seconds[source.stem] = time.perf_counter() - started
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{source.name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)  # atomic: a reader never sees half a library
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built on first use."""
    source = Path(source)
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(_library_path(source)))
            _LOADED[source] = lib
        return lib


def build_log(source: Path) -> str:
    """The compiler's output (``-Xptxas -v``) for ``source``'s library."""
    log = _library_path(Path(source)).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {status}")
