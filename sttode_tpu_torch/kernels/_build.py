"""Build the port's CUDA kernels with nvcc and load them through ctypes.

The sources in ``sttode_tpu_torch/csrc/*.cu`` are compiled at first use into
one shared library with a plain C interface, for Hopper only
(``sm_90a``). The library file is keyed on a hash of the sources and the
compiler flags and lives in ``sttode_tpu_torch/_build/`` (listed in
``.gitignore``), so a process rebuilds only when the sources change.
Importing this module compiles nothing and does not need ``nvcc``.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.
There is no fallback: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libsttode_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
                       "default /usr/local/cuda/bin): the CUDA kernels of "
                       "sttode_tpu_torch are built with nvcc at first use")


def build() -> Path:
    """Compile the library if it is not built yet; return its path. The
    compiler's output (``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept beside it as ``<library>.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(f) for f in _sources() if f.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (f"$ {' '.join(cmd)}\n# {time.perf_counter() - t0:.1f} s, "
           f"exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
    path.with_name(path.name + ".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building sttode_tpu_torch kernels:\n"
                           f"{log}")
    os.replace(tmp, path)   # atomic: a concurrent build sees all or nothing
    return path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.mhgsa_fwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
            lib.mhgsa_fwd.restype = _I
            lib.select_decode_fwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,
                                              _I, _I, _I, _I, _I, _I, _I, _P]
            lib.select_decode_fwd.restype = _I
            lib.sttode_error_string.argtypes = [_I]
            lib.sttode_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load().sttode_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
