"""Build the port's CUDA kernels with nvcc and load them through ctypes.

The sources in ``sttode_tpu_torch/csrc/*.cu`` are compiled at first use, one
``nvcc`` process per source, all started together, for Hopper only
(``sm_90a``); the objects are then linked into one shared library with a
plain C interface. The library file is keyed on a hash of the sources and
the compiler flags and lives in ``sttode_tpu_torch/_build/`` (listed in
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

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the geodesic-attention entry points end in (metric, curvature, stream):
# metric 0 = oblique, 1 = poincaré
_SIGNATURES = {
    "mhgsa_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "mhgsa_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _F, _P],
    "select_decode_fwd": [_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_mhgsa_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "packed_mhgsa_bwd": [_P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _P],
    "flash_mhgsa_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "flash_mhgsa_dq": [_P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _F, _P],
    "flash_mhgsa_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _F, _P],
}


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
    compilers' output (``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept beside it as ``<library>.log``."""
    path = library_path()
    if path.exists():
        return path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{path.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in (f for f in _sources() if f.suffix == ".cu"):
        obj = BUILD_DIR / f"{stem}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], False
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n# exit {proc.returncode}\n{out}")
        failed |= proc.returncode != 0
    tmp = path.with_name(f"{stem}.tmp")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n# exit {proc.returncode}\n"
                   f"{proc.stdout}{proc.stderr}")
        failed = proc.returncode != 0
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    text = (f"# {len(jobs)} sources, {time.perf_counter() - t0:.1f} s\n"
            + "\n".join(log))
    path.with_name(path.name + ".log").write_text(text)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building sttode_tpu_torch kernels:\n"
                           f"{text}")
    os.replace(tmp, path)   # atomic: a concurrent build sees all or nothing
    return path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I
            lib.sttode_error_string.argtypes = [_I]
            lib.sttode_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load().sttode_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


class Entry:
    """One C entry point of the library, looked up at its first call and
    kept, so that a launch does no library or symbol lookup. ``fn`` may be
    set to another library's function of the same signature (a timing
    script's variant build)."""

    __slots__ = ("name", "fn")

    def __init__(self, name: str):
        self.name, self.fn = name, None

    def __call__(self, *args) -> int:
        fn = self.fn
        if fn is None:
            fn = self.fn = getattr(load(), self.name)
        return fn(*args)


# the raw handle of a device's current stream, read without building a
# torch.cuda.Stream object (as PyTorch's own generated launchers read it)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def launch(entry: Entry, device: torch.device, *args) -> int:
    """Call ``entry(*args, stream)`` on ``device`` with the raw handle of
    its current PyTorch stream, switching the current device only when it
    differs; returns the entry's CUDA error code (0 on success). At the
    model's small shapes a kernel takes a few µs on the card, so the host
    path is kept lean: no ``torch.cuda.Stream`` object and no device
    context per call."""
    index = device.index
    if index == torch.cuda.current_device():
        return entry(*args, _raw_stream(index))
    with torch.cuda.device(device):
        return entry(*args, _raw_stream(index))
