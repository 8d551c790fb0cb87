"""ctypes binding and build of the native windowing engine (port of
``sttode_tpu/native/binding.py``).

The port's own copy of the C++ source, ``windowing.cpp`` beside this file,
is compiled with ``g++`` at first use into ``sttode_tpu_torch/_build/``
(listed in ``.gitignore``), in a library file keyed on a hash of the source
and the compiler flags. Importing this module builds nothing. A failed
build raises with the compiler's output: there is no quiet fallback, so a
caller always knows which engine ran (``load_eth_ucy(backend="python")`` is
the explicit numpy path).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("windowing.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libwindowing_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; return its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the native windowing engine failed: "
                           f"$ {' '.join(cmd)}\n{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed building the native windowing engine "
                           f"(exit {proc.returncode}):\n$ {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent build sees all or nothing
    return path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64p = ctypes.POINTER(ctypes.c_int64)
            f32p = ctypes.POINTER(ctypes.c_float)
            f64p = ctypes.POINTER(ctypes.c_double)
            common = [f64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_double,
                      ctypes.c_double]
            lib.ws_count.argtypes = common + [i64p, i64p]
            lib.ws_count.restype = ctypes.c_int
            lib.ws_fill.argtypes = common + [f32p, i64p, f64p, f64p, f32p]
            lib.ws_fill.restype = ctypes.c_int
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the engine builds (at the first call) and loads here."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def window_file(rows: np.ndarray, *, obs_len: int = 8, pred_len: int = 12,
                skip: int = 1, min_ped: int = 1, traj_scale: float = 1.0,
                threshold: float = 0.002) -> list[dict]:
    """Window one file's rows [R, 4] (frame, ped, x, y) into scene dicts
    with the C++ engine; ``seq_name`` is left empty for the caller."""
    rows = np.ascontiguousarray(rows, dtype=np.float64)
    if rows.ndim != 2 or rows.shape[1] != 4:
        raise ValueError(f"rows must be [R, 4] (frame, ped, x, y), got "
                         f"{rows.shape}")
    lib = load()
    seq_len = obs_len + pred_len
    n_scenes, total_agents = ctypes.c_int64(), ctypes.c_int64()
    rp = _ptr(rows, ctypes.c_double)
    args = (rp, rows.shape[0], obs_len, pred_len, skip, min_ped, traj_scale,
            threshold)
    lib.ws_count(*args, ctypes.byref(n_scenes), ctypes.byref(total_agents))
    window_file.calls += 1
    S, A = n_scenes.value, total_agents.value
    if S == 0:
        return []
    traj = np.empty((A, seq_len, 2), np.float32)
    offsets = np.empty((S + 1,), np.int64)
    frames = np.empty((S,), np.float64)
    ped_ids = np.empty((A,), np.float64)
    nonlin = np.empty((A,), np.float32)
    lib.ws_fill(*args, _ptr(traj, ctypes.c_float),
                _ptr(offsets, ctypes.c_int64), _ptr(frames, ctypes.c_double),
                _ptr(ped_ids, ctypes.c_double), _ptr(nonlin, ctypes.c_float))
    scenes = []
    for s in range(S):
        lo, hi = offsets[s], offsets[s + 1]
        t = traj[lo:hi]
        rel = np.zeros_like(t)
        rel[:, 1:] = t[:, 1:] - t[:, :-1]
        n = hi - lo
        scenes.append({
            "obs": t[:, :obs_len],
            "pred": t[:, obs_len:],
            "obs_rel": rel[:, :obs_len],
            "pred_rel": rel[:, obs_len:],
            "non_linear": nonlin[lo:hi].copy(),
            "ped_ids": ped_ids[lo:hi].astype(np.float32),
            "obs_mask": np.ones((n, obs_len), np.float32),
            "pred_mask": np.ones((n, pred_len), np.float32),
            "frame": float(frames[s]),
            "seq_name": "",
        })
    return scenes


# files windowed by the engine (counted in window_file)
window_file.calls = 0
