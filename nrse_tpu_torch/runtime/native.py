"""ctypes bindings for the port's native C++ audio runtime.

The port's counterpart of ``nrse_tpu/runtime/native.py``, over its own copy
of the decoder source (``runtime/audio_io.cpp``): WAV decode, polyphase
resample and a multithreaded batch loader.  At first use the source is
compiled with ``g++`` (the flags of ``nrse_tpu/runtime/Makefile`` but
``-march=native``, so that the library runs on any x86-64 host) into
``build/nrse_tpu_torch/libnrse_audio_<hash>.so`` at the root of the
checkout, a directory ``.gitignore`` lists; the hash covers the source and
the flags, so an edited source is rebuilt.  Where no compiler is found or
the build fails, :func:`native_available` is False and every caller takes
the pure-Python path of ``audio/io.py``, the behavioural spec.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "audio_io.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "nrse_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall",
             "-shared", "-lpthread")

_lock = threading.Lock()
_lib = None
_load_attempted = False


def library_path() -> Path:
    """Path of the library for the current source and flags (built or
    not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnrse_audio_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    out = library_path()
    if out.is_file():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS[:-2], str(SOURCE), "-o", str(tmp),
                        *CXX_FLAGS[-2:]], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return out


def _load():
    global _lib, _load_attempted
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.nrse_decode_wav.restype = ctypes.c_int64
        lib.nrse_decode_wav.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.nrse_wav_length.restype = ctypes.c_int64
        lib.nrse_wav_length.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32)
        ]
        lib.nrse_load_batch.restype = None
        lib.nrse_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.nrse_readahead.restype = None
        lib.nrse_readahead.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_decode_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode to float32 [1, samples] + sample rate (mono downmixed)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native audio runtime not available")
    sr = ctypes.c_int32(0)
    n = lib.nrse_wav_length(path.encode(), ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"native decode failed: {path}")
    out = np.empty(n, np.float32)
    got = lib.nrse_decode_wav(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, ctypes.byref(sr),
    )
    if got < 0:
        raise ValueError(f"native decode failed: {path}")
    return out[None, :got], int(sr.value)


def native_load_batch(paths: List[str], target_sr: int, max_samples: int,
                      random_crop: bool = True,
                      seeds: Optional[np.ndarray] = None,
                      threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Parallel decode+resample+crop/pad.

    Returns (batch [N, max_samples] float32, lengths [N] int64 with -1 on
    per-file failure — the caller applies the dataset retry policy).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native audio runtime not available")
    n = len(paths)
    out = np.zeros((n, max_samples), np.float32)
    lengths = np.zeros(n, np.int64)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if seeds is None:
        seeds = np.arange(1, n + 1, dtype=np.uint64)
    seeds = np.ascontiguousarray(seeds, np.uint64)
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    lib.nrse_load_batch(
        c_paths, n, target_sr, max_samples, int(random_crop),
        seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out, lengths


def native_readahead(paths: List[str]) -> bool:
    """Queue async page-cache readahead (POSIX_FADV_WILLNEED) for files a
    few batches ahead of the decode pool.  Returns False (no-op) without
    the native library."""
    lib = _load()
    if lib is None:
        return False
    n = len(paths)
    if n == 0:
        return True
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.nrse_readahead(c_paths, n)
    return True
