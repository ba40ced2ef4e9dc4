"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Counterpart of ``nrse_tpu/runtime/native.py``, which builds its audio
``.so`` on first use.  Every ``nrse_tpu_torch/csrc/*.cu`` file is compiled
for Hopper (``sm_90a``) into one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/nrse_tpu_torch/libnrse_kernels_<hash>.so \\
         nrse_tpu_torch/csrc/*.cu

The library name carries a hash of the sources and flags, so an edited
kernel is rebuilt and a cached build is reused.  The build directory sits
at the root of the checkout and is listed in ``.gitignore``.  The library
is loaded with ``ctypes``; each C entry takes device pointers and the CUDA
stream as ``c_void_p`` and returns a ``cudaError_t`` (0 on success).
Nothing here runs at import time: the tests on the CPU import every
module of the port, and that machine has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "nrse_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of every C entry in csrc/
_ENTRIES = {
    "nrse_block_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, ctypes.c_float, _P],
    "nrse_fused_ffn_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the port's "
            "CUDA kernels cannot be built on this machine")
    return found


def library_path() -> Path:
    """Path of the library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libnrse_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for these sources is missing.
    Raises ``RuntimeError`` with nvcc's output if the build fails."""
    out = library_path()
    if out.is_file():
        return out
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
