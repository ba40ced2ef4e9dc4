"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Counterpart of ``nrse_tpu/runtime/native.py``, which builds its audio
``.so`` on first use.  Every ``nrse_tpu_torch/csrc/*.cu`` file is compiled
for Hopper (``sm_90a``) into an object, all of them at once (one ``nvcc``
process each), and the objects are linked into one shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <obj>/<name>.o nrse_tpu_torch/csrc/<name>.cu
    nvcc -shared -o build/nrse_tpu_torch/libnrse_kernels_<hash>.so <obj>/*.o

The library name carries a hash of the sources (``*.cu`` and the shared
``*.cuh`` headers) and flags, so an edited kernel is rebuilt and a cached
build is reused.  The build directory sits
at the root of the checkout and is listed in ``.gitignore``.  The library
is loaded with ``ctypes``; each C entry takes device pointers and the CUDA
stream as ``c_void_p`` and returns a ``cudaError_t`` (0 on success).
Nothing here runs at import time: the tests on the CPU import every
module of the port, and that machine has no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "nrse_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
# name -> argtypes of every C entry in csrc/
_ENTRIES = {
    "nrse_block_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _U, _U, _F, _F, _I,
                                 _I, _I, _I, _I, _F, _P],
    "nrse_block_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _U, _U, _F, _F, _I,
                                 _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _F, _P],
    "nrse_flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _F, _P],
    "nrse_flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _P, _P, _P,
                                    _I, _I, _I, _I, _F, _P],
    "nrse_flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _P,
                                     _I, _I, _I, _I, _F, _P],
    "nrse_fused_ffn_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "nrse_fused_ffn_fwd_train": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _U, _U, _F, _F, _F, _F, _I, _I, _I, _I,
                                 _P],
    "nrse_fused_ffn_bwd_dx": [_P, _P, _P, _P, _P, _P, _P, _P, _U, _U,
                              _F, _F, _F, _F, _I, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _P],
    "nrse_fused_ffn_bwd_dw": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "nrse_dropout": [_P, _P, _P, _L, _U, _U, _U, _F, _F, _I, _P],
    "nrse_channel_layernorm_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    "nrse_channel_layernorm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _P],
    "nrse_fused_frontend_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _F, _P],
    "nrse_fused_frontend_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _P, _I, _I, _I, _I, _I, _P],
    "nrse_adamw_ema": [_P, _P, _P, _P, _P, _P, _L, _L, _P],
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


def _run(cmds):
    """Run the commands concurrently; raise with the output of the first
    that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile the kernels if the library for these sources is missing.
    Raises ``RuntimeError`` with nvcc's output if the build fails."""
    out = library_path()
    if out.is_file():
        return out
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objdir = Path(tempfile.mkdtemp(prefix="obj_", dir=BUILD_DIR))
    try:
        objs = [objdir / f"{src.stem}.o" for src in sources]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(sources, objs)])
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
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


def on_device(dev):
    """A context that makes the card ``dev`` current for a launch: a no-op
    when it already is (entering ``torch.cuda.device`` costs host time on
    every call of a wrapper)."""
    import torch

    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
