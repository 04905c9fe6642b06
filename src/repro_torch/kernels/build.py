"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source in ``SOURCES`` (paths relative to this package) has a plain C
interface and compiles on its own with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3`` (no fast-math) into ``build/kernels/``
under the repository root, a directory that .gitignore lists. All sources
are compiled at first use, in parallel (one nvcc process each), from the
sources alone; a library is rebuilt whenever its source changes (the file
name carries a hash of the source and the flags).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

KERNELS = Path(__file__).resolve().parent
BUILD_DIR = KERNELS.parents[2] / "build" / "kernels"
SOURCES = ("zsign/csrc/zsign_encode.cu", "zsign/csrc/sign_reduce.cu",
           "zsign/csrc/zsign_compress.cu", "zsign/csrc/unpack_sum.cu",
           "efsign/csrc/ef_sign.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOID_P = ctypes.c_void_p
_INT, _LL = ctypes.c_int, ctypes.c_longlong
#: ctypes signature of every exported launcher (all return cudaError_t)
SIGNATURES = {
    "zsign_encode_launch": [_VOID_P, _VOID_P, _VOID_P, _VOID_P, _INT, _LL,
                            _INT, _LL, _VOID_P],
    "sign_reduce_launch": [_VOID_P, _VOID_P, _VOID_P, _VOID_P, _INT, _LL,
                           _INT, _VOID_P],
    "zsign_compress_launch": [_VOID_P, _VOID_P, _VOID_P, _VOID_P, _INT, _LL,
                              _VOID_P],
    "unpack_sum_launch": [_VOID_P, _VOID_P, _INT, _LL, _VOID_P],
    "ef_sign_launch": [_VOID_P, _LL, _VOID_P, _LL, _VOID_P, _LL, _VOID_P,
                       _LL, _VOID_P, _VOID_P, _VOID_P, _INT, _LL, _LL,
                       _VOID_P],
}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, spills) of each source built by this process
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return nvcc


def _lib_path(src: str) -> Path:
    digest = hashlib.sha256((KERNELS / src).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(src).stem}_{digest}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library (all nvcc processes started together),
    load them and bind their signatures. Raises on any failed build."""
    missing = [s for s in SOURCES if s not in _LIBS]
    if not missing:
        return _LIBS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in missing:
        target = _lib_path(src)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(KERNELS / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target)
    failed = []
    for src, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[src] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{src}:\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for src in missing:
        lib = ctypes.CDLL(str(_lib_path(src)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LIBS[src] = lib
    return _LIBS


def check_cuda(t, name: str, dtype) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    ``dtype`` (what every launcher's pointers assume)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def raise_on(err: int, what: str) -> None:
    """Raise if a launcher returned a cudaError_t other than 0."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def launcher(src: str, name: str):
    """The bound C launcher ``name`` from the library built from ``src``
    (a path in ``SOURCES``)."""
    return getattr(build_all()[src], name)
