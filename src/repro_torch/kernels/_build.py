"""Build and load the hand-written CUDA kernels of ``kernels/csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds, not minutes).  Libraries land in
``<repo>/build/torch_kernels/`` under a name that carries a hash of the
sources, so an edited kernel is rebuilt and a current one is reused.
Nothing is built or loaded at import time: the first wrapper call builds
the kernel it needs, and :func:`build_all` builds several in parallel.
A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]

_VOIDP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_FLOAT = ctypes.c_float
# C signatures of the exported entry points (every one returns cudaError_t)
SIGNATURES = {
    "checksum": {"craft_checksum_rows": [_VOIDP, _VOIDP, _LL, _LL, _VOIDP]},
    "snapshot": {"craft_snapshot": [_VOIDP, _VOIDP, _VOIDP, _LL, _LL, _INT,
                                    _VOIDP]},
    "xor_parity": {"craft_xor_reduce": [_VOIDP, _VOIDP, _LL, _LL, _VOIDP]},
    "rs_erasure": {"craft_gf_matmul": [_VOIDP, _VOIDP, _VOIDP, _INT, _INT,
                                       _LL, _VOIDP]},
    "flash_attention": {
        "craft_flash_attention": [_VOIDP] * 5 + [_INT] * 7 + [_LL] * 9
        + [_FLOAT] + [_INT] * 5 + [_VOIDP],
        "craft_flash_prefill_tc": [_VOIDP] * 5 + [_INT] * 7 + [_LL] * 9
        + [_FLOAT] + [_INT] * 4 + [_VOIDP],
        "craft_flash_decode": [_VOIDP] * 6 + [_INT] * 6 + [_LL] * 9
        + [_FLOAT] + [_INT] * 9 + [_VOIDP],
    },
    "ssm_scan": {
        "craft_ssd_scan": [_VOIDP] * 8 + [_INT] * 5 + [_LL] * 12
        + [_INT, _VOIDP],
        "craft_s6_scan": [_VOIDP] * 8 + [_INT] * 4 + [_LL] * 8
        + [_INT, _VOIDP],
        "craft_ssd_scan_chunked": [_VOIDP] * 10 + [_INT] * 6 + [_LL] * 12
        + [_INT, _VOIDP],
        "craft_s6_scan_chunked": [_VOIDP] * 10 + [_INT] * 5 + [_LL] * 8
        + [_INT, _VOIDP],
    },
}
KERNELS = tuple(SIGNATURES)

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str):
    """Start nvcc for ``name`` unless a current library exists; returns
    ``(process, tmp_path, lib_path)`` or None."""
    lib = _lib_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish_build(name: str, started) -> None:
    proc, tmp, lib = started
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)          # atomic: concurrent builds agree


def build_all(names: Iterable[str]) -> None:
    """Compile every named kernel, all nvcc processes at once."""
    started = {n: _start_build(n) for n in names}
    errors = []
    for n, s in started.items():
        if s is None:
            continue
        try:
            _finish_build(n, s)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start_build(name)
            if started is not None:
                _finish_build(name, started)
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return lib


def count_launch(wrapper, route: Optional[str] = None) -> None:
    """Add one to ``wrapper.launches`` and, where the wrapper has routes, to
    ``wrapper.routes[route]`` (rank threads launch concurrently)."""
    with _count_lock:
        wrapper.launches += 1
        if route is not None:
            wrapper.routes[route] += 1


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
