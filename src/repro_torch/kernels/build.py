"""Build, load and count the port's CUDA kernels.

Each ``csrc/<stem>.cu`` has a plain C interface (one or more entry points;
shared device code lives in ``csrc/*.cuh``) and is compiled by nvcc into
``build/repro_torch/lib<name>-<hash>.so`` at the checkout's root at first
use, then loaded with ``ctypes`` (no PyTorch headers: a build takes
seconds).  :func:`build_all` starts one nvcc per source at once.  Builds
are safe under concurrent first use (the three party processes of a mesh
run): a build holds a file lock in the build directory, and a library
lands under its final name only by an atomic rename, so no process loads
a half-written ``.so``.

``LAUNCHES`` counts kernel launches per kernel name: each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that it
went through the kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["KERNELS", "LAUNCHES", "reset_launches", "library", "build_all",
           "check", "stream_ptr", "BUILD_DIR", "SOURCE_DIR"]

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> (source stem, C entry point, ctypes argtypes)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
KERNELS = {
    "rss_matmul": ("rss_matmul", "rss_matmul_launch",
                   [_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I,
                    _P]),
    "rss_matmul_pair": ("rss_matmul", "rss_matmul_pair_launch",
                        [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I,
                         _I, _P]),
    "grouped_rss_matmul": ("grouped_rss_matmul", "grouped_rss_matmul_launch",
                           [_P, _P, _P, _P, _I, _I, _L, _I, _I,
                            _L, _L, _L, _L, _L, _L, _L, _L, _I, _P]),
    "grouped_rss_matmul_pair": ("grouped_rss_matmul",
                                "grouped_rss_matmul_pair_launch",
                                [_P, _P, _P, _P, _P, _I, _I, _L, _I, _I,
                                 _L, _L, _L, _L, _L, _L, _L, _L, _P]),
    "bin_rss_matmul": ("bin_rss_matmul", "bin_rss_matmul_launch",
                       [_P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _I,
                        _I, _P]),
    "bin_grouped_matmul": ("bin_grouped_matmul", "bin_grouped_matmul_launch",
                           [_P, _P, _P, _I, _I, _L, _I, _I,
                            _L, _L, _L, _L, _L, _L, _L, _L, _P]),
    "ring_matmul": ("ring_matmul", "ring_matmul_launch",
                    [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P]),
    "ring_matmul_batched": ("ring_matmul", "ring_matmul_batched_launch",
                            [_P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I,
                             _P]),
    "bin_weight_matmul": ("binary_matmul", "bin_weight_matmul_launch",
                          [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P]),
    "bin_bin_matmul": ("binary_matmul", "bin_bin_matmul_launch",
                       [_P, _P, _P, _L, _I, _I, _P]),
    "flash_attention": ("flash_attention", "flash_attention_launch",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         *[_L] * 9, _F, _P]),
    "ssd_scan": ("ssd_scan", "ssd_scan_launch",
                 [*[_P] * 10, *[_I] * 6, *[_L] * 13, _I, _P]),
}

LAUNCHES = {name: 0 for name in KERNELS}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _target(stem: str) -> Path:
    # the shared headers (csrc/*.cuh) are part of every source's hash
    text = b"".join(p.read_bytes() for p in
                    [SOURCE_DIR / f"{stem}.cu",
                     *sorted(SOURCE_DIR.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def _start(stem: str):
    """Start nvcc for one source; returns (process, temp .so, target, log)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _target(stem)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(BUILD_DIR / f"{stem}.log", "w")
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{stem}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish(stem: str, proc, tmp: Path, out: Path, log) -> None:
    rc = proc.wait()
    log.close()
    if rc != 0:
        text = (BUILD_DIR / f"{stem}.log").read_text()
        raise RuntimeError(f"nvcc failed for {stem}.cu (rc={rc}):\n{text}")
    os.replace(tmp, out)


@contextlib.contextmanager
def _build_lock():
    """Exclusive across processes: one builds, the others wait and then
    find the library built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all() -> dict[str, str]:
    """Build every kernel not yet built, one nvcc per source started
    together; returns {kernel name: nvcc log (ptxas register report)}."""
    stems = {stem for stem, _, _ in KERNELS.values()}
    with _build_lock():
        pending = {s: _start(s) for s in sorted(stems)
                   if not _target(s).exists()}
        errors = []
        for s, job in pending.items():   # wait for every nvcc before raising
            try:
                _finish(s, *job)
            except RuntimeError as e:
                errors.append(e)
    if errors:
        raise errors[0]
    return {name: (BUILD_DIR / f"{KERNELS[name][0]}.log").read_text()
            if (BUILD_DIR / f"{KERNELS[name][0]}.log").exists() else ""
            for name in KERNELS}


def library(name: str):
    """The loaded C entry point of kernel ``name`` (built if needed)."""
    with _LOCK:
        if name not in _LIBS:
            stem, fn_name, argtypes = KERNELS[name]
            out = _target(stem)
            if not out.exists():
                with _build_lock():
                    if not out.exists():
                        _finish(stem, *_start(stem))
            lib = ctypes.CDLL(str(out))
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[name] = fn
        return _LIBS[name]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, err: int) -> None:
    """Raise on a refused launch (the C function returns
    ``cudaGetLastError()``)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
