"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface, so ``nvcc`` compiles it in
seconds into a shared library with no PyTorch headers; the library lands in
``kernels/_build/`` (ignored by git), named by a hash of its source and the
shared headers (``csrc/*.cuh``), so an edited kernel is rebuilt.
:func:`build` compiles several kernels at once, one ``nvcc`` each, all
started together. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}  # kernel name -> nvcc's output (ptxas register use)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from source at first use")


def _library(name: str) -> Path:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return _BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(names) -> None:
    """Run one ``nvcc`` per kernel whose library is missing, all at once;
    raise naming every kernel that failed. Caller holds ``_lock``."""
    todo = [(n, _library(n)) for n in names if not _library(n).exists()]
    if not todo:
        return
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        build_logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}:\n{build_logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))


def build(names) -> None:
    """Compile the kernels ``names`` (those not built yet) in parallel."""
    with _lock:
        _compile([n for n in names if n not in _libs])


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``.

    ``signatures`` maps each C function to ``(argtypes, restype)``."""
    with _lock:
        if name in _libs:
            return _libs[name]
        _compile([name])
        lib = ctypes.CDLL(str(_library(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
        return lib
