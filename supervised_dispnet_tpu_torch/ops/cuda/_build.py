"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``supervised_dispnet_tpu_torch/csrc/<name>.cu`` compiles on its own into
``build/kernels/lib<name>-<hash>.so`` beside the package (``.gitignore``
lists ``build/``), for ``sm_90a`` (H100), with a plain C interface. The hash
covers the source, the shared headers in ``csrc/`` and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. A library exports
its C entries, each returning ``cudaGetLastError()`` as an int, and
``<name>_error_string(int)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else the CUDA toolkit's default place."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor /usr/local/cuda/bin): the "
            "port's CUDA kernels are built on the machine with the card")
    return nvcc


def sources() -> list[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile the named sources (all of ``csrc/`` by default) that are not
    built yet, one ``nvcc`` per source, all started together. Returns each
    name's compiler output (empty when the library was already built)."""
    names = sources() if names is None else names
    todo = [n for n in names if not library_path(n).exists()]
    logs = {n: "" for n in names}
    if not todo:
        return logs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, out, tmp, proc in procs:
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu:\n{logs[n]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent process never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load_library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; set each entry's
    ``argtypes`` from ``signatures`` and its ``restype`` to ``c_int``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, entry: str, code: int) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {code} ({msg})")
