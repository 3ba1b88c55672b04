"""Build the port's host C++ code with ``g++`` at first use and load it with
``ctypes``.

``supervised_dispnet_tpu_torch/csrc/host/<name>.cpp`` compiles into
``build/host/lib<name>-<hash>.so`` beside the package (``.gitignore`` lists
``build/``), with a plain C interface. The hash covers the source and the
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is. Processes that build at once each compile to a file of their own and
rename it into place, so none loads half a library. There is no fallback:
without ``g++`` the build raises. ``ctypes`` releases the interpreter lock
during a call, so threads run the native entries side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_HOST = Path(__file__).resolve().parents[1] / "csrc" / "host"
BUILD_DIR = CSRC_HOST.parents[2] / "build" / "host"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_gxx() -> str:
    """Path of ``g++`` on PATH."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the port's host codec "
                           f"({CSRC_HOST}) is built with it at first use")
    return gxx


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update((CSRC_HOST / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/host/<name>.cpp`` unless it is built; returns the
    compiler's output (empty when the library was already there)."""
    out = library_path(name)
    if out.exists():
        return ""
    gxx = find_gxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(CSRC_HOST / f"{name}.cpp")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {name}.cpp:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent process never sees half a file
    return proc.stdout


def load_library(name: str, signatures: dict[str, tuple[list, type]]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/host/<name>.cpp``; set each entry's
    ``argtypes`` and ``restype`` from ``signatures``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
    return lib
