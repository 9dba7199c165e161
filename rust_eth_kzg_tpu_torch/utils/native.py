"""ctypes bindings to the port's native host library (`csrc/host/kzg_host.cpp`).

The verifier's closing multi-pairing check runs here. The library is built
with g++ at first use into `_build/host-<hash>/`, on the machine that runs it
(`-march=native`): the hash covers the source, the flags and the host's name
and processor, so a library built on another machine is not loaded. There is
no fallback: a missing compiler, a failed build or a failed load raises. The
pure-Python pairing of `utils/bls_host.py` is the tests' oracle, never a
substitute.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "host", "kzg_host.cpp")
BUILD_ROOT = os.path.join(_PKG, "_build")
GXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    h = hashlib.sha256(" ".join([*GXX_FLAGS, platform.node(), platform.machine(), platform.processor()]).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_ROOT, f"host-{h.hexdigest()[:16]}", "libkzg_host.so")


def build() -> str:
    """Compile the library unless it is built already for this host."""
    path = library_path()
    if os.path.exists(path):
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native pairing library is built at first use")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.kzg_pairing_check.restype = ctypes.c_int
            lib.kzg_pairing_check.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t]
            lib.kzg_pairing_selftest.restype = ctypes.c_int
            lib.kzg_pairing_selftest.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            _lib = lib
    return _lib


def _g1_bytes(p) -> bytes:
    return p[0].to_bytes(48, "big") + p[1].to_bytes(48, "big")


def _g2_bytes(q) -> bytes:
    (x0, x1), (y0, y1) = q
    return b"".join(v.to_bytes(48, "big") for v in (x0, x1, y0, y1))


def multi_pairings(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 for host affine points (None = identity)."""
    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    if not live:
        return True
    g1 = b"".join(_g1_bytes(p) for p, _ in live)
    g2 = b"".join(_g2_bytes(q) for _, q in live)
    rc = _load().kzg_pairing_check(g1, g2, None, len(live))
    if rc < 0:
        raise ValueError(f"malformed pairing input (code {rc})")
    return rc == 1


def selftest(p, q) -> bool:
    """The library's own check of its final exponentiation and cyclotomic
    squaring against the plain versions, on e(p, q)'s Miller loop."""
    return _load().kzg_pairing_selftest(_g1_bytes(p), _g2_bytes(q)) == 1
