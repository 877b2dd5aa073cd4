"""Native tier loader: builds and binds the C++ reference renderer.

Build-on-demand via g++ (no pybind11; plain C ABI + ctypes). The compiled
shared object is cached next to the sources and rebuilt when they change.
`available()` gates gracefully when no toolchain exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import shutil
import subprocess
from pathlib import Path

_log = logging.getLogger(__name__)
_SRC_DIR = Path(__file__).parent / "src"
_SOURCES = [_SRC_DIR / "l2n_native.cpp"]
_LIB_BASENAME = "libl2n_native"

_lib = None
_lib_error: str | None = None


def _source_digest() -> str:
    h = hashlib.sha256()
    for s in _SOURCES:
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False) -> Path:
    """Compile the shared library (g++ -O3 -march=native -shared -fPIC)."""
    out = _SRC_DIR.parent / f"{_LIB_BASENAME}-{_source_digest()}.so"
    if out.exists() and not force:
        return out
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found")
    for stale in out.parent.glob(f"{_LIB_BASENAME}-*.so"):
        stale.unlink(missing_ok=True)
    cmd = [cxx, "-O3", "-march=native", "-ffp-contract=off", "-shared",
           "-fPIC", "-std=c++17", "-pthread",
           *map(str, _SOURCES), "-o", str(out)]
    _log.info("building native tier: %s", " ".join(cmd))
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return out


def load() -> ctypes.CDLL:
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        raise RuntimeError(_lib_error)
    try:
        _lib = ctypes.CDLL(str(build()))
    except Exception as exc:  # record once; callers gate on available()
        _lib_error = f"native tier unavailable: {exc}"
        raise RuntimeError(_lib_error) from exc
    return _lib


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


from l2n.native.api import (  # noqa: E402,F401
    NativeRenderer,
    NativeTriangleRenderer,
    threefry2x32_native,
    tinymt_uint32_native,
)
