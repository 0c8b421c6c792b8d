"""Native (C++) runtime components, loaded via ctypes.

The accelerator compute path is JAX/XLA; host-side scene-compile work
that the reference does in C++ (TBB-parallel BVH build, bvh.cpp:36-120) is
C++ here too. Libraries are compiled on demand with g++ and cached next to
the sources; every consumer falls back to its numpy reference implementation
when the toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIBS: dict[str, object] = {}


def _cache_dir() -> str:
    base = os.environ.get("ORT_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "optix_renderer_tpu"
    )
    d = os.path.join(base, "native")
    os.makedirs(d, exist_ok=True)
    return d


def _build_and_load(name: str, extra_flags=()):
    """Compile {name}.cpp → a user-cache .so keyed by a content hash of the
    source + host arch (a committed or mtime-cached binary built with
    -march=native on another machine would SIGILL at first call; keying by
    content also means source edits can never be shadowed by a stale .so).
    Returns None when compilation fails (callers fall back to numpy)."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(_DIR, f"{name}.cpp")
        lib = None
        try:
            with open(src, "rb") as f:
                key = hashlib.sha256(
                    f.read() + platform.machine().encode() + platform.node().encode()
                ).hexdigest()[:20]
            so = os.path.join(_cache_dir(), f"lib{name}-{key}.so")
            if not os.path.exists(so):
                tmp = so + f".tmp{os.getpid()}"
                cmd = [
                    "g++", "-O3", "-march=native", "-shared", "-fPIC",
                    "-fopenmp", "-o", tmp, src, *extra_flags,
                ]
                r = subprocess.run(cmd, capture_output=True, timeout=120)
                if r.returncode != 0:  # retry without OpenMP
                    cmd = [c for c in cmd if c != "-fopenmp"]
                    r = subprocess.run(cmd, capture_output=True, timeout=120)
                    r.check_returncode()
                os.replace(tmp, so)  # atomic: concurrent builders race safely
            lib = ctypes.CDLL(so)
        except Exception:
            lib = None
        _LIBS[name] = lib
        return lib
