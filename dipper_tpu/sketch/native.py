"""ctypes bindings for the native host sketcher (native/sketchnat.cpp).

Auto-builds libsketchnat.so with `make` on first use; callers fall
back to the device sketch path when no toolchain is available. The
native path exists because the CLI's mash frontend needs the u64 bank
host-side (np.unique rank compression): hashing on the host removes a
device-to-host copy of the bank and leaves the device free for tree
building.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libsketchnat.so"))

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("DIPPER_NATIVE_SKETCH") == "0":
        return None
    src = os.path.join(os.path.abspath(_NATIVE_DIR), "sketchnat.cpp")
    stale = (not os.path.exists(_LIB_PATH)
             or (os.path.exists(src)
                 and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)))
    if stale:
        try:
            subprocess.run(
                ["make", "-C", os.path.abspath(_NATIVE_DIR),
                 "libsketchnat.so"],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            if not os.path.exists(_LIB_PATH):
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.sketchnat_sketch.restype = ctypes.c_int
    lib.sketchnat_sketch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # concatenated sequence bytes
        ctypes.POINTER(ctypes.c_int64),   # offsets [n+1]
        ctypes.c_int64,                   # n
        ctypes.c_int,                     # k
        ctypes.c_int,                     # sketch_size
        ctypes.c_int,                     # nthreads
        ctypes.POINTER(ctypes.c_uint64),  # out [n, sketch_size]
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def sketch_sequences_native(seqs, k: int,
                            sketch_size: int) -> Optional[np.ndarray]:
    """Host-native sketch bank: [N, sketch_size] u64, each row the
    ascending bottom-sketch_size murmur hashes (sentinel-padded).
    Bit-identical to sketch_sequences (tests/test_native_sketch.py).
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(seqs)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offs[1:])
    buf = np.frombuffer(b"".join(bytes(s) for s in seqs), dtype=np.uint8) \
        if n else np.zeros(0, np.uint8)
    if buf.size == 0:
        buf = np.zeros(1, np.uint8)  # valid pointer for the empty case
    out = np.empty((n, sketch_size), dtype=np.uint64)
    nthreads = min(32, os.cpu_count() or 1)
    rc = lib.sketchnat_sketch(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n), ctypes.c_int(k), ctypes.c_int(sketch_size),
        ctypes.c_int(nthreads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        return None
    return out
