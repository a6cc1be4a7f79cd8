"""Native (C++) host reader, built from the JAX package's source.

The host must parse and 2-bit encode FASTQ fast enough to feed the GPU; the
pure-Python reader tops out far below that.  ``ntsm_tpu/native/
fastx_reader.cpp`` (the analogue of the reference's kseq parser,
vendor/kseq.h:178-219) has no JAX in it, so this module compiles that one
source by its path with g++ into ``build/ntsm_tpu_torch/`` at first use and
binds it with ctypes.  Without g++, zlib or the source, :func:`load` returns
None after saying so on stderr, and callers use the Python reader: the host
reader is the one part of the port that may fall back.

The build has no ``-march=native``, so the library runs on any x86-64 host.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "ntsm_tpu", "native", "fastx_reader.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "ntsm_tpu_torch")
SO_PATH = os.path.join(BUILD_DIR, "libntsm_fastx.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    # build into a pid-unique name, then rename atomically: concurrent
    # processes (test workers) must never dlopen a half-written .so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{SO_PATH}.tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp, SOURCE, "-lz"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"ntsm_tpu_torch.native: cannot build ({e}), "
              "using the Python reader", file=sys.stderr)
        return False
    if res.returncode != 0:
        print("ntsm_tpu_torch.native: build failed, using the Python reader\n"
              f"{res.stderr}", file=sys.stderr)
        return False
    os.replace(tmp, SO_PATH)
    return True


def load():
    """Return the loaded native library, building it if needed, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(SOURCE):
            print(f"ntsm_tpu_torch.native: {SOURCE} not found, "
                  "using the Python reader", file=sys.stderr)
            return None
        stale = (not os.path.exists(SO_PATH)
                 or os.path.getmtime(SO_PATH) < os.path.getmtime(SOURCE))
        if stale and not _build():
            return None
        try:
            lib = ctypes.CDLL(SO_PATH)
        except OSError as e:
            print(f"ntsm_tpu_torch.native: load failed ({e}), "
                  "using the Python reader", file=sys.stderr)
            return None
        lib.ntsm_reader_open.restype = ctypes.c_void_p
        lib.ntsm_reader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.ntsm_reader_close.restype = None
        lib.ntsm_reader_close.argtypes = [ctypes.c_void_p]
        lib.ntsm_reader_next_batch.restype = ctypes.c_int
        lib.ntsm_reader_next_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.ntsm_pack_batch.restype = None
        lib.ntsm_pack_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.ntsm_canonical_hashes.restype = None
        lib.ntsm_canonical_hashes.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None
