"""Native (C++) host library, built from the JAX package's sources.

The host must parse and 2-bit encode FASTQ fast enough to feed the GPU, and
parse, score and format count files fast enough for ``eval``; the Python
paths top out far below that.  Two sources under ``ntsm_tpu/native/`` have
no JAX in them, so this module compiles them by their paths with g++ into
one library in ``build/ntsm_tpu_torch/`` at first use and binds it with
ctypes:

* ``fastx_reader.cpp``: the FASTQ reader and packer (the analogue of the
  reference's kseq parser, vendor/kseq.h:178-219), the counts.txt parsers
  and the eval row formatter;
* ``exact_pairs.cpp``: the exact engine's f64 pair scorer
  (``ntsm_exact_pairs``).

Without g++, zlib or the sources, :func:`load` returns None after saying so
on stderr, and callers use their Python paths (the JAX package's rule): the
host library is the one part of the port that may fall back.

The build has no ``-march=native``, so the library runs on any x86-64 host,
and with ``-ffp-contract=off`` the scorer's per-site f64 arithmetic is the
plain IEEE sequence of its source (no FMA), which ``csrc/pair_stats.cu``
reproduces bit for bit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCES = tuple(
    os.path.join(_REPO, "ntsm_tpu", "native", name)
    for name in ("fastx_reader.cpp", "exact_pairs.cpp")
)
BUILD_DIR = os.path.join(_REPO, "build", "ntsm_tpu_torch")
SO_PATH = os.path.join(BUILD_DIR, "libntsm_host.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    # build into a pid-unique name, then rename atomically: concurrent
    # processes (test workers) must never dlopen a half-written .so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{SO_PATH}.tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-ffp-contract=off", "-fPIC", "-shared",
           "-o", tmp, *SOURCES, "-lz"]
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
        missing = [p for p in SOURCES if not os.path.exists(p)]
        if missing:
            print(f"ntsm_tpu_torch.native: {missing[0]} not found, "
                  "using the Python reader", file=sys.stderr)
            return None
        stale = (not os.path.exists(SO_PATH) or os.path.getmtime(SO_PATH)
                 < max(os.path.getmtime(p) for p in SOURCES))
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
        P, L, D = ctypes.c_void_p, ctypes.c_long, ctypes.c_double
        PL = ctypes.POINTER(ctypes.c_long)
        lib.ntsm_parse_counts.restype = L
        lib.ntsm_parse_counts.argtypes = [
            ctypes.c_char_p, L,  # buf, len
            P, L,  # ints i64 [cap, 6], cap
            P, L, PL,  # ids_out, ids_cap, ids_len
            PL, PL,  # tk, ks
        ]
        lib.ntsm_parse_counts2.restype = L
        lib.ntsm_parse_counts2.argtypes = [
            ctypes.c_char_p, L,  # buf, len
            P, P, P, L,  # mc i32 [cap, 2], sc i32 [cap, 2], dist i64 or NULL, cap
            P, L, PL,  # ids_out, ids_cap, ids_len
            PL, PL,  # tk, ks
        ]
        lib.ntsm_exact_pairs.restype = None
        lib.ntsm_exact_pairs.argtypes = [
            P, P, P, P,  # A f64, B f64, CLS u8, S f64, each [N, L]
            L, L, D,  # N, L, min_cov
            P, P, L,  # ii i32 [P], jj i32 [P], P
            P, P, P,  # joint f64 [P], ss f64 [P], tallies i64 [P, 8]
        ]
        lib.ntsm_format_eval_rows.restype = L
        lib.ntsm_format_eval_rows.argtypes = [
            L, P, P,  # n_pairs, ii i32, jj i32
            P, P, P, P,  # f3 f64 [P,3], i9 i64 [P,9], same u8, dist f64 or NULL
            P, L, L,  # samp bytes [n_samp, 6] of width samp_w, samp_w, n_samp
            P, L,  # outbuf, outcap
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None
