"""FASTA/FASTQ reading (counterpart of ntsm_tpu/io/fastx.py).

Replaces the reference's kseq streaming parser (vendor/kseq.h:178-219) with
two host-side paths:

* :func:`read_fastx` — a simple record generator with kseq semantics
  (name = header token up to first whitespace, multi-line FASTA bodies
  concatenated, transparent gzip).  Used for site FASTAs and as the golden
  model's read source.
* :class:`BatchReader` — the production feed for the device pipeline:
  reads files in large chunks, parses records with vectorized numpy, 2-bit
  encodes, splits long reads into overlapping segments (k-1 halo, so the
  k-mer multiset is unchanged) and yields fixed-shape [batch, seglen] code
  arrays ready for the device.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import queue
import zlib
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from ntsm_tpu_torch.core.encode import NT4_TABLE


class _ZStream(ctypes.Structure):
    _fields_ = [
        ("next_in", ctypes.c_void_p),
        ("avail_in", ctypes.c_uint),
        ("total_in", ctypes.c_ulong),
        ("next_out", ctypes.c_void_p),
        ("avail_out", ctypes.c_uint),
        ("total_out", ctypes.c_ulong),
        ("msg", ctypes.c_char_p),
        ("state", ctypes.c_void_p),
        ("zalloc", ctypes.c_void_p),
        ("zfree", ctypes.c_void_p),
        ("opaque", ctypes.c_void_p),
        ("data_type", ctypes.c_int),
        ("adler", ctypes.c_ulong),
        ("reserved", ctypes.c_ulong),
    ]


_LIBZ = None
_LIBZ_TRIED = False


def _libz():
    global _LIBZ, _LIBZ_TRIED
    if not _LIBZ_TRIED:
        _LIBZ_TRIED = True
        try:
            lz = ctypes.CDLL("libz.so.1")
            lz.zlibVersion.restype = ctypes.c_char_p
            _LIBZ = lz
        except OSError:
            _LIBZ = None
    return _LIBZ


GZ_CALL = 16384  # kseq's gzread request size (vendor/kseq.h:229)


class _InflateRaw(io.RawIOBase):
    """gzread-semantics gzip stream via libz's inflate (ctypes).

    The reference reads through kseq, which refills its buffer with
    `gzread(f, buf, 16384)` calls (vendor/kseq.h:229,74).  Measured
    gzread behavior on damaged input (A/B'd against the reference binary
    for trailer-CRC flips, ISIZE flips, mid-stream flips, truncation):

    * truncation (clean EOF, no error): every inflated byte is returned;
    * ANY zlib data error (bad CRC trailer, mid-stream damage): the
      erroring 16384-byte CALL returns -1, so its entire output window
      is voided — but all PRIOR calls' output stands.

    Python's zlib module cannot express this (decompressobj discards the
    raising call's output unconditionally), so this drives libz's
    inflate directly and reproduces the per-call window granularity.
    Concatenated members (bgzf-style) restart via inflateReset2, like
    gzread."""

    Z_OK, Z_STREAM_END, Z_BUF_ERROR = 0, 1, -5

    def __init__(self, fh):
        self._fh = fh
        self._z = _libz()
        self._s = _ZStream()
        self._inbuf = None
        self._feof = False
        self._stream_done = False
        self._win = b""
        self._wpos = 0
        self._wbuf = ctypes.create_string_buffer(GZ_CALL)
        rc = self._z.inflateInit2_(
            ctypes.byref(self._s), 15 + 32, self._z.zlibVersion(),
            ctypes.c_int(ctypes.sizeof(self._s)),
        )
        if rc != self.Z_OK:
            raise OSError(f"inflateInit2 failed ({rc})")

    def readable(self) -> bool:
        return True

    def _gzread_call(self) -> bytes:
        """One emulated gzread(f, buf, 16384): the inflated window, b""
        at EOF, and b"" with the stream poisoned on a data error (the
        erroring call's output is voided, as gzread returns -1)."""
        s, z = self._s, self._z
        base = ctypes.addressof(self._wbuf)
        produced = 0
        error = False
        while produced < GZ_CALL:
            if s.avail_in == 0 and not self._feof:
                raw = self._fh.read(1 << 16)
                if not raw:
                    self._feof = True
                else:
                    self._inbuf = ctypes.create_string_buffer(raw, len(raw))
                    s.next_in = ctypes.addressof(self._inbuf)
                    s.avail_in = len(raw)
            s.next_out = base + produced
            s.avail_out = GZ_CALL - produced
            rc = z.inflate(ctypes.byref(s), 0)  # Z_NO_FLUSH
            produced = GZ_CALL - s.avail_out
            if rc == self.Z_STREAM_END:
                if s.avail_in == 0 and self._feof:
                    self._stream_done = True
                    break
                # gz_look semantics (zlib gzread.c): bytes after a
                # finished member are a NEW member only if they carry
                # the gzip magic; anything else is trailing garbage —
                # "ignore the trailing garbage and finish" with every
                # inflated byte delivered.  Resetting and inflating
                # garbage unconditionally voided the whole 16 KB window
                # (real gzread only voids on a data error INSIDE a
                # member, which the magic path below still reproduces).
                if s.avail_in < 2 and not self._feof:
                    rem = (
                        ctypes.string_at(s.next_in, s.avail_in)
                        if s.avail_in
                        else b""
                    )
                    raw = self._fh.read(1 << 16)
                    if not raw:
                        self._feof = True
                    data = rem + (raw or b"")
                    if data:
                        self._inbuf = ctypes.create_string_buffer(
                            data, len(data)
                        )
                        s.next_in = ctypes.addressof(self._inbuf)
                        s.avail_in = len(data)
                if (
                    s.avail_in < 2
                    or ctypes.string_at(s.next_in, 2) != b"\x1f\x8b"
                ):
                    self._stream_done = True
                    break
                if z.inflateReset2(ctypes.byref(s), 15 + 32) != self.Z_OK:
                    self._stream_done = True
                    break
            elif rc != self.Z_OK and rc != self.Z_BUF_ERROR:
                error = True
                self._stream_done = True
                break
            elif rc == self.Z_BUF_ERROR and s.avail_in == 0 and self._feof:
                self._stream_done = True
                break
        if error:
            return b""
        return self._wbuf.raw[:produced]

    def readinto(self, b) -> int:
        if self._wpos >= len(self._win):
            if self._stream_done:
                return 0
            self._win = self._gzread_call()
            self._wpos = 0
            if not self._win:
                return 0
        k = min(len(b), len(self._win) - self._wpos)
        b[:k] = self._win[self._wpos : self._wpos + k]
        self._wpos += k
        return k

    def close(self) -> None:
        try:
            if self._z is not None:
                self._z.inflateEnd(ctypes.byref(self._s))
                self._z = None
            self._fh.close()
        finally:
            super().close()


class _ZlibRaw(io.RawIOBase):
    """Fallback gzip stream when libz isn't loadable: decompressobj with
    errors treated as EOF.  NOT byte-exact with gzread on corrupt (not
    merely truncated) members — a decompress call that raises discards
    its own output; _InflateRaw is the exact path."""

    def __init__(self, fh):
        self._fh = fh
        self._d = zlib.decompressobj(15 + 32)
        self._pending = memoryview(b"")
        self._eof = False

    def readable(self) -> bool:
        return True

    def _fill(self) -> None:
        raw = self._fh.read(1 << 16)
        if not raw:
            self._eof = True
            return
        try:
            self._pending = memoryview(self._d.decompress(raw))
        except zlib.error:
            self._eof = True
            return
        while self._d.eof:  # member boundary: restart on the unused tail
            tail = self._d.unused_data
            self._d = zlib.decompressobj(15 + 32)
            if not tail:
                break
            try:
                more = self._d.decompress(tail)
                if more:
                    self._pending = memoryview(
                        bytes(self._pending) + more
                    )
            except zlib.error:  # trailing garbage: stop like gzread
                self._eof = True
                break

    def readinto(self, b) -> int:
        while not self._pending and not self._eof:
            self._fill()
        k = min(len(b), len(self._pending))
        b[:k] = self._pending[:k]
        self._pending = self._pending[k:]  # memoryview slice: no copy
        return k

    def close(self) -> None:
        try:
            self._fh.close()
        finally:
            super().close()


def _open(path: str):
    fh = open(path, "rb")
    magic = fh.read(2)
    fh.seek(0)
    if magic == b"\x1f\x8b":
        raw = _InflateRaw(fh) if _libz() is not None else _ZlibRaw(fh)
        return io.BufferedReader(raw)
    return fh


@dataclass
class FastxRecord:
    name: str
    seq: bytes
    qual: bytes | None = None


def read_fastx(path: str) -> Iterator[FastxRecord]:
    """Yield records from a FASTA or FASTQ file (optionally gzipped).

    kseq-faithful record grammar (vendor/kseq.h:178-219): records start at
    a '>' or '@' header line; sequence lines accumulate until a line whose
    first char is '>', '+' or '@' (empty lines skipped); a '+' line
    introduces quality, which accumulates until its total length reaches
    the sequence length.  Line-wrapped FASTQ and mixed FASTA/FASTQ files
    therefore parse exactly like the reference — including kseq's header
    hunt (kseq.h:182-186): at file start, and again after every FASTQ
    record (last_char resets, kseq.h:216), bytes are skipped up to the
    next '>' or '@' ANYWHERE in the stream, so leading junk is ignored
    and a mid-line header char starts a record.
    """
    with _open(path) as fh:
        buffered = io.BufferedReader(fh) if not isinstance(fh, io.BufferedReader) else fh

        _rl = buffered.readline  # gz streams report errors as EOF
        line = _rl()
        while line:
            hdr = line.rstrip(b"\r\n")
            if hdr[:1] not in (b">", b"@"):
                # kseq's byte scan to the next header char (any position)
                i = min(
                    (k for k in (hdr.find(b">"), hdr.find(b"@")) if k >= 0),
                    default=-1,
                )
                if i < 0:
                    line = _rl()
                    continue
                hdr = hdr[i:]
            name = _header_name(hdr)
            seq_parts: list[bytes] = []
            is_fastq = False
            line = _rl()
            while line:
                c = line[:1]
                if c == b"+":
                    is_fastq = True
                    break
                if c in (b">", b"@"):
                    break
                s = line.rstrip(b"\r\n")
                if s:
                    seq_parts.append(s)
                line = _rl()
            seq = seq_parts[0] if len(seq_parts) == 1 else b"".join(seq_parts)
            qual = None
            if is_fastq:
                # kseq reads at least one quality line (ks_getuntil2 runs
                # before the length check, kseq.h:214) and keeps reading
                # while qual.l < seq.l; a final length mismatch is
                # kseq_read's -2 return, which ends the reference's
                # per-file `while (kseq_read(seq) >= 0)` loop
                # (FingerPrint.hpp:156) — drop the record and abandon the
                # rest of the file.
                qual_parts: list[bytes] = []
                qlen = 0
                slen = len(seq)
                first = True
                while first or qlen < slen:
                    ql = _rl()
                    if not ql:
                        break
                    first = False
                    ql = ql.rstrip(b"\r\n")
                    qual_parts.append(ql)
                    qlen += len(ql)
                if qlen != slen:
                    return  # kseq -2: malformed quality aborts the file
                qual = (
                    qual_parts[0]
                    if len(qual_parts) == 1
                    else b"".join(qual_parts)
                )
                line = _rl()
            yield FastxRecord(name, seq, qual)


def _header_name(line: bytes) -> str:
    # latin-1: kseq keeps names as raw bytes, so any byte value must
    # parse (a 0x80+ byte crashed strict ascii where the reference reads
    # the file fine); latin-1 maps bytes 1:1 onto code points
    return line[1:].split(None, 1)[0].decode("latin-1") if len(line) > 1 else ""


# ---------------------------------------------------------------------------
# Batched production reader
# ---------------------------------------------------------------------------


@dataclass
class ReadBatch:
    """A fixed-shape batch of encoded read segments for the device kernel."""

    codes: np.ndarray  # [batch, seglen] uint8, 0..3 valid, 4 invalid/pad
    lengths: np.ndarray  # [batch] int32 — segment length (incl. halo)
    n_reads: int  # whole reads finishing in this batch
    n_bases: int  # raw bases of those reads (reference counts every byte
    #               of the read including Ns: src/FingerPrint.hpp:102)


class NativeBatchReader:
    """BatchReader backed by the C++ chunker (ntsm_tpu_torch.native).

    Identical batch semantics to :class:`PyBatchReader` (asserted by
    tests/test_native_reader.py); ~an order of magnitude faster parse +
    encode, and the GIL is released inside every next-batch call so a
    prefetch thread overlaps it with device compute.
    """

    def __init__(
        self,
        paths: Sequence[str],
        k: int,
        seglen: int = 256,
        batch: int = 16384,
        dense: bool = False,
    ):
        from ntsm_tpu_torch import native

        if seglen <= k:
            raise ValueError("seglen must exceed k")
        self._lib = native.load()
        if self._lib is None:
            raise RuntimeError("native reader unavailable")
        self.paths = [str(p) for p in paths]
        for p in self.paths:
            if not _exists(p):
                raise FileNotFoundError(p)
        self.k = k
        self.seglen = seglen
        self.batch = batch
        self.dense = dense

    def __iter__(self) -> Iterator[ReadBatch]:
        import ctypes

        lib = self._lib
        B, L = self.batch, self.seglen
        cpaths = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths]
        )
        h = lib.ntsm_reader_open(
            cpaths, len(self.paths), self.k, L, B, int(self.dense)
        )
        try:
            while True:
                codes = np.empty((B, L), dtype=np.uint8)
                lengths = np.empty(B, dtype=np.int32)
                n_reads = ctypes.c_long(0)
                n_bases = ctypes.c_long(0)
                rows = lib.ntsm_reader_next_batch(
                    h,
                    codes.ctypes.data_as(ctypes.c_void_p),
                    lengths.ctypes.data_as(ctypes.c_void_p),
                    ctypes.byref(n_reads),
                    ctypes.byref(n_bases),
                )
                if rows < 0:
                    raise RuntimeError(
                        "native reader failed (bad file/format or IO error; "
                        "see stderr)"
                    )
                if rows == 0:
                    return
                yield ReadBatch(codes, lengths, n_reads.value, n_bases.value)
        finally:
            lib.ntsm_reader_close(h)


def _exists(path: str) -> bool:
    import os

    return os.path.exists(path)


def BatchReader(
    paths: Sequence[str],
    k: int,
    seglen: int = 256,
    batch: int = 16384,
    dense: bool = False,
):
    """Factory: the native C++ reader when available, else pure Python.

    dense=True packs multiple reads per row with a 1-byte separator and a
    k-1 halo across row boundaries (exact k-mer multiset; see the native
    reader) — ~40% more useful windows per probe for 150 bp reads."""
    import os

    if not os.environ.get("NTSM_NO_NATIVE"):
        try:
            return NativeBatchReader(
                paths, k=k, seglen=seglen, batch=batch, dense=dense
            )
        except (RuntimeError, OSError):
            pass
    return PyBatchReader(paths, k=k, seglen=seglen, batch=batch, dense=dense)


def _no_stage(name: str):
    return contextlib.nullcontext()


def _bounded_put(q, stop, item) -> bool:
    """Put onto a bounded queue unless `stop` is set (the shared
    stoppable-producer primitive for the engine upload thread and both
    reader fan-outs — keep the shutdown semantics in ONE place)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class ParallelFileReader:
    """Thread-per-file-group batch reader.

    The reference's only counting parallelism is one OpenMP thread per
    input file (FingerPrint.hpp:47); this is the same idea for the host
    pipeline: `threads` NativeBatchReaders each own a file subset and feed
    one bounded queue.  Single-stream gzip decompression tops out at
    ~130 Mbase/s/core, so multi-file gz inputs (the common
    lane_1/lane_2/... layout) need the fan-out to keep a >130 Mbase/s
    device fed.  Batch ORDER is nondeterministic across files, like the
    reference's threaded reads; counts are order-invariant and -m early
    termination is order-dependent there too.
    """

    def __init__(
        self,
        paths: Sequence[str],
        k: int,
        seglen: int = 256,
        batch: int = 16384,
        threads: int = 2,
        depth: int = 4,
        dense: bool = False,
        recorder=None,
    ):
        self.groups = [list(paths[i::threads]) for i in range(threads)]
        self.groups = [g for g in self.groups if g]
        self.k = k
        self.seglen = seglen
        self.batch = batch
        self.depth = depth
        self.dense = dense
        self.recorder = recorder  # a utils/spans.Recorder: each batch's parse, its stage

    def __iter__(self) -> Iterator[ReadBatch]:
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        sentinel = object()
        err: list[BaseException] = []

        def _put(item) -> bool:
            return _bounded_put(q, stop, item)

        stage = self.recorder.stage if self.recorder is not None else _no_stage

        def produce(group):
            try:
                reader = BatchReader(
                    group,
                    k=self.k,
                    seglen=self.seglen,
                    batch=self.batch,
                    dense=self.dense,
                )
                it = iter(reader)
                while True:
                    with stage("parse"):
                        b = next(it, None)
                    if b is None:
                        break
                    if not _put(b):
                        return  # consumer went away; reader closes via its
                        # own finally when the iterator is released
            except BaseException as e:
                err.append(e)
            finally:
                _put(sentinel)

        ts = [
            threading.Thread(target=produce, args=(g,), daemon=True)
            for g in self.groups
        ]
        for t in ts:
            t.start()
        done = 0
        try:
            while done < len(ts):
                item = q.get()
                if err:
                    raise err[0]  # fail fast, not after all groups finish
                if item is sentinel:
                    done += 1
                    continue
                yield item
            if err:
                raise err[0]
        finally:
            stop.set()
            for t in ts:
                t.join(timeout=5)


class PyBatchReader:
    """Stream one or more FASTA/FASTQ files as fixed-shape code batches.

    Long reads are split into segments of ``seglen`` with a k-1 overlap, so
    every k-mer appears in exactly one segment — "sequence parallelism" for
    arbitrary-length reads without any cross-segment state.
    """

    def __init__(
        self,
        paths: Sequence[str],
        k: int,
        seglen: int = 256,
        batch: int = 16384,
        dense: bool = False,
    ):
        if seglen <= k:
            raise ValueError("seglen must exceed k")
        self.paths = list(paths)
        self.k = k
        self.seglen = seglen
        self.batch = batch
        self.dense = dense

    def _iter_dense(self) -> Iterator[ReadBatch]:
        """Dense packing, mirroring the native reader exactly: reads
        concatenated per row with one separator byte; a read continues
        across the row boundary with a k-1 halo."""
        k, L, B = self.k, self.seglen, self.batch
        codes = np.full((B, L), 4, dtype=np.uint8)
        lengths = np.zeros(B, dtype=np.int32)
        state = dict(row=0, col=0, n_reads=0, n_bases=0)
        carry: list = [None, False]  # (remaining codes, cont)

        def flush():
            out = ReadBatch(
                codes.copy(), lengths.copy(), state["n_reads"], state["n_bases"]
            )
            codes.fill(4)
            lengths.fill(0)
            state.update(row=0, col=0, n_reads=0, n_bases=0)
            return out

        def place(enc: np.ndarray, cont: bool) -> bool:
            n = enc.shape[0]
            start = 0
            if not cont and state["col"] > 0:
                state["col"] += 1  # separator byte (stays 4)
            while True:
                if state["col"] > L - k:
                    state["row"] += 1
                    state["col"] = 0
                if state["row"] == B:
                    carry[0] = enc[start:]
                    carry[1] = cont or start > 0
                    return False
                m = min(L - state["col"], n - start)
                r, c = state["row"], state["col"]
                codes[r, c : c + m] = enc[start : start + m]
                state["col"] = c + m
                lengths[r] = state["col"]
                if start + m >= n:
                    return True
                start += m - (k - 1)
                state["row"] += 1
                state["col"] = 0

        def records():
            for path in self.paths:
                for rec in read_fastx(path):
                    yield rec

        it = records()
        while True:
            if carry[0] is not None:
                enc, cont = carry
                carry[0] = None
                if not place(enc, cont):
                    yield flush()
                    continue
            rec = next(it, None)
            if rec is None:
                break
            enc = NT4_TABLE[np.frombuffer(rec.seq, dtype=np.uint8)]
            state["n_reads"] += 1
            state["n_bases"] += enc.shape[0]
            if not place(enc, False):
                yield flush()
        if state["row"] > 0 or state["col"] > 0:
            yield flush()

    def __iter__(self) -> Iterator[ReadBatch]:
        if self.dense:
            yield from self._iter_dense()
            return
        k, L, B = self.k, self.seglen, self.batch
        stride = L - (k - 1)
        codes = np.full((B, L), 4, dtype=np.uint8)
        lengths = np.zeros(B, dtype=np.int32)
        row = 0
        n_reads = 0
        n_bases = 0

        def flush():
            nonlocal row, n_reads, n_bases
            out = ReadBatch(codes.copy(), lengths.copy(), n_reads, n_bases)
            codes.fill(4)
            lengths.fill(0)
            row = 0
            n_reads = 0
            n_bases = 0
            return out

        for path in self.paths:
            for rec in read_fastx(path):
                enc = NT4_TABLE[np.frombuffer(rec.seq, dtype=np.uint8)]
                n = enc.shape[0]
                n_reads += 1
                n_bases += n
                start = 0
                while True:
                    seg = enc[start : start + L]
                    m = seg.shape[0]
                    if m >= k or start == 0:
                        codes[row, :m] = seg
                        if m < L:
                            codes[row, m:] = 4
                        lengths[row] = m
                        row += 1
                        if row == B:
                            yield flush()
                    if start + L >= n:
                        break
                    start += stride
        if row:
            yield flush()
