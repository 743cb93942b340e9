"""ctypes bindings for the native FASTA/FASTQ loader (native/fastx.cpp).

The loader produces the same joined-bytes layout as the pure-python path
(records separated by `sep_len` zero bytes), so the two are interchangeable;
pipeline prefers native when the shared library is present (built lazily
with `make -C native` on first use if a compiler is available).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SO = os.path.join(_REPO, "native", "build", "libdtpu_fastx.so")

_lock = threading.Lock()
_lib = None
_tried = False


class _DtpuFastx(ctypes.Structure):
    # `names` must be a raw pointer, NOT c_char_p: attribute access on a
    # c_char_p field converts to a NUL-truncated bytes object, and
    # string_at(that, names_len) then reads past the short buffer —
    # leaked heap bytes (or a crash) for any header containing a NUL
    _fields_ = [
        ("seq", ctypes.POINTER(ctypes.c_uint8)),
        ("seq_len", ctypes.c_uint64),
        ("names", ctypes.POINTER(ctypes.c_char)),
        ("names_len", ctypes.c_uint64),
        ("nrecords", ctypes.c_uint64),
        ("rec_ends", ctypes.POINTER(ctypes.c_uint64)),
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            # always invoke make: a no-op when up to date, and it rebuilds
            # after fastx.cpp edits instead of serving a stale .so.  An
            # exclusive flock serializes concurrent first-builds (two
            # same-host ranks compiling -o the same .so interleaved
            # writes and left a corrupt fresh-mtime library behind).
            import fcntl
            lock_path = os.path.join(_REPO, "native", ".build.lock")
            with open(lock_path, "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                try:
                    subprocess.run(
                        ["make", "-C", os.path.join(_REPO, "native")],
                        check=True, capture_output=True, timeout=120)
                finally:
                    fcntl.flock(lk, fcntl.LOCK_UN)
        except Exception:
            if not os.path.exists(_SO):
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.dtpu_read_fastx.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                        ctypes.POINTER(_DtpuFastx)]
        lib.dtpu_read_fastx.restype = ctypes.c_int
        lib.dtpu_free.argtypes = [ctypes.POINTER(_DtpuFastx)]
        lib.dtpu_free.restype = None
        lib.dtpu_read_raw.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.dtpu_read_raw.restype = ctypes.c_int
        lib.dtpu_free_buf.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.dtpu_free_buf.restype = None
        lib.dtpu_fmt_rows.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        lib.dtpu_fmt_rows.restype = ctypes.c_int
        if hasattr(lib, "dtpu_fmt_nn_rows"):
            lib.dtpu_fmt_nn_rows.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int64, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64)]
            lib.dtpu_fmt_nn_rows.restype = ctypes.c_int
        if hasattr(lib, "dtpu_stream_open"):
            lib.dtpu_stream_open.argtypes = [ctypes.c_char_p,
                                             ctypes.c_uint32]
            lib.dtpu_stream_open.restype = ctypes.c_void_p
            lib.dtpu_stream_read.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_uint64]
            lib.dtpu_stream_read.restype = ctypes.c_int64
            lib.dtpu_stream_close.argtypes = [ctypes.c_void_p]
            lib.dtpu_stream_close.restype = None
        if hasattr(lib, "dtpu_hk_create"):
            lib.dtpu_hk_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_uint64, ctypes.c_double]
            lib.dtpu_hk_create.restype = ctypes.c_void_p
            lib.dtpu_hk_destroy.argtypes = [ctypes.c_void_p]
            lib.dtpu_hk_destroy.restype = None
            lib.dtpu_hk_add.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int64]
            lib.dtpu_hk_add.restype = None
            lib.dtpu_hk_query.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32)]
            lib.dtpu_hk_query.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def read_raw(path: str) -> Optional[bytes]:
    """Whole-file decompressed bytes via the native loader (handles gz and,
    when built against libzstd, zstd frames).  None on unavailability."""
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.POINTER(ctypes.c_uint8)()
    ln = ctypes.c_uint64()
    rc = lib.dtpu_read_raw(path.encode(), ctypes.byref(buf),
                           ctypes.byref(ln))
    if rc != 0:
        return None
    try:
        return ctypes.string_at(buf, ln.value)
    finally:
        lib.dtpu_free_buf(buf)


def fmt_rows_iter(vals: np.ndarray, counts: np.ndarray, fmt: int):
    """Format matrix rows natively; yields one str segment per row, each of
    the form '\\t<v0>\\t<v1>...'.  `vals` holds the rows concatenated,
    `counts` the per-row value counts.  fmt: 0 = '%.6g', 1 = '%e',
    2 = '%f' (matching io.distmat's emitters).  Returns None when the
    native library is unavailable — callers fall back to the Python loop.

    Rows are processed in bounded batches (~64 MB of formatting buffer) so
    arbitrarily large matrices never materialize a full text copy."""
    lib = _load()
    if lib is None or not hasattr(lib, "dtpu_fmt_rows"):
        return None
    counts = np.asarray(counts, np.int64)
    if int(counts.sum()) != vals.size:
        raise ValueError("counts do not partition vals")
    slot = 56 if fmt == 2 else 18
    batch_vals = max(1, (64 << 20) // slot)

    def gen():
        r, v0 = 0, 0
        nrows = counts.size
        while r < nrows:
            r1, acc = r, 0
            while r1 < nrows and (acc == 0 or acc + counts[r1] <= batch_vals):
                acc += int(counts[r1])
                r1 += 1
            off = np.zeros(r1 - r + 1, np.int64)
            np.cumsum(counts[r:r1], out=off[1:])
            # convert per batch: `vals` may be an out-of-core memmap of the
            # whole condensed matrix — never materialize it wholesale
            sub = np.ascontiguousarray(vals[v0:v0 + acc], np.float32)
            v0 += acc
            out = ctypes.create_string_buffer(max(1, acc * slot))
            seg = np.zeros(r1 - r, np.int64)
            rc = lib.dtpu_fmt_rows(
                sub.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                r1 - r, fmt, slot, 0, out,
                seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            if rc != 0:
                raise RuntimeError("dtpu_fmt_rows failed")
            mv = memoryview(out)
            for i in range(r1 - r):
                a = int(off[i]) * slot
                yield bytes(mv[a:a + int(seg[i])]).decode("ascii")
            r = r1
    return gen()


def fmt_nn_rows_iter(vals: np.ndarray, ids: np.ndarray, fmt: int = 0):
    """Format k-NN rows natively; yields one '\\t<id>:<v>...' str segment
    per row.  vals (nrows, nn) float32, ids (nrows, nn) int64.  Returns
    None when unavailable — callers fall back to the Python loop."""
    lib = _load()
    if lib is None or not hasattr(lib, "dtpu_fmt_nn_rows"):
        return None
    nrows, nn = vals.shape
    slot = 78 if fmt == 2 else 40
    batch_rows = max(1, (64 << 20) // (slot * max(nn, 1)))

    def gen():
        r = 0
        while r < nrows:
            r1 = min(nrows, r + batch_rows)
            sub_v = np.ascontiguousarray(vals[r:r1], np.float32)
            sub_i = np.ascontiguousarray(ids[r:r1], np.int64)
            out = ctypes.create_string_buffer(max(1, (r1 - r) * nn * slot))
            seg = np.zeros(r1 - r, np.int64)
            rc = lib.dtpu_fmt_nn_rows(
                sub_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                sub_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                r1 - r, nn, fmt, slot, out,
                seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            if rc != 0:
                raise RuntimeError("dtpu_fmt_nn_rows failed")
            mv = memoryview(out)
            for i in range(r1 - r):
                a = i * nn * slot
                yield bytes(mv[a:a + int(seg[i])]).decode("ascii")
            r = r1
    return gen()


def stream_joined(path: str, sep_len: int, chunk_bytes: int = 4 << 20):
    """Generator of joined uint8 arrays for one file in O(chunk) memory.

    Concatenating the yielded arrays equals read_joined(path, sep_len)[0]
    byte-for-byte (the incremental state machine in native/fastx.cpp
    replicates the batch parser's kseq record semantics).  Returns None
    when the native library lacks the streaming API or the file cannot be
    opened (zstd without libzstd included) — callers fall back to the
    Python streaming parser."""
    lib = _load()
    if lib is None or not hasattr(lib, "dtpu_stream_open"):
        return None
    h = lib.dtpu_stream_open(path.encode(), sep_len)
    if not h:
        return None

    def gen():
        buf = np.empty(chunk_bytes, np.uint8)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        try:
            while True:
                got = lib.dtpu_stream_read(h, ptr, chunk_bytes)
                if got == 0:
                    return
                if got < 0:
                    raise ValueError(
                        f"{path}: malformed or unreadable FASTA/FASTQ "
                        f"(native stream error {got})")
                yield buf[:got].copy()
        finally:
            lib.dtpu_stream_close(h)
    return gen()


def read_joined(path: str, sep_len: int
                ) -> Optional[Tuple[np.ndarray, List[bytes], np.ndarray]]:
    """Returns (joined uint8 array, record names, record end offsets), or
    None if the native library is unavailable or refuses the file."""
    lib = _load()
    if lib is None:
        return None
    res = _DtpuFastx()
    rc = lib.dtpu_read_fastx(path.encode(), sep_len, ctypes.byref(res))
    if rc != 0:
        return None
    try:
        n = int(res.seq_len)
        seq = np.ctypeslib.as_array(res.seq, shape=(n,)).copy() if n else \
            np.zeros(0, np.uint8)
        names_blob = ctypes.string_at(res.names, int(res.names_len))
        nrec_hdr = int(res.nrecords)
        names = (names_blob.split(b"\n") if nrec_hdr
                 else [])   # one entry per record even for empty headers
        if nrec_hdr and len(names) != nrec_hdr:
            names = (names + [b""] * nrec_hdr)[:nrec_hdr]
        nrec = int(res.nrecords)
        ends = (np.ctypeslib.as_array(res.rec_ends, shape=(nrec,)).copy()
                if nrec else np.zeros(0, np.uint64))
        return seq, names, ends
    finally:
        lib.dtpu_free(ctypes.byref(res))
