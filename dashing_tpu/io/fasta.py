"""Host-side FASTA/FASTQ reading (the kseq + zlib layer of the reference).

The reference streams records through klib's kseq over gzFile with zstd
transparently wrapped behind the zlib API (reference Makefile:58-62,
src/sketch_and_cmp.h:565-570).  Here files are parsed with vectorized numpy
newline scans, which at device feed rates is the pragmatic host-side choice;
gzip/zstd handled by the stdlib / a gated zstandard import.

Output contract: a list of (name, sequence-bytes) records, or a single flat
uint8 array with records joined by invalid separator bytes ready for tiling
(see ops/encode.join_records).
"""
from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, List, Tuple

import numpy as np

Record = Tuple[bytes, bytes]


def _open_raw(path: str) -> bytes:
    with open(path, "rb") as fp:
        head = fp.read(4)
        fp.seek(0)
        if head[:2] == b"\x1f\x8b":
            with gzip.open(fp) as gz:
                return gz.read()
        if head == b"\x28\xb5\x2f\xfd":  # zstd frame
            try:
                import zstandard  # optional; gate, don't require
                return zstandard.ZstdDecompressor().stream_reader(fp).read()
            except ImportError:
                pass
            from . import native    # native loader links libzstd if present
            raw = native.read_raw(path)
            if raw is not None:
                return raw
            raise RuntimeError(
                f"{path} is zstd-compressed but neither the zstandard "
                "module nor a zstd-enabled native loader is available")
        return fp.read()


def read_records(path: str) -> List[Record]:
    """Parse one FASTA or FASTQ file (auto-detected, optionally gz/zstd)."""
    return [(n, s) for n, _, s, _ in read_records_full(path)]


def read_records_full(path: str):
    """Full kseq-shaped records: (name, comment, seq, qual_or_None).

    name/comment split like kseq (name = up to the first whitespace,
    comment = the rest of the header line); qual is None for FASTA.
    readfilt re-emits reads with their original comment (reference
    src/readfilt.cpp:17-33), so the parser must keep it."""
    data = _open_raw(path)
    if not data:
        return []
    if data[0:1] == b">":
        return _parse_fasta(data)
    if data[0:1] == b"@":
        return _parse_fastq(data)
    raise ValueError(f"{path}: not FASTA or FASTQ (starts with {data[:1]!r})")


def _split_header(header: bytes):
    header = header.rstrip(b"\r")
    parts = header.split(None, 1)
    name = parts[0] if parts else b""
    comment = parts[1] if len(parts) > 1 else b""
    return bytes(name), bytes(comment)


def _parse_fasta(data: bytes):
    out = []
    # Split on '\n>' boundaries without copying the whole payload per record.
    chunks = data.split(b"\n>")
    for i, chunk in enumerate(chunks):
        if i == 0:
            chunk = chunk[1:]  # strip leading '>'
        if not chunk:
            continue
        nl = chunk.find(b"\n")
        if nl < 0:
            header, body = chunk, b""
        else:
            header, body = chunk[:nl], chunk[nl + 1:]
        name, comment = _split_header(header)
        seq = body.replace(b"\n", b"").replace(b"\r", b"")
        out.append((name, comment, seq, None))
    return out


def _parse_fastq(data: bytes):
    """FASTQ with full kseq record semantics (reference call sites
    src/sketch_and_cmp.h:565-570): sequence may WRAP over multiple lines
    until the '+' separator, and quality is consumed by LENGTH (not by
    line count), so '@' at the start of a quality line never starts a
    false record.  The common strict 4-line layout takes a constant-work
    fast path (1M-read files are host-parse bound)."""
    out = []
    lines = data.split(b"\n")
    i = 0
    n = len(lines)
    while i < n:
        header = lines[i]
        if not header or header == b"\r":
            i += 1
            continue
        if not header.startswith(b"@"):
            raise ValueError(f"malformed FASTQ near line {i}")
        name, comment = _split_header(header[1:])
        if (i + 2 < n and lines[i + 2][:1] == b"+"
                and lines[i + 1][:1] not in (b"+", b"@", b">")):
            # single-line sequence (the common layout).  The marker guard
            # keeps kseq semantics: a line starting '+'/'@'/'>' ends the
            # (empty) sequence even in the 4-line shape, matching the
            # native parser and the streaming iterator exactly.
            seq = lines[i + 1].rstrip(b"\r")
            i += 3                       # past the '+' line
            has_qual = True
        else:
            i += 1
            parts = []
            # kseq stops sequence accumulation at '+', '@' OR '>' — a
            # record missing its '+' separator must not swallow the next
            # record (and quality then doesn't exist for it)
            while i < n and lines[i][:1] not in (b"+", b"@", b">"):
                parts.append(lines[i].rstrip(b"\r"))
                i += 1
            seq = b"".join(parts)
            has_qual = i < n and lines[i][:1] == b"+"
            if has_qual:
                i += 1                   # '+' line
        qual = None
        if has_qual:
            qparts = []
            qlen = 0
            while i < n and qlen < len(seq):
                qline = lines[i].rstrip(b"\r")
                qparts.append(qline)
                qlen += len(qline)
                i += 1
            qual = b"".join(qparts)
        out.append((bytes(name), comment, bytes(seq), qual))
    return out



# ---------------------------------------------------------------------------
# Streaming joined-bytes fallback: O(chunk) memory regardless of file size.
# Primary path is the native incremental parser (native/fastx.cpp
# dtpu_stream_*); this pure-Python state machine produces the identical
# joined stream (records separated by sep_len zero bytes, kseq record
# semantics per reference src/sketch_and_cmp.h:565-570) when the native
# library is unavailable.
# ---------------------------------------------------------------------------

class _ClosingStream:
    """Read-through wrapper whose close() also closes the underlying
    file (gzip.GzipFile and zstandard's stream_reader leave the passed
    fileobj open, which leaks the os-level fd until GC)."""

    def __init__(self, outer, inner):
        self._outer, self._inner = outer, inner

    def read(self, n=-1):
        return self._outer.read(n)

    def close(self):
        try:
            self._outer.close()
        finally:
            self._inner.close()


def _open_stream(path: str):
    """Binary stream with transparent gz/zstd decompression (O(chunk))."""
    fp = open(path, "rb")
    head = fp.read(4)
    fp.seek(0)
    if head[:2] == b"\x1f\x8b":
        return _ClosingStream(gzip.open(fp), fp)
    if head == b"\x28\xb5\x2f\xfd":
        try:
            import zstandard
            return _ClosingStream(
                zstandard.ZstdDecompressor().stream_reader(fp), fp)
        except ImportError:
            fp.close()
            # last resort: materialize via the native raw reader (bounded
            # memory is lost but correctness kept; native builds link zstd
            # so in practice the native STREAM serves zstd before this)
            from . import native
            raw = native.read_raw(path)
            if raw is None:
                raise RuntimeError(
                    f"{path} is zstd-compressed but neither the zstandard "
                    "module nor a zstd-enabled native loader is available")
            return io.BytesIO(raw)
    return fp


class _JoinStreamParser:
    """Span-level incremental parser emitting the joined-byte stream —
    a Python port of the native state machine (native/fastx.cpp
    dtpu_stream_*), so the two are semantically one parser: trailing-
    '\\r' runs withheld until line resolution, FASTQ sequence wraps
    until a line starting '+'/'@' ('>' is an error), quality consumed by
    LENGTH so '@' quality lines never open a false record.  No line
    carry is kept: a single-line multi-hundred-MB FASTA streams through
    in O(chunk) (the previous line-based version buffered the whole
    line)."""

    def __init__(self, sep_len: int):
        self.sep_len = sep_len
        self.state = "detect"
        self.line_start = True
        self.nrecords = 0
        self.slen = 0
        self.qlen = 0
        self.cr_held = 0

    def _start_record(self, out: list):
        if self.nrecords:
            out.append(b"\x00" * self.sep_len)
        self.nrecords += 1

    def _span(self, data: bytes, i: int, e: int, out: list,
              count_only: bool):
        """Content span [i, e) with trailing-'\\r' withholding."""
        if i == e:
            return
        t = e
        while t > i and data[t - 1:t] == b"\r":
            t -= 1
        if t == i:                 # all-'\r' span: extend the hold
            self.cr_held += e - i
            return
        emitted = self.cr_held + (t - i)
        if count_only:
            self.qlen += emitted
        else:
            if self.cr_held:
                out.append(b"\r" * self.cr_held)
            out.append(data[i:t])
            self.slen += emitted
        self.cr_held = e - t

    def feed(self, data: bytes) -> bytes:
        out: list = []
        n = len(data)
        i = 0
        while i < n:
            st = self.state
            c = data[i:i + 1]
            if st == "detect":
                if c == b">":
                    self._start_record(out)
                    self.state = "fa_header"
                elif c == b"@":
                    self._start_record(out)
                    self.state = "fq_header"
                else:
                    raise ValueError(
                        f"not FASTA or FASTQ (starts with {c!r})")
                i += 1
            elif st in ("fa_header", "fq_header", "fq_plus"):
                nl = data.find(b"\n", i)
                if nl < 0:
                    i = n
                    self.line_start = False
                else:
                    i = nl + 1
                    self.line_start = True
                    if st == "fa_header":
                        self.state = "fa_body"
                    elif st == "fq_header":
                        self.state = "fq_seq"
                        self.slen = 0
                    else:
                        self.state = "fq_qual"
                        self.qlen = 0
            elif st == "fa_body":
                if self.line_start and c == b">":
                    self.cr_held = 0
                    self._start_record(out)
                    self.state = "fa_header"
                    i += 1
                    continue
                nl = data.find(b"\n", i)
                e = n if nl < 0 else nl
                self._span(data, i, e, out, False)
                if nl < 0:
                    i = n
                    self.line_start = False
                else:
                    self.cr_held = 0
                    i = nl + 1
                    self.line_start = True
            elif st == "fq_seq":
                if self.line_start:
                    if c == b"+":
                        self.cr_held = 0
                        self.state = "fq_plus"
                        continue
                    if c == b"@":
                        self.cr_held = 0
                        self.state = "fq_bound"
                        continue
                    if c == b">":
                        raise ValueError("malformed FASTQ ('>' in record)")
                nl = data.find(b"\n", i)
                e = n if nl < 0 else nl
                self._span(data, i, e, out, False)
                if nl < 0:
                    i = n
                    self.line_start = False
                else:
                    self.cr_held = 0
                    i = nl + 1
                    self.line_start = True
            elif st == "fq_qual":
                if self.line_start and self.qlen >= self.slen:
                    self.state = "fq_bound"
                    continue
                nl = data.find(b"\n", i)
                e = n if nl < 0 else nl
                self._span(data, i, e, out, True)
                if nl < 0:
                    i = n
                    self.line_start = False
                else:
                    self.cr_held = 0
                    i = nl + 1
                    self.line_start = True
            else:  # fq_bound: between records, skip '\r'/'\n' bytes
                if c in (b"\n", b"\r"):
                    i += 1
                elif c == b"@":
                    self._start_record(out)
                    self.state = "fq_header"
                    i += 1
                else:
                    raise ValueError(
                        "malformed FASTQ (expected '@' record header)")
        return b"".join(out)

    def finish(self) -> bytes:
        self.cr_held = 0     # EOF strips a trailing-'\r' run (batch parity)
        return b""


def stream_joined(path: str, sep_len: int, chunk_bytes: int = 4 << 20
                  ) -> Iterator[np.ndarray]:
    """Yield joined uint8 arrays for one file in O(chunk) memory; the
    concatenation equals the batch parse (join_records over read_records)
    byte-for-byte."""
    parser = _JoinStreamParser(sep_len)
    fp = _open_stream(path)
    try:
        while True:
            chunk = fp.read(chunk_bytes)
            if not chunk:
                tail = parser.finish()
                if tail:
                    yield np.frombuffer(tail, np.uint8)
                return
            got = parser.feed(chunk)
            if got:
                yield np.frombuffer(got, np.uint8)
    finally:
        fp.close()


def iter_records_full(path: str, chunk_bytes: int = 4 << 20):
    """Streaming equivalent of read_records_full: yields kseq-shaped
    (name, comment, seq, qual_or_None) records in O(record + chunk)
    memory instead of materializing the whole decompressed file (the
    reference's kseq streaming, src/sketch_and_cmp.h:565-570).  Record
    contents match read_records_full (fuzz-pinned in
    tests/test_streaming_ingest.py)."""
    fp = _open_stream(path)
    try:
        first = fp.read(1)
        if not first:
            return
        if first == b">":
            yield from _iter_fasta(fp, chunk_bytes)
        elif first == b"@":
            yield from _iter_fastq(fp, chunk_bytes)
        else:
            raise ValueError(
                f"{path}: not FASTA or FASTQ (starts with {first!r})")
    finally:
        fp.close()


def _iter_fasta(fp, chunk_bytes):
    """Record boundaries at '\\n>' exactly like _parse_fasta (the leading
    '>' was already consumed by the caller's sniff)."""
    carry = b""
    while True:
        chunk = fp.read(chunk_bytes)
        if not chunk:
            break
        pieces = (carry + chunk).split(b"\n>")
        carry = pieces.pop()
        for piece in pieces:
            rec = _fasta_record(piece)
            if rec is not None:
                yield rec
    rec = _fasta_record(carry)
    if rec is not None:
        yield rec


def _fasta_record(piece: bytes):
    if not piece:
        return None          # batch parser skips empty chunks
    nl = piece.find(b"\n")
    if nl < 0:
        header, body = piece, b""
    else:
        header, body = piece[:nl], piece[nl + 1:]
    name, comment = _split_header(header)
    return (name, comment,
            body.replace(b"\n", b"").replace(b"\r", b""), None)


def _iter_fastq(fp, chunk_bytes):
    """Line-driven incremental FASTQ with the kseq record semantics of
    _parse_fastq: sequence wraps until '+'/'@'/'>', quality consumed by
    LENGTH.  The caller consumed the first '@' already."""
    state = "header"
    name = comment = None
    parts: list = []
    qparts: list = []
    slen = qlen = 0
    first_line = True
    carry = b""

    def record(qual):
        return (name, comment, b"".join(parts), qual)

    while True:
        chunk = fp.read(chunk_bytes)
        lines = (carry + chunk).split(b"\n")
        carry = lines.pop()
        if not chunk:
            lines.append(carry)      # final (unterminated) line
            carry = b""
        for line in lines:
            if first_line:
                # the sniffed-off '@' belonged to this header line
                line = b"@" + line
                first_line = False
            redo = True
            while redo:
                redo = False
                if state == "header":
                    if not line or line == b"\r":
                        break
                    if not line.startswith(b"@"):
                        raise ValueError("malformed FASTQ record header")
                    name, comment = _split_header(line[1:])
                    parts, slen = [], 0
                    state = "seq"
                elif state == "seq":
                    c = line[:1]
                    if c == b"+":
                        qparts, qlen = [], 0
                        state = "qual"
                    elif c in (b"@", b">"):
                        yield record(None)
                        state = "header"
                        redo = True
                    else:
                        seg = line.rstrip(b"\r")
                        parts.append(seg)
                        slen += len(seg)
                elif state == "qual":
                    if qlen >= slen:
                        yield record(b"".join(qparts))
                        state = "header"
                        redo = True
                    else:
                        seg = line.rstrip(b"\r")
                        qparts.append(seg)
                        qlen += len(seg)
        if not chunk:
            break
    if state == "seq":
        yield record(None)
    elif state == "qual":
        yield record(b"".join(qparts))


def fname_is_fq(path: str) -> bool:
    """reference src/dashing.cpp:245-248."""
    return ".fastq" in path or ".fq" in path
