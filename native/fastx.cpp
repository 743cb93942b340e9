// Native FASTA/FASTQ loader for dashing_tpu.
//
// The reference's sequence layer is C (klib kseq over gzFile; see reference
// Makefile:58-65 and src/sketch_and_cmp.h:565-570).  This is its device-host
// equivalent: parse a (possibly gzip-compressed) FASTA/FASTQ file into ONE
// contiguous byte buffer with records joined by `sep_len` zero bytes —
// exactly the layout dashing_tpu.ops.encode.join_records produces — plus a
// newline-joined name table.  Zero bytes are invalid bases, so k-mer windows
// never span records.
//
// Build:  make -C native     (g++ -O3 -shared -fPIC, links zlib)
// Python: dashing_tpu/io/native.py (ctypes, numpy zero-copy views).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>
#ifdef DTPU_HAVE_ZSTD
#include <zstd.h>
#endif

extern "C" {

struct DtpuFastx {
    uint8_t *seq;        // joined sequence bytes (malloc'd)
    uint64_t seq_len;
    char *names;         // '\n'-joined record names (malloc'd)
    uint64_t names_len;
    uint64_t nrecords;
    uint64_t *rec_ends;  // exclusive end offset of each record in `seq`
};

// zstd is wrapped transparently like the reference's zlibWrapper
// (reference Makefile:58-62, -DZWRAP_USE_ZSTD=1): sniff the frame magic
// and stream-decompress; builds without libzstd return -7 so the Python
// fallback engages instead of mis-parsing compressed bytes.
static int read_zstd(const char *path, std::vector<uint8_t> &out) {
#ifdef DTPU_HAVE_ZSTD
    std::FILE *fp = std::fopen(path, "rb");
    if (!fp) return -1;
    ZSTD_DStream *ds = ZSTD_createDStream();
    if (!ds) { std::fclose(fp); return -2; }
    std::vector<uint8_t> inbuf(ZSTD_DStreamInSize());
    std::vector<uint8_t> outbuf(ZSTD_DStreamOutSize());
    out.clear();
    int rc = 0;
    size_t last = 0;   // last ZSTD_decompressStream hint: 0 = frame done
    for (;;) {
        size_t got = std::fread(inbuf.data(), 1, inbuf.size(), fp);
        if (got == 0) break;
        ZSTD_inBuffer zin{inbuf.data(), got, 0};
        while (zin.pos < zin.size) {
            ZSTD_outBuffer zout{outbuf.data(), outbuf.size(), 0};
            last = ZSTD_decompressStream(ds, &zout, &zin);
            if (ZSTD_isError(last)) { rc = -2; goto done; }
            out.insert(out.end(), outbuf.data(), outbuf.data() + zout.pos);
        }
        if (got < inbuf.size()) break;
    }
    // EOF mid-frame = truncated input: silently returning the partial
    // bytes would parse as a valid-but-shorter FASTA and skew sketches
    if (last != 0) rc = -2;
done:
    ZSTD_freeDStream(ds);
    std::fclose(fp);
    return rc;
#else
    (void)path; (void)out;
    return -7;
#endif
}

static int read_all(const char *path, std::vector<uint8_t> &data) {
    {   // zstd frame? (zlib cannot; mirror the reference's zstd wrapping)
        std::FILE *fp = std::fopen(path, "rb");
        if (!fp) return -1;
        unsigned char head[4] = {0, 0, 0, 0};
        size_t n = std::fread(head, 1, 4, fp);
        std::fclose(fp);
        if (n == 4 && head[0] == 0x28 && head[1] == 0xb5 && head[2] == 0x2f
            && head[3] == 0xfd)
            return read_zstd(path, data);
    }
    gzFile fp = gzopen(path, "rb");  // reads plain files transparently too
    if (!fp) return -1;
    gzbuffer(fp, 1 << 20);
    const size_t CHUNK = 1 << 22;
    size_t used = 0;
    for (;;) {
        // grow geometrically: fixed-step resize realloc-copied the whole
        // buffer every 4 MB (O(n^2) memcpy — measured slower than the
        // Python parser on a 210 MB FASTQ)
        if (data.size() < used + CHUNK)
            data.resize(std::max(used + CHUNK, used + used / 2));
        size_t room = data.size() - used;
        int got = gzread(fp, data.data() + used,
                         static_cast<unsigned>(std::min(room, CHUNK)));
        if (got < 0) { gzclose(fp); return -2; }
        used += static_cast<size_t>(got);
        if (static_cast<size_t>(got) < CHUNK) break;
    }
    data.resize(used);
    gzclose(fp);
    return 0;
}

// Returns 0 on success; negative error codes otherwise.
int dtpu_read_fastx(const char *path, uint32_t sep_len, DtpuFastx *out) {
    std::vector<uint8_t> data;
    int rc = read_all(path, data);
    if (rc) return rc;
    std::memset(out, 0, sizeof(*out));
    if (data.empty()) {
        out->seq = static_cast<uint8_t *>(std::malloc(1));
        out->names = static_cast<char *>(std::malloc(1));
        out->rec_ends = static_cast<uint64_t *>(std::malloc(8));
        return 0;
    }
    const bool fastq = data[0] == '@';
    if (!fastq && data[0] != '>') return -3;

    std::vector<uint8_t> seq;
    seq.reserve(data.size());
    std::string names;
    std::vector<uint64_t> rec_ends;
    const uint8_t *p = data.data();
    const uint8_t *end = p + data.size();

    auto line_end = [&](const uint8_t *s) {
        const uint8_t *nl = static_cast<const uint8_t *>(
            std::memchr(s, '\n', static_cast<size_t>(end - s)));
        return nl ? nl : end;
    };
    size_t named_records = 0;
    auto push_name = [&](const uint8_t *s, const uint8_t *e) {
        // first whitespace-delimited token.  Separator decision tracks
        // the RECORD count, not names.empty(): a leading empty header
        // used to emit no separator, shifting every later name onto the
        // wrong record in the Python-side split.
        const uint8_t *t = s;
        while (t < e && *t != ' ' && *t != '\t' && *t != '\r') ++t;
        if (named_records++) names.push_back('\n');
        names.append(reinterpret_cast<const char *>(s),
                     static_cast<size_t>(t - s));
    };
    auto start_record = [&]() {
        if (!rec_ends.empty())
            seq.insert(seq.end(), sep_len, 0);
    };

    if (!fastq) {
        while (p < end) {
            if (*p != '>') return -4;
            const uint8_t *nl = line_end(p + 1);
            start_record();
            push_name(p + 1, nl);
            p = nl < end ? nl + 1 : end;
            while (p < end && *p != '>') {
                nl = line_end(p);
                const uint8_t *q = nl;
                while (q > p && (q[-1] == '\r')) --q;
                seq.insert(seq.end(), p, q);
                p = nl < end ? nl + 1 : end;
            }
            rec_ends.push_back(seq.size());
        }
    } else {
        // kseq record semantics (reference src/sketch_and_cmp.h:565-570):
        // sequence may wrap over multiple lines until the '+' separator;
        // quality is consumed by LENGTH, so a quality line starting with
        // '@' never opens a false record.
        while (p < end) {
            if (*p != '@') {
                if (*p == '\n' || *p == '\r') { ++p; continue; }
                return -5;
            }
            const uint8_t *nl = line_end(p + 1);
            start_record();
            push_name(p + 1, nl);
            p = nl < end ? nl + 1 : end;           // -> sequence line(s)
            const size_t seq_start = seq.size();
            // kseq stops sequence accumulation at '+', '@' or '>': a
            // record missing its '+' must not swallow the next record
            while (p < end && *p != '+' && *p != '@' && *p != '>') {
                nl = line_end(p);
                const uint8_t *q = nl;
                while (q > p && q[-1] == '\r') --q;
                seq.insert(seq.end(), p, q);
                p = nl < end ? nl + 1 : end;
            }
            const size_t slen = seq.size() - seq_start;
            rec_ends.push_back(seq.size());
            if (p < end && *p == '+') {            // quality exists
                nl = line_end(p);                  // skip the '+' line
                p = nl < end ? nl + 1 : end;
                size_t qlen = 0;                   // -> quality by length
                while (p < end && qlen < slen) {
                    nl = line_end(p);
                    const uint8_t *q = nl;
                    while (q > p && q[-1] == '\r') --q;
                    qlen += static_cast<size_t>(q - p);
                    p = nl < end ? nl + 1 : end;
                }
            }
        }
    }

    out->seq_len = seq.size();
    out->seq = static_cast<uint8_t *>(std::malloc(seq.size() ? seq.size() : 1));
    std::memcpy(out->seq, seq.data(), seq.size());
    out->names_len = names.size();
    // +1: the Python side reads this as a C string, so it must be
    // NUL-terminated (ctypes strlen-scans past the end otherwise)
    out->names = static_cast<char *>(std::malloc(names.size() + 1));
    std::memcpy(out->names, names.data(), names.size());
    out->names[names.size()] = '\0';
    out->nrecords = rec_ends.size();
    out->rec_ends = static_cast<uint64_t *>(
        std::malloc(rec_ends.size() ? rec_ends.size() * 8 : 8));
    std::memcpy(out->rec_ends, rec_ends.data(), rec_ends.size() * 8);
    return 0;
}

// Decompressed whole-file bytes (gz/zstd/plain) for the Python record
// parser — lets read_records handle zstd without a python zstd module.
int dtpu_read_raw(const char *path, uint8_t **buf, uint64_t *len) {
    std::vector<uint8_t> data;
    int rc = read_all(path, data);
    if (rc) return rc;
    *buf = static_cast<uint8_t *>(std::malloc(data.size() ? data.size() : 1));
    if (!*buf) return -8;   // let the Python fallback engage, don't segfault
    std::memcpy(*buf, data.data(), data.size());
    *len = data.size();
    return 0;
}

// ---------------------------------------------------------------------------
// Streaming joined-bytes reader: O(chunk) host memory regardless of file
// size.  The reference streams records through kseq over gzFile
// (src/sketch_and_cmp.h:565-570) in O(record); dtpu_read_fastx above
// materializes the whole decompressed file (~2x decompressed size peak),
// which swaps on multi-GB FASTQ.  This incremental state machine produces
// the IDENTICAL joined-byte stream (records separated by sep_len zero
// bytes, kseq record semantics: wrapped sequence until '+', quality by
// LENGTH, trailing-'\r' stripping per line) in bounded memory; the Python
// side (pipeline._stream_file_tiles) re-cuts it into the same tiles.
// ---------------------------------------------------------------------------

namespace {

struct DtpuStream {
    // decompression source (gz handles plain files transparently)
    gzFile gz = nullptr;
#ifdef DTPU_HAVE_ZSTD
    std::FILE *zfp = nullptr;
    ZSTD_DStream *ds = nullptr;
    std::vector<uint8_t> zin;
    size_t zin_pos = 0, zin_len = 0;
    size_t zlast = 0;        // last decompressStream hint: 0 = frame done
    bool zin_eof = false;
#endif
    bool is_zstd = false;
    bool src_eof = false;

    uint32_t sep_len = 0;
    int err = 0;

    enum State { DETECT, FA_HEADER, FA_BODY, FQ_BOUND, FQ_HEADER, FQ_SEQ,
                 FQ_PLUS, FQ_QUAL };
    int state = DETECT;
    bool line_start = true;
    uint64_t nrecords = 0;
    uint64_t slen = 0;       // current FASTQ record's emitted sequence length
    uint64_t qlen = 0;       // quality bytes consumed so far
    uint64_t cr_held = 0;    // trailing-'\r' run withheld until resolution

    std::vector<uint8_t> out;   // joined bytes ready for the caller
    size_t out_pos = 0;
    std::vector<uint8_t> inbuf; // current decompressed chunk
};

constexpr size_t kStreamChunk = 1 << 20;

// Emit/count a span of line content with trailing-'\r' withholding: the
// batch parsers strip ONLY the trailing run of '\r' before a newline (or
// EOF), so a '\r' run that a chunk boundary splits must be withheld until
// we know whether content follows on the same line.
static void span_content(DtpuStream *s, const uint8_t *b, const uint8_t *e,
                         bool count_only) {
    if (b == e) return;
    const uint8_t *t = e;
    while (t > b && t[-1] == '\r') --t;
    if (t == b) {                      // span is all '\r': extend the hold
        s->cr_held += static_cast<uint64_t>(e - b);
        return;
    }
    // non-CR content exists: any held CRs (and interior ones) are mid-line
    uint64_t emitted = s->cr_held + static_cast<uint64_t>(t - b);
    if (!count_only) {
        s->out.insert(s->out.end(), s->cr_held, '\r');
        s->out.insert(s->out.end(), b, t);
        s->slen += emitted;
    }
    s->qlen += count_only ? emitted : 0;
    s->cr_held = static_cast<uint64_t>(e - t);
}

static void start_record(DtpuStream *s) {
    if (s->nrecords)
        s->out.insert(s->out.end(), s->sep_len, 0);
    ++s->nrecords;
}

// Parse the whole current inbuf into s->out.  Every state consumes to the
// next newline or chunk end, so no cross-call input carry is needed.
static void stream_parse(DtpuStream *s) {
    const uint8_t *d = s->inbuf.data();
    const size_t n = s->inbuf.size();
    size_t i = 0;
    auto find_nl = [&](size_t from) -> size_t {
        const void *nl = std::memchr(d + from, '\n', n - from);
        return nl ? static_cast<size_t>(static_cast<const uint8_t *>(nl) - d)
                  : n;
    };
    while (i < n && !s->err) {
        const uint8_t c = d[i];
        switch (s->state) {
        case DtpuStream::DETECT:
            if (c == '>') { start_record(s); s->state = DtpuStream::FA_HEADER; ++i; }
            else if (c == '@') { start_record(s); s->state = DtpuStream::FQ_HEADER; ++i; }
            else s->err = -3;
            break;
        case DtpuStream::FA_HEADER:
        case DtpuStream::FQ_HEADER:
        case DtpuStream::FQ_PLUS: {
            const size_t nl = find_nl(i);
            if (nl == n) { i = n; s->line_start = false; break; }
            i = nl + 1;
            s->line_start = true;
            if (s->state == DtpuStream::FA_HEADER)
                s->state = DtpuStream::FA_BODY;
            else if (s->state == DtpuStream::FQ_HEADER) {
                s->state = DtpuStream::FQ_SEQ;
                s->slen = 0;
            } else {                    // FQ_PLUS
                s->state = DtpuStream::FQ_QUAL;
                s->qlen = 0;
            }
            break;
        }
        case DtpuStream::FA_BODY: {
            if (s->line_start && c == '>') {
                s->cr_held = 0;
                start_record(s);
                s->state = DtpuStream::FA_HEADER;
                ++i;
                break;
            }
            const size_t nl = find_nl(i);
            span_content(s, d + i, d + nl, /*count_only=*/false);
            if (nl == n) { i = n; s->line_start = false; }
            else { s->cr_held = 0; i = nl + 1; s->line_start = true; }
            break;
        }
        case DtpuStream::FQ_SEQ: {
            if (s->line_start) {
                // kseq stops sequence accumulation at '+', '@' or '>': a
                // record missing its '+' must not swallow the next record
                if (c == '+') { s->cr_held = 0; s->state = DtpuStream::FQ_PLUS; break; }
                if (c == '@') { s->cr_held = 0; s->state = DtpuStream::FQ_BOUND; break; }
                if (c == '>') { s->err = -5; break; }
            }
            const size_t nl = find_nl(i);
            span_content(s, d + i, d + nl, /*count_only=*/false);
            if (nl == n) { i = n; s->line_start = false; }
            else { s->cr_held = 0; i = nl + 1; s->line_start = true; }
            break;
        }
        case DtpuStream::FQ_QUAL: {
            if (s->line_start && s->qlen >= s->slen) {
                s->state = DtpuStream::FQ_BOUND;   // re-dispatch this byte
                break;
            }
            const size_t nl = find_nl(i);
            span_content(s, d + i, d + nl, /*count_only=*/true);
            if (nl == n) { i = n; s->line_start = false; }
            else { s->cr_held = 0; i = nl + 1; s->line_start = true; }
            break;
        }
        case DtpuStream::FQ_BOUND:
            if (c == '\n' || c == '\r') { ++i; break; }
            if (c == '@') {
                start_record(s);
                s->state = DtpuStream::FQ_HEADER;
                ++i;
                break;
            }
            s->err = -5;
            break;
        }
    }
}

// Refill s->inbuf with the next decompressed chunk; sets src_eof / err.
static void stream_fill(DtpuStream *s) {
    s->inbuf.clear();
    if (s->is_zstd) {
#ifdef DTPU_HAVE_ZSTD
        s->inbuf.resize(kStreamChunk);
        ZSTD_outBuffer zout{s->inbuf.data(), s->inbuf.size(), 0};
        while (zout.pos == 0) {
            if (s->zin_pos == s->zin_len) {
                if (s->zin_eof) {
                    // EOF mid-frame = truncated input (same policy as the
                    // batch loader): partial bytes would mis-sketch
                    if (s->zlast != 0) s->err = -2;
                    s->src_eof = true;
                    break;
                }
                s->zin_len = std::fread(s->zin.data(), 1, s->zin.size(),
                                        s->zfp);
                s->zin_pos = 0;
                if (s->zin_len < s->zin.size()) s->zin_eof = true;
                if (s->zin_len == 0) continue;   // loop re-checks zin_eof
            }
            ZSTD_inBuffer zin{s->zin.data(), s->zin_len, s->zin_pos};
            s->zlast = ZSTD_decompressStream(s->ds, &zout, &zin);
            s->zin_pos = zin.pos;
            if (ZSTD_isError(s->zlast)) { s->err = -2; break; }
        }
        s->inbuf.resize(zout.pos);
#else
        s->err = -7;
#endif
        return;
    }
    s->inbuf.resize(kStreamChunk);
    int got = gzread(s->gz, s->inbuf.data(),
                     static_cast<unsigned>(s->inbuf.size()));
    if (got < 0) { s->err = -2; got = 0; }
    if (got == 0) s->src_eof = true;
    s->inbuf.resize(static_cast<size_t>(got));
}

}  // namespace

void *dtpu_stream_open(const char *path, uint32_t sep_len) {
    auto *s = new DtpuStream();
    s->sep_len = sep_len;
    {   // zstd frame? (mirror the batch loader's sniff)
        std::FILE *fp = std::fopen(path, "rb");
        if (!fp) { delete s; return nullptr; }
        unsigned char head[4] = {0, 0, 0, 0};
        size_t hn = std::fread(head, 1, 4, fp);
        std::fclose(fp);
        if (hn == 4 && head[0] == 0x28 && head[1] == 0xb5 && head[2] == 0x2f
            && head[3] == 0xfd)
            s->is_zstd = true;
    }
    if (s->is_zstd) {
#ifdef DTPU_HAVE_ZSTD
        s->zfp = std::fopen(path, "rb");
        s->ds = s->zfp ? ZSTD_createDStream() : nullptr;
        if (!s->ds) {
            if (s->zfp) std::fclose(s->zfp);
            delete s;
            return nullptr;
        }
        s->zin.resize(ZSTD_DStreamInSize());
        s->zlast = 1;   // mid-frame until the first decompress says otherwise
#else
        delete s;       // no libzstd: let the Python fallback engage
        return nullptr;
#endif
    } else {
        s->gz = gzopen(path, "rb");
        if (!s->gz) { delete s; return nullptr; }
        gzbuffer(s->gz, 1 << 20);
    }
    return s;
}

// Copy up to `cap` joined bytes into dst.  Returns bytes written (0 = EOF)
// or a negative error code (same codes as dtpu_read_fastx).
int64_t dtpu_stream_read(void *h, uint8_t *dst, uint64_t cap) {
    auto *s = static_cast<DtpuStream *>(h);
    uint64_t written = 0;
    for (;;) {
        const size_t avail = s->out.size() - s->out_pos;
        if (avail) {
            const size_t take = static_cast<size_t>(
                std::min<uint64_t>(avail, cap - written));
            std::memcpy(dst + written, s->out.data() + s->out_pos, take);
            s->out_pos += take;
            written += take;
            if (written == cap) return static_cast<int64_t>(written);
            continue;
        }
        s->out.clear();
        s->out_pos = 0;
        if (s->err) return s->err;
        if (s->src_eof) {
            s->cr_held = 0;   // EOF strips a trailing-'\r' run (batch parity)
            return static_cast<int64_t>(written);
        }
        stream_fill(s);
        if (s->err) return s->err;
        stream_parse(s);
        if (s->err) return s->err;
    }
}

void dtpu_stream_close(void *h) {
    auto *s = static_cast<DtpuStream *>(h);
    if (!s) return;
    if (s->gz) gzclose(s->gz);
#ifdef DTPU_HAVE_ZSTD
    if (s->ds) ZSTD_freeDStream(s->ds);
    if (s->zfp) std::fclose(s->zfp);
#endif
    delete s;
}

void dtpu_free_buf(uint8_t *p) { std::free(p); }

void dtpu_free(DtpuFastx *r) {
    std::free(r->seq);
    std::free(r->names);
    std::free(r->rec_ends);
    std::memset(r, 0, sizeof(*r));
}

}  // extern "C"
