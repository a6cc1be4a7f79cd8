// The host entry points of the port that are not the exact engine's: the
// FASTA/FASTQ(.gz) chunker and 2-bit batch encoder, the batch packer, the
// canonical k-mer hasher, the counts.txt parser and the eval row formatter.
// Taken from ntsm_tpu/native/fastx_reader.cpp, which the port never builds,
// and cut to what the port calls.
//
// The reader is the native replacement for the role kseq plays in the
// reference (vendor/kseq.h:178-219 feeding FingerPrint::computeCounts,
// src/FingerPrint.hpp:46-87): stream reads off disk, translate to 2-bit
// codes (A/a=0 C/c=1 G/g=2 T/t/U/u=3, else 4 — vendor/KseqHashIterator.hpp:
// 114-127), split long reads into seglen segments with a k-1 halo (the
// k-mer multiset is preserved exactly), and emit fixed-shape
// [batch, seglen] code blocks — plus, optionally, the 2-bit block-packed
// upload format of the v3 device engine (see count/kernel_v2.py:pack_batch:
// byte j of row holds bases j, j+L/4, j+L/2, j+3L/4; validity bitmask in
// the same block layout).
//
// Exposed as a tiny C ABI driven from Python via ctypes; the GIL is
// released for the duration of every next_batch call, so a one-thread
// prefetcher overlaps parsing with device compute (the working version of
// the reference's dead producer-consumer path,
// vendor/ProdConKseqRunner.hpp:31-184).
//
// Built with exact_pairs.cpp into one library by native/__init__.py
// (g++ -O3 -shared -fPIC, links -lz).

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr size_t CHUNK = 1 << 20;
// digit-accumulation cap: one more digit past this would overflow
// int64, so the parser returns -1 (falling back to the checked Python
// path) instead of wrapping silently
constexpr int64_t kDIG_MAX = (9223372036854775807LL - 9) / 10;

struct GzFile {
    FILE* fp = nullptr;
    z_stream zs{};
    bool gz = false;
    bool eof_ = false;
    bool io_error = false;
    std::vector<uint8_t> in;
    size_t in_pos = 0, in_len = 0;

    bool open(const char* path) {
        fp = std::fopen(path, "rb");
        if (!fp) return false;
        in.resize(CHUNK);
        in_len = std::fread(in.data(), 1, CHUNK, fp);
        if (std::ferror(fp)) io_error = true;
        in_pos = 0;
        if (in_len >= 2 && in[0] == 0x1f && in[1] == 0x8b) {
            gz = true;
            std::memset(&zs, 0, sizeof zs);
            // 15+32: zlib/gzip auto-detect; inflateReset2 below handles
            // concatenated members (bgzf, pigz output)
            if (inflateInit2(&zs, 15 + 32) != Z_OK) return false;
            zs.next_in = in.data();
            zs.avail_in = static_cast<uInt>(in_len);
        }
        return true;
    }

    // One emulated gzread(f, buf, want): kseq refills through 16384-byte
    // gzread calls (vendor/kseq.h:229,74), and measured gzread behavior
    // on damaged input (A/B'd vs the reference binary) is: truncation =
    // clean EOF keeping every inflated byte; a zlib data error INSIDE a
    // member (bad CRC trailer, mid-stream damage) returns -1 from the
    // erroring call, voiding that call's whole output window while prior
    // calls stand; non-magic bytes AFTER a finished member are trailing
    // garbage, ignored with a clean finish (gz_look). stream_done
    // latches so nothing follows the error.
    bool stream_done = false;

    size_t read_call(uint8_t* buf, size_t want) {
        if (stream_done) return 0;
        size_t produced = 0;
        bool error = false;
        while (produced < want) {
            if (zs.avail_in == 0 && fp && !std::feof(fp)) {
                in_len = std::fread(in.data(), 1, CHUNK, fp);
                if (in_len == 0 && std::ferror(fp)) {
                    io_error = true;
                    break;
                }
                zs.next_in = in.data();
                zs.avail_in = static_cast<uInt>(in_len);
            }
            zs.next_out = buf + produced;
            zs.avail_out = static_cast<uInt>(want - produced);
            int rc = inflate(&zs, Z_NO_FLUSH);
            produced = want - zs.avail_out;
            if (rc == Z_STREAM_END) {
                if (zs.avail_in == 0 && (!fp || std::feof(fp))) {
                    stream_done = true;
                    break;
                }
                // gz_look semantics (zlib gzread.c): after a finished
                // member, only the gzip magic starts a new member —
                // anything else is trailing garbage, ignored with a
                // clean finish (all inflated bytes kept).  Inflating
                // garbage here instead voided the whole window, which
                // real gzread only does on an error INSIDE a member.
                if (zs.avail_in < 2 && fp && !std::feof(fp)) {
                    // top up so the 2-byte magic check can see across
                    // a buffer boundary (mirrors zlib's gz_avail)
                    size_t rem = zs.avail_in;
                    if (rem) std::memmove(in.data(), zs.next_in, rem);
                    size_t got = std::fread(in.data() + rem, 1,
                                            CHUNK - rem, fp);
                    if (got == 0 && std::ferror(fp)) {
                        io_error = true;
                        break;
                    }
                    in_len = rem + got;
                    zs.next_in = in.data();
                    zs.avail_in = static_cast<uInt>(in_len);
                }
                if (zs.avail_in < 2 || zs.next_in[0] != 0x1f ||
                    zs.next_in[1] != 0x8b) {
                    stream_done = true;
                    break;
                }
                if (inflateReset2(&zs, 15 + 32) != Z_OK) {
                    stream_done = true;
                    break;
                }
            } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
                error = true;  // data error: this call yields nothing
                stream_done = true;
                break;
            } else if (rc == Z_BUF_ERROR && zs.avail_in == 0 &&
                       (!fp || std::feof(fp))) {
                stream_done = true;
                break;
            }
        }
        return error ? 0 : produced;
    }

    // returns bytes produced into buf (0 = eof).  gz output is staged
    // through whole 16384-byte windows (one read_call each) so the
    // error-voiding granularity matches kseq's gzread calls exactly: a
    // window is only served once it inflated cleanly, and window
    // boundaries sit at global multiples of 16384 regardless of the
    // caller's read sizes.
    std::vector<uint8_t> win;
    size_t win_pos = 0;

    size_t read(uint8_t* buf, size_t want) {
        if (!gz) {
            size_t got = 0;
            if (in_pos < in_len) {
                got = std::min(want, in_len - in_pos);
                std::memcpy(buf, in.data() + in_pos, got);
                in_pos += got;
            }
            if (got < want && fp && !std::feof(fp)) {
                got += std::fread(buf + got, 1, want - got, fp);
                // a mid-stream disk error must surface as the batch
                // call's -1 (the gz path already latches io_error);
                // short-read-at-ferror otherwise looks like clean EOF
                // and counts would silently come from a partial file
                if (std::ferror(fp)) io_error = true;
            }
            return got;
        }
        constexpr size_t GZ_CALL = 16384;
        size_t total = 0;
        while (total < want) {
            if (win_pos >= win.size()) {
                win.resize(GZ_CALL);
                size_t got = read_call(win.data(), GZ_CALL);
                win.resize(got);
                win_pos = 0;
                if (got == 0) break;
            }
            size_t k = std::min(want - total, win.size() - win_pos);
            std::memcpy(buf + total, win.data() + win_pos, k);
            win_pos += k;
            total += k;
        }
        return total;
    }

    void close() {
        if (gz) {
            inflateEnd(&zs);
            gz = false;  // idempotent: the destructor closes too
        }
        if (fp) std::fclose(fp);
        fp = nullptr;
    }

    // a Reader deleted mid-file (early termination, a consumer breaking
    // out of the batch generator) must not leak the fd + inflate state
    ~GzFile() { close(); }
};

struct LineReader {
    GzFile f;
    std::vector<uint8_t> buf;
    size_t pos = 0, len = 0;
    bool eof = false;

    bool open(const char* path) {
        buf.resize(CHUNK);
        pos = len = 0;
        eof = false;
        f.close();  // idempotent; the fresh-state assign must not leak
        f = GzFile{};
        return f.open(path);
    }
    void close() { f.close(); }

    bool fill() {
        if (eof) return false;
        if (pos < len) std::memmove(buf.data(), buf.data() + pos, len - pos);
        len -= pos;
        pos = 0;
        if (len == buf.size()) buf.resize(buf.size() * 2);
        size_t got = f.read(buf.data() + len, buf.size() - len);
        len += got;
        if (got == 0) eof = true;
        if (f.io_error) eof = true;
        return got > 0;
    }

    // next line (without \n / \r\n); returns false at EOF
    bool getline(const uint8_t** out, size_t* out_len) {
        for (;;) {
            uint8_t* nl = static_cast<uint8_t*>(
                std::memchr(buf.data() + pos, '\n', len - pos));
            if (nl) {
                size_t n = static_cast<size_t>(nl - (buf.data() + pos));
                *out = buf.data() + pos;
                *out_len = (n > 0 && (*out)[n - 1] == '\r') ? n - 1 : n;
                pos += n + 1;
                return true;
            }
            if (!fill()) {
                if (pos < len) {  // last line without newline
                    size_t n = len - pos;
                    *out = buf.data() + pos;
                    *out_len = (n > 0 && (*out)[n - 1] == '\r') ? n - 1 : n;
                    pos = len;
                    return true;
                }
                return false;
            }
        }
    }

    int peek() {
        while (pos >= len) {
            if (!fill()) return -1;
        }
        return buf[pos];
    }
};

uint8_t NT4[256];
struct Nt4Init {
    Nt4Init() {
        std::memset(NT4, 4, sizeof NT4);
        NT4['A'] = NT4['a'] = 0;
        NT4['C'] = NT4['c'] = 1;
        NT4['G'] = NT4['g'] = 2;
        NT4['T'] = NT4['t'] = NT4['U'] = NT4['u'] = 3;
    }
} nt4_init;

struct Reader {
    std::vector<std::string> paths;
    size_t path_idx = 0;
    LineReader lr;
    bool file_open = false;
    bool error = false;  // open failure / bad format / IO error
    int k, seglen, batch;
    bool dense = false;            // pack multiple reads per row (see below)
    std::vector<uint8_t> seq;      // encoded current read
    std::vector<uint8_t> carry;    // encoded segments carried past a flush
    bool carry_cont = false;       // carry continues a read (its sub-k tail
                                   // must not be emitted as a fresh read)

    bool next_file() {
        while (path_idx < paths.size()) {
            if (!lr.open(paths[path_idx].c_str())) {
                std::fprintf(stderr, "ntsm: cannot open %s\n",
                             paths[path_idx].c_str());
                error = true;  // hard error (reference exits on gzopen fail)
                return false;
            }
            ++path_idx;
            file_open = true;
            // NOTE: a non-header first byte is NOT an error — kseq
            // (vendor/kseq.h:182-186) scans to the first '>'/'@' anywhere
            // in the stream; next_record() implements that hunt.
            return true;
        }
        return false;
    }

    // read next record's encoded sequence into `seq`; false at global EOF.
    // kseq-faithful grammar (vendor/kseq.h:178-219): a record starts at a
    // '>' or '@' header line; sequence lines accumulate until a line whose
    // first char is '>', '+' or '@'; a '+' introduces quality, consumed
    // until its total length reaches the sequence length.  Leading junk
    // (and junk after a FASTQ record) is skipped up to the next '>'/'@'
    // anywhere in the stream, per kseq's header hunt.  Line-wrapped
    // FASTQ and mixed FASTA/FASTQ therefore parse exactly like kseq.
    bool next_record() {
        const uint8_t* line = nullptr;
        size_t n = 0;
        for (;;) {
            if (!file_open) {
                if (!next_file()) return false;
            }
            if (lr.f.io_error) {
                std::fprintf(stderr, "ntsm: %s: read error\n",
                             paths[path_idx - 1].c_str());
                error = true;
                return false;
            }
            int c = lr.peek();
            if (c < 0) {
                if (lr.f.io_error) continue;  // re-enter the check above
                lr.close();
                file_open = false;
                continue;
            }
            if (c != '>' && c != '@') {
                // kseq's header hunt (kseq.h:182-186): skip BYTES to the
                // next '>'/'@' anywhere — a mid-line header char starts a
                // record (the name is discarded here, so consuming the
                // whole junk+header line is equivalent)
                lr.getline(&line, &n);
                if (memchr(line, '>', n) == nullptr &&
                    memchr(line, '@', n) == nullptr)
                    continue;
            } else {
                lr.getline(&line, &n);  // consume header
            }
            seq.clear();
            for (;;) {
                c = lr.peek();
                if (c < 0 || c == '>' || c == '+' || c == '@') break;
                lr.getline(&line, &n);
                size_t off = seq.size();
                seq.resize(off + n);
                for (size_t i = 0; i < n; ++i) seq[off + i] = NT4[line[i]];
            }
            if (c == '+') {
                size_t qn = 0;
                const uint8_t* ql;
                lr.getline(&ql, &qn);  // '+' separator line
                // kseq reads at least one quality line and stops once
                // qual.l >= seq.l (kseq.h:214); a length mismatch is
                // kseq_read's -2, which ends the reference's per-file
                // `while (kseq_read(seq) >= 0)` loop
                // (FingerPrint.hpp:156): drop the record, abandon the
                // rest of the file.
                size_t qlen = 0;
                bool first = true;
                while ((first || qlen < seq.size()) && lr.getline(&ql, &qn)) {
                    qlen += qn;
                    first = false;
                }
                if (qlen != seq.size()) {
                    lr.close();
                    file_open = false;
                    continue;  // next file
                }
            }
            return true;
        }
    }
};

}  // namespace

extern "C" {

void* ntsm_reader_open(const char** paths, int n_paths, int k, int seglen,
                       int batch, int dense) {
    auto* r = new Reader;
    for (int i = 0; i < n_paths; ++i) r->paths.emplace_back(paths[i]);
    r->k = k;
    r->seglen = seglen;
    r->batch = batch;
    r->dense = dense != 0;
    return r;
}

void ntsm_reader_close(void* h) { delete static_cast<Reader*>(h); }

// Fill up to `batch` rows of codes [batch, seglen] / lengths [batch].
// Returns rows filled; *n_reads / *n_bases accumulate whole reads consumed
// into this batch (reference counts every byte incl. Ns,
// src/FingerPrint.hpp:102).  Rows beyond the return value are all-4 /
// length 0.  Returns 0 at end of input.
// Returns rows filled, 0 at end of input, or -1 on a hard error (open
// failure, wrong format, mid-stream IO error) after printing to stderr.
int ntsm_reader_next_batch(void* h, uint8_t* codes, int32_t* lengths,
                           long* n_reads, long* n_bases) {
    auto* r = static_cast<Reader*>(h);
    const int L = r->seglen, B = r->batch, k = r->k;
    const int stride = L - (k - 1);
    std::memset(codes, 4, static_cast<size_t>(B) * L);
    std::memset(lengths, 0, sizeof(int32_t) * B);
    *n_reads = 0;
    *n_bases = 0;
    int row = 0;

    auto emit = [&](const uint8_t* enc, long n, bool cont) -> bool {
        // segment one read; returns false if the batch filled mid-read and
        // stores the remainder in carry (resumed next call)
        long start = 0;
        for (;;) {
            long m = std::min<long>(L, n - start);
            if (m >= k || (start == 0 && !cont)) {
                if (row == B) {
                    r->carry.assign(enc + start, enc + n);
                    r->carry_cont = cont || start > 0;
                    return false;
                }
                std::memcpy(codes + static_cast<size_t>(row) * L, enc + start,
                            m);
                lengths[row] = static_cast<int32_t>(m);
                ++row;
            }
            if (start + L >= n) return true;
            start += stride;
        }
    };

    // --- dense mode: sequence packing with a k-1 halo -------------------
    // One read per row wastes (L - readlen)/L of every probe on padding
    // (41% for 150 bp reads at L=256).  Dense mode concatenates reads into
    // rows with a single invalid byte between reads (any window crossing
    // the junction contains it and is masked by the N-reset semantics,
    // vendor/KseqHashIterator.hpp:106-107) and continues a read across the
    // row boundary with a k-1 overlap, so the k-mer multiset is exactly
    // preserved.  Utilization is ~1 - (k + sep)/L regardless of read
    // length.
    if (r->dense) {
        int col = 0;
        auto place = [&](const uint8_t* enc, long n, bool cont) -> bool {
            long start = 0;
            if (!cont) {
                if (col > 0) ++col;  // separator byte (stays 4)
            }
            for (;;) {
                if (col > L - k) {  // no room for even one window
                    ++row;
                    col = 0;
                }
                if (row == B) {
                    r->carry.assign(enc + start, enc + n);
                    r->carry_cont = cont || start > 0;
                    return false;
                }
                long m = std::min<long>(L - col, n - start);
                std::memcpy(codes + static_cast<size_t>(row) * L + col,
                            enc + start, m);
                col += static_cast<int>(m);
                lengths[row] = col;
                if (start + m >= n) return true;
                start += m - (k - 1);
                ++row;
                col = 0;
            }
        };
        if (!r->carry.empty()) {
            std::vector<uint8_t> c;
            c.swap(r->carry);
            bool cont = r->carry_cont;
            r->carry_cont = false;
            if (!place(c.data(), static_cast<long>(c.size()), cont))
                return B;
        }
        for (;;) {
            if (!r->next_record()) break;
            *n_reads += 1;
            *n_bases += static_cast<long>(r->seq.size());
            if (!place(r->seq.data(), static_cast<long>(r->seq.size()), false))
                return B;
        }
        if (r->error) return -1;
        return row + (col > 0 ? 1 : 0);
    }
    // --- classic mode: one segment per row ------------------------------

    // resume a read interrupted by a batch boundary
    if (!r->carry.empty()) {
        std::vector<uint8_t> c;
        c.swap(r->carry);
        bool cont = r->carry_cont;
        r->carry_cont = false;
        // carried segments continue an already-counted read
        emit(c.data(), static_cast<long>(c.size()), cont);
    }

    while (row < B) {
        if (!r->next_record()) break;
        *n_reads += 1;
        *n_bases += static_cast<long>(r->seq.size());
        if (!emit(r->seq.data(), static_cast<long>(r->seq.size()), false))
            break;
    }
    if (r->error) return -1;
    return row;
}

// Block-layout 2-bit pack of a [B, L] code batch (kernel_v2.pack_batch):
// packed [B, L/4] u8 (bit pairs 0,2,4,6 = bases j, j+L/4, j+L/2, j+3L/4),
// vbits [B, L/8] u8 (bit i = base j + i*L/8 is a real A/C/G/T).
void ntsm_pack_batch(const uint8_t* codes, int B, int L, uint8_t* packed,
                     uint8_t* vbits) {
    const int q = L / 4, e = L / 8;
    for (int b = 0; b < B; ++b) {
        const uint8_t* row = codes + static_cast<size_t>(b) * L;
        uint8_t* p = packed + static_cast<size_t>(b) * q;
        for (int j = 0; j < q; ++j) {
            p[j] = static_cast<uint8_t>((row[j] & 3) |
                                        ((row[j + q] & 3) << 2) |
                                        ((row[j + 2 * q] & 3) << 4) |
                                        ((row[j + 3 * q] & 3) << 6));
        }
        uint8_t* v = vbits + static_cast<size_t>(b) * e;
        for (int j = 0; j < e; ++j) {
            uint8_t acc = 0;
            for (int i = 0; i < 8; ++i)
                acc |= static_cast<uint8_t>((row[j + i * e] < 4) << i);
            v[j] = acc;
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Canonical k-mer hashing over a flat 2-bit code stream (the rolling
// iterator of vendor/KseqHashIterator.hpp:95-139 as a batch function).
// codes: n bytes of 0..3 (valid) / >=4 (invalid).  Writes one hash and a
// validity flag per window position (n-k+1 of each).  Used by the host for
// site-table construction and golden fallbacks; the numpy implementation
// of the same semantics is the parity oracle (core/kmers.py).
// ---------------------------------------------------------------------------

static inline uint64_t ntsm_hash64(uint64_t key, uint64_t mask) {
    key = (~key + (key << 21)) & mask;
    key = key ^ (key >> 24);
    key = ((key + (key << 3)) + (key << 8)) & mask;
    key = key ^ (key >> 14);
    key = ((key + (key << 2)) + (key << 4)) & mask;
    key = key ^ (key >> 28);
    key = (key + (key << 31)) & mask;
    return key;
}

extern "C" void ntsm_canonical_hashes(const uint8_t* codes, long n, int k,
                                      uint64_t* hashes, uint8_t* valid) {
    const long w = n - k + 1;
    if (w <= 0) return;
    const uint64_t mask =
        (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const int shift = 2 * (k - 1);
    uint64_t fw = 0, rv = 0;
    int run = 0;  // consecutive valid bases ending at position i
    for (long i = 0; i < n; ++i) {
        uint8_t c = codes[i];
        if (c < 4) {
            fw = ((fw << 2) | c) & mask;
            rv = (rv >> 2) | (static_cast<uint64_t>(3 - c) << shift);
            if (run < k) ++run;
        } else {
            run = 0;
        }
        long pos = i - k + 1;
        if (pos >= 0) {
            if (run >= k) {
                valid[pos] = 1;
                hashes[pos] = ntsm_hash64(fw < rv ? fw : rv, mask);
            } else {
                valid[pos] = 0;
                hashes[pos] = 0;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// counts.txt parser (the eval-side load: CompareCounts ctor,
// src/CompareCounts.hpp:30-114).  Rows are "locusID \t 6 ints"; header
// lines start with '#' ("#@TK\t<n>", "#@KS\t<k>", column header).  Writes
// the eval engine's planes directly: mc/sc are int32 [cap, 2] row-major
// buffers (one sample's slices of the [N, L, 2] planes, or scratch rows),
// dist is an optional int64 [cap, 2] for the distinct columns (pass NULL
// to skip); locus ids are written '\n'-joined into ids_out.  Returns rows,
// or -1 on malformed input / int32 overflow (the caller's id-mapped
// Python parse then takes the file).
// ---------------------------------------------------------------------------
extern "C" long ntsm_parse_counts2(const uint8_t* buf, long len, int32_t* mc,
                                   int32_t* sc, int64_t* dist, long cap,
                                   uint8_t* ids_out, long ids_cap,
                                   long* ids_len, long* tk, long* ks) {
    *tk = 0;
    *ks = 0;
    long rows = 0;
    long idw = 0;
    const uint8_t* p = buf;
    const uint8_t* end = buf + len;
    // Every row inside [buf, fast_end) is '\n'-terminated, so the digit
    // loops below need no per-char bounds check: any non-digit (including
    // '\n') stops them via the unsigned *q - '0' trick.  This took the
    // parse from ~290 MB/s to the rewritten rate (the old loop carried
    // three branches per digit char).  An unterminated tail row (no final
    // newline) is handled by the bounded epilogue after the loop.
    const uint8_t* last_nl =
        static_cast<const uint8_t*>(memrchr(buf, '\n', len));
    const uint8_t* fast_end = last_nl ? last_nl + 1 : buf;
    while (p < fast_end) {
        if (*p == '\n') {  // blank line
            ++p;
            continue;
        }
        if (*p == '#' || *p == '\r') {  // header (or stray CR/blank-CRLF)
            const uint8_t* nl = static_cast<const uint8_t*>(
                memchr(p, '\n', fast_end - p));
            const uint8_t* e = nl;  // nl != NULL inside the fast region
            if (e[-1] == '\r') --e;
            if (e - p > 5 && p[0] == '#' && p[1] == '@' &&
                ((p[2] == 'T' && p[3] == 'K') ||
                 (p[2] == 'K' && p[3] == 'S')) &&
                p[4] == '\t') {
                long v = 0;
                for (const uint8_t* q = p + 5; q < e; ++q) {
                    if (*q < '0' || *q > '9') return -1;
                    if (v > kDIG_MAX) return -1;
                    v = v * 10 + (*q - '0');
                }
                if (p[2] == 'T')
                    *tk = v;
                else
                    *ks = v;
            }
            p = nl + 1;
            continue;
        }
        if (rows >= cap) return -1;
        const uint8_t* tab =
            static_cast<const uint8_t*>(memchr(p, '\t', fast_end - p));
        if (!tab ||
            memchr(p, '\n', tab - p))  // no tab on this line => malformed
            return -1;
        long idlen = tab - p;
        if (idw + idlen + 1 > ids_cap) return -1;
        memcpy(ids_out + idw, p, idlen);
        idw += idlen;
        ids_out[idw++] = '\n';
        const uint8_t* q = tab + 1;
        int64_t cols[6];
        for (int col = 0; col < 6; ++col) {
            bool neg = (*q == '-');
            q += neg;
            unsigned d = static_cast<unsigned>(*q) - '0';
            if (d > 9u) return -1;
            int64_t v = d;
            ++q;
            while ((d = static_cast<unsigned>(*q) - '0') <= 9u) {
                if (v > kDIG_MAX) return -1;
                v = v * 10 + d;
                ++q;
            }
            cols[col] = neg ? -v : v;
            if (col < 5) {
                if (*q != '\t') return -1;
                ++q;
            }
        }
        if (*q == '\r') ++q;
        if (*q != '\n') return -1;  // trailing junk
        for (int col = 0; col < 4; ++col) {
            if (cols[col] > 2147483647LL || cols[col] < -2147483648LL)
                return -1;  // caller falls back to the int64 path
        }
        mc[rows * 2] = static_cast<int32_t>(cols[0]);
        mc[rows * 2 + 1] = static_cast<int32_t>(cols[1]);
        sc[rows * 2] = static_cast<int32_t>(cols[2]);
        sc[rows * 2 + 1] = static_cast<int32_t>(cols[3]);
        if (dist) {
            dist[rows * 2] = cols[4];
            dist[rows * 2 + 1] = cols[5];
        }
        ++rows;
        p = q + 1;
    }
    // epilogue: an unterminated final row (rare; bounds-checked like the
    // original loop)
    if (fast_end < end) {
        const uint8_t* e = end;
        if (e > fast_end && e[-1] == '\r') --e;
        p = fast_end;
        if (e == p) {
            // bare CR tail
        } else if (*p == '#') {
            if (e - p > 5 && p[1] == '@' &&
                ((p[2] == 'T' && p[3] == 'K') ||
                 (p[2] == 'K' && p[3] == 'S')) &&
                p[4] == '\t') {
                long v = 0;
                for (const uint8_t* q = p + 5; q < e; ++q) {
                    if (*q < '0' || *q > '9') return -1;
                    if (v > kDIG_MAX) return -1;
                    v = v * 10 + (*q - '0');
                }
                if (p[2] == 'T')
                    *tk = v;
                else
                    *ks = v;
            }
        } else {
            if (rows >= cap) return -1;
            const uint8_t* tab =
                static_cast<const uint8_t*>(memchr(p, '\t', e - p));
            if (!tab) return -1;
            long idlen = tab - p;
            if (idw + idlen + 1 > ids_cap) return -1;
            memcpy(ids_out + idw, p, idlen);
            idw += idlen;
            ids_out[idw++] = '\n';
            const uint8_t* q = tab + 1;
            int64_t cols[6];
            for (int col = 0; col < 6; ++col) {
                bool neg = false;
                if (q < e && *q == '-') {
                    neg = true;
                    ++q;
                }
                if (q >= e || *q < '0' || *q > '9') return -1;
                int64_t v = 0;
                while (q < e && *q >= '0' && *q <= '9') {
                    if (v > kDIG_MAX) return -1;
                    v = v * 10 + (*q++ - '0');
                }
                cols[col] = neg ? -v : v;
                if (col < 5) {
                    if (q >= e || *q != '\t') return -1;
                    ++q;
                }
            }
            if (q != e) return -1;
            for (int col = 0; col < 4; ++col) {
                if (cols[col] > 2147483647LL || cols[col] < -2147483648LL)
                    return -1;
            }
            mc[rows * 2] = static_cast<int32_t>(cols[0]);
            mc[rows * 2 + 1] = static_cast<int32_t>(cols[1]);
            sc[rows * 2] = static_cast<int32_t>(cols[2]);
            sc[rows * 2 + 1] = static_cast<int32_t>(cols[3]);
            if (dist) {
                dist[rows * 2] = cols[4];
                dist[rows * 2 + 1] = cols[5];
            }
            ++rows;
        }
    }
    *ids_len = idw;
    return rows;
}

// ---------------------------------------------------------------------------
// Eval row formatter: emits the 26-column summary.tsv rows for a block of
// sample pairs (resultsStr, src/CompareCounts.hpp:844-921).  The Python
// emission loop costs ~10-50 us/row (5.1M rows at the N=3202 cohort =
// minutes of pure host formatting); this does the same work at ~1 us/row.
// Float columns are glibc's "%f", as std::to_string prints them
// (utils/formats.py:cpp_to_string): fmt_f6 below writes every finite value
// under 2^40 itself, exactly, and hands the rest (nan, -nan, +-inf, huge
// values such as an n = 0 pair's DBL_MAX score) to snprintf("%f").
//
// Inputs:
//   ii/jj      [P] i32 sample indices per pair
//   f3         [P*3] f64: score, relatedness, homConcord
//   i9         [P*9] i64: ibs0, ibs2, hets1, hets2, sharedHet,
//                          homs1, homs2, sharedHom, n
//   same       [P]   u8: '0' or '1' (column 4)
//   samp       [n_samp * 6] fixed-width byte strings, width samp_w,
//              NUL-padded, column order: fname, cov, errorRate, miss,
//              homs, hets (per-sample values are formatted once on the
//              Python side)
//   outbuf     [outcap] output; rows are '\t'-joined, '\n'-terminated
//   n_slow     out (NULL allowed): the float fields that took snprintf
// Returns bytes written, or -1 if outbuf would overflow (caller retries
// with a bigger buffer / smaller block).

static inline char* fmt_i64(char* p, int64_t v) {
    if (v < 0) { *p++ = '-'; }
    uint64_t u = v < 0 ? (uint64_t)(-(v + 1)) + 1 : (uint64_t)v;
    char tmp[20];
    int n = 0;
    do { tmp[n++] = (char)('0' + u % 10); u /= 10; } while (u);
    while (n) *p++ = tmp[--n];
    return p;
}

// x as "%f" prints it: fixed, six decimals, the exact value rounded half to
// even (glibc's result in the default rounding mode), "-" for a set sign
// bit, so -0.0 and negatives that round to zero print "-0.000000".  The
// decimal point is '.', which is what snprintf writes in the C LC_NUMERIC
// locale the process runs under (Python sets LC_CTYPE alone).  A finite x
// with |x| < 2^40 is m * 2^e with an integer significand m < 2^53 and
// e <= -13 (e = -1074 for subnormals), so x * 10^6 = (m * 10^6) >> -e: one
// 128-bit product and shift give the quotient and the exact remainder.
// Every other value goes to snprintf ("nan", "-nan", "inf", "-inf", and
// the up to 309 digits of a huge one); *slow counts those.
static inline char* fmt_f6(char* p, double x, long* slow) {
    uint64_t bits;
    memcpy(&bits, &x, sizeof bits);
    const int be = (int)((bits >> 52) & 0x7ff);
    if (be >= 1023 + 40) {  // inf, nan, |x| >= 2^40
        ++*slow;
        return p + snprintf(p, 340, "%f", x);
    }
    const uint64_t frac = bits & ((1ull << 52) - 1);
    const uint64_t m = be ? frac | (1ull << 52) : frac;
    const int s = be ? 1075 - be : 1074;  // x = m * 2^-s, s >= 13
    const unsigned __int128 v = (unsigned __int128)m * 1000000u;  // < 2^73
    uint64_t q = 0;
    if (s < 74) {  // from 74 on, v < 2^73 <= half a unit: q = 0
        q = (uint64_t)(v >> s);
        const unsigned __int128 r = v & ((((unsigned __int128)1) << s) - 1);
        const unsigned __int128 half = ((unsigned __int128)1) << (s - 1);
        // bitwise, not &&/||: the direction is random, and a branch on it
        // mispredicts half the time
        q += (uint64_t)((r > half) | ((r == half) & (q & 1)));
    }
    *p = '-';
    p += bits >> 63;  // the sign, without a branch
    p = fmt_i64(p, (int64_t)(q / 1000000));
    *p++ = '.';
    uint32_t d = (uint32_t)(q % 1000000);
    for (int k = 6; k-- > 0;) { p[k] = (char)('0' + d % 10); d /= 10; }
    return p + 6;
}

// fmt_f6 alone, for the tests: x formatted into out (>= 340 bytes); returns
// the length, or -(length) where snprintf printed it.
extern "C" long ntsm_format_f6(double x, char* out) {
    long slow = 0;
    const long n = (long)(fmt_f6(out, x, &slow) - out);
    return slow ? -n : n;
}

extern "C" long ntsm_format_eval_rows(
    long n_pairs, const int32_t* ii, const int32_t* jj, const double* f3,
    const int64_t* i9, const uint8_t* same, const double* dist,
    const char* samp, long samp_w, long n_samp, char* outbuf, long outcap,
    long* n_slow) {
    (void)n_samp;
    long slow = 0;
    char* p = outbuf;
    char* const cap = outbuf + outcap;
    // worst case per float field: -1.8e308 in %f = 310 digits + '.' + 6
    // 12 sample-string fields/row: fname1, fname2 + 10 interleaved
    const long MAXROW = 4 * 330 + 9 * 20 + 12 * samp_w + 32;
    for (long r = 0; r < n_pairs; ++r) {
        if (cap - p < MAXROW) return -1;
        const char* si = samp + (long)ii[r] * 6 * samp_w;
        const char* sj = samp + (long)jj[r] * 6 * samp_w;
        const double* f = f3 + r * 3;
        const int64_t* g = i9 + r * 9;
        // fname1 \t fname2
        size_t n = strnlen(si, samp_w); memcpy(p, si, n); p += n; *p++ = '\t';
        n = strnlen(sj, samp_w); memcpy(p, sj, n); p += n; *p++ = '\t';
        // score \t same \t dist(-1) \t relate \t
        p = fmt_f6(p, f[0], &slow); *p++ = '\t';
        *p++ = (char)same[r]; *p++ = '\t';
        if (dist) {  // -p mode: squared PCA distance; -a prints "-1"
            p = fmt_f6(p, dist[r], &slow);
        } else {
            *p++ = '-'; *p++ = '1';
        }
        *p++ = '\t';
        p = fmt_f6(p, f[1], &slow); *p++ = '\t';
        // ibs0 \t ibs2 \t homConcord \t
        p = fmt_i64(p, g[0]); *p++ = '\t';
        p = fmt_i64(p, g[1]); *p++ = '\t';
        p = fmt_f6(p, f[2], &slow); *p++ = '\t';
        // hets1 hets2 sharedHet homs1 homs2 sharedHom n
        for (int c = 2; c < 9; ++c) { p = fmt_i64(p, g[c]); *p++ = '\t'; }
        // cov1 cov2 err1 err2 miss1 miss2 homs1 homs2 hets1 hets2
        for (int c = 1; c < 6; ++c) {
            const char* a = si + (long)c * samp_w;
            const char* b = sj + (long)c * samp_w;
            n = strnlen(a, samp_w); memcpy(p, a, n); p += n; *p++ = '\t';
            n = strnlen(b, samp_w); memcpy(p, b, n); p += n;
            *p++ = (c < 5) ? '\t' : '\n';
        }
    }
    if (n_slow) *n_slow = slow;
    return (long)(p - outbuf);
}
