// A Zstandard frame decoder written from RFC 8878, for the host: no
// library behind it. It reads what the JAX package's orbax checkpoints hold
// (utils/orbax_reader.py): zarr chunks and OCDBT nodes, each one zstd frame.
//
// Supported: raw, RLE and compressed blocks; raw, RLE, Huffman (1 or 4
// streams) and treeless literals; predefined, RLE, FSE and repeat sequence
// tables with the repeat offsets; any window up to 2^31 bytes; frames with
// or without a content size; concatenated and skippable frames; the
// xxHash64 content checksum, verified when a frame carries one. A frame
// that names a dictionary is refused. Every malformed or truncated input
// raises: no partial output is ever returned.
//
// C interface (ctypes, utils/zstd.py):
//   int64_t zstd_decode(src, n, limit, err, err_cap)
//       decodes every frame of src[0, n) into a buffer of the calling
//       thread; returns its size, or -1 with a message in err. limit > 0
//       caps the decoded size.
//   void zstd_take(dst)   copies that buffer to dst and frees it.
//   uint32_t crc32c(src, n)   the CRC-32C of OCDBT's manifests and nodes
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
    using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Corrupt(msg); }

constexpr size_t kBlockMax = 128 * 1024;
constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint64_t kWindowMax = 1ull << 31;

inline int highest_bit(uint64_t v) { return 63 - __builtin_clzll(v); }  // v > 0

inline uint32_t le16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t le32(const uint8_t* p) { return le16(p) | (le16(p + 2) << 16); }
inline uint64_t le64(const uint8_t* p) { return le32(p) | (uint64_t(le32(p + 4)) << 32); }

// bits [start, start + n) of src[0, len) as a little-endian integer, n <= 56;
// bits past len read as 0
inline uint64_t load_bits(const uint8_t* src, size_t len, uint64_t start, int n) {
    size_t byte = start >> 3;
    uint64_t v = 0;
    if (byte + 8 <= len) {
        std::memcpy(&v, src + byte, 8);  // little-endian host
    } else {
        for (size_t i = 0; i < 8 && byte + i < len; ++i) v |= uint64_t(src[byte + i]) << (8 * i);
    }
    return (v >> (start & 7)) & ((1ull << n) - 1);
}

// ----------------------------------------------------------------- xxHash64

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull, P3 = 1609587929392839161ull,
                   P4 = 9650029242287828579ull, P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xx_round(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xx_merge(uint64_t h, uint64_t v) { return (h ^ xx_round(0, v)) * P1 + P4; }

uint64_t xxh64_impl(const uint8_t* p, size_t n, uint64_t seed) {
    const uint8_t* end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        for (; p + 32 <= end; p += 32) {
            v1 = xx_round(v1, le64(p));
            v2 = xx_round(v2, le64(p + 8));
            v3 = xx_round(v3, le64(p + 16));
            v4 = xx_round(v4, le64(p + 24));
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xx_merge(xx_merge(xx_merge(xx_merge(h, v1), v2), v3), v4);
    } else {
        h = seed + P5;
    }
    h += uint64_t(n);
    for (; p + 8 <= end; p += 8) h = rotl(h ^ xx_round(0, le64(p)), 27) * P1 + P4;
    if (p + 4 <= end) {
        h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
        p += 4;
    }
    for (; p < end; ++p) h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    return h ^ (h >> 32);
}

// ------------------------------------------------------------- bit readers

// forward, least significant bit first: the FSE table descriptions
struct ForwardBits {
    const uint8_t* src;
    size_t len;
    uint64_t bit = 0;
    uint32_t read(int n) {
        uint32_t v = uint32_t(load_bits(src, len, bit, n));
        bit += n;
        return v;
    }
    size_t bytes_used() const {
        if (bit > uint64_t(len) * 8) fail("truncated FSE table description");
        return size_t((bit + 7) / 8);
    }
};

// backward, from the end marker (the highest set bit of the last byte) to
// the first byte: Huffman streams and FSE bitstreams. Bits before the
// start read as 0; ``bit`` then goes negative.
struct BackwardBits {
    const uint8_t* src = nullptr;
    size_t len = 0;
    int64_t bit = 0;
    void init(const uint8_t* s, size_t n) {
        if (n == 0) fail("empty bitstream");
        if (s[n - 1] == 0) fail("bitstream without its end marker");
        src = s;
        len = n;
        bit = int64_t(n) * 8 - (8 - highest_bit(s[n - 1]));
    }
    uint64_t read(int n) {
        if (n == 0) return 0;
        bit -= n;
        if (bit >= 0) return load_bits(src, len, uint64_t(bit), n);
        if (bit <= -n) return 0;
        return load_bits(src, len, 0, int(n + bit)) << (-bit);
    }
};

// ---------------------------------------------------------------------- FSE

struct FseTable {
    int log = -1;  // -1: no table yet
    std::vector<uint8_t> symbol, bits;
    std::vector<uint16_t> base;
};

void fse_build(FseTable& t, const int16_t* norm, int nsym, int log) {
    const uint32_t size = 1u << log;
    t.log = log;
    t.symbol.assign(size, 0);
    t.bits.assign(size, 0);
    t.base.assign(size, 0);
    std::vector<uint32_t> next(nsym, 0);
    uint32_t high = size;
    for (int s = 0; s < nsym; ++s) {
        if (norm[s] == -1) {
            if (high == 0) fail("FSE table overflows");
            t.symbol[--high] = uint8_t(s);
            next[s] = 1;
        }
    }
    const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    uint32_t pos = 0;
    for (int s = 0; s < nsym; ++s) {
        if (norm[s] <= 0) continue;
        next[s] = uint32_t(norm[s]);
        for (int i = 0; i < norm[s]; ++i) {
            t.symbol[pos] = uint8_t(s);
            do {
                pos = (pos + step) & mask;
            } while (pos >= high);
        }
    }
    if (pos != 0) fail("FSE table does not fill its states");
    for (uint32_t i = 0; i < size; ++i) {
        uint32_t d = next[t.symbol[i]]++;
        int nb = log - highest_bit(d);
        t.bits[i] = uint8_t(nb);
        t.base[i] = uint16_t((d << nb) - size);
    }
}

// reads an FSE table description from src[0, n); returns the bytes it took
size_t fse_read(FseTable& t, const uint8_t* src, size_t n, int max_log, int max_symbol) {
    if (n == 0) fail("truncated FSE table description");
    ForwardBits in{src, n};
    const int log = 5 + int(in.read(4));
    if (log > max_log) fail("FSE accuracy log " + std::to_string(log) + " above " + std::to_string(max_log));
    int32_t remaining = 1 << log;
    int16_t norm[256];
    int nsym = 0;
    while (remaining > 0) {
        if (nsym > max_symbol) fail("FSE table description names too many symbols");
        const int nb = highest_bit(uint64_t(remaining) + 1) + 1;
        uint32_t v = in.read(nb);
        const uint32_t low_mask = (1u << (nb - 1)) - 1;
        const uint32_t threshold = (1u << nb) - 1 - uint32_t(remaining + 1);
        if ((v & low_mask) < threshold) {
            in.bit -= 1;
            v &= low_mask;
        } else if (v > low_mask) {
            v -= threshold;
        }
        const int16_t proba = int16_t(int32_t(v) - 1);
        remaining -= proba < 0 ? -proba : proba;
        norm[nsym++] = proba;
        if (proba == 0) {
            uint32_t repeat = in.read(2);
            for (;;) {
                for (uint32_t i = 0; i < repeat; ++i) {
                    if (nsym > max_symbol) fail("FSE table description names too many symbols");
                    norm[nsym++] = 0;
                }
                if (repeat != 3) break;
                repeat = in.read(2);
            }
        }
    }
    if (remaining != 0) fail("FSE probabilities do not sum to the table size");
    size_t used = in.bytes_used();
    fse_build(t, norm, nsym, log);
    return used;
}

void fse_rle(FseTable& t, uint8_t symbol) {
    t.log = 0;
    t.symbol.assign(1, symbol);
    t.bits.assign(1, 0);
    t.base.assign(1, 0);
}

inline uint8_t fse_decode(const FseTable& t, uint32_t& state, BackwardBits& br) {
    uint8_t s = t.symbol[state];
    state = t.base[state] + uint32_t(br.read(t.bits[state]));
    return s;
}

// ------------------------------------------------------------------ Huffman

constexpr int kHufMaxBits = 11;

struct HufTable {
    int max_bits = 0;  // 0: no table yet
    std::vector<uint8_t> symbol, bits;
};

// the Huffman tree description at src[0, n); returns the bytes it took
size_t huf_read(HufTable& h, const uint8_t* src, size_t n) {
    if (n == 0) fail("truncated Huffman tree description");
    uint8_t weights[256] = {0};
    int nw = 0;
    size_t used;
    const uint8_t header = src[0];
    if (header >= 128) {
        nw = header - 127;
        used = 1 + size_t(nw + 1) / 2;
        if (used > n) fail("truncated Huffman weights");
        for (int i = 0; i < nw; ++i) weights[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
    } else {
        used = 1 + size_t(header);
        if (used > n || header == 0) fail("truncated Huffman weights");
        FseTable t;
        size_t k = fse_read(t, src + 1, header, 6, 255);
        if (k >= header) fail("Huffman weights without a bitstream");
        BackwardBits br;
        br.init(src + 1 + k, header - k);
        uint32_t s1 = uint32_t(br.read(t.log)), s2 = uint32_t(br.read(t.log));
        for (;;) {
            if (nw >= 255) fail("too many Huffman weights");
            weights[nw++] = fse_decode(t, s1, br);
            if (br.bit < 0) {
                if (nw >= 255) fail("too many Huffman weights");
                weights[nw++] = t.symbol[s2];
                break;
            }
            if (nw >= 255) fail("too many Huffman weights");
            weights[nw++] = fse_decode(t, s2, br);
            if (br.bit < 0) {
                if (nw >= 255) fail("too many Huffman weights");
                weights[nw++] = t.symbol[s1];
                break;
            }
        }
    }
    uint64_t sum = 0;
    for (int i = 0; i < nw; ++i) {
        if (weights[i] > kHufMaxBits) fail("Huffman weight above the maximum");
        if (weights[i]) sum += 1ull << (weights[i] - 1);
    }
    if (sum == 0) fail("Huffman weights are all zero");
    const int max_bits = highest_bit(sum) + 1;
    if (max_bits > kHufMaxBits) fail("Huffman code longer than 11 bits");
    const uint64_t left = (1ull << max_bits) - sum;
    if (left & (left - 1)) fail("Huffman weights do not complete a power of two");
    weights[nw++] = uint8_t(highest_bit(left) + 1);  // the implied last symbol

    uint8_t nbits[256];
    uint32_t rank_count[kHufMaxBits + 2] = {0};
    for (int i = 0; i < nw; ++i) {
        nbits[i] = weights[i] ? uint8_t(max_bits + 1 - weights[i]) : 0;
        rank_count[nbits[i]]++;
    }
    const uint32_t size = 1u << max_bits;
    h.max_bits = max_bits;
    h.symbol.assign(size, 0);
    h.bits.assign(size, 0);
    uint32_t rank_idx[kHufMaxBits + 2] = {0};
    rank_idx[max_bits] = 0;
    for (int b = max_bits; b >= 1; --b) {
        rank_idx[b - 1] = rank_idx[b] + rank_count[b] * (1u << (max_bits - b));
        if (rank_idx[b - 1] > size) fail("Huffman codes overflow the table");
        std::memset(&h.bits[rank_idx[b]], b, rank_idx[b - 1] - rank_idx[b]);
    }
    if (rank_idx[0] != size) fail("Huffman codes do not fill the table");
    for (int i = 0; i < nw; ++i) {
        if (!nbits[i]) continue;
        uint32_t code = rank_idx[nbits[i]], len = 1u << (max_bits - nbits[i]);
        std::memset(&h.symbol[code], i, len);
        rank_idx[nbits[i]] += len;
    }
    return used;
}

void huf_stream(const HufTable& h, const uint8_t* src, size_t n, uint8_t* out, size_t count) {
    BackwardBits br;
    br.init(src, n);
    const int mb = h.max_bits;
    const uint32_t mask = (1u << mb) - 1;
    uint32_t state = uint32_t(br.read(mb));
    const uint8_t* sym = h.symbol.data();
    const uint8_t* bits = h.bits.data();
    for (size_t i = 0; i < count; ++i) {
        out[i] = sym[state];
        const int b = bits[state];
        state = ((state << b) | uint32_t(br.read(b))) & mask;
    }
    if (br.bit != -mb) fail("Huffman stream not consumed exactly");
}

// ---------------------------------------------------------------- sequences

const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,   5,   6,   7,   8,    9,    10,   11,   12,   13,   14,    15,    16,   18,
                              20, 22, 24, 28, 32,  40,  48,  64,  128,  256,  512,  1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,  15,  16,   17,   18,   19,   20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,  33,  34,   35,   37,   39,   41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1,  1,  2,  2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Defaults {
    FseTable ll, ml, of;
    Defaults() {
        fse_build(ll, LL_DEFAULT, 36, 6);
        fse_build(ml, ML_DEFAULT, 53, 6);
        fse_build(of, OF_DEFAULT, 29, 5);
    }
};

const Defaults& defaults() {
    static const Defaults d;
    return d;
}

// ------------------------------------------------------------------- frames

struct Frame {
    std::vector<uint8_t>& out;
    size_t start;      // the frame's first byte in out
    uint64_t window;   // offsets beyond it are corrupt
    HufTable huf;
    FseTable ll, ml, of;
    uint64_t rep[3] = {1, 4, 8};
    std::vector<uint8_t> lits;
};

const uint8_t* need(const uint8_t* p, const uint8_t* end, size_t k, const char* what) {
    if (size_t(end - p) < k) fail(std::string("truncated ") + what);
    return p;
}

// the literals section at p; fills f.lits, returns the bytes it took
size_t read_literals(Frame& f, const uint8_t* p, const uint8_t* end) {
    need(p, end, 1, "literals section");
    const int type = p[0] & 3, sf = (p[0] >> 2) & 3;
    if (type < 2) {  // raw or RLE
        size_t regen, hs;
        if (sf == 0 || sf == 2) {
            regen = p[0] >> 3;
            hs = 1;
        } else if (sf == 1) {
            need(p, end, 2, "literals header");
            regen = (p[0] >> 4) + (size_t(p[1]) << 4);
            hs = 2;
        } else {
            need(p, end, 3, "literals header");
            regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
            hs = 3;
        }
        if (regen > kBlockMax) fail("literals larger than a block");
        if (type == 0) {
            need(p, end, hs + regen, "raw literals");
            f.lits.assign(p + hs, p + hs + regen);
            return hs + regen;
        }
        need(p, end, hs + 1, "RLE literals");
        f.lits.assign(regen, p[hs]);
        return hs + 1;
    }
    const int streams = sf == 0 ? 1 : 4;
    const size_t hs = sf < 2 ? 3 : size_t(sf + 2);
    need(p, end, hs, "literals header");
    uint64_t v = 0;
    for (size_t i = 0; i < hs; ++i) v |= uint64_t(p[i]) << (8 * i);
    size_t regen, csize;
    if (hs == 3) {
        regen = (v >> 4) & 0x3FF;
        csize = (v >> 14) & 0x3FF;
    } else if (hs == 4) {
        regen = (v >> 4) & 0x3FFF;
        csize = (v >> 18) & 0x3FFF;
    } else {
        regen = (v >> 4) & 0x3FFFF;
        csize = (v >> 22) & 0x3FFFF;
    }
    if (regen > kBlockMax) fail("literals larger than a block");
    need(p, end, hs + csize, "compressed literals");
    const uint8_t* q = p + hs;
    size_t m = csize;
    if (type == 2) {
        size_t k = huf_read(f.huf, q, m);
        q += k;
        m -= k;
    } else if (f.huf.max_bits == 0) {
        fail("treeless literals without an earlier Huffman table");
    }
    f.lits.resize(regen);
    if (streams == 1) {
        huf_stream(f.huf, q, m, f.lits.data(), regen);
    } else {
        if (m < 6) fail("truncated jump table");
        size_t s[4] = {le16(q), le16(q + 2), le16(q + 4), 0};
        if (s[0] + s[1] + s[2] + 6 > m) fail("jump table beyond the literals");
        s[3] = m - 6 - s[0] - s[1] - s[2];
        const size_t per = (regen + 3) / 4;
        if (3 * per > regen) fail("four Huffman streams for too few literals");
        const uint8_t* src = q + 6;
        uint8_t* dst = f.lits.data();
        for (int i = 0; i < 4; ++i) {
            const size_t count = i < 3 ? per : regen - 3 * per;
            huf_stream(f.huf, src, s[i], dst, count);
            src += s[i];
            dst += count;
        }
    }
    return hs + csize;
}

size_t select_table(FseTable& t, int mode, const FseTable& predefined, int max_log, int max_symbol,
                    const uint8_t* p, const uint8_t* end, const char* name) {
    switch (mode) {
        case 0:
            t = predefined;
            return 0;
        case 1:
            need(p, end, 1, "RLE sequence table");
            if (p[0] > max_symbol) fail(std::string("RLE ") + name + " code out of range");
            fse_rle(t, p[0]);
            return 1;
        case 2:
            return fse_read(t, p, size_t(end - p), max_log, max_symbol);
        default:
            if (t.log < 0) fail(std::string("repeat ") + name + " table without an earlier table");
            return 0;
    }
}

void append(std::vector<uint8_t>& out, const uint8_t* src, size_t n) {
    if (n) out.insert(out.end(), src, src + n);
}

void copy_match(Frame& f, uint64_t offset, size_t length) {
    const size_t produced = f.out.size() - f.start;
    if (offset == 0 || offset > produced) fail("match offset beyond the decoded data");
    if (offset > f.window) fail("match offset beyond the window");
    const size_t at = f.out.size();
    f.out.resize(at + length);
    uint8_t* d = f.out.data() + at;
    const uint8_t* s = d - offset;
    if (offset >= length) {
        std::memcpy(d, s, length);
    } else {
        for (size_t i = 0; i < length; ++i) d[i] = s[i];
    }
}

void compressed_block(Frame& f, const uint8_t* p, size_t n) {
    const uint8_t* end = p + n;
    p += read_literals(f, p, end);
    need(p, end, 1, "sequences section");
    uint32_t nseq = p[0];
    p += 1;
    const size_t block_start = f.out.size();
    if (nseq == 0) {
        if (p != end) fail("bytes after an empty sequences section");
        append(f.out, f.lits.data(), f.lits.size());
        return;
    }
    if (nseq >= 255) {
        need(p, end, 2, "sequence count");
        nseq = p[0] + (uint32_t(p[1]) << 8) + 0x7F00;
        p += 2;
    } else if (nseq >= 128) {
        need(p, end, 1, "sequence count");
        nseq = ((nseq - 128) << 8) + p[0];
        p += 1;
    }
    need(p, end, 1, "sequence modes");
    const uint8_t modes = p[0];
    p += 1;
    if (modes & 3) fail("reserved bits of the sequence modes are set");
    const Defaults& d = defaults();
    p += select_table(f.ll, modes >> 6, d.ll, 9, 35, p, end, "literals length");
    p += select_table(f.of, (modes >> 4) & 3, d.of, 8, 31, p, end, "offset");
    p += select_table(f.ml, (modes >> 2) & 3, d.ml, 9, 52, p, end, "match length");
    if (p >= end) fail("truncated sequence bitstream");
    BackwardBits br;
    br.init(p, size_t(end - p));
    uint32_t sl = uint32_t(br.read(f.ll.log)), so = uint32_t(br.read(f.of.log)), sm = uint32_t(br.read(f.ml.log));
    size_t lit = 0;
    for (uint32_t i = 0; i < nseq; ++i) {
        const uint8_t oc = f.of.symbol[so], mc = f.ml.symbol[sm], lc = f.ll.symbol[sl];
        uint64_t ofv = (1ull << oc) + br.read(oc);
        const size_t ml = ML_BASE[mc] + size_t(br.read(ML_BITS[mc]));
        const size_t ll = LL_BASE[lc] + size_t(br.read(LL_BITS[lc]));
        if (i + 1 < nseq) {
            sl = f.ll.base[sl] + uint32_t(br.read(f.ll.bits[sl]));
            sm = f.ml.base[sm] + uint32_t(br.read(f.ml.bits[sm]));
            so = f.of.base[so] + uint32_t(br.read(f.of.bits[so]));
        }
        uint64_t offset;
        if (ofv > 3) {
            offset = ofv - 3;
            f.rep[2] = f.rep[1];
            f.rep[1] = f.rep[0];
            f.rep[0] = offset;
        } else {
            const uint64_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
            if (idx == 0) {
                offset = f.rep[0];
            } else {
                offset = idx < 3 ? f.rep[idx] : f.rep[0] - 1;
                if (idx > 1) f.rep[2] = f.rep[1];
                f.rep[1] = f.rep[0];
                f.rep[0] = offset;
            }
        }
        if (ll > f.lits.size() - lit) fail("sequence takes more literals than the block has");
        append(f.out, f.lits.data() + lit, ll);
        lit += ll;
        if (f.out.size() - block_start + ml > kBlockMax) fail("block decodes to more than 128 KiB");
        copy_match(f, offset, ml);
    }
    if (br.bit != 0) fail("sequence bitstream not consumed exactly");
    append(f.out, f.lits.data() + lit, f.lits.size() - lit);
    if (f.out.size() - block_start > kBlockMax) fail("block decodes to more than 128 KiB");
}

// one frame at p (its magic already checked); returns the bytes it took
size_t read_frame(std::vector<uint8_t>& out, const uint8_t* p, const uint8_t* end, uint64_t limit) {
    const uint8_t* const begin = p;
    p += 4;
    need(p, end, 1, "frame header");
    const uint8_t fhd = *p++;
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
    if (fhd & 8) fail("reserved bit of the frame header is set");
    uint64_t window = 0;
    if (!single) {
        need(p, end, 1, "window descriptor");
        const uint8_t wd = *p++;
        const int wlog = 10 + (wd >> 3);
        if (wlog > 31) fail("window larger than 2 GiB");
        const uint64_t wbase = 1ull << wlog;
        window = wbase + (wbase / 8) * (wd & 7);
    }
    const size_t did_size[4] = {0, 1, 2, 4};
    need(p, end, did_size[did_flag], "dictionary id");
    uint64_t dict = 0;
    for (size_t i = 0; i < did_size[did_flag]; ++i) dict |= uint64_t(p[i]) << (8 * i);
    p += did_size[did_flag];
    if (dict != 0) fail("the frame names dictionary " + std::to_string(dict) + ": dictionaries are not supported");
    const size_t fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : size_t(1) << fcs_flag;
    need(p, end, fcs_size, "frame content size");
    uint64_t fcs = 0;
    for (size_t i = 0; i < fcs_size; ++i) fcs |= uint64_t(p[i]) << (8 * i);
    if (fcs_size == 2) fcs += 256;
    p += fcs_size;
    if (single) window = fcs;
    if (window > kWindowMax) fail("window larger than 2 GiB");
    if (fcs_size && limit && fcs > limit - (out.size() < limit ? out.size() : limit)) {
        fail("frame content size above the limit");
    }
    if (fcs_size && fcs <= (1ull << 32)) out.reserve(out.size() + size_t(fcs));
    const uint64_t block_max = window < kBlockMax ? window : kBlockMax;

    Frame f{out, out.size(), window, {}, {}, {}, {}, {1, 4, 8}, {}};
    for (bool last = false; !last;) {
        need(p, end, 3, "block header");
        const uint32_t bh = p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
        p += 3;
        last = bh & 1;
        const int type = (bh >> 1) & 3;
        const size_t size = bh >> 3;
        if (size > block_max) fail("block larger than the block maximum");
        if (type == 0) {
            need(p, end, size, "raw block");
            append(out, p, size);
            p += size;
        } else if (type == 1) {
            need(p, end, 1, "RLE block");
            out.insert(out.end(), size, *p);
            p += 1;
        } else if (type == 2) {
            need(p, end, size, "compressed block");
            compressed_block(f, p, size);
            p += size;
        } else {
            fail("reserved block type");
        }
        if (limit && out.size() > limit) fail("decoded data above the limit");
    }
    const size_t produced = out.size() - f.start;
    if (fcs_size && produced != fcs) fail("frame decodes to another size than its header says");
    if (checksum) {
        need(p, end, 4, "content checksum");
        if (uint32_t(xxh64_impl(out.data() + f.start, produced, 0)) != le32(p)) fail("content checksum mismatch");
        p += 4;
    }
    return size_t(p - begin);
}

void decode_all(std::vector<uint8_t>& out, const uint8_t* src, size_t n, uint64_t limit) {
    if (n == 0) fail("no zstd frame in an empty input");
    const uint8_t* p = src;
    const uint8_t* end = src + n;
    while (p < end) {
        need(p, end, 4, "frame magic");
        const uint32_t magic = le32(p);
        if (magic == kFrameMagic) {
            p += read_frame(out, p, end, limit);
        } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
            need(p, end, 8, "skippable frame");
            const size_t size = le32(p + 4);
            need(p + 8, end, size, "skippable frame");
            p += 8 + size;
        } else {
            fail("not a zstd frame");
        }
    }
}

thread_local std::vector<uint8_t> result;

uint32_t crc_table[256];
struct CrcInit {
    CrcInit() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
            crc_table[i] = c;
        }
    }
} crc_init;

}  // namespace

extern "C" {

int64_t zstd_decode(const uint8_t* src, size_t n, uint64_t limit, char* err, size_t err_cap) {
    result.clear();
    result.shrink_to_fit();
    try {
        decode_all(result, src, n, limit);
    } catch (const std::exception& e) {  // Corrupt, or bad_alloc
        result.clear();
        result.shrink_to_fit();
        if (err_cap) std::snprintf(err, err_cap, "%s", e.what());
        return -1;
    }
    return int64_t(result.size());
}

void zstd_take(uint8_t* dst) {
    if (!result.empty()) std::memcpy(dst, result.data(), result.size());
    result.clear();
    result.shrink_to_fit();
}

uint32_t crc32c(const uint8_t* src, size_t n) {
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < n; ++i) c = crc_table[(c ^ src[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}
}
