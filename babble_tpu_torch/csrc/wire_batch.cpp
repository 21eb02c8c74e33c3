// The host half of a columnar sync batch: every row's Go-JSON encodings
// and SHA-256 digests, built in one call from the packed columns.
//
// For each row of a ColumnarEvents batch (net/columnar.py), in row order,
// babble_wire_batch writes the bytes that hashgraph/event.py's
// materialize_wire_event and Event.hex() produce in Python:
//
//   body  = {"Transactions":T,"Parents":["P0","P1"],"Creator":"C",
//            "Timestamp":"RFC3339Nano","Index":I}
//   event = {"Body":body,"R":R,"S":S}
//
// where T is null (a nil slice, count -1), [] (count 0) or the quoted
// standard base64 of each transaction; C the creator's base64 (a table
// by creator id, built once per graph); the timestamp Go's RFC3339Nano
// (UTC, the fraction's trailing zeros trimmed, no fraction when zero); R
// and S the signature's two 32-byte big-endian words in decimal. Then the
// SHA-256 of body + "\n" (what the creator signed), of event + "\n" (the
// event's identity) and that digest's "0x" + upper-hex form.
//
// A parent is either an earlier row of the batch, whose hex this call has
// just written, or a string the caller resolved against its store before
// the call (the same lookups, in the same order, that the Python path
// makes, so an unknown parent fails there and never reaches this file).
//
// Output, row k at out + off[k]:  body "\n" event "\n" hex (66 bytes);
// lens[2k] and lens[2k + 1] are the two encodings' lengths, dig[64k..]
// the body digest then the event digest. off[n] is the bytes written.
//
// Returns 0; 1 when the columns are inconsistent (a count, length or id
// out of range); 2 when `cap` is too small. Nothing here touches a Python
// object: ctypes releases the interpreter lock for the call.
//
// SHA-256 is FIPS 180-4, with the x86 SHA extensions where the CPU has
// them (checked once with cpuid) and a portable compression elsewhere.

#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#endif

namespace {

const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

const uint32_t IV[8] = {
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a, 0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
};

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

inline uint32_t load_be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

void compress_portable(uint32_t st[8], const uint8_t* data, size_t blocks) {
    uint32_t w[64];
    for (; blocks; --blocks, data += 64) {
        for (int i = 0; i < 16; ++i) w[i] = load_be32(data + 4 * i);
        for (int i = 16; i < 64; ++i) {
            uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
            uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
        uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
        for (int i = 0; i < 64; ++i) {
            uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) + K[i] + w[i];
            uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
            h = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        st[0] += a; st[1] += b; st[2] += c; st[3] += d;
        st[4] += e; st[5] += f; st[6] += g; st[7] += h;
    }
}

#if defined(__x86_64__)
// Sixteen groups of four rounds; the message schedule runs two groups
// ahead (sha256msg1) and one ahead (sha256msg2) of the rounds using it.
__attribute__((target("sha,sse4.1,ssse3")))
void compress_shani(uint32_t st[8], const uint8_t* data, size_t blocks) {
    const __m128i mask = _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
    __m128i tmp = _mm_loadu_si128(reinterpret_cast<const __m128i*>(st));
    __m128i s1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(st + 4));
    tmp = _mm_shuffle_epi32(tmp, 0xB1);         // CDAB
    s1 = _mm_shuffle_epi32(s1, 0x1B);           // EFGH
    __m128i s0 = _mm_alignr_epi8(tmp, s1, 8);   // ABEF
    s1 = _mm_blend_epi16(s1, tmp, 0xF0);        // CDGH
    for (; blocks; --blocks, data += 64) {
        const __m128i abef = s0, cdgh = s1;
        __m128i m[4];
        for (int g = 0; g < 16; ++g) {
            if (g < 4)
                m[g] = _mm_shuffle_epi8(
                    _mm_loadu_si128(reinterpret_cast<const __m128i*>(data + 16 * g)), mask);
            __m128i msg = _mm_add_epi32(
                m[g & 3], _mm_loadu_si128(reinterpret_cast<const __m128i*>(K + 4 * g)));
            s1 = _mm_sha256rnds2_epu32(s1, s0, msg);
            if (g >= 3 && g <= 14) {
                __m128i next = _mm_add_epi32(m[(g + 1) & 3], _mm_alignr_epi8(m[g & 3], m[(g + 3) & 3], 4));
                m[(g + 1) & 3] = _mm_sha256msg2_epu32(next, m[g & 3]);
            }
            s0 = _mm_sha256rnds2_epu32(s0, s1, _mm_shuffle_epi32(msg, 0x0E));
            if (g >= 1 && g <= 12)
                m[(g + 3) & 3] = _mm_sha256msg1_epu32(m[(g + 3) & 3], m[g & 3]);
        }
        s0 = _mm_add_epi32(s0, abef);
        s1 = _mm_add_epi32(s1, cdgh);
    }
    tmp = _mm_shuffle_epi32(s0, 0x1B);          // FEBA
    s1 = _mm_shuffle_epi32(s1, 0xB1);           // DCHG
    s0 = _mm_blend_epi16(tmp, s1, 0xF0);        // DCBA
    s1 = _mm_alignr_epi8(s1, tmp, 8);           // HGFE
    _mm_storeu_si128(reinterpret_cast<__m128i*>(st), s0);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(st + 4), s1);
}

bool cpu_has_sha() {
    unsigned a, b, c, d;
    if (!__get_cpuid(1, &a, &b, &c, &d)) return false;
    if (!(c & bit_SSE4_1) || !(c & bit_SSSE3)) return false;
    if (!__get_cpuid_count(7, 0, &a, &b, &c, &d)) return false;
    return (b >> 29) & 1;
}
#endif

using Compress = void (*)(uint32_t*, const uint8_t*, size_t);

Compress pick(bool portable) {
#if defined(__x86_64__)
    static const bool sha = cpu_has_sha();
    if (sha && !portable) return compress_shani;
#endif
    (void)portable;
    return compress_portable;
}

void sha256(Compress f, const uint8_t* data, size_t len, uint8_t out[32]) {
    uint32_t st[8];
    std::memcpy(st, IV, sizeof st);
    size_t full = len / 64, rem = len % 64;
    f(st, data, full);
    uint8_t tail[128] = {0};
    std::memcpy(tail, data + 64 * full, rem);
    tail[rem] = 0x80;
    size_t tl = rem + 9 <= 64 ? 64 : 128;
    uint64_t bits = uint64_t(len) * 8;
    for (int i = 0; i < 8; ++i) tail[tl - 1 - i] = uint8_t(bits >> (8 * i));
    f(st, tail, tl / 64);
    for (int i = 0; i < 8; ++i) {
        out[4 * i] = uint8_t(st[i] >> 24);
        out[4 * i + 1] = uint8_t(st[i] >> 16);
        out[4 * i + 2] = uint8_t(st[i] >> 8);
        out[4 * i + 3] = uint8_t(st[i]);
    }
}

// Appends into a caller's buffer, failing (and staying failed) past cap.
struct Out {
    uint8_t* p;
    uint8_t* end;
    bool full = false;
    bool room(size_t n) {
        if (full || size_t(end - p) < n) full = true;
        return !full;
    }
    void put(const void* s, size_t n) {
        if (room(n)) { std::memcpy(p, s, n); p += n; }
    }
    template <size_t N> void lit(const char (&s)[N]) { put(s, N - 1); }
    void ch(char c) { if (room(1)) *p++ = uint8_t(c); }
};

const char B64[] = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

void base64(Out& o, const uint8_t* s, size_t n) {
    if (!o.room((n + 2) / 3 * 4)) return;
    uint8_t* p = o.p;
    size_t i = 0;
    for (; i + 3 <= n; i += 3) {
        uint32_t v = (uint32_t(s[i]) << 16) | (uint32_t(s[i + 1]) << 8) | s[i + 2];
        p[0] = B64[v >> 18]; p[1] = B64[(v >> 12) & 63]; p[2] = B64[(v >> 6) & 63]; p[3] = B64[v & 63];
        p += 4;
    }
    if (i < n) {
        uint32_t v = uint32_t(s[i]) << 16;
        if (i + 1 < n) v |= uint32_t(s[i + 1]) << 8;
        p[0] = B64[v >> 18]; p[1] = B64[(v >> 12) & 63];
        p[2] = i + 1 < n ? B64[(v >> 6) & 63] : '=';
        p[3] = '=';
        p += 4;
    }
    o.p = p;
}

void decimal(Out& o, int64_t v) {
    char buf[24];
    int at = 24;
    uint64_t u = v < 0 ? uint64_t(0) - uint64_t(v) : uint64_t(v);
    do { buf[--at] = char('0' + u % 10); u /= 10; } while (u);
    if (v < 0) buf[--at] = '-';
    o.put(buf + at, 24 - at);
}

// A 256-bit big-endian word in decimal: eight 32-bit limbs divided by
// 10^9 in turn, each remainder nine digits.
void decimal256(Out& o, const uint8_t* be) {
    uint32_t limb[8];
    for (int i = 0; i < 8; ++i) limb[i] = load_be32(be + 4 * i);
    char buf[81];
    int at = 81;
    for (;;) {
        uint64_t rem = 0;
        bool zero = true;
        for (int i = 0; i < 8; ++i) {
            uint64_t cur = (rem << 32) | limb[i];
            limb[i] = uint32_t(cur / 1000000000u);
            rem = cur % 1000000000u;
            zero &= limb[i] == 0;
        }
        uint32_t r = uint32_t(rem);
        if (zero) {
            do { buf[--at] = char('0' + r % 10); r /= 10; } while (r);
            break;
        }
        for (int j = 0; j < 9; ++j) { buf[--at] = char('0' + r % 10); r /= 10; }
    }
    o.put(buf + at, 81 - at);
}

inline int64_t floor_div(int64_t a, int64_t b) {
    int64_t q = a / b;
    return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

void two(char* p, unsigned v) { p[0] = char('0' + v / 10); p[1] = char('0' + v % 10); }

// Go's time.RFC3339Nano of a UTC instant, `sec` seconds after the Unix
// epoch and `nanos` in [0, 1e9); days to a civil date by H. Hinnant's
// days_from_civil inverse. Years 1 to 9999.
void rfc3339nano(Out& o, int64_t sec, int64_t nanos) {
    int64_t days = floor_div(sec, 86400);
    int64_t sod = sec - days * 86400;
    int64_t z = days + 719468;
    int64_t era = floor_div(z, 146097);
    int64_t doe = z - era * 146097;
    int64_t yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
    int64_t doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
    int64_t mp = (5 * doy + 2) / 153;
    unsigned day = unsigned(doy - (153 * mp + 2) / 5 + 1);
    unsigned month = unsigned(mp < 10 ? mp + 3 : mp - 9);
    int64_t year = yoe + era * 400 + (month <= 2);
    char b[30];
    two(b, unsigned(year / 100)); two(b + 2, unsigned(year % 100));
    b[4] = '-'; two(b + 5, month); b[7] = '-'; two(b + 8, day);
    b[10] = 'T'; two(b + 11, unsigned(sod / 3600)); b[13] = ':';
    two(b + 14, unsigned(sod / 60 % 60)); b[16] = ':'; two(b + 17, unsigned(sod % 60));
    int len = 19;
    if (nanos) {
        b[len++] = '.';
        uint32_t f = uint32_t(nanos);
        char d[9];
        for (int j = 8; j >= 0; --j) { d[j] = char('0' + f % 10); f /= 10; }
        int keep = 9;
        while (d[keep - 1] == '0') --keep;
        std::memcpy(b + len, d, keep);
        len += keep;
    }
    b[len++] = 'Z';
    o.put(b, len);
}

void upper_hex(uint8_t* p, const uint8_t* digest) {
    static const char H[] = "0123456789ABCDEF";
    p[0] = '0'; p[1] = 'x';
    for (int i = 0; i < 32; ++i) { p[2 + 2 * i] = H[digest[i] >> 4]; p[3 + 2 * i] = H[digest[i] & 15]; }
}

}  // namespace

extern "C" {

int babble_wire_batch(
    int32_t n, const int32_t* cid, const int32_t* idx, const int64_t* ts_ns,
    const int32_t* tx_counts, const int32_t* tx_lens, int64_t n_tx,
    const uint8_t* tx_blob, int64_t blob_len, const uint8_t* sigs,
    const int32_t* par, const int32_t* ext_len, int64_t n_ext,
    const uint8_t* ext_blob, int64_t ext_blob_len,
    const int32_t* cre_off, int32_t n_cre, const uint8_t* cre_blob,
    uint8_t* out, int64_t cap, int64_t* off, int32_t* lens, uint8_t* dig) {
    const Compress f = pick(false);
    Out o{out, out + cap};
    int64_t tx = 0, tx_at = 0, ext = 0, ext_at = 0;
    for (int32_t k = 0; k < n; ++k) {
        off[k] = o.p - out;
        uint8_t* body = o.p;
        const int32_t c = cid[k];
        if (c < 0 || c >= n_cre || cre_off[c + 1] < cre_off[c]) return 1;
        o.lit("{\"Transactions\":");
        const int32_t count = tx_counts[k];
        if (count < 0) {
            o.lit("null");
        } else {
            if (count > n_tx - tx) return 1;
            o.ch('[');
            for (int32_t i = 0; i < count; ++i, ++tx) {
                const int32_t len = tx_lens[tx];
                if (len < 0 || len > blob_len - tx_at) return 1;
                if (i) o.ch(',');
                o.ch('"');
                base64(o, tx_blob + tx_at, size_t(len));
                o.ch('"');
                tx_at += len;
            }
            o.ch(']');
        }
        o.lit(",\"Parents\":[\"");
        for (int j = 0; j < 2; ++j) {
            if (j) o.lit("\",\"");
            const int32_t row = par[2 * k + j];
            if (row >= 0) {
                if (row >= k) return 1;
                o.put(out + off[row] + lens[2 * row] + lens[2 * row + 1] + 2, 66);
            } else {
                if (ext >= n_ext || ext_len[ext] < 0 || ext_len[ext] > ext_blob_len - ext_at) return 1;
                o.put(ext_blob + ext_at, size_t(ext_len[ext]));
                ext_at += ext_len[ext++];
            }
        }
        o.lit("\"],\"Creator\":\"");
        o.put(cre_blob + cre_off[c], size_t(cre_off[c + 1] - cre_off[c]));
        o.lit("\",\"Timestamp\":\"");
        const int64_t sec = floor_div(ts_ns[k], 1000000000);
        rfc3339nano(o, sec, ts_ns[k] - sec * 1000000000);
        o.lit("\",\"Index\":");
        decimal(o, idx[k]);
        o.ch('}');
        if (o.full) return 2;
        const size_t body_len = size_t(o.p - body);
        o.ch('\n');
        uint8_t* event = o.p;
        o.lit("{\"Body\":");
        o.put(body, body_len);
        o.lit(",\"R\":");
        decimal256(o, sigs + 64 * int64_t(k));
        o.lit(",\"S\":");
        decimal256(o, sigs + 64 * int64_t(k) + 32);
        o.ch('}');
        if (!o.room(68)) return 2;
        const size_t event_len = size_t(o.p - event);
        *o.p++ = '\n';
        sha256(f, body, body_len + 1, dig + 64 * int64_t(k));
        sha256(f, event, event_len + 1, dig + 64 * int64_t(k) + 32);
        upper_hex(o.p, dig + 64 * int64_t(k) + 32);
        o.p += 66;
        lens[2 * k] = int32_t(body_len);
        lens[2 * k + 1] = int32_t(event_len);
    }
    off[n] = o.p - out;
    return 0;
}

// SHA-256 of one buffer (portable != 0: without the SHA extensions).
void babble_sha256(const uint8_t* data, int64_t len, uint8_t* out, int32_t portable) {
    sha256(pick(portable != 0), data, size_t(len), out);
}

// RFC3339Nano of sec seconds after the epoch and nanos in [0, 1e9), into
// out (at least 30 bytes); returns its length.
int32_t babble_rfc3339nano(int64_t sec, int64_t nanos, uint8_t* out) {
    Out o{out, out + 30};
    rfc3339nano(o, sec, nanos);
    return o.full ? -1 : int32_t(o.p - out);
}

}  // extern "C"
