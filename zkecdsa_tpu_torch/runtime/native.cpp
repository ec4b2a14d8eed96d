// Native runtime of zkecdsa_tpu_torch's host layer.
//
// The reference implementation leans on the JS platform's native
// primitives: WebCrypto SHA-256 for Fiat-Shamir and the WebCrypto CSPRNG
// (reference src/bignum/big.ts:136-185, src/curves/group.ts:221-233).
// This is the port's equivalent: a small C++ library exposing
//   - zk_sha256        : one-shot digest
//   - zk_sha256_batch  : many digests hashed on a thread pool (the batched
//                        prover hashes hundreds of transcripts per batch)
//   - zk_read_proof    : a SignatureProofList's canonical wire JSON in one
//                        pass (structure, hex, every point's curve check)
//                        into flat arrays; declines anything else
// loaded via ctypes (see native.py).  The reference's zk_fill_random
// (getrandom) is not here: the OS CSPRNG comes from Python's `secrets`,
// which calls getrandom too, at a third of a ctypes call's cost for the
// verifier's 32-byte draws (about 1,400 a proof).
//
// SHA-256 is implemented from the FIPS 180-4 specification.  On an x86 CPU
// with the SHA extensions the compression runs on them (sha256rnds2/msg1/
// msg2, chosen at run time by CPUID): the scalar rounds run several times
// slower than OpenSSL's single-core hashlib.  zk_sha256_batch starts one
// thread for every kMinBytesPerThread bytes of input, up to `threads`:
// starting a thread costs more than hashing a short batch.
// -DZK_SHA256_SCALAR builds the scalar rounds only; -DZK_MIN_BYTES_PER_THREAD
// overrides the constant (0: always `threads`, the reference's policy).
//
// Build (native.py does this at first use, into build/zkecdsa_tpu_torch/):
//   g++ -O3 -shared -fPIC -std=c++17 -pthread native.cpp -o libzkruntime.so

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#ifdef __SSE2__
#include <emmintrin.h>
#endif

#if defined(__x86_64__) && !defined(ZK_SHA256_SCALAR)
#define ZK_SHANI 1
#include <cpuid.h>
#include <immintrin.h>
#endif

#ifndef ZK_MIN_BYTES_PER_THREAD
#define ZK_MIN_BYTES_PER_THREAD (1024 * 1024)
#endif

namespace {

const uint64_t kMinBytesPerThread = ZK_MIN_BYTES_PER_THREAD;

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

void scalar_blocks(uint32_t h[8], const uint8_t* p, size_t n) {
    for (; n; n--, p += 64) {
        uint32_t w[64];
        for (int i = 0; i < 16; i++) {
            w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
                   (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
        }
        for (int i = 16; i < 64; i++) {
            uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
            uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
        uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
        for (int i = 0; i < 64; i++) {
            uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
            uint32_t ch = (e & f) ^ (~e & g);
            uint32_t t1 = hh + S1 + ch + K[i] + w[i];
            uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
            uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            uint32_t t2 = S0 + maj;
            hh = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d;
        h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
    }
}

#ifdef ZK_SHANI
// The x86 SHA extensions: four rounds per pair of sha256rnds2, the
// schedule's next four words from sha256msg1/msg2.  The state is held as
// ABEF and CDGH, the layout sha256rnds2 reads.
__attribute__((target("sha,sse4.1"))) void shani_blocks(uint32_t h[8], const uint8_t* p, size_t n) {
    const __m128i bswap = _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
    __m128i tmp = _mm_shuffle_epi32(_mm_loadu_si128((const __m128i*)&h[0]), 0xB1);  // CDAB
    __m128i st1 = _mm_shuffle_epi32(_mm_loadu_si128((const __m128i*)&h[4]), 0x1B);  // EFGH
    __m128i st0 = _mm_alignr_epi8(tmp, st1, 8);     // ABEF
    st1 = _mm_blend_epi16(st1, tmp, 0xF0);          // CDGH
    for (; n; n--, p += 64) {
        const __m128i abef = st0, cdgh = st1;
        __m128i w[4];
        for (int g = 0; g < 16; g++) {
            if (g < 4) {
                w[g] = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)(p + 16 * g)), bswap);
            } else {  // W[4g..4g+3] from the 16 words before them
                w[g & 3] = _mm_sha256msg2_epu32(
                    _mm_add_epi32(_mm_sha256msg1_epu32(w[g & 3], w[(g + 1) & 3]),
                                  _mm_alignr_epi8(w[(g + 3) & 3], w[(g + 2) & 3], 4)),
                    w[(g + 3) & 3]);
            }
            __m128i msg = _mm_add_epi32(w[g & 3], _mm_loadu_si128((const __m128i*)&K[4 * g]));
            st1 = _mm_sha256rnds2_epu32(st1, st0, msg);
            st0 = _mm_sha256rnds2_epu32(st0, st1, _mm_shuffle_epi32(msg, 0x0E));
        }
        st0 = _mm_add_epi32(st0, abef);
        st1 = _mm_add_epi32(st1, cdgh);
    }
    tmp = _mm_shuffle_epi32(st0, 0x1B);             // FEBA
    st1 = _mm_shuffle_epi32(st1, 0xB1);             // DCHG
    _mm_storeu_si128((__m128i*)&h[0], _mm_blend_epi16(tmp, st1, 0xF0));  // h[0..3] = A B C D
    _mm_storeu_si128((__m128i*)&h[4], _mm_alignr_epi8(st1, tmp, 8));     // h[4..7] = E F G H
}

bool cpu_has_sha() {
    unsigned a, b, c, d;
    if (!__get_cpuid_count(7, 0, &a, &b, &c, &d)) return false;
    const bool sha = b & (1u << 29);
    if (!__get_cpuid(1, &a, &b, &c, &d)) return false;
    return sha && (c & bit_SSE4_1) && (c & bit_SSSE3);
}

const bool kShaNi = cpu_has_sha();
#endif

void compress(uint32_t h[8], const uint8_t* p, size_t n) {
#ifdef ZK_SHANI
    if (kShaNi) {
        shani_blocks(h, p, n);
        return;
    }
#endif
    scalar_blocks(h, p, n);
}

struct Sha256Ctx {
    uint32_t h[8];
    uint64_t total = 0;
    uint8_t buf[64];
    size_t buflen = 0;

    Sha256Ctx() {
        static const uint32_t init[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                         0xa54ff53a, 0x510e527f, 0x9b05688c,
                                         0x1f83d9ab, 0x5be0cd19};
        std::memcpy(h, init, sizeof(h));
    }

    void update(const uint8_t* data, size_t len) {
        total += len;
        if (buflen) {
            size_t need = 64 - buflen;
            size_t take = len < need ? len : need;
            std::memcpy(buf + buflen, data, take);
            buflen += take;
            data += take;
            len -= take;
            if (buflen == 64) {
                compress(h, buf, 1);
                buflen = 0;
            }
        }
        if (len >= 64) {
            compress(h, data, len / 64);
            data += len & ~size_t(63);
            len &= 63;
        }
        if (len) {
            std::memcpy(buf, data, len);
            buflen = len;
        }
    }

    void final(uint8_t out[32]) {
        uint64_t bits = total * 8;
        buf[buflen++] = 0x80;
        if (buflen > 56) {  // no room for the length: one more block
            std::memset(buf + buflen, 0, 64 - buflen);
            compress(h, buf, 1);
            buflen = 0;
        }
        std::memset(buf + buflen, 0, 56 - buflen);
        for (int i = 0; i < 8; i++) buf[56 + i] = uint8_t(bits >> (56 - 8 * i));
        compress(h, buf, 1);
        for (int i = 0; i < 8; i++) {
            out[4 * i] = uint8_t(h[i] >> 24);
            out[4 * i + 1] = uint8_t(h[i] >> 16);
            out[4 * i + 2] = uint8_t(h[i] >> 8);
            out[4 * i + 3] = uint8_t(h[i]);
        }
    }
};

// ---------- the wire decoder ----------
//
// zk_read_proof reads exactly the text serde.write_json emits for a
// SignatureProofList, which is also what the reference's JSON.stringify
// emits: compact JSON with the keys in declared order, ExpProof's optional
// fields present or absent in their declared order, arrays of any length,
// the groups "p256" and "tomEdwards256", every integer "0x" and lowercase
// hex digits (at most kDigits of them past leading zeros).  Each point is
// checked on its curve with Z = 1: P-256 y^2 = x^3 + a x + b, Tom-256
// a x^2 + y^2 = 1 + d x^2 y^2 (both equations of TEdwards.is_on_group once
// T = x y), each coordinate below the field prime.  It declines anything
// else (a nonzero return, never an error), and serde.read_json then parses
// with its Python path, which gives the same object or raises.  Arithmetic
// is Montgomery (CIOS) in five 64-bit limbs: Tom-256's prime has 258 bits.
// On x86 the digits are found and converted sixteen at a time (SSE2).

typedef unsigned __int128 u128;
constexpr int kLimbs = 5;
constexpr size_t kDigits = 66;  // an integer's output: 33 big-endian bytes
constexpr size_t kIntBytes = kDigits / 2;

inline bool is_hex(char c) { return (uint8_t(c - '0') < 10) | (uint8_t(c - 'a') < 6); }

inline uint64_t nibble(char c) { return uint64_t((c & 0xf) + 9 * (c >> 6)); }  // '0'-'9', 'a'-'f'

#ifdef __SSE2__
// Bytes of c in [lo, lo + n), as 0xff lanes (unsigned compare through the sign bit).
inline __m128i in_range(__m128i c, char lo, int n) {
    const __m128i d = _mm_xor_si128(_mm_sub_epi8(c, _mm_set1_epi8(lo)), _mm_set1_epi8(char(0x80)));
    return _mm_cmplt_epi8(d, _mm_set1_epi8(char(0x80 + n)));
}

// 16 zero bytes then 16 0xff: loaded at kTail + k, the last k lanes are set.
alignas(16) const uint8_t kTail[32] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                       255, 255, 255, 255, 255, 255, 255, 255,
                                       255, 255, 255, 255, 255, 255, 255, 255};

// The last `take` (1-16) hex digits before e as a number; reads e - 16 .. e.
inline uint64_t chunk_value(const char* e, size_t take) {
    const __m128i c = _mm_loadu_si128(reinterpret_cast<const __m128i*>(e - 16));
    __m128i nib = _mm_add_epi8(_mm_and_si128(c, _mm_set1_epi8(0x0f)),
                               _mm_and_si128(in_range(c, 'a', 6), _mm_set1_epi8(9)));
    nib = _mm_and_si128(nib, _mm_loadu_si128(reinterpret_cast<const __m128i*>(kTail + take)));
    // 16-bit lane i: digit 2i (low byte) and 2i+1 -> the byte 16 d_2i + d_2i+1
    const __m128i pairs = _mm_or_si128(_mm_and_si128(_mm_slli_epi16(nib, 4), _mm_set1_epi16(0x00f0)),
                                       _mm_srli_epi16(nib, 8));
    return __builtin_bswap64(uint64_t(_mm_cvtsi128_si64(_mm_packus_epi16(pairs, pairs))));
}
#endif

// The end of the run of lowercase hex digits from p.
const char* hex_run(const char* p, const char* end) {
#ifdef __SSE2__
    while (end - p >= 16) {
        const __m128i c = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
        const unsigned hex = unsigned(_mm_movemask_epi8(_mm_or_si128(in_range(c, '0', 10), in_range(c, 'a', 6))));
        if (hex != 0xffff) return p + __builtin_ctz(~hex);
        p += 16;
    }
#endif
    while (p < end && is_hex(*p)) p++;
    return p;
}

// Hex digits [s, e) (at most kDigits) into little-endian limbs, sixteen a
// limb from the last; `begin` is the start of the text, which may be read.
void hex_limbs(const char* begin, const char* s, const char* e, uint64_t out[kLimbs]) {
    size_t n = size_t(e - s);
    for (int i = 0; i < kLimbs; i++) {
        const size_t take = n < 16 ? n : 16;
        uint64_t limb = 0;
#ifdef __SSE2__
        if (take && e - begin >= 16) {
            limb = chunk_value(e, take);
        } else
#endif
        {
            for (const char* q = e - take; q < e; q++) limb = (limb << 4) | nibble(*q);
        }
        out[i] = limb;
        n -= take;
        e -= take;
    }
}

// Limbs below 2^264 as 33 big-endian bytes.
void put_bytes(const uint64_t v[kLimbs], uint8_t* o) {
    for (size_t k = 0; k < kIntBytes; k++) o[kIntBytes - 1 - k] = uint8_t(v[k / 8] >> (8 * (k % 8)));
}

bool less(const uint64_t a[kLimbs], const uint64_t b[kLimbs]) {
    for (int i = kLimbs - 1; i >= 0; i--) {
        if (a[i] != b[i]) return a[i] < b[i];
    }
    return false;
}

bool equal(const uint64_t a[kLimbs], const uint64_t b[kLimbs]) {
    return std::memcmp(a, b, sizeof(uint64_t) * kLimbs) == 0;
}

struct Field {
    uint64_t p[kLimbs];
    uint64_t n0;           // -p^-1 mod 2^64
    uint64_t r2[kLimbs];   // R^2 mod p, R = 2^(64 kLimbs)

    explicit Field(const char* hex) {
        hex_limbs(hex, hex, hex + std::strlen(hex), p);
        uint64_t inv = p[0];  // right to 3 bits; each Newton step doubles them
        for (int i = 0; i < 5; i++) inv *= 2 - p[0] * inv;
        n0 = 0 - inv;
        uint64_t r[kLimbs] = {1};
        for (int i = 0; i < 128 * kLimbs; i++) add(r, r, r);
        std::memcpy(r2, r, sizeof(r));
    }

    // r = t mod p for t < 2p, without a branch on t.
    void reduce_once(uint64_t r[kLimbs], const uint64_t t[kLimbs]) const {
        uint64_t d[kLimbs], borrow = 0;
        for (int i = 0; i < kLimbs; i++) {
            const u128 x = u128(t[i]) - p[i] - borrow;
            d[i] = uint64_t(x);
            borrow = uint64_t(x >> 64) & 1;
        }
        const uint64_t keep = 0 - borrow;  // all ones where t < p
        for (int i = 0; i < kLimbs; i++) r[i] = (t[i] & keep) | (d[i] & ~keep);
    }

    // r = a + b mod p, for a, b < p (p < 2^258: the sum fits the limbs).
    void add(uint64_t r[kLimbs], const uint64_t a[kLimbs], const uint64_t b[kLimbs]) const {
        uint64_t t[kLimbs];
        u128 c = 0;
        for (int i = 0; i < kLimbs; i++) {
            c += u128(a[i]) + b[i];
            t[i] = uint64_t(c);
            c >>= 64;
        }
        reduce_once(r, t);
    }

    // r = a b R^-1 mod p, for a, b < p.
    void mul(uint64_t r[kLimbs], const uint64_t a[kLimbs], const uint64_t b[kLimbs]) const {
        uint64_t t[kLimbs + 2] = {0};
        for (int i = 0; i < kLimbs; i++) {
            u128 c = 0;
            for (int j = 0; j < kLimbs; j++) {
                c += u128(a[j]) * b[i] + t[j];
                t[j] = uint64_t(c);
                c >>= 64;
            }
            c += t[kLimbs];
            t[kLimbs] = uint64_t(c);
            t[kLimbs + 1] = uint64_t(c >> 64);
            const uint64_t m = t[0] * n0;
            c = (u128(m) * p[0] + t[0]) >> 64;
            for (int j = 1; j < kLimbs; j++) {
                c += u128(m) * p[j] + t[j];
                t[j - 1] = uint64_t(c);
                c >>= 64;
            }
            c += t[kLimbs];
            t[kLimbs - 1] = uint64_t(c);
            t[kLimbs] = t[kLimbs + 1] + uint64_t(c >> 64);
        }
        reduce_once(r, t);  // t < 2p < 2^259: t[kLimbs] is 0
    }

    // v R^k mod p for the hex constant v (k >= -1).
    void constant(uint64_t r[kLimbs], const char* hex, int k) const {
        hex_limbs(hex, hex, hex + std::strlen(hex), r);
        const uint64_t one[kLimbs] = {1};
        mul(r, r, one);  // v R^-1
        for (int i = -1; i < k; i++) mul(r, r, r2);
    }
};

// y^2 = x^3 + a x + b, with x, y taken to Montgomery form.
struct Weierstrass {
    Field f;
    uint64_t a[kLimbs], b[kLimbs];  // a R, b R

    Weierstrass(const char* p, const char* a_hex, const char* b_hex) : f(p) {
        f.constant(a, a_hex, 1);
        f.constant(b, b_hex, 1);
    }

    bool on_curve(const uint64_t x[kLimbs], const uint64_t y[kLimbs]) const {
        if (!less(x, f.p) || !less(y, f.p)) return false;
        uint64_t xm[kLimbs], ym[kLimbs], lhs[kLimbs], rhs[kLimbs];
        f.mul(xm, x, f.r2);
        f.mul(ym, y, f.r2);
        f.mul(lhs, ym, ym);
        f.mul(rhs, xm, xm);
        f.add(rhs, rhs, a);
        f.mul(rhs, rhs, xm);
        f.add(rhs, rhs, b);
        return equal(lhs, rhs);
    }
};

// a x^2 + y^2 = 1 + d x^2 y^2, both sides times R^-1: with X = x^2 R^-1
// and Y = y^2 R^-1 (one product each), a x^2 R^-1 = (a R) X R^-1 and
// d x^2 y^2 R^-1 = (d R^3) (X Y R^-1) R^-1, five products a point.
struct TwistedEdwards {
    Field f;
    uint64_t a[kLimbs], d[kLimbs], one[kLimbs];  // a R, d R^3, R^-1

    TwistedEdwards(const char* p, const char* a_hex, const char* d_hex) : f(p) {
        f.constant(a, a_hex, 1);
        f.constant(d, d_hex, 3);
        f.constant(one, "1", -1);
    }

    bool on_curve(const uint64_t x[kLimbs], const uint64_t y[kLimbs]) const {
        if (!less(x, f.p) || !less(y, f.p)) return false;
        uint64_t x2[kLimbs], y2[kLimbs], lhs[kLimbs], rhs[kLimbs];
        f.mul(x2, x, x);
        f.mul(y2, y, y);
        f.mul(lhs, a, x2);
        f.add(lhs, lhs, y2);
        f.mul(rhs, x2, y2);
        f.mul(rhs, rhs, d);
        f.add(rhs, rhs, one);
        return equal(lhs, rhs);
    }
};

// curves/instances.py
const Weierstrass kP256(
    "ffffffff00000001000000000000000000000000ffffffffffffffffffffffff",
    "ffffffff00000001000000000000000000000000fffffffffffffffffffffffc",
    "5ac635d8aa3a93e7b3ebbd55769886bc651d06b0cc53b0f63bce3c3e27d2604b");
const TwistedEdwards kTom256(
    "3fffffffc000000040000000000000002ae382c7957cc4ff9713c3d82bc47d3af",
    "1abce3fd8e1d7a21252515332a512e09d4249bd5b1ec35e316c02254fe8cedf5d",
    "51781d9823abde00ec99295ba542c8b1401874bcbeb9e9c861174c7bca6a02aa");

// The value kinds written to `kinds`, one a point or scalar in document order.
enum Kind : uint8_t { kP256Point = 0, kTomPoint = 1, kP256Scalar = 2, kTomScalar = 3 };

// ExpProof's optional fields, in declared order, as bits of a round's mask.
enum Optional : int32_t {
    kAlpha = 1, kBeta1 = 2, kBeta2 = 4, kBeta3 = 8, kZ = 16, kZ2 = 32, kProof = 64, kR1 = 128, kR2 = 256
};

struct Wire {
    const char* begin;
    const char* p;
    const char* end;
    uint8_t* kinds;     // one a value
    uint8_t* ints;      // kIntBytes an integer: x, y of a point, k of a scalar
    size_t cap;         // integers `ints` (and values `kinds`) can hold
    int32_t* shape;     // rounds, each round's mask, the seven GK lengths
    size_t shape_cap;
    size_t n_kinds = 0, n_ints = 0, n_shape = 0;

    template <size_t N>
    bool lit(const char (&s)[N]) {
        constexpr size_t n = N - 1;
        if (size_t(end - p) < n || std::memcmp(p, s, n) != 0) return false;
        p += n;
        return true;
    }

    bool push_shape(int32_t v) {
        if (n_shape >= shape_cap) return false;
        shape[n_shape++] = v;
        return true;
    }

    // {"group":{"name":"p256"} -> 0, {"group":{"name":"tomEdwards256"} -> 1, else -1
    int group() {
        if (n_kinds >= cap || !lit("{\"group\":{\"name\":\"")) return -1;
        if (lit("p256\"}")) return 0;
        if (lit("tomEdwards256\"}")) return 1;
        return -1;
    }

    // "0x" and lowercase hex digits, leading zeros allowed.
    bool hex(uint64_t v[kLimbs]) {
        if (!lit("\"0x")) return false;
        const char* s = p;
        p = hex_run(p, end);
        if (p == s || p == end || *p != '"') return false;
        const char* e = p++;
        while (s < e && *s == '0') s++;
        if (size_t(e - s) > kDigits) return false;
        hex_limbs(begin, s, e, v);
        return true;
    }

    void put(const uint64_t v[kLimbs]) { put_bytes(v, ints + kIntBytes * n_ints++); }

    bool point() {
        uint64_t x[kLimbs], y[kLimbs];
        const int g = group();
        if (g < 0 || n_ints + 2 > cap || !lit(",\"x\":") || !hex(x) || !lit(",\"y\":") || !hex(y) || !lit("}")) {
            return false;
        }
        if (!(g == 0 ? kP256.on_curve(x, y) : kTom256.on_curve(x, y))) return false;
        put(x);
        put(y);
        kinds[n_kinds++] = g == 0 ? kP256Point : kTomPoint;
        return true;
    }

    bool scalar() {
        uint64_t k[kLimbs];
        const int g = group();
        if (g < 0 || n_ints >= cap || !lit(",\"k\":") || !hex(k) || !lit("}")) return false;
        put(k);
        kinds[n_kinds++] = g == 0 ? kP256Scalar : kTomScalar;
        return true;
    }

    // [item,item,...], its length pushed to the shape
    template <class Item>
    bool array(Item item) {
        if (!lit("[")) return false;
        int32_t n = 0;
        if (!lit("]")) {
            do {
                if (!(this->*item)()) return false;
                n++;
            } while (lit(","));
            if (!lit("]")) return false;
        }
        return push_shape(n);
    }

    bool equality() {
        return lit("{\"A_1\":") && point() && lit(",\"A_2\":") && point() &&
               lit(",\"t_x\":") && scalar() && lit(",\"t_r1\":") && scalar() &&
               lit(",\"t_r2\":") && scalar() && lit("}");
    }

    bool mult() {
        return lit("{\"C_4\":") && point() && lit(",\"A_x\":") && point() &&
               lit(",\"A_y\":") && point() && lit(",\"A_z\":") && point() &&
               lit(",\"A_4_1\":") && point() && lit(",\"A_4_2\":") && point() &&
               lit(",\"t_x\":") && scalar() && lit(",\"t_y\":") && scalar() &&
               lit(",\"t_z\":") && scalar() && lit(",\"t_rx\":") && scalar() &&
               lit(",\"t_ry\":") && scalar() && lit(",\"t_rz\":") && scalar() &&
               lit(",\"t_r4\":") && scalar() && lit("}");
    }

    bool point_add() {
        return lit("{\"C_8\":") && point() && lit(",\"C_10\":") && point() &&
               lit(",\"C_11\":") && point() && lit(",\"C_13\":") && point() &&
               lit(",\"pi_8\":") && mult() && lit(",\"pi_10\":") && mult() &&
               lit(",\"pi_11\":") && mult() && lit(",\"pi_13\":") && mult() &&
               lit(",\"pi_x\":") && equality() && lit(",\"pi_y\":") && equality() && lit("}");
    }

    bool round() {
        if (!(lit("{\"A\":") && point() && lit(",\"Tx\":") && point() && lit(",\"Ty\":") && point())) {
            return false;
        }
        int32_t mask = 0;
        if (lit(",\"alpha\":")) { if (!scalar()) return false; mask |= kAlpha; }
        if (lit(",\"beta1\":")) { if (!scalar()) return false; mask |= kBeta1; }
        if (lit(",\"beta2\":")) { if (!scalar()) return false; mask |= kBeta2; }
        if (lit(",\"beta3\":")) { if (!scalar()) return false; mask |= kBeta3; }
        if (lit(",\"z\":")) { if (!scalar()) return false; mask |= kZ; }
        if (lit(",\"z2\":")) { if (!scalar()) return false; mask |= kZ2; }
        if (lit(",\"proof\":")) { if (!point_add()) return false; mask |= kProof; }
        if (lit(",\"r1\":")) { if (!scalar()) return false; mask |= kR1; }
        if (lit(",\"r2\":")) { if (!scalar()) return false; mask |= kR2; }
        return lit("}") && push_shape(mask);
    }

    // the rounds' count, then each round's mask
    bool rounds() {
        const size_t at = n_shape;
        if (!push_shape(0) || !lit("[")) return false;
        int32_t n = 0;
        if (!lit("]")) {
            do {
                if (!round()) return false;
                n++;
            } while (lit(","));
            if (!lit("]")) return false;
        }
        shape[at] = n;
        return true;
    }

    bool gk() {
        return lit("{\"cl\":") && array(&Wire::point) && lit(",\"ca\":") && array(&Wire::point) &&
               lit(",\"cb\":") && array(&Wire::point) && lit(",\"cd\":") && array(&Wire::point) &&
               lit(",\"f\":") && array(&Wire::scalar) && lit(",\"za\":") && array(&Wire::scalar) &&
               lit(",\"zb\":") && array(&Wire::scalar) && lit(",\"zd\":") && scalar() && lit("}");
    }

    bool proof() {
        return lit("{\"R\":") && point() && lit(",\"comS1\":") && point() &&
               lit(",\"keyXcom\":") && point() && lit(",\"keyYcom\":") && point() &&
               lit(",\"expProof\":") && rounds() && lit(",\"membershipProof\":") && gk() &&
               lit("}") && p == end;
    }
};

}  // namespace

extern "C" {

void zk_sha256(const uint8_t* data, size_t len, uint8_t* out) {
    Sha256Ctx ctx;
    ctx.update(data, len);
    ctx.final(out);
}

// Hash `count` messages: data is the concatenation, offsets[i]..offsets[i+1]
// delimit message i (offsets has count+1 entries).  Outputs 32*count bytes.
void zk_sha256_batch(const uint8_t* data, const uint64_t* offsets,
                     size_t count, uint8_t* out, int threads) {
    if (count) {  // a thread for every kMinBytesPerThread bytes, at most `threads`
        const uint64_t bytes = offsets[count] - offsets[0];
        const uint64_t most = kMinBytesPerThread ? 1 + bytes / kMinBytesPerThread : uint64_t(threads);
        if (most < uint64_t(threads)) threads = int(most);
    }
    if (threads <= 1 || count < 8) {
        for (size_t i = 0; i < count; i++) {
            zk_sha256(data + offsets[i], offsets[i + 1] - offsets[i],
                      out + 32 * i);
        }
        return;
    }
    int nt = threads;
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; t++) {
        pool.emplace_back([=]() {
            for (size_t i = t; i < count; i += nt) {
                zk_sha256(data + offsets[i], offsets[i + 1] - offsets[i],
                          out + 32 * i);
            }
        });
    }
    for (auto& th : pool) th.join();
}

// Read a SignatureProofList's wire text (see Wire).  Returns 0 and fills
// kinds (Kind, a value), ints (33 big-endian bytes an integer, `cap` of
// them), shape (the rounds' count, each round's Optional mask, the lengths
// of cl, ca, cb, cd, f, za, zb) and counts (values, integers, shape
// entries); returns 1, with the outputs undefined, on anything else.
int zk_read_proof(const char* text, size_t len, uint8_t* kinds, uint8_t* ints, size_t cap,
                  int32_t* shape, size_t shape_cap, uint64_t* counts) {
    Wire w{text, text, text + len, kinds, ints, cap, shape, shape_cap};
    if (!w.proof()) return 1;
    counts[0] = w.n_kinds;
    counts[1] = w.n_ints;
    counts[2] = w.n_shape;
    return 0;
}
}
