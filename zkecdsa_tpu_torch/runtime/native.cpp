// Native runtime of zkecdsa_tpu_torch's host layer.
//
// The reference implementation leans on the JS platform's native
// primitives: WebCrypto SHA-256 for Fiat-Shamir and the WebCrypto CSPRNG
// (reference src/bignum/big.ts:136-185, src/curves/group.ts:221-233).
// This is the port's equivalent: a small C++ library exposing
//   - zk_sha256        : one-shot digest
//   - zk_sha256_batch  : many digests hashed on a thread pool (the batched
//                        prover hashes hundreds of transcripts per batch)
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
}
