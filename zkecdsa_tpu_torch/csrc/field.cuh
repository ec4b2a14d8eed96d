// Modular arithmetic over the five moduli of the two-curve design, for
// Hopper.  Counterpart of zkecdsa_tpu/ops/f32field.py (its base-2^7 float32
// digits existed for the TPU's matrix unit; here a field element is nine
// little-endian 32-bit limbs, because the Tom-256 base prime is 258 bits).
//
// Boundary contract: every value a kernel reads or writes in device memory
// is canonical (in [0, p)) and in standard form.  Inside a kernel values are
// in Montgomery form (x * R mod p, R = 2^288), except in the P-256 prime's
// Solinas products at the end of the file, which stay in standard form;
// every operation returns a fully reduced result, so the kernel arithmetic
// is branch-free and needs no bound tracking.
//
// The constants below are checked against Python integers by
// tests/test_torch_field.py (which parses this file), the Solinas steps by
// tests/test_torch_field_p256.py.
#pragma once

#include <cstdint>

#define ZK_NL 9  // limbs per field element

// Modulus ids; the same order as zkecdsa_tpu_torch/ops/field.py.
#define ZK_P256_P 0
#define ZK_P256_N 1
#define ZK_TOM_P 2
#define ZK_TOM_N 3
#define ZK_WAR_P 4

struct ZkModulus {
    uint32_t p[ZK_NL];    // the modulus
    uint32_t r2[ZK_NL];   // R^2 mod p (to Montgomery form)
    uint32_t one[ZK_NL];  // R mod p (Montgomery one)
    uint32_t pinv;        // -p^-1 mod 2^32
};

static __constant__ ZkModulus ZK_MODS[5] = {
    {  // P256_P
        {0xffffffffu, 0xffffffffu, 0xffffffffu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000001u, 0xffffffffu, 0x00000000u},
        {0x00000002u, 0x00000005u, 0x00000003u, 0xfffffffeu, 0xfffffff9u, 0xfffffffbu, 0xfffffffcu, 0xfffffffcu, 0x00000000u},
        {0x00000000u, 0x00000001u, 0x00000000u, 0x00000000u, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xfffffffeu, 0x00000000u},
        0x00000001u},
    {  // P256_N
        {0xfc632551u, 0xf3b9cac2u, 0xa7179e84u, 0xbce6faadu, 0xffffffffu, 0xffffffffu, 0x00000000u, 0xffffffffu, 0x00000000u},
        {0x3af42abbu, 0x5706acb0u, 0x30a9cdc7u, 0xdf119f1bu, 0x51d16bdbu, 0x619076abu, 0xd0b168a4u, 0x1c1f0858u, 0x00000000u},
        {0x00000000u, 0x039cdaafu, 0x0c46353du, 0x58e8617bu, 0x43190552u, 0x00000000u, 0x00000000u, 0xffffffffu, 0x00000000u},
        0xee00bc4fu},
    {  // TOM_P
        {0xbc47d3afu, 0x713c3d82u, 0x57cc4ff9u, 0xae382c79u, 0x00000002u, 0x00000000u, 0x00000004u, 0xfffffffcu, 0x00000003u},
        {0xad03ba69u, 0xdf4d5887u, 0x94025ccdu, 0xb1571595u, 0x5ed18516u, 0x16ff2f35u, 0xc31e50c3u, 0xcb6e66e9u, 0x00000001u},
        {0x40000000u, 0x50ee0b14u, 0xa3b0f09fu, 0xaa0cec01u, 0x5471f4e1u, 0xffffffffu, 0xffffffffu, 0xfffffffeu, 0x00000000u},
        0x26289cb1u},
    {  // TOM_N (the Tom-256 group order is the P-256 base prime)
        {0xffffffffu, 0xffffffffu, 0xffffffffu, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000001u, 0xffffffffu, 0x00000000u},
        {0x00000002u, 0x00000005u, 0x00000003u, 0xfffffffeu, 0xfffffff9u, 0xfffffffbu, 0xfffffffcu, 0xfffffffcu, 0x00000000u},
        {0x00000000u, 0x00000001u, 0x00000000u, 0x00000000u, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xfffffffeu, 0x00000000u},
        0x00000001u},
    {  // WAR_P
        {0xb1c4b117u, 0x93135661u, 0x30e73177u, 0x7e72b42bu, 0x00000001u, 0x00000000u, 0x00000001u, 0xffffffffu, 0x00000000u},
        {0x202a7633u, 0x7c5edd01u, 0xc33bd53du, 0x9da74f75u, 0xedc98d7eu, 0xe8bed96du, 0xdec364bbu, 0x57fe6976u, 0x00000000u},
        {0x00000000u, 0x4e3b4ee9u, 0x6ceca99eu, 0xcf18ce88u, 0x818d4bd4u, 0xfffffffeu, 0xffffffffu, 0xfffffffeu, 0x00000000u},
        0x0f646959u},
};

typedef uint32_t Fe[ZK_NL];

__device__ __forceinline__ void fe_copy(Fe r, const Fe a) {
#pragma unroll
    for (int i = 0; i < ZK_NL; ++i) r[i] = a[i];
}

__device__ __forceinline__ void fe_set_zero(Fe r) {
#pragma unroll
    for (int i = 0; i < ZK_NL; ++i) r[i] = 0u;
}

__device__ __forceinline__ bool fe_is_zero(const Fe a) {
    uint32_t acc = 0u;
#pragma unroll
    for (int i = 0; i < ZK_NL; ++i) acc |= a[i];
    return acc == 0u;
}

// r = c ? a : b, without a branch
__device__ __forceinline__ void fe_select(Fe r, bool c, const Fe a, const Fe b) {
    const uint32_t m = 0u - (uint32_t)c;
#pragma unroll
    for (int i = 0; i < ZK_NL; ++i) r[i] = (a[i] & m) | (b[i] & ~m);
}

// The additions below run their carries in the PTX carry flag (add.cc/addc,
// sub.cc/subc): one instruction a limb, against two or three for a 64-bit
// emulated carry.  Each chain is one asm statement, so nothing can come
// between a carry and its use.
#define ZK_L9(v) "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(v[4]), "r"(v[5]), "r"(v[6]), \
                 "r"(v[7]), "r"(v[8])
#define ZK_O9(v) "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]), "=r"(v[4]), "=r"(v[5]), \
                 "=r"(v[6]), "=r"(v[7]), "=r"(v[8])

// r = t - p if t >= p else t, for t < 2p held in ZK_NL limbs plus `hi`.
__device__ __forceinline__ void fe_reduce_once(Fe r, const uint32_t* t, uint32_t hi,
                                               const ZkModulus& M) {
    uint32_t d[ZK_NL], top;
    // d = t - p; top = hi - borrow: 0 when t >= p, all ones when t < p
    asm("sub.cc.u32 %0, %10, %19;\n\t"
        "subc.cc.u32 %1, %11, %20;\n\t"
        "subc.cc.u32 %2, %12, %21;\n\t"
        "subc.cc.u32 %3, %13, %22;\n\t"
        "subc.cc.u32 %4, %14, %23;\n\t"
        "subc.cc.u32 %5, %15, %24;\n\t"
        "subc.cc.u32 %6, %16, %25;\n\t"
        "subc.cc.u32 %7, %17, %26;\n\t"
        "subc.cc.u32 %8, %18, %27;\n\t"
        "subc.u32 %9, %28, 0;"
        : ZK_O9(d), "=r"(top)
        : ZK_L9(t), ZK_L9(M.p), "r"(hi));
#pragma unroll
    for (int i = 0; i < ZK_NL; ++i) r[i] = (t[i] & top) | (d[i] & ~top);
}

// r = a + b mod p (a, b canonical, either domain)
__device__ __forceinline__ void fe_add(Fe r, const Fe a, const Fe b, const ZkModulus& M) {
    uint32_t s[ZK_NL], hi;
    asm("add.cc.u32 %0, %10, %19;\n\t"
        "addc.cc.u32 %1, %11, %20;\n\t"
        "addc.cc.u32 %2, %12, %21;\n\t"
        "addc.cc.u32 %3, %13, %22;\n\t"
        "addc.cc.u32 %4, %14, %23;\n\t"
        "addc.cc.u32 %5, %15, %24;\n\t"
        "addc.cc.u32 %6, %16, %25;\n\t"
        "addc.cc.u32 %7, %17, %26;\n\t"
        "addc.cc.u32 %8, %18, %27;\n\t"
        "addc.u32 %9, 0, 0;"
        : ZK_O9(s), "=r"(hi)
        : ZK_L9(a), ZK_L9(b));
    fe_reduce_once(r, s, hi, M);
}

// r = a - b mod p (a, b canonical, either domain)
__device__ __forceinline__ void fe_sub(Fe r, const Fe a, const Fe b, const ZkModulus& M) {
    uint32_t d[ZK_NL], m, q[ZK_NL];
    // d = a - b; m = all ones on a borrow
    asm("sub.cc.u32 %0, %10, %19;\n\t"
        "subc.cc.u32 %1, %11, %20;\n\t"
        "subc.cc.u32 %2, %12, %21;\n\t"
        "subc.cc.u32 %3, %13, %22;\n\t"
        "subc.cc.u32 %4, %14, %23;\n\t"
        "subc.cc.u32 %5, %15, %24;\n\t"
        "subc.cc.u32 %6, %16, %25;\n\t"
        "subc.cc.u32 %7, %17, %26;\n\t"
        "subc.cc.u32 %8, %18, %27;\n\t"
        "subc.u32 %9, 0, 0;"
        : ZK_O9(d), "=r"(m)
        : ZK_L9(a), ZK_L9(b));
#pragma unroll
    for (int i = 0; i < ZK_NL; ++i) q[i] = M.p[i] & m;  // add p back on a borrow
    asm("add.cc.u32 %0, %9, %18;\n\t"
        "addc.cc.u32 %1, %10, %19;\n\t"
        "addc.cc.u32 %2, %11, %20;\n\t"
        "addc.cc.u32 %3, %12, %21;\n\t"
        "addc.cc.u32 %4, %13, %22;\n\t"
        "addc.cc.u32 %5, %14, %23;\n\t"
        "addc.cc.u32 %6, %15, %24;\n\t"
        "addc.cc.u32 %7, %16, %25;\n\t"
        "addc.u32 %8, %17, %26;"
        : ZK_O9(r)
        : ZK_L9(d), ZK_L9(q));
}

// Montgomery product r = a * b * R^-1 mod p (CIOS, 32-bit words, 64-bit
// accumulators: ptxas turns each step into one IMAD.WIDE and a 64-bit add,
// fewer instructions than the same rows as PTX mad.lo.cc/madc.hi.cc
// chains, which it splits into IMAD and IADD3 pairs; see PERF.md).
// a, b < p gives r < p.
__device__ __forceinline__ void fe_mont_mul(Fe r, const Fe a, const Fe b, const ZkModulus& M) {
    uint32_t t[ZK_NL + 2];
#pragma unroll
    for (int i = 0; i < ZK_NL + 2; ++i) t[i] = 0u;
#pragma unroll
    for (int i = 0; i < ZK_NL; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < ZK_NL; ++j) {
            c += (uint64_t)a[j] * b[i] + t[j];
            t[j] = (uint32_t)c;
            c >>= 32;
        }
        c += t[ZK_NL];
        t[ZK_NL] = (uint32_t)c;
        t[ZK_NL + 1] = (uint32_t)(c >> 32);
        const uint32_t q = t[0] * M.pinv;
        c = ((uint64_t)q * M.p[0] + t[0]) >> 32;
#pragma unroll
        for (int j = 1; j < ZK_NL; ++j) {
            c += (uint64_t)q * M.p[j] + t[j];
            t[j - 1] = (uint32_t)c;
            c >>= 32;
        }
        c += t[ZK_NL];
        t[ZK_NL - 1] = (uint32_t)c;
        t[ZK_NL] = t[ZK_NL + 1] + (uint32_t)(c >> 32);
    }
    fe_reduce_once(r, t, t[ZK_NL], M);
}

__device__ __forceinline__ void fe_to_mont(Fe r, const Fe a, const ZkModulus& M) {
    fe_mont_mul(r, a, M.r2, M);
}

__device__ __forceinline__ void fe_from_mont(Fe r, const Fe a, const ZkModulus& M) {
    Fe one;
    fe_set_zero(one);
    one[0] = 1u;
    fe_mont_mul(r, a, one, M);
}

// r = k * a mod p for a small constant k >= 1 (repeated addition)
template <int K>
__device__ __forceinline__ void fe_mul_small(Fe r, const Fe a, const ZkModulus& M) {
    Fe acc;
    fe_copy(acc, a);
#pragma unroll
    for (int i = 1; i < K; ++i) fe_add(acc, acc, a, M);
    fe_copy(r, acc);
}

// r = a^(p-2) = a^-1 mod p (Montgomery in and out; 0 maps to 0), by a
// fixed 4-bit window over p-2: a table of a^1..a^15 (14 products), then
// from the top digit down four squarings and, for a nonzero digit, one
// product by its table entry.  That is 298 products on the P-256 prime,
// 312 on Tom-256's, 321 on the P-256 order and 306 on war256's prime (a
// 3- or 5-bit window takes more on each), where the bit ladder this
// replaces ran 288 squarings and a product a set bit: 416 and 392.
// The digits are the modulus's, the same for every thread, so the loop
// does not diverge; the table is indexed by a digit known only at run
// time, so it lives in local memory (576 bytes a thread, L1-resident;
// a table held in registers through a switch on the digit ran slower).
// Nothing in the chain is unrolled: with the four squarings inlined the
// loop outgrew the instruction cache, and a chain took 20% longer once
// most SMs ran it (tools/torch_inv_probe.py; PERF.md).
__device__ __forceinline__ void fe_inv(Fe r, const Fe a, const ZkModulus& M) {
    Fe tab[16];
    fe_copy(tab[1], a);
#pragma unroll 1
    for (int k = 2; k < 16; ++k) fe_mont_mul(tab[k], tab[k - 1], a, M);
    // digit i of p - 2 (every modulus here has p[0] >= 2: no borrow)
    auto digit = [&](int i) {
        const uint32_t w = (i >> 3) ? M.p[i >> 3] : M.p[0] - 2u;
        return (w >> ((i & 7) * 4)) & 15u;
    };
    int i = ZK_NL * 8 - 1;
    while (digit(i) == 0u) --i;  // p - 2 > 0: a nonzero digit exists
    Fe acc;
    fe_copy(acc, tab[digit(i)]);
#pragma unroll 1
    for (--i; i >= 0; --i) {
#pragma unroll 1
        for (int s = 0; s < 4; ++s) fe_mont_mul(acc, acc, acc, M);
        const uint32_t d = digit(i);
        if (d != 0u) fe_mont_mul(acc, acc, tab[d], M);
    }
    fe_copy(r, acc);
}

__device__ __forceinline__ void fe_load(Fe r, const uint32_t* g) {
#pragma unroll
    for (int i = 0; i < ZK_NL; ++i) r[i] = g[i];
}

__device__ __forceinline__ void fe_store(uint32_t* g, const Fe a) {
#pragma unroll
    for (int i = 0; i < ZK_NL; ++i) g[i] = a[i];
}

// ---------------------------------------------------------------------------
// The P-256 prime p = 2^256 - 2^224 + 2^192 + 2^96 - 1 (ZK_P256_P, and
// ZK_TOM_N: the Tom-256 group order is the same prime) by Solinas
// reduction, in standard form: no conversion in or out.  A product is the
// 8x8-limb schoolbook product (64 wide products; limb 8 of a canonical
// value is 0) and the reduction of FIPS 186-4 D.2.3 (Hankerson, Menezes,
// Vanstone, Alg. 2.29): with the product's words c0..c15,
//   t = s1 + 2 s2 + 2 s3 + s4 + s5 - s6 - s7 - s8 - s9 + 5p,
// each s_k a word permutation below (LSB first, "-" a zero word).  Without
// the 5p, t lies in (-4 2^256, 7 2^256) and its top word is signed; the 5p
// keeps it in [0, 12 2^256), so the top word h is in [0, 11] and one fold
// through 2^256 = 2^224 - 2^192 - 2^96 + 1 (mod p) leaves t < 2p, which
// one masked subtraction of p makes canonical.  Every step runs on every
// value: no branch, no loop whose count depends on a value.  A fold costs
// two carry chains, so the reduction is 10 chains and a subtraction
// (about 110 additions) against the two 9x9-limb Montgomery products (2 x
// 171 wide products) it replaces.  tests/test_torch_field_p256.py models
// every step with Python integers.
//
//   s1 = c0  c1  c2  c3  c4  c5  c6  c7      s6 = c11 c12 c13 -   -   -   c8  c10
//   s2 = -   -   -   c11 c12 c13 c14 c15     s7 = c12 c13 c14 c15 -   -   c9  c11
//   s3 = -   -   -   c12 c13 c14 c15 -       s8 = c13 c14 c15 c8  c9  c10 -   c12
//   s4 = c8  c9  c10 -   -   -   c14 c15     s9 = c14 c15 -   c9  c10 c11 -   c13
//   s5 = c9  c10 c11 c13 c14 c15 c13 c8

// t[0..8] += (x0, ..., x7, 0): one carry chain
__device__ __forceinline__ void p256_add8(uint32_t* t, uint32_t x0, uint32_t x1, uint32_t x2,
                                          uint32_t x3, uint32_t x4, uint32_t x5, uint32_t x6,
                                          uint32_t x7) {
    asm("add.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, %16;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8])
        : "r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(x4), "r"(x5), "r"(x6), "r"(x7));
}

// t[0..8] -= (x0, ..., x7, 0), modulo 2^288
__device__ __forceinline__ void p256_sub8(uint32_t* t, uint32_t x0, uint32_t x1, uint32_t x2,
                                          uint32_t x3, uint32_t x4, uint32_t x5, uint32_t x6,
                                          uint32_t x7) {
    asm("sub.cc.u32 %0, %0, %9;\n\t"
        "subc.cc.u32 %1, %1, %10;\n\t"
        "subc.cc.u32 %2, %2, %11;\n\t"
        "subc.cc.u32 %3, %3, %12;\n\t"
        "subc.cc.u32 %4, %4, %13;\n\t"
        "subc.cc.u32 %5, %5, %14;\n\t"
        "subc.cc.u32 %6, %6, %15;\n\t"
        "subc.cc.u32 %7, %7, %16;\n\t"
        "subc.u32 %8, %8, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8])
        : "r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(x4), "r"(x5), "r"(x6), "r"(x7));
}

// t[0..8] = t[0..7] + h (2^224 - 2^192 - 2^96 + 1) for h = t[8], any word:
// h (2^256 mod p) < 2^256, so the result is below 2^257.  The new top word
// is its own early-clobber output: written while h is still to be read, it
// must not share h's register (nvcc gives an input the register of an
// in-out operand that holds the same value).
__device__ __forceinline__ void p256_fold(uint32_t* t) {
    uint32_t top;
    asm("add.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, 0;\n\t"
        "addc.cc.u32 %2, %2, 0;\n\t"
        "addc.cc.u32 %3, %3, 0;\n\t"
        "addc.cc.u32 %4, %4, 0;\n\t"
        "addc.cc.u32 %5, %5, 0;\n\t"
        "addc.cc.u32 %6, %6, 0;\n\t"
        "addc.cc.u32 %7, %7, %9;\n\t"
        "addc.u32 %8, 0, 0;\n\t"
        "sub.cc.u32 %3, %3, %9;\n\t"
        "subc.cc.u32 %4, %4, 0;\n\t"
        "subc.cc.u32 %5, %5, 0;\n\t"
        "subc.cc.u32 %6, %6, %9;\n\t"
        "subc.cc.u32 %7, %7, 0;\n\t"
        "subc.u32 %8, %8, 0;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "=&r"(top)
        : "r"(t[8]));
    t[8] = top;
}

// c[0..15] = a * b for a, b < 2^256 (limbs 0..7): operand scanning, 64-bit
// accumulators (one IMAD.WIDE and an add a step, as in fe_mont_mul)
__device__ __forceinline__ void p256_wide_mul(uint32_t* c, const uint32_t* a, const uint32_t* b) {
#pragma unroll
    for (int i = 0; i < 16; ++i) c[i] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t t = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            t += (uint64_t)a[j] * b[i] + c[i + j];
            c[i + j] = (uint32_t)t;
            t >>= 32;
        }
        c[i + 8] = (uint32_t)t;
    }
}

// r = c mod p, canonical, for c < 2^512 (c[0..15])
__device__ __forceinline__ void p256_reduce(Fe r, const uint32_t* c) {
    uint32_t t[9] = {c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], 0u};  // s1
    p256_add8(t, 0u, 0u, 0u, c[11], c[12], c[13], c[14], c[15]);    // s2
    p256_add8(t, 0u, 0u, 0u, c[11], c[12], c[13], c[14], c[15]);    // s2
    p256_add8(t, 0u, 0u, 0u, c[12], c[13], c[14], c[15], 0u);       // s3
    p256_add8(t, 0u, 0u, 0u, c[12], c[13], c[14], c[15], 0u);       // s3
    p256_add8(t, c[8], c[9], c[10], 0u, 0u, 0u, c[14], c[15]);      // s4
    p256_add8(t, c[9], c[10], c[11], c[13], c[14], c[15], c[13], c[8]);  // s5
    p256_sub8(t, c[11], c[12], c[13], 0u, 0u, 0u, c[8], c[10]);     // s6
    p256_sub8(t, c[12], c[13], c[14], c[15], 0u, 0u, c[9], c[11]);  // s7
    p256_sub8(t, c[13], c[14], c[15], c[8], c[9], c[10], 0u, c[12]);  // s8
    p256_sub8(t, c[14], c[15], 0u, c[9], c[10], c[11], 0u, c[13]);  // s9
    // + 5p, top word 4
    asm("add.cc.u32 %0, %0, 0xfffffffb;\n\t"
        "addc.cc.u32 %1, %1, 0xffffffff;\n\t"
        "addc.cc.u32 %2, %2, 0xffffffff;\n\t"
        "addc.cc.u32 %3, %3, 0x00000004;\n\t"
        "addc.cc.u32 %4, %4, 0x00000000;\n\t"
        "addc.cc.u32 %5, %5, 0x00000000;\n\t"
        "addc.cc.u32 %6, %6, 0x00000005;\n\t"
        "addc.cc.u32 %7, %7, 0xfffffffb;\n\t"
        "addc.u32 %8, %8, 0x00000004;"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
          "+r"(t[7]), "+r"(t[8]));
    p256_fold(t);  // t < 2p, t[8] in {0, 1}
    fe_reduce_once(r, t, 0u, ZK_MODS[ZK_P256_P]);
}

// r = a * b mod p (a, b canonical, standard form)
__device__ __forceinline__ void fe_mul_p256(Fe r, const Fe a, const Fe b) {
    uint32_t c[16];
    p256_wide_mul(c, a, b);
    p256_reduce(r, c);
}
