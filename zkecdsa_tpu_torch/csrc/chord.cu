// chord: the prover's phase-B field pass of the point-add sub-proofs, one
// thread per even-round row, all mod the P-256 base prime (ZK_TOM_N, the
// Tom-256 order).  It takes T1 = T + D in projective form and does both of
// phase B's inversions with one Fermat inverse a row:
//   T1 [K, 3, 9] canonical (X:Y:Z), and rows [K, 13, 9] canonical in the
//   order of zkecdsa_tpu_torch/ops/field.py CHORD_IN:
//     pkx pky txv pky_r txr cb0 cb1 cb2 cb3 kx0 kx1 kx2 kx3
// -> [K, 25, 9] canonical (CHORD_OUT):
//   t1x = X/Z, t1y = Y/Z ((0, 0) for the identity, as to_affine writes);
//   i7 = pkx - t1x, i8 = i7^-1 (0 -> 0), i9 = pky - t1y, i10 = i8 i9,
//   i11 = i10^2, i12 = t1x - txv, i13 = i10 i12   (pointAdd.ts:119-136);
//   ext_vals   x_j y_j (j = 0..3), then kx_j y_j;
//   ext_blinds x_j rb_j, then kx_j rb_j;
// with y = [i8, i9, i10, i12], x = [i7, i8, i10, i10] and
// rb = [cb2, pky_r - cb1, cb3, cb0 - txr].
//
// Replaces zkecdsa_tpu/ops/f32field.py:441 batch_inv and the field pass of
// zkecdsa_tpu/protocol/batch.py:464-493, with the affine pass before it
// (nist_affine_std, :463), which the port ran as a to_affine launch of its
// own.  The two inverses share one chain: with a = Z and b = pkx Z - X,
// i7 = b / a, so w = (a b)^-1 gives 1/Z = b w and i8 = a / b = a^2 w.  A
// zero factor is replaced by one in the chain (a = 1 and X = 0 for the
// identity, so that b = pkx = i7; b = 1 when i7 = 0), and its outputs are
// masked as the plain version gives them.
//
// Bound on the H100: 32-bit integer multiply-adds.  A row takes one
// inverse (267 products by an addition chain for p - 2, or 298 by
// field.cuh's fe_inv) and 31 products besides, against 576 bytes read and
// 900 written; the function's least work inverts the K products a b as
// one batch (3 products a row and one inverse).  A row's inverse chain is
// what a call takes: 10240 rows are 320 warps, one a scheduler on 80 SMs.
// Forms: values stay standard where they can, since a Montgomery product
// of a standard and a Montgomery operand is the standard product, so only
// Z, i7, i8, i10 and the four kx_j are converted, and no output is
// converted back; every output is stored as soon as it is made.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int NIN = 13;
constexpr int NOUT = 25;
// input rows
constexpr int PKX = 0, PKY = 1, TXV = 2, PKY_R = 3, TXR = 4, CB = 5, KX = 9;
// output rows
constexpr int T1X = 0, T1Y = 1, I7 = 2, I8 = 3, I9 = 4, I10 = 5, I11 = 6, I12 = 7, I13 = 8;
constexpr int EXT_VALS = 9, EXT_BLINDS = 17;

// r = a^(2^n) (n Montgomery squarings)
__device__ __forceinline__ void fe_sqr_n(Fe r, const Fe a, int n, const ZkModulus& M) {
    fe_copy(r, a);
#pragma unroll 1
    for (int i = 0; i < n; ++i) fe_mont_mul(r, r, r, M);
}

// r = a^(p-2) for the P-256 prime by an addition chain: 255 squarings and
// 12 products (fe_inv's 4-bit window takes 298 and a 576-byte table).  p - 2
// = 2^256 - 2^224 + 2^192 + 2^96 - 3 is 32 ones, 31 zeros and a one, 96
// zeros, 64 ones, then 30 ones and 01; x_k = a^(2^k - 1).  The same
// Montgomery power as fe_inv: a zero maps to zero.
__device__ __forceinline__ void fe_inv_p256(Fe r, const Fe a, const ZkModulus& M) {
    Fe x2, x3, x30, x32, t;
    fe_mont_mul(t, a, a, M);
    fe_mont_mul(x2, t, a, M);
    fe_mont_mul(t, x2, x2, M);
    fe_mont_mul(x3, t, a, M);
    fe_sqr_n(t, x3, 3, M);
    fe_mont_mul(t, t, x3, M);  // x6
    fe_sqr_n(x30, t, 6, M);
    fe_mont_mul(t, x30, t, M);  // x12
    fe_sqr_n(t, t, 3, M);
    fe_mont_mul(t, t, x3, M);  // x15
    fe_sqr_n(x30, t, 15, M);
    fe_mont_mul(x30, x30, t, M);
    fe_sqr_n(t, x30, 2, M);
    fe_mont_mul(x32, t, x2, M);
    fe_sqr_n(t, x32, 32, M);
    fe_mont_mul(t, t, a, M);
    fe_sqr_n(t, t, 128, M);
    fe_mont_mul(t, t, x32, M);
    fe_sqr_n(t, t, 32, M);
    fe_mont_mul(t, t, x32, M);
    fe_sqr_n(t, t, 30, M);
    fe_mont_mul(t, t, x30, M);
    fe_sqr_n(t, t, 2, M);
    fe_mont_mul(r, t, a, M);
}

template <bool CHAIN>
__global__ void chord_kernel(long long K, const uint32_t* __restrict__ T1,
                             const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= K) return;
    const ZkModulus& M = ZK_MODS[ZK_TOM_N];
    const uint32_t* t1 = T1 + k * 3 * ZK_NL;
    const uint32_t* v = in + k * NIN * ZK_NL;
    uint32_t* o = out + k * NOUT * ZK_NL;
    auto row = [&](int s) { return v + s * ZK_NL; };
    auto put = [&](int s, const Fe x) { fe_store(o + s * ZK_NL, x); };

    Fe one, zero, Z, X, Zm, b, u, w;
    fe_set_zero(zero);
    fe_set_zero(one);
    one[0] = 1u;
    // a = Z, or 1 with X = 0 for the identity; b = pkx Z - X = i7 Z
    fe_load(Z, t1 + 2 * ZK_NL);
    const bool inf = fe_is_zero(Z);
    fe_select(Z, inf, one, Z);
    fe_load(X, t1);
    fe_select(X, inf, zero, X);
    fe_to_mont(Zm, Z, M);
    fe_load(u, row(PKX));
    fe_mont_mul(b, u, Zm, M);
    fe_sub(b, b, X, M);
    const bool i7zero = fe_is_zero(b);
    fe_select(b, i7zero, one, b);
    // w = (a b)^-1 R^2: the inverse of a standard-form value
    fe_mont_mul(u, Zm, b, M);
    if constexpr (CHAIN) {
        fe_inv_p256(w, u, M);
    } else {
        fe_inv(w, u, M);
    }
    // R / Z = b w R^-1, then t1x = X / Z, t1y = Y / Z (standard form)
    fe_mont_mul(u, b, w, M);
    Fe t1x, t1y, i7, i8, i9, i10, i12, m7, m8, m10, t;
    fe_mont_mul(t1x, X, u, M);
    put(T1X, t1x);
    fe_load(t, t1 + ZK_NL);
    fe_mont_mul(t1y, t, u, M);
    fe_select(t1y, inf, zero, t1y);
    put(T1Y, t1y);
    // i8 = a / b = a^2 w (a^2 R^-1 w R^-1); 0 when i7 = 0
    fe_mont_mul(t, Z, Z, M);
    fe_mont_mul(i8, t, w, M);
    fe_select(i8, i7zero, zero, i8);
    put(I8, i8);
    fe_load(t, row(PKX));
    fe_sub(i7, t, t1x, M);
    put(I7, i7);
    fe_load(t, row(PKY));
    fe_sub(i9, t, t1y, M);
    put(I9, i9);
    fe_load(t, row(TXV));
    fe_sub(i12, t1x, t, M);
    put(I12, i12);
    fe_to_mont(m8, i8, M);
    fe_mont_mul(i10, m8, i9, M);
    put(I10, i10);
    fe_to_mont(m10, i10, M);
    fe_mont_mul(t, m10, i10, M);
    put(I11, t);
    put(EXT_VALS + 2, t);  // x_2 y_2 = i10 i10 = i11
    fe_mont_mul(t, m10, i12, M);
    put(I13, t);
    put(EXT_VALS + 3, t);  // x_3 y_3 = i10 i12 = i13
    put(EXT_VALS + 1, i10);  // x_1 y_1 = i8 i9 = i10
    // x_0 y_0 = i7 i8: 1, or 0 when i7 = 0
    fe_select(t, i7zero, zero, one);
    put(EXT_VALS, t);
    fe_to_mont(m7, i7, M);
    const uint32_t* ys[4] = {i8, i9, i10, i12};
    const uint32_t* xm[4] = {m7, m8, m10, m10};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        Fe rb, kxm;
        if (j == 0 || j == 2) {
            fe_load(rb, row(j == 0 ? CB + 2 : CB + 3));
        } else {
            Fe c;
            fe_load(t, row(j == 1 ? PKY_R : CB));
            fe_load(c, row(j == 1 ? CB + 1 : TXR));
            fe_sub(rb, t, c, M);
        }
        fe_load(t, row(KX + j));
        fe_to_mont(kxm, t, M);
        fe_mont_mul(t, kxm, ys[j], M);
        put(EXT_VALS + 4 + j, t);
        fe_mont_mul(t, xm[j], rb, M);
        put(EXT_BLINDS + j, t);
        fe_mont_mul(t, kxm, rb, M);
        put(EXT_BLINDS + 4 + j, t);
    }
}

// The shipped form, the fastest in tools/torch_chord_probe.py on the
// H100 at K = 10240 (PERF.md): the addition chain, 5% faster than
// fe_inv's window; one-warp blocks (64 and 128 threads within 1%).
constexpr bool CHORD_CHAIN = true;
constexpr int CHORD_THREADS = 32;

}  // namespace

extern "C" int zk_chord(long long K, const void* T1, const void* in, void* out, void* stream) {
    if (K == 0) return 0;
    const unsigned blocks = (unsigned)((K + CHORD_THREADS - 1) / CHORD_THREADS);
    chord_kernel<CHORD_CHAIN><<<blocks, CHORD_THREADS, 0, (cudaStream_t)stream>>>(
        K, (const uint32_t*)T1, (const uint32_t*)in, (uint32_t*)out);
    return (int)cudaGetLastError();
}
