// comb_mixed: g*v + h*r on Tom-256 from the concatenated mixed-add comb
// tables [64, 256, 5, 9] (windows 0..31 of g, then 0..31 of h; entry
// [j][d] = d * 2^(8j) * base as affine rows X, Y, X+Y, d*T, a*X) and
// [B, 64] LSB-first byte digits -> [B, 4, 9] canonical extended
// coordinates.  64 table lookups and mixed adds, no doublings, one thread
// per row, in the window order of the reference so the projective result
// is the same.
//
// Replaces zkecdsa_tpu/ops/curve_ops.py:731 double_mul_comb_mixed / :705
// mul_comb_mixed (the TPU's one-hot matrix gather becomes an index into
// the table).
//
// Bound on the H100: 32-bit integer multiply-adds: per window 9 Montgomery
// products for the add plus 5 to bring the looked-up entry into Montgomery
// form; the table (5.9 MB for both bases) stays in L2.
//
// comb_weier: the P-256 fixed-base multiply of the prover's Pedersen base h
// from its comb table [32, 256, 3, 9] (entry [j][d] = d * 2^(8j) * h,
// affine with Z = 1, entry d = 0 the identity (0:1:0)) and [B, 32]
// LSB-first byte digits -> [B, 3, 9]: acc = acc + T[j][d_j] for j = 0..31,
// complete RCB15 adds, one thread per row.  Replaces
// zkecdsa_tpu/ops/curve_ops.py:330 mul_comb (and :358 double_mul_comb).
// Bound: 32 adds of 14 products plus 3 to-Montgomery passes per window; the
// table (0.9 MB) stays in L2.

#include <cuda_runtime.h>

#include "curve.cuh"

__global__ void comb_mixed_kernel(long long B, const uint32_t* __restrict__ tabs,
                                  const uint8_t* __restrict__ digits,
                                  uint32_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    constexpr int CID = ZK_CURVE_TOM;
    const ZkModulus& M = curve_mod<CID>();
    Pt<CID> acc, tmp;
    pt_identity<CID>(acc);
    for (int j = 0; j < 64; ++j) {
        const int d = digits[i * 64 + j];
        const uint32_t* ent = tabs + ((long long)j * 256 + d) * 5 * ZK_NL;
        Fe row[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            Fe t;
            fe_load(t, ent + k * ZK_NL);
            fe_to_mont(row[k], t, M);
        }
        edw_add_mixed(tmp, acc, row[0], row[1], row[2], row[3], row[4]);
        acc = tmp;
    }
    pt_store<CID>(out + i * 4 * ZK_NL, acc);
}

extern "C" int zk_comb_mixed(long long B, const void* tabs, const void* digits, void* out,
                             void* stream) {
    if (B == 0) return 0;
    const int threads = 128;
    const unsigned blocks = (unsigned)((B + threads - 1) / threads);
    comb_mixed_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        B, (const uint32_t*)tabs, (const uint8_t*)digits, (uint32_t*)out);
    return (int)cudaGetLastError();
}

__global__ void comb_weier_kernel(long long B, const uint32_t* __restrict__ tab,
                                  const uint8_t* __restrict__ digits,
                                  uint32_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    constexpr int CID = ZK_CURVE_P256;
    constexpr int PT = 3 * ZK_NL;
    Pt<CID> acc, tmp, e;
    pt_identity<CID>(acc);
    for (int j = 0; j < 32; ++j) {
        pt_load<CID>(e, tab + ((long long)j * 256 + digits[i * 32 + j]) * PT);
        pt_add<CID>(tmp, acc, e);
        acc = tmp;
    }
    pt_store<CID>(out + i * PT, acc);
}

extern "C" int zk_comb_weier(long long B, const void* tab, const void* digits, void* out,
                             void* stream) {
    if (B == 0) return 0;
    const int threads = 128;
    const unsigned blocks = (unsigned)((B + threads - 1) / threads);
    comb_weier_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        B, (const uint32_t*)tab, (const uint8_t*)digits, (uint32_t*)out);
    return (int)cudaGetLastError();
}
