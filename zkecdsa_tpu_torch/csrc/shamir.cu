// shamir: dP*P + dQ*Q on P-256 from two window tables (entry k = k*base,
// k = 0..15, canonical projective) and MSB-first 4-bit digits, with the
// doublings shared (Shamir's trick, group.ts:97-132).  Tables [Bt, 16, 3, 9]
// with a row stride of 16*3*9 limbs, or 0 when one table serves every row;
// digits [B, 64] uint8 -> [B, 3, 9] canonical projective coordinates.
//
// Replaces zkecdsa_tpu/ops/curve_ops.py:238 double_mul_tables (and :264
// double_mul).  Per digit column: four doublings, then + tp[dP], + tq[dQ],
// complete formulas, the order of the reference's scan, so the projective
// result equals the plain version's (ops/curve_ops.py).
//
// Bound on the H100: 32-bit integer multiply-adds; per row 256 doublings and
// 128 adds (~5,100 Montgomery products).  One thread per row: the prover's
// calls have 256-512 rows, so the card is nearly empty and the time is the
// latency of one row's dependent chain of products, not the IMAD rate.

#include <cuda_runtime.h>

#include "curve.cuh"

__global__ void shamir_kernel(long long B, const uint32_t* __restrict__ tp, long long sp,
                              const uint8_t* __restrict__ dP, const uint32_t* __restrict__ tq,
                              long long sq, const uint8_t* __restrict__ dQ,
                              uint32_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    constexpr int CID = ZK_CURVE_P256;
    constexpr int PT = 3 * ZK_NL;  // limbs per point
    const uint32_t* rp = tp + i * sp;
    const uint32_t* rq = tq + i * sq;
    Pt<CID> acc, tmp, e;
    pt_identity<CID>(acc);
    for (int col = 0; col < 64; ++col) {
#pragma unroll 1
        for (int k = 0; k < 4; ++k) {
            pt_dbl<CID>(tmp, acc);
            acc = tmp;
        }
        pt_load<CID>(e, rp + dP[i * 64 + col] * PT);
        pt_add<CID>(tmp, acc, e);
        pt_load<CID>(e, rq + dQ[i * 64 + col] * PT);
        pt_add<CID>(acc, tmp, e);
    }
    pt_store<CID>(out + i * PT, acc);
}

extern "C" int zk_shamir(long long B, const void* tp, long long sp, const void* dP,
                         const void* tq, long long sq, const void* dQ, void* out,
                         void* stream) {
    if (B == 0) return 0;
    const int threads = 32;  // one warp per block: spread the few rows over SMs
    const unsigned blocks = (unsigned)((B + threads - 1) / threads);
    shamir_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        B, (const uint32_t*)tp, sp, (const uint8_t*)dP, (const uint32_t*)tq, sq,
        (const uint8_t*)dQ, (uint32_t*)out);
    return (int)cudaGetLastError();
}
