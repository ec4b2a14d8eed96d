// msm_ladder: per term, s * P by an MSB-first double-and-add ladder over the
// 256 bits of s.  Points [B, C, 9] canonical projective, bits [B, 256] uint8
// (MSB first) -> [B, C, 9] canonical; the caller
// (zkecdsa_tpu_torch/ops/curve_ops.py::msm_ladder) tree-sums the terms of a
// row with ec_add.
//
// Replaces zkecdsa_tpu/ops/curve_ops.py:373 msm_ladder (its scan of 256
// masked steps; the tree sum is sum_reduce).
//
// Design: one thread per term runs the plain version's steps in its order:
// a doubling, a complete add of P, and a select on the bit, every step, so
// the lanes of a warp never diverge and the result is the plain version's
// projective point.  No window table: the only state is the accumulator.
//
// Bound on the H100: 32-bit integer multiply-adds, 256 doublings and 256
// adds per term (about 7,000 Montgomery products on P-256); the operands are
// C*36 + 256 bytes per term.

#include <cuda_runtime.h>

#include "curve.cuh"

template <int CID>
__global__ void msm_ladder_kernel(long long B, const uint32_t* __restrict__ points,
                                  const uint8_t* __restrict__ bits, uint32_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    constexpr int C = CurveT<CID>::C;
    Pt<CID> P, acc, dbl, cand;
    pt_load<CID>(P, points + i * C * ZK_NL);
    pt_identity<CID>(acc);
    const uint8_t* bt = bits + i * 256;
#pragma unroll 1
    for (int k = 0; k < 256; ++k) {
        pt_dbl<CID>(dbl, acc);
        pt_add<CID>(cand, dbl, P);
        pt_select<CID>(acc, bt[k] != 0, cand, dbl);
    }
    pt_store<CID>(out + i * C * ZK_NL, acc);
}

extern "C" int zk_msm_ladder(int curve, long long B, const void* points, const void* bits, void* out,
                             void* stream) {
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 64;
    const unsigned blocks = (unsigned)((B + threads - 1) / threads);
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        msm_ladder_kernel<CID><<<blocks, threads, 0, st>>>(
            B, (const uint32_t*)points, (const uint8_t*)bits, (uint32_t*)out);
    });
    return bad ? bad : (int)cudaGetLastError();
}
