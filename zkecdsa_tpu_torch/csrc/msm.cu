// straus_msm: per row, sum_t s_t * P_t with 4-bit MSB-first digits
// (Straus / interleaved windows: doublings are shared by the terms of a
// chunk).  Points [R, T, C, 9] canonical projective, digits [R, T, 64]
// uint8 -> one partial sum per (row, chunk) [R, nchunks, C, 9]; the caller
// (zkecdsa_tpu_torch/ops/curve_ops.py::straus_msm) tree-sums the partials
// of a row with ec_add.
//
// Replaces zkecdsa_tpu/ops/curve_ops.py:393 msm_shared (and :164
// scalar_mul_table, the T = 1 case the verifier's window muls use).
//
// Design: one thread per (row, chunk of `chunk` terms).  The thread builds
// the 16-entry window table of each of its terms into global scratch
// (Montgomery form, private to the thread), then runs the 64 digit columns:
// 4 doublings of its one accumulator, one table add per term.  Per term
// that is 64 adds + 15 table adds + 256/chunk doublings, against a ladder
// per term's 256 doublings + 64 adds.
//
// Bound on the H100: 32-bit integer multiply-adds (each point op is 11-14
// Montgomery products); the table traffic is C*36 bytes per lookup, far
// below the operations' time.

#include <cuda_runtime.h>

#include "curve.cuh"

template <int CID>
__global__ void straus_kernel(long long R, long long T, int chunk, long long nchunks,
                              const uint32_t* __restrict__ points,
                              const uint8_t* __restrict__ digits, uint32_t* __restrict__ table,
                              uint32_t* __restrict__ partial) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= R * nchunks) return;
    constexpr int C = CurveT<CID>::C;
    constexpr long long PT = (long long)C * ZK_NL;  // limbs per point
    const long long r = idx / nchunks, c = idx % nchunks;
    const long long t0 = c * chunk;
    const long long t1 = (t0 + chunk < T) ? t0 + chunk : T;

    Pt<CID> P, e, acc, tmp;
    for (long long t = t0; t < t1; ++t) {
        const long long term = r * T + t;
        uint32_t* tab = table + term * 16 * PT;
        pt_load<CID>(P, points + term * PT);
        pt_identity<CID>(e);
        pt_store_raw<CID>(tab, e);
        pt_store_raw<CID>(tab + PT, P);
        e = P;
        for (int k = 2; k < 16; ++k) {
            pt_add<CID>(tmp, e, P);
            e = tmp;
            pt_store_raw<CID>(tab + k * PT, e);
        }
    }

    pt_identity<CID>(acc);
    for (int col = 0; col < 64; ++col) {
#pragma unroll 1
        for (int k = 0; k < 4; ++k) {
            pt_dbl<CID>(tmp, acc);
            acc = tmp;
        }
        for (long long t = t0; t < t1; ++t) {
            const long long term = r * T + t;
            const int d = digits[term * 64 + col];
            pt_load_raw<CID>(e, table + (term * 16 + d) * PT);
            pt_add<CID>(tmp, acc, e);
            acc = tmp;
        }
    }
    pt_store<CID>(partial + idx * PT, acc);
}

extern "C" int zk_straus_msm(int curve, long long R, long long T, int chunk, const void* points,
                             const void* digits, void* table, void* partial, void* stream) {
    if (R * T == 0) return 0;
    if (chunk <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const long long nchunks = (T + chunk - 1) / chunk;
    const int threads = 64;
    const unsigned blocks = (unsigned)((R * nchunks + threads - 1) / threads);
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        straus_kernel<CID><<<blocks, threads, 0, st>>>(
            R, T, chunk, nchunks, (const uint32_t*)points, (const uint8_t*)digits,
            (uint32_t*)table, (uint32_t*)partial);
    });
    return bad ? bad : (int)cudaGetLastError();
}
