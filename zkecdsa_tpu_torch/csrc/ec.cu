// ec_add: complete point addition over [B, C, 9] canonical projective
// coordinates, one thread per point pair; and its sibling to_affine.
//
// ec_add replaces zkecdsa_tpu/ops/pallas_field.py:214 pallas_ec_add and the
// generic WeierOps.add / EdwardsOps.add (zkecdsa_tpu/ops/curve_ops.py:502,
// :589).  to_affine replaces CurveOps.to_affine (:459) plus F32Field.canon:
// an element-wise Fermat inverse (the TPU's batch-inversion tree saved
// inversions; a GPU thread per point needs none), then canonical x, y and
// an infinity flag.
//
// Bound on the H100: 32-bit integer multiply-adds.  An add is ~14
// Montgomery products plus C to-Montgomery and C from-Montgomery passes per
// point against 2*C*36 bytes read and C*36 written; to_affine is ~290
// squarings per point.  Every intermediate stays in registers.

#include <cuda_runtime.h>

#include "curve.cuh"

template <int CID>
__global__ void ec_add_kernel(long long B, const uint32_t* __restrict__ P,
                              const uint32_t* __restrict__ Q, uint32_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    constexpr int C = CurveT<CID>::C;
    Pt<CID> a, b, r;
    pt_load<CID>(a, P + i * C * ZK_NL);
    pt_load<CID>(b, Q + i * C * ZK_NL);
    pt_add<CID>(r, a, b);
    pt_store<CID>(out + i * C * ZK_NL, r);
}

template <int CID>
__global__ void to_affine_kernel(long long B, const uint32_t* __restrict__ P,
                                 uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                                 uint8_t* __restrict__ inf) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    constexpr int C = CurveT<CID>::C;
    const ZkModulus& M = curve_mod<CID>();
    const uint32_t* p = P + i * C * ZK_NL;
    Fe t, z, zinv, xm, ym, r;
    fe_load(t, p + (C - 1) * ZK_NL);
    inf[i] = fe_is_zero(t) ? 1 : 0;
    fe_to_mont(z, t, M);
    fe_inv(zinv, z, M);  // 0 -> 0, so infinity yields (0, 0)
    fe_load(t, p);
    fe_to_mont(xm, t, M);
    fe_load(t, p + ZK_NL);
    fe_to_mont(ym, t, M);
    fe_mont_mul(r, xm, zinv, M);
    fe_from_mont(t, r, M);
    fe_store(x + i * ZK_NL, t);
    fe_mont_mul(r, ym, zinv, M);
    fe_from_mont(t, r, M);
    fe_store(y + i * ZK_NL, t);
}

static unsigned grid_for(long long n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}

extern "C" int zk_ec_add(int curve, long long B, const void* P, const void* Q, void* out,
                         void* stream) {
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 128;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        ec_add_kernel<CID><<<grid_for(B, threads), threads, 0, st>>>(
            B, (const uint32_t*)P, (const uint32_t*)Q, (uint32_t*)out);
    });
    return bad ? bad : (int)cudaGetLastError();
}

extern "C" int zk_to_affine(int curve, long long B, const void* P, void* x, void* y, void* inf,
                            void* stream) {
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 128;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        to_affine_kernel<CID><<<grid_for(B, threads), threads, 0, st>>>(
            B, (const uint32_t*)P, (uint32_t*)x, (uint32_t*)y, (uint8_t*)inf);
    });
    return bad ? bad : (int)cudaGetLastError();
}
