// msm_ladder before its redesign for the H100, kept as
// tools/torch_ladder_probe.py's "old" form: one thread per term in 64-thread
// blocks, the plain version's steps in its order (a doubling, a complete add
// of P, a select on the bit), the bit byte loaded from device memory every
// step.  Points [B, C, 9] canonical projective, bits [B, 256] uint8 (MSB
// first) -> [B, C, 9] canonical, the terms unsummed.  Built only by the
// probe, in one translation unit with zkecdsa_tpu_torch/csrc/ladder.cu.

#include <cuda_runtime.h>

#include "curve.cuh"

namespace old_ladder {

template <int CID>
__global__ void ladder_old_kernel(long long B, const uint32_t* __restrict__ points,
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

}  // namespace old_ladder

extern "C" int probe_old_msm_ladder(int curve, long long B, const void* points, const void* bits,
                                    void* out, void* stream) {
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 64;
    const unsigned blocks = (unsigned)((B + threads - 1) / threads);
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        old_ladder::ladder_old_kernel<CID><<<blocks, threads, 0, st>>>(
            B, (const uint32_t*)points, (const uint8_t*)bits, (uint32_t*)out);
    });
    return bad ? bad : (int)cudaGetLastError();
}
