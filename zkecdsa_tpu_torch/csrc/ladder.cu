// msm_ladder: per term, s * P by an MSB-first double-and-add ladder over the
// 256 bits of s.  Points [B, C, 9] canonical projective, bits [B, 256] uint8
// (MSB first; each term's row 16-byte aligned) -> [B, C, 9] canonical; the
// caller (zkecdsa_tpu_torch/ops/curve_ops.py::msm_ladder) tree-sums the
// terms of a row with tree_sum, the plain version's pairing order, so the
// kernel folds no terms itself.
//
// Replaces zkecdsa_tpu/ops/curve_ops.py:373 msm_ladder (its scan of 256
// masked steps; the tree sum is sum_reduce).
//
// Every step is the plain version's: a doubling, a complete add of P and a
// select on the bit, with no branch and no early exit on a scalar bit (the
// table-free, constant-shape MSM of the reference), so the result is the
// plain version's projective point.  A term's 256 bit bytes arrive as
// sixteen 16-byte loads (comb.cuh Digits), not a byte from memory a step.
//
// Bound on the H100: a term's dependent chain of 256 steps.  One lane a
// term (the kernel before this design) runs 256 x 27 Montgomery products on
// P-256 (13 a doubling, 14 an add) and 256 x 20 on Tom-256, and 4096 terms
// fill only 64 SMs.  Here a team of four lanes runs each point operation
// (curve.cuh team_dbl / team_add), so the chain is 256 x 9 team rounds on
// P-256 (4 + 5) and 256 x 6 on Tom-256 (3 + 3), on four times the lanes.
// Once the terms fill the card (tens of thousands of terms), the 32-bit
// multiply-add count sets the time instead (about 2.4 M IMADs a P-256
// term, more in a team, whose every lane also runs the additions between
// rounds): there one lane a term can be the faster form (PERF.md).
//
// P is converted to Montgomery form once, by the team (team_to_mont: lane q
// converts coordinate q), and kept on every lane; the result leaves by
// team_store, canonical standard form.  A team past B runs term B-1 and
// stores nothing (every lane of the warp takes part in the exchanges).  A
// team's values are bit for bit the lane's (curve.cuh), so the kernel
// equals the plain version exactly.

#include <cuda_runtime.h>

#include "comb.cuh"

namespace {

constexpr int LADDER_THREADS = 64;  // 16 teams a block: 4096 terms make 256 blocks

template <int CID, int THREADS>
__global__ void __launch_bounds__(THREADS) msm_ladder_kernel(long long B, const uint32_t* __restrict__ points,
                                                             const uint8_t* __restrict__ bits,
                                                             uint32_t* __restrict__ out) {
    constexpr int PT = CurveT<CID>::C * ZK_NL;
    const long long term = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / ZK_TEAM;
    const bool live = term < B;
    const long long i = live ? term : B - 1;
    Digits bt{reinterpret_cast<const uint4*>(bits + i * 256)};
    Pt<CID> P, acc, cand;
    pt_identity<CID>(acc);
    team_to_mont<CID>(P, points + i * PT);
#pragma unroll 1
    for (int k = 0; k < 256; ++k) {
        team_dbl<CID>(acc, acc);
        team_add<CID>(cand, acc, P);
        pt_select<CID>(acc, bt.next(k) != 0, cand, acc);
    }
    team_store<CID>(out + i * PT, acc, live);
}

}  // namespace

// bits rows 16-byte aligned
extern "C" int zk_msm_ladder(int curve, long long B, const void* points, const void* bits, void* out,
                             void* stream) {
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned blocks = (unsigned)((B * ZK_TEAM + LADDER_THREADS - 1) / LADDER_THREADS);
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        msm_ladder_kernel<CID, LADDER_THREADS><<<blocks, LADDER_THREADS, 0, st>>>(
            B, (const uint32_t*)points, (const uint8_t*)bits, (uint32_t*)out);
    });
    return bad ? bad : (int)cudaGetLastError();
}
