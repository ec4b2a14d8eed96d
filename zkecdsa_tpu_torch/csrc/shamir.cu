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
// Bound on the H100: the latency of one row's dependent chain.  The
// prover's calls have 256 and 512 rows, far too few to fill the card's
// 32-bit multiply-add pipes, so a call lasts as long as one row's 64
// columns of 4 doublings and 2 adds.  Design: a team of four lanes
// (curve.cuh) runs each point operation, which cuts a row's chain from
// ~5,100 Montgomery products to 64 * (4*4 + 2*5) = 1,664 rounds of one
// product; 8 rows to a one-warp block.  The block first stages its rows'
// tables in shared memory (cp.async) and converts them to Montgomery form
// once, so a lookup is a shared-memory read and no product; a shared table
// (stride 0) is staged once per block.

#include <cuda_runtime.h>

#include "curve.cuh"

namespace {

constexpr int CID = ZK_CURVE_P256;
constexpr int PT = 3 * ZK_NL;          // limbs per point
constexpr int TAB = 16 * PT;           // limbs per window table
constexpr int ROWS = 8;                // rows (teams) per block: one warp
constexpr int THREADS = ROWS * ZK_TEAM;
constexpr int CHUNKS = TAB / 4;        // 16-byte pieces per table

// Copy the block's n tables (n = 1 for a shared one) from g to s as
// 16-byte cp.async pieces, then convert every coordinate to Montgomery form.
__device__ __forceinline__ void stage_tables(uint32_t* s, const uint32_t* g, long long stride,
                                             int n) {
    for (int c = threadIdx.x; c < n * CHUNKS; c += THREADS) {
        const int row = c / CHUNKS, piece = c % CHUNKS;
        const uint32_t* src = g + row * stride + piece * 4;
        const unsigned dst = (unsigned)__cvta_generic_to_shared(s + row * TAB + piece * 4);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src));
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    const ZkModulus& M = curve_mod<CID>();
    for (int e = threadIdx.x; e < n * 16 * 3; e += THREADS) {
        Fe t;
        fe_load(t, s + e * ZK_NL);
        fe_to_mont(t, t, M);
        fe_store(s + e * ZK_NL, t);
    }
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS) shamir_kernel(
    long long B, const uint32_t* __restrict__ tp, long long sp, const uint8_t* __restrict__ dP,
    const uint32_t* __restrict__ tq, long long sq, const uint8_t* __restrict__ dQ,
    uint32_t* __restrict__ out) {
    __shared__ __align__(16) uint32_t stp[ROWS * TAB];
    __shared__ __align__(16) uint32_t stq[ROWS * TAB];
    const long long row0 = (long long)blockIdx.x * ROWS;
    const int rows = (int)(B - row0 < ROWS ? B - row0 : ROWS);
    const int team = threadIdx.x / ZK_TEAM;
    // an idle team (past B) runs the block's last row and stores nothing
    const int k = team < rows ? team : rows - 1;
    const long long i = row0 + k;
    stage_tables(stp, tp + (sp ? row0 * sp : 0), sp, sp ? rows : 1);
    stage_tables(stq, tq + (sq ? row0 * sq : 0), sq, sq ? rows : 1);
    const uint32_t* rp = stp + (sp ? k : 0) * TAB;
    const uint32_t* rq = stq + (sq ? k : 0) * TAB;
    const uint8_t* ep = dP + i * 64;
    const uint8_t* eq = dQ + i * 64;
    Pt<CID> acc, e;
    pt_identity<CID>(acc);
    for (int col = 0; col < 64; ++col) {
#pragma unroll 1
        for (int d = 0; d < 4; ++d) team_dbl<CID>(acc, acc);
        pt_load_raw<CID>(e, rp + ep[col] * PT);
        team_add<CID>(acc, acc, e);
        pt_load_raw<CID>(e, rq + eq[col] * PT);
        team_add<CID>(acc, acc, e);
    }
    team_store<CID>(out + i * PT, acc, team < rows);
}

}  // namespace

extern "C" int zk_shamir(long long B, const void* tp, long long sp, const void* dP,
                         const void* tq, long long sq, const void* dQ, void* out,
                         void* stream) {
    if (B == 0) return 0;
    const unsigned blocks = (unsigned)((B + ROWS - 1) / ROWS);
    shamir_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        B, (const uint32_t*)tp, sp, (const uint8_t*)dP, (const uint32_t*)tq, sq,
        (const uint8_t*)dQ, (uint32_t*)out);
    return (int)cudaGetLastError();
}
