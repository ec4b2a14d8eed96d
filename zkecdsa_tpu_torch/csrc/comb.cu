// comb_mixed: g*v + h*r on Tom-256 from the concatenated mixed-add comb
// tables [64, 256, 5, 9] (windows 0..31 of g, then 0..31 of h; entry
// [j][d] = d * 2^(8j) * base as affine rows X, Y, X+Y, d*T, a*X), held in
// Montgomery form (x * 2^288 mod p, built once per parameter set by
// comb8_entries), and [B, 64] LSB-first byte digits -> [B, 4, 9] canonical extended
// coordinates.  64 table lookups and mixed adds, no doublings, in the
// window order of the reference, so the projective result is the same.
//
// Replaces zkecdsa_tpu/ops/curve_ops.py:731 double_mul_comb_mixed / :705
// mul_comb_mixed (the TPU's one-hot matrix gather becomes an index into
// the table).
//
// Bound on the H100: 32-bit integer multiply-adds, 9 Montgomery products a
// window (the table needs no conversion); the table (5.9 MB for both
// bases) stays in L2.  Two geometries, chosen from B by
// ops/curve_ops.py::comb_plan:
//   * LANES = 4, a team per row (curve.cuh team_edw_add_mixed): a window
//     is 3 rounds on the row's chain instead of 9 products, for the calls
//     whose rows leave the card under-filled (latency-bound); lane q loads
//     only the entry rows its products take (row q and a*X), and the next
//     window's while the current one runs;
//   * LANES = 1, a lane per row: 9 products a window and no exchanges, for
//     the calls that fill the card several times over (throughput-bound).
// A row's 64 digit bytes arrive as four 16-byte loads.
//
// comb_weier: the P-256 fixed-base multiply of the prover's Pedersen base h
// from its comb table [32, 256, 3, 9] (entry [j][d] = d * 2^(8j) * h,
// affine with Z = 1, entry d = 0 the identity (0:1:0)), held in Montgomery
// form (built once per parameter set by comb8_entries, which writes both
// forms), and [B, 32] LSB-first byte digits -> [B, 3, 9] canonical:
// acc = acc + T[j][d_j] for j = 0..31, complete RCB15 adds in window order.
// Replaces zkecdsa_tpu/ops/curve_ops.py:330 mul_comb (and :358
// double_mul_comb).  The prover makes one call a prove, [N, 81] rows (the
// 80 rounds' r*h and com_r*h).
//
// Bound on the H100: 32-bit integer multiply-adds, 14 products a window
// (the table needs no conversion); the table (0.9 MB) stays in L2.  At
// N = 256 the 20,736 rows leave the card under-filled, so a row's chain of
// 32 adds sets the time: the geometry comes from comb_plan as for
// comb_mixed (comb.cuh comb_weier_row):
//   * LANES = 4, a team a row: an add is 5 rounds on the chain instead of
//     14 products, the next window's entry loaded ahead;
//   * LANES = 1, a lane a row, for calls that fill the card several times
//     over.
// A row's 32 digit bytes arrive as two 16-byte loads.

#include <cuda_runtime.h>

#include "comb.cuh"

namespace {

constexpr int ROW = 5 * ZK_NL;  // limbs per mixed-table entry

template <int LANES>
__global__ void __launch_bounds__(COMB_THREADS) comb_mixed_kernel(
    long long B, const uint32_t* __restrict__ tabs, const uint8_t* __restrict__ digits,
    uint32_t* __restrict__ out) {
    constexpr int CID = ZK_CURVE_TOM;
    const long long t = (long long)blockIdx.x * COMB_THREADS + threadIdx.x;
    const long long row = t / LANES;
    Pt<CID> acc;
    pt_identity<CID>(acc);
    if constexpr (LANES == 1) {
        if (row >= B) return;
        Digits dg{reinterpret_cast<const uint4*>(digits + row * 64)};
        for (int j = 0; j < 64; ++j) {
            const uint32_t* ent = tabs + ((long long)j * 256 + dg.next(j)) * ROW;
            Fe e[5];
#pragma unroll
            for (int k = 0; k < 5; ++k) fe_load(e[k], ent + k * ZK_NL);
            edw_add_mixed(acc, acc, e[0], e[1], e[2], e[3], e[4]);
        }
        pt_store<CID>(out + row * 4 * ZK_NL, acc);
    } else {
        // a team past B runs row B-1 and stores nothing (every lane of the
        // warp takes part in the exchanges)
        const bool live = row < B;
        const long long i = live ? row : B - 1;
        const int q = team_lane();
        // lane q's operand of the first round: rows X, Y, X+Y, d*T of the
        // entry, in team_edw_add_mixed's lane order
        const int mine = q * ZK_NL;
        Digits dg{reinterpret_cast<const uint4*>(digits + i * 64)};
        Fe tq, tax;
        const uint32_t* ent = tabs + (long long)dg.next(0) * ROW;
        fe_load(tq, ent + mine);
        fe_load(tax, ent + 4 * ZK_NL);
#pragma unroll 1
        for (int j = 0; j < 64; ++j) {
            const bool more = j < 63;
            Fe nq, nax;
            if (more) {  // the next window's entry, loaded ahead
                ent = tabs + ((long long)(j + 1) * 256 + dg.next(j + 1)) * ROW;
                fe_load(nq, ent + mine);
                fe_load(nax, ent + 4 * ZK_NL);
            }
            team_edw_add_mixed(acc, acc, tq, tax);
            if (more) {
                fe_copy(tq, nq);
                fe_copy(tax, nax);
            }
        }
        team_store<CID>(out + i * 4 * ZK_NL, acc, live);
    }
}

}  // namespace

// lanes = 1 or 4 lanes a row (comb_plan); tabs in Montgomery form; digits
// 16-byte aligned.
extern "C" int zk_comb_mixed(long long B, int lanes, const void* tabs, const void* digits,
                             void* out, void* stream) {
    if (B == 0) return 0;
    if (lanes != 1 && lanes != ZK_TEAM) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((B * lanes + COMB_THREADS - 1) / COMB_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t* t = (const uint32_t*)tabs;
    const uint8_t* d = (const uint8_t*)digits;
    if (lanes == 1) {
        comb_mixed_kernel<1><<<blocks, COMB_THREADS, 0, st>>>(B, t, d, (uint32_t*)out);
    } else {
        comb_mixed_kernel<ZK_TEAM><<<blocks, COMB_THREADS, 0, st>>>(B, t, d, (uint32_t*)out);
    }
    return (int)cudaGetLastError();
}

// Warps of the one-lane comb_mixed kernel that one SM of the current
// device holds at once (the occupancy calculator's count from its
// registers), for comb_plan.
extern "C" int zk_comb_mixed_resident_warps(int* warps) {
    int blocks = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, comb_mixed_kernel<1>, COMB_THREADS, 0);
    *warps = blocks * (COMB_THREADS / 32);
    return (int)err;
}

// n = 32 windows, passed at run time (comb.cuh comb_weier_row)
template <int LANES>
__global__ void __launch_bounds__(COMB_THREADS) comb_weier_kernel(
    long long B, const uint32_t* __restrict__ tab, const uint8_t* __restrict__ digits, int n,
    uint32_t* __restrict__ out) {
    constexpr int PT = 3 * ZK_NL;
    const long long row = ((long long)blockIdx.x * COMB_THREADS + threadIdx.x) / LANES;
    if constexpr (LANES == 1) {
        if (row >= B) return;
    }
    // a team past B runs row B-1 and stores nothing (every lane of the
    // warp takes part in the exchanges)
    const bool live = row < B;
    const long long i = live ? row : B - 1;
    comb_weier_row<LANES, 256>(out + i * PT, tab, digits + i * n, n, live);
}

// lanes = 1 or 4 lanes a row (comb_plan); tab in Montgomery form; digits
// 16-byte aligned.
extern "C" int zk_comb_weier(long long B, int lanes, const void* tab, const void* digits, void* out,
                             void* stream) {
    if (B == 0) return 0;
    if (lanes != 1 && lanes != ZK_TEAM) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((B * lanes + COMB_THREADS - 1) / COMB_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t* t = (const uint32_t*)tab;
    const uint8_t* d = (const uint8_t*)digits;
    if (lanes == 1) {
        comb_weier_kernel<1><<<blocks, COMB_THREADS, 0, st>>>(B, t, d, 32, (uint32_t*)out);
    } else {
        comb_weier_kernel<ZK_TEAM><<<blocks, COMB_THREADS, 0, st>>>(B, t, d, 32, (uint32_t*)out);
    }
    return (int)cudaGetLastError();
}

// Warps of the one-lane comb_weier kernel that one SM holds at once, for
// comb_plan.
extern "C" int zk_comb_weier_resident_warps(int* warps) {
    int blocks = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, comb_weier_kernel<1>, COMB_THREADS, 0);
    *warps = blocks * (COMB_THREADS / 32);
    return (int)err;
}
