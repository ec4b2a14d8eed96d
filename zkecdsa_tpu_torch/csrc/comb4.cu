// comb4: the per-base 4-bit comb on P-256, for many scalars that share one
// dynamic base (the prover's 80 exp rounds T_i = alpha_i * R share the R of
// their instance).
//
// The table [R, 64, 16, 3, 9], entry [j][d] = d * 16^(63-j) * base
// (position axis MSB-first, as nibble digits are), replaces
// zkecdsa_tpu/ops/curve_ops.py:194 comb4_table, in its order, as two
// entries:
//
// zk_comb4_bases: bases [R, 3, 9] -> position bases [R, 64, 3, 9], entry j
// = 16^(63-j) * base: a serial chain of 63 runs of four doublings, a team
// of four lanes per base (curve.cuh team_dbl: 4 rounds a doubling instead
// of 13 products), 8 bases to a one-warp block; lane q converts and stores
// coordinate q of each position base.
//
// zk_comb4_entries: position bases [R, 64, 3, 9] -> tables [R, 64, 16, 3,
// 9]: a team of four lanes per (base, position) row builds the 16 entries
// by doubling the entry set: m_k = dbl(entry k/2), entries k..2k-1 =
// entries 0..k-1 + m_k, 3 doublings and 14 adds in 82 rounds of one
// product where one thread would take 240 products, 8 rows to a one-warp
// block.  The entries of a row are kept in shared memory (8 rows x 16 x
// 108 B = 13.8 KB a block), not on the stack, as each is made; the team
// reads back the ones the next level adds.  The prove's call writes them
// in Montgomery form (x * 2^288 mod p), the form zk_mul_comb4 reads, so
// neither kernel converts an entry; the canonical form (one more product
// a coordinate, one round) is a flag for the tests and chip_smoke.py.
//
// zk_mul_comb4: Montgomery tables [R, 64, 16, 3, 9] and MSB-first nibbles
// [R, S, 64] (one a byte) -> [R, S, 3, 9] canonical: 64 gather-adds from
// the row's own table per scalar, no doublings (comb.cuh comb_weier_row),
// a team of four lanes or one lane a scalar by ops/curve_ops.py::comb_plan.
// Replaces curve_ops.py:218 mul_comb4.
//
// Every operation is a complete formula in the plain version's order
// (ops/curve_ops.py), so the projective results are the same integers.
//
// Bound on the H100: 32-bit integer multiply-adds.  The bases are 252
// doublings per base in one dependent chain (latency-bound: 256 chains at
// N=256 on a card of 132 SMs, so the team cuts the chain, 1,008 rounds of
// one product instead of 3,276 products); the entries are 3 doublings and
// 14 adds per (base, position), 16,384 rows at N=256: one thread a row
// would be about one warp a scheduler, a chain with little to hide it;
// the team both cuts the chain and gives four times the warps
// (tools/torch_comb4_entries_probe.py times both, and four lanes a row
// each running whole adds of a level); the multiply is 64 adds per scalar
// reading 64 scattered 108-byte entries of a 110 KB per-base table, which
// L2 holds.  At N=256 its 20,480 scalars leave the card under-filled, so
// a scalar's chain of 64 adds sets the time and the team takes it: 5
// rounds an add instead of 14 products, the next entry loaded ahead, a
// scalar's 64 nibbles in four 16-byte loads.

#include <cuda_runtime.h>

#include "comb.cuh"

namespace {

constexpr int CID = ZK_CURVE_P256;
constexpr int PT = 3 * ZK_NL;                 // limbs per point
constexpr long long TAB = 64LL * 16 * PT;     // limbs per base's table

constexpr int BASES = 8;  // bases (teams) per one-warp block

__global__ void __launch_bounds__(BASES * ZK_TEAM) comb4_bases_kernel(
    long long R, const uint32_t* __restrict__ P, uint32_t* __restrict__ bases) {
    const long long r0 = (long long)blockIdx.x * BASES + threadIdx.x / ZK_TEAM;
    // a team past R runs base R-1 and stores nothing
    const bool live = r0 < R;
    const long long r = live ? r0 : R - 1;
    team_comb_bases<CID, 4, true>(bases + r * 64 * PT, P + r * PT, 64, live);
}

constexpr int ROWS = 8;  // (base, position) rows (teams) per one-warp entries block

// Entry P of a team's row: lane q (q < 3) keeps coordinate q in the row's
// shared entries `e` (Montgomery form) and writes it to `g`, in Montgomery
// form (MONT) or canonical standard form, if `live`; the warp then syncs,
// so every lane may read the entry back.
template <bool MONT>
__device__ __forceinline__ void entry_keep(uint32_t* e, uint32_t* g, const Pt<CID>& P, bool live) {
    const int q = team_lane();
    Fe c;
    team_coord<CID>(c, P);
    if (q < 3) fe_store(e + q * ZK_NL, c);
    if constexpr (!MONT) fe_from_mont(c, c, curve_mod<CID>());
    if (live && q < 3) fe_store(g + q * ZK_NL, c);
    __syncwarp();
}

template <bool MONT>
__global__ void __launch_bounds__(ROWS * ZK_TEAM) comb4_entries_kernel(
    long long RJ, const uint32_t* __restrict__ bases, uint32_t* __restrict__ tab) {
    __shared__ uint32_t ent[ROWS * 16 * PT];
    const int team = threadIdx.x / ZK_TEAM;
    const long long row = (long long)blockIdx.x * ROWS + team;
    // a team past RJ runs row RJ-1 and stores nothing
    const bool live = row < RJ;
    const long long idx = live ? row : RJ - 1;
    uint32_t* t = tab + idx * 16 * PT;  // the (base, position) row of 16 entries
    uint32_t* e = ent + team * 16 * PT;
    Pt<CID> a, m;
    pt_identity<CID>(a);
    entry_keep<MONT>(e, t, a, live);
    team_to_mont<CID>(a, bases + idx * PT);
    entry_keep<MONT>(e + PT, t + PT, a, live);
#pragma unroll 1
    for (int k = 2; k < 16; k *= 2) {
        pt_load_raw<CID>(a, e + (k / 2) * PT);
        team_dbl<CID>(m, a);
#pragma unroll 1
        for (int s = 0; s < k; ++s) {
            pt_load_raw<CID>(a, e + s * PT);
            team_add<CID>(a, a, m);
            entry_keep<MONT>(e + (k + s) * PT, t + (k + s) * PT, a, live);
        }
    }
}

// n = 64 positions, passed at run time (as comb_weier_kernel's n)
template <int LANES>
__global__ void __launch_bounds__(COMB_THREADS) mul_comb4_kernel(
    long long RS, long long S, const uint32_t* __restrict__ tab, const uint8_t* __restrict__ digits,
    int n, uint32_t* __restrict__ out) {
    const long long row = ((long long)blockIdx.x * COMB_THREADS + threadIdx.x) / LANES;
    if constexpr (LANES == 1) {
        if (row >= RS) return;
    }
    // a team past RS runs scalar RS-1 and stores nothing
    const bool live = row < RS;
    const long long i = live ? row : RS - 1;
    comb_weier_row<LANES, 16>(out + i * PT, tab + (i / S) * TAB, digits + i * n, n, live);
}

unsigned grid_for(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

}  // namespace

extern "C" int zk_comb4_bases(long long R, const void* P, void* bases, void* stream) {
    if (R == 0) return 0;
    comb4_bases_kernel<<<grid_for(R, BASES), BASES * ZK_TEAM, 0, (cudaStream_t)stream>>>(
        R, (const uint32_t*)P, (uint32_t*)bases);
    return (int)cudaGetLastError();
}

// mont != 0: the entries in Montgomery form (mul_comb4's), else canonical.
extern "C" int zk_comb4_entries(long long R, int mont, const void* bases, void* tab, void* stream) {
    if (R == 0) return 0;
    const unsigned blocks = grid_for(R * 64, ROWS);
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t* b = (const uint32_t*)bases;
    if (mont) {
        comb4_entries_kernel<true><<<blocks, ROWS * ZK_TEAM, 0, st>>>(R * 64, b, (uint32_t*)tab);
    } else {
        comb4_entries_kernel<false><<<blocks, ROWS * ZK_TEAM, 0, st>>>(R * 64, b, (uint32_t*)tab);
    }
    return (int)cudaGetLastError();
}

// lanes = 1 or 4 lanes a scalar (comb_plan); tab in Montgomery form;
// digits 16-byte aligned.
extern "C" int zk_mul_comb4(long long R, long long S, int lanes, const void* tab, const void* digits,
                            void* out, void* stream) {
    if (R * S == 0) return 0;
    if (lanes != 1 && lanes != ZK_TEAM) return (int)cudaErrorInvalidValue;
    const unsigned blocks = grid_for(R * S * lanes, COMB_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    const uint32_t* t = (const uint32_t*)tab;
    const uint8_t* d = (const uint8_t*)digits;
    if (lanes == 1) {
        mul_comb4_kernel<1><<<blocks, COMB_THREADS, 0, st>>>(R * S, S, t, d, 64, (uint32_t*)out);
    } else {
        mul_comb4_kernel<ZK_TEAM><<<blocks, COMB_THREADS, 0, st>>>(R * S, S, t, d, 64, (uint32_t*)out);
    }
    return (int)cudaGetLastError();
}

// Warps of the one-lane mul_comb4 kernel that one SM holds at once, for
// comb_plan.
extern "C" int zk_mul_comb4_resident_warps(int* warps) {
    int blocks = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mul_comb4_kernel<1>, COMB_THREADS, 0);
    *warps = blocks * (COMB_THREADS / 32);
    return (int)err;
}
