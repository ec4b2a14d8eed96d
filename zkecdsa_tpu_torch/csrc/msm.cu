// straus_msm: per row, sum_t s_t * P_t with 4-bit MSB-first digits
// (Straus / interleaved windows: the doublings are shared by the terms of a
// chunk).  Points [R, T, C, 9] canonical projective, digits [R, T, 64]
// uint8 -> [R, nparts, C, 9] canonical partial sums; the caller
// (zkecdsa_tpu_torch/ops/curve_ops.py::straus_msm, whose straus_plan picks
// the geometry) tree-sums the parts of a row with ec_add when nparts > 1.
//
// Replaces zkecdsa_tpu/ops/curve_ops.py:393 msm_shared (and :164
// scalar_mul_table, the T = 1 case the verifier's window muls use).
//
// Bound on the H100: the dependent chain of point operations of one team,
// not the 32-bit multiply-add rate, at every shape the verifier gives it:
// [5376, 1], [256, 48] and path B's one-row calls hold far fewer chains
// than the card can run at once, and at [16, 8192] a chain of ~1,000
// point operations still keeps each SM's pipes waiting on its own carries.
// Design: a team of four lanes (curve.cuh) runs each point operation, so a
// P-256 add is 5 rounds of one product instead of 14 products in a row;
// one team per (row, chunk of `chunk` terms), with the chunk taken from
// the shape so the teams fill every SM with a few warps.  A team builds
// its terms' 16-entry window tables into global scratch (Montgomery form,
// L2-resident, read back only by the team), runs the 64 digit columns (4
// doublings of its accumulator, one table add per term), and the `group`
// teams of a row part fold their sums in shared memory by a tree of team
// adds, so a row of up to 64 chunks leaves the kernel as one point.

#include <cuda_runtime.h>

#include "curve.cuh"

namespace {

constexpr int MAX_TEAMS = 64;  // teams per block: 256 threads
constexpr int MAX_THREADS = MAX_TEAMS * ZK_TEAM;

template <int CID>
__global__ void __launch_bounds__(MAX_THREADS) straus_kernel(
    long long R, long long T, int chunk, int group, int rows_per_block,
    const uint32_t* __restrict__ points, const uint8_t* __restrict__ digits,
    uint32_t* __restrict__ table, uint32_t* __restrict__ out) {
    constexpr int C = CurveT<CID>::C;
    constexpr int PT = C * ZK_NL;  // limbs per point
    __shared__ uint32_t folds[MAX_TEAMS * PT];
    const long long nchunks = (T + chunk - 1) / chunk;
    const long long nparts = (nchunks + group - 1) / group;
    const int tb = threadIdx.x / ZK_TEAM;  // team in the block
    const int q = team_lane();
    const int g = tb % group;              // team in its part
    const long long seg = (long long)blockIdx.x * rows_per_block + tb / group;  // (row, part)
    const bool live = tb < rows_per_block * group && seg < R * nparts;
    const long long segc = live ? seg : 0;
    const long long r = segc / nparts;
    const long long c = (segc % nparts) * group + g;  // chunk of the row
    const bool live_chunk = live && c < nchunks;

    // window tables of the chunk's terms: entry k = entry k-1 + P, from the
    // identity (the reference's order)
    Pt<CID> P, e, acc;
#pragma unroll 1
    for (int j = 0; j < chunk; ++j) {
        const long long t = c * chunk + j;
        const bool tlive = live_chunk && t < T;
        const long long term = r * T + (tlive ? t : 0);
        uint32_t* tab = table + term * 16 * PT;
        team_to_mont<CID>(P, points + term * PT);
        pt_identity<CID>(e);
#pragma unroll 1
        for (int k = 0; k < 16; ++k) {
            if (k == 1) e = P;
            if (k >= 2) team_add<CID>(e, e, P);
            if (tlive && q < C) {
                Fe v;
                team_coord<CID>(v, e);
                fe_store(tab + k * PT + q * ZK_NL, v);
            }
        }
    }
    __syncwarp();

    pt_identity<CID>(acc);
#pragma unroll 1
    for (int col = 0; col < 64; ++col) {
#pragma unroll 1
        for (int d = 0; d < 4; ++d) team_dbl<CID>(acc, acc);
#pragma unroll 1
        for (int j = 0; j < chunk; ++j) {
            const long long t = c * chunk + j;
            if (live_chunk && t < T) {
                const long long term = r * T + t;
                pt_load_raw<CID>(e, table + (term * 16 + digits[term * 64 + col]) * PT);
            } else {
                pt_identity<CID>(e);
            }
            team_add<CID>(acc, acc, e);
        }
    }

    // fold the part's `group` sums: at step h, team g (g % 2h == 0) takes
    // team g + h's sum; a team without a partner keeps its own
    uint32_t* mine = folds + tb * PT;
    if (q == 0) pt_store_raw<CID>(mine, acc);
    __syncthreads();
    for (int h = 1; h < group; h *= 2) {
        const bool take = live && g % (2 * h) == 0 && g + h < group;
        if (take) {
            pt_load_raw<CID>(e, mine + h * PT);
        } else {
            pt_identity<CID>(e);
        }
        team_add<CID>(acc, acc, e);
        __syncthreads();
        if (take && q == 0) pt_store_raw<CID>(mine, acc);
        __syncthreads();
    }
    team_store<CID>(out + segc * PT, acc, live && g == 0);
}

}  // namespace

extern "C" int zk_straus_msm(int curve, long long R, long long T, int chunk, int group,
                             int rows_per_block, const void* points, const void* digits,
                             void* table, void* out, void* stream) {
    if (R * T == 0) return 0;
    if (chunk <= 0 || group <= 0 || rows_per_block <= 0 || group * rows_per_block > MAX_TEAMS)
        return (int)cudaErrorInvalidValue;
    const long long nchunks = (T + chunk - 1) / chunk;
    const long long nparts = (nchunks + group - 1) / group;
    const int threads = (group * rows_per_block * ZK_TEAM + 31) / 32 * 32;
    const unsigned blocks = (unsigned)((R * nparts + rows_per_block - 1) / rows_per_block);
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto cv) {
        constexpr int CID = decltype(cv)::value;
        straus_kernel<CID><<<blocks, threads, 0, st>>>(
            R, T, chunk, group, rows_per_block, (const uint32_t*)points,
            (const uint8_t*)digits, (uint32_t*)table, (uint32_t*)out);
    });
    return bad ? bad : (int)cudaGetLastError();
}

// One-warp blocks of straus_kernel<curve> that one SM of the current device
// holds at once (its registers, shared memory and block limit, as the
// occupancy calculator counts them), for straus_plan's geometry.
extern "C" int zk_straus_resident_warps(int curve, int* warps) {
    *warps = 0;
    cudaError_t err = cudaSuccess;
    const int bad = zk_dispatch_curve(curve, [&](auto cv) {
        constexpr int CID = decltype(cv)::value;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(warps, straus_kernel<CID>, 32, 0);
    });
    return bad ? bad : (int)err;
}
