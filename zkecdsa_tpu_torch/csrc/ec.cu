// ec_add: complete point addition over [B, C, 9] canonical projective
// coordinates, a team of four lanes per point pair; and its siblings
// tree_sum, window_table and to_affine.
//
// ec_add replaces zkecdsa_tpu/ops/pallas_field.py:214 pallas_ec_add and the
// generic WeierOps.add / EdwardsOps.add (zkecdsa_tpu/ops/curve_ops.py:502,
// :589).  Bound on the H100: 32-bit integer multiply-adds.  An add is ~14
// Montgomery products plus C to-Montgomery and C from-Montgomery passes per
// point against 2*C*36 bytes read and C*36 written.  Every intermediate
// stays in registers.  The callers' batches (512 to 51,200 pairs) leave
// most of the card idle, so a call takes one pair's chain of dependent
// products: ~23 for a thread a pair, ~8 for a team of four lanes
// (curve.cuh), which runs the add in 3 (Tom-256) or 5 (P-256) rounds,
// each lane converting one coordinate in and one out.  So a team takes
// every pair; one thread a pair wins only for P-256 batches past about
// 100k pairs, which no caller sends (tools/torch_ec_add_sweep.py times
// both forms; PERF.md).

// tree_sum replaces CurveOps.sum_reduce (zkecdsa_tpu/ops/curve_ops.py:274,
// a level of adds at a time: n - 1 adds, an odd level carrying its last
// point up) in one launch where ec_add took a launch a level: points
// [n, M, C, 9] -> [M, C, 9], a block a column.  The column's points go to
// Montgomery form in shared memory (n <= TREE_MAX); each level's pairs
// (i, i + h), h = level / 2, are added by the block's teams, the sum
// written to slot i and an odd level's last point moved to slot h, with a
// barrier after the reads and after the writes; the plain pairing order,
// so the integers are the level loop's.  A column of n points is
// ceil(log2 n) team adds long.  Past TREE_MAX points the wrapper runs the
// first levels as ec_add launches, one a level, until the column fits.
//
// window_table replaces zkecdsa_tpu/ops/curve_ops.py:133 table (a
// lax.scan of 15 adds) in one launch, where 15 ec_add launches would each
// pay a launch for one add: points [B, C, 9] -> tables [B, 16, C, 9],
// entry k = entry k-1 + P from the identity, the plain version's order
// (so entry 1 is identity + P as the formula gives it, and the integers
// are the plain version's).  What
// bounds it: one point's chain of 15 dependent adds, since the prover's
// calls have 256 points, far too few to fill the card.  A team of four
// lanes (curve.cuh) runs each point's adds, 5 rounds of one product an add
// instead of 14 products, 8 points to a one-warp block; P goes to
// Montgomery form once, and each entry is stored as soon as it is made
// (lane q, coordinate q), so a team holds two points and no table.
//
// to_affine replaces CurveOps.to_affine (zkecdsa_tpu/ops/curve_ops.py:459)
// plus F32Field.canon: canonical x, y and an infinity flag.  Like the
// reference's batch_inv it inverts a batch with one Fermat power: the least
// work of B inversions is 3(B-1) products and one inverse, then 2 products
// a point for x and y; an inverse a point would take ~420 products a
// point, ~80x that work.
// What bounds it depends on B: the inverse is one chain of ~300 dependent
// products, and one warp of such a chain keeps a scheduler's INT32 pipe
// most of the way busy.  So a thread takes a group of g points
// (Montgomery's trick in its registers: the prefix products of the Z, one
// inverse, a walk back with 2 products a point, 5 products a point in
// all), and the host plan (ops/curve_ops.py::affine_plan) picks g from B
// and the card: one warp a scheduler (132 * 128 threads on the H100), so
// g = 1 while the points fit that (the chain sets the time; the windowed
// fe_inv shortens it) and g = B / threads beyond, the inverses' work
// falling by g; a second warp a scheduler nearly doubles every chain's
// time (tools/torch_affine_sweep.py times the group sizes; PERF.md).  The
// group is interleaved (thread t of T takes points t, t + T, ...), so at
// each step a warp reads and writes neighbouring points; the prefix
// products are parked in the x output, which the walk back overwrites: no
// scratch, and a thread holds only a few field elements.  A product tree
// over a block in shared memory would make the inverses' work negligible,
// but its one inverse a block is the same chain of ~300 products, run by
// one thread while the block waits at a barrier, so a call would still
// take that chain's latency, which the per-thread group reaches with no
// barrier.

#include <cuda_runtime.h>

#include "curve.cuh"

#define EC_THREADS 128  // threads of an ec_add block
#define TREE_MAX 64      // points of a tree_sum column in shared memory
#define AFFINE_THREADS 128
#define WTAB_POINTS 8  // points (teams) per one-warp window_table block

// a team of four lanes a pair: lane q converts coordinate q in and out
template <int CID>
__global__ void __launch_bounds__(EC_THREADS) ec_add_kernel(long long B,
                                                            const uint32_t* __restrict__ P,
                                                            const uint32_t* __restrict__ Q,
                                                            uint32_t* __restrict__ out) {
    constexpr int PT = CurveT<CID>::C * ZK_NL;
    const long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / ZK_TEAM;
    // a team past B runs pair B-1 and stores nothing
    const bool live = i0 < B;
    const long long i = live ? i0 : B - 1;
    Pt<CID> a, b, r;
    team_to_mont<CID>(a, P + i * PT);
    team_to_mont<CID>(b, Q + i * PT);
    team_add<CID>(r, a, b);
    team_store<CID>(out + i * PT, r, live);
}

// The whole tree of a column in one block (n <= TREE_MAX points, the
// column's points [n] at stride M points); see the head of this file.
template <int CID>
__global__ void __launch_bounds__(TREE_MAX / 2 * ZK_TEAM) tree_sum_kernel(
    int n, long long M, const uint32_t* __restrict__ P, uint32_t* __restrict__ out) {
    constexpr int C = CurveT<CID>::C;
    constexpr int PT = C * ZK_NL;
    __shared__ uint32_t pts[TREE_MAX * PT];
    const ZkModulus& Mod = curve_mod<CID>();
    const long long m = blockIdx.x;
    for (int e = threadIdx.x; e < n * C; e += blockDim.x) {
        Fe t;
        fe_load(t, P + ((long long)(e / C) * M + m) * PT + (e % C) * ZK_NL);
        fe_to_mont(t, t, Mod);
        fe_store(pts + e * ZK_NL, t);
    }
    __syncthreads();
    const int team = threadIdx.x / ZK_TEAM;
    const int q = team_lane();
    for (int s = n; s > 1;) {
        const int h = s / 2;
        // teams past the level's h pairs run pair h-1 and write nothing
        const int i = team < h ? team : h - 1;
        Pt<CID> a, b, r;
        pt_load_raw<CID>(a, pts + i * PT);
        pt_load_raw<CID>(b, pts + (i + h) * PT);
        team_add<CID>(r, a, b);
        __syncthreads();
        Fe c;
        team_coord<CID>(c, r);
        if (team < h && q < C) fe_store(pts + team * PT + q * ZK_NL, c);
        if (s & 1) {
            for (int e = threadIdx.x; e < PT; e += blockDim.x) pts[h * PT + e] = pts[(s - 1) * PT + e];
        }
        __syncthreads();
        s = h + (s & 1);
    }
    if (threadIdx.x < C) {
        Fe t;
        fe_from_mont(t, pts + threadIdx.x * ZK_NL, Mod);
        fe_store(out + m * PT + threadIdx.x * ZK_NL, t);
    }
}

template <int CID>
__global__ void __launch_bounds__(WTAB_POINTS * ZK_TEAM) window_table_kernel(
    long long B, const uint32_t* __restrict__ P, uint32_t* __restrict__ tab) {
    constexpr int PT = CurveT<CID>::C * ZK_NL;
    const long long i0 = (long long)blockIdx.x * WTAB_POINTS + threadIdx.x / ZK_TEAM;
    // a team past B runs point B-1 and stores nothing
    const bool live = i0 < B;
    const long long i = live ? i0 : B - 1;
    uint32_t* t = tab + i * 16 * PT;
    Pt<CID> p, e;
    team_to_mont<CID>(p, P + i * PT);
    pt_identity<CID>(e);
    team_store<CID>(t, e, live);
#pragma unroll 1
    for (int k = 1; k < 16; ++k) {
        team_add<CID>(e, e, p);
        team_store<CID>(t + k * PT, e, live);
    }
}

// The Z of point i is read raw, as a Montgomery value u_i = Z_i R^-1: no
// conversion.  The forward pass forms c_k = u_0 ... u_k (one product a
// point) and parks c_k in x[i_k]; fe_inv of c_last times the standard one
// gives I = R / c_last, the Montgomery form of 1 / (Z_0 ... Z_last)
// scaled by R^(k+1) so that the walk back yields, with 2 products a point,
// I * c_(k-1) = R / Z_k and I <- I * u_k; then x = X * (R / Z_k) R^-1 =
// X / Z_k in standard form, and y likewise.  A zero Z (the identity) is
// replaced by one in the chain and flagged; its x, y are written as 0.
template <int CID>
__device__ __forceinline__ bool affine_z(Fe z, const uint32_t* P, long long i) {
    constexpr int C = CurveT<CID>::C;
    Fe one;
    fe_set_zero(one);
    one[0] = 1u;
    fe_load(z, P + (i * C + C - 1) * ZK_NL);
    const bool zero = fe_is_zero(z);
    fe_select(z, zero, one, z);
    return zero;
}

template <int CID>
__device__ __forceinline__ void affine_out(const uint32_t* P, long long i, const Fe zinv, bool zero,
                                           uint32_t* x, uint32_t* y) {
    constexpr int C = CurveT<CID>::C;
    const ZkModulus& M = curve_mod<CID>();
    Fe t, r, o;
    fe_set_zero(o);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        fe_load(t, P + (i * C + k) * ZK_NL);
        fe_mont_mul(r, t, zinv, M);
        fe_select(r, zero, o, r);
        fe_store((k ? y : x) + i * ZK_NL, r);
    }
}

template <int CID>
__global__ void __launch_bounds__(AFFINE_THREADS) to_affine_kernel(
    long long B, long long T, const uint32_t* __restrict__ P, uint32_t* __restrict__ x,
    uint32_t* __restrict__ y, uint8_t* __restrict__ inf) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= T) return;
    const ZkModulus& M = curve_mod<CID>();
    Fe z, c, w, zi;
    // forward: the prefix products, parked in x
    bool zero = affine_z<CID>(c, P, t);
    inf[t] = zero;
    fe_store(x + t * ZK_NL, c);
    long long i = t;
    for (long long j = t + T; j < B; j += T) {
        i = j;
        zero = affine_z<CID>(z, P, i);
        inf[i] = zero;
        fe_mont_mul(c, c, z, M);
        fe_store(x + i * ZK_NL, c);
    }
    // one inverse for the group: I = R / c_last
    fe_inv(w, c, M);
    fe_set_zero(z);
    z[0] = 1u;
    fe_mont_mul(c, w, z, M);
    // backward: R / Z_k from I and c_(k-1), then I <- I * u_k
    for (; i > t; i -= T) {
        fe_load(w, x + (i - T) * ZK_NL);
        fe_mont_mul(zi, c, w, M);
        zero = affine_z<CID>(z, P, i);
        fe_mont_mul(c, c, z, M);
        affine_out<CID>(P, i, zi, zero, x, y);
    }
    affine_out<CID>(P, t, c, inf[t] != 0, x, y);
}

static unsigned grid_for(long long n, int threads) {
    return (unsigned)((n + threads - 1) / threads);
}

extern "C" int zk_ec_add(int curve, long long B, const void* P, const void* Q, void* out,
                         void* stream) {
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        ec_add_kernel<CID><<<grid_for(B * ZK_TEAM, EC_THREADS), EC_THREADS, 0, st>>>(
            B, (const uint32_t*)P, (const uint32_t*)Q, (uint32_t*)out);
    });
    return bad ? bad : (int)cudaGetLastError();
}

// The whole tree of each of the M columns of n <= TREE_MAX points -> [M].
extern "C" int zk_tree_sum(int curve, int n, long long M, const void* P, void* out, void* stream) {
    if (M == 0) return 0;
    if (n < 1 || n > TREE_MAX) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        // a team a pair of the first level, in whole warps
        const int threads = ((n / 2 * ZK_TEAM + 31) / 32) * 32;
        tree_sum_kernel<CID><<<(unsigned)M, threads > 0 ? threads : 32, 0, st>>>(
            n, M, (const uint32_t*)P, (uint32_t*)out);
    });
    return bad ? bad : (int)cudaGetLastError();
}

extern "C" int zk_window_table(int curve, long long B, const void* P, void* tab, void* stream) {
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        window_table_kernel<CID><<<grid_for(B, WTAB_POINTS), WTAB_POINTS * ZK_TEAM, 0, st>>>(
            B, (const uint32_t*)P, (uint32_t*)tab);
    });
    return bad ? bad : (int)cudaGetLastError();
}

extern "C" int zk_to_affine(int curve, long long B, long long T, const void* P, void* x, void* y,
                            void* inf, void* stream) {
    if (B == 0) return 0;
    if (T < 1 || T > B) return (int)cudaErrorInvalidValue;  // T threads, each 1+ points
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        to_affine_kernel<CID><<<grid_for(T, AFFINE_THREADS), AFFINE_THREADS, 0, st>>>(
            B, T, (const uint32_t*)P, (uint32_t*)x, (uint32_t*)y, (uint8_t*)inf);
    });
    return bad ? bad : (int)cudaGetLastError();
}

// Warps of to_affine_kernel one SM holds at once (its registers), for the
// host's group plan (ops/curve_ops.py::affine_threads).
extern "C" int zk_to_affine_resident_warps(int curve, int* warps) {
    *warps = 0;
    int blocks = 0;
    cudaError_t err = cudaSuccess;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, to_affine_kernel<CID>,
                                                            AFFINE_THREADS, 0);
    });
    *warps = blocks * (AFFINE_THREADS / 32);
    return bad ? bad : (int)err;
}
