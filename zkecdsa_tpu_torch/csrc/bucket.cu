// Pippenger bucket MSM per row, in two kernels (the caller,
// zkecdsa_tpu_torch/ops/msm_bucket.py, counts them apart and picks their
// geometry with bucket_plan):
//
// bucket_sums: points [N, T, C, 9] canonical projective, base-2^w digits
// [N, D, T] uint8 (MSB window first) -> S [N, D, B, C, 9] canonical, S[i][d][b]
// the sum of the points of row i whose window-d digit is b (b = 0: identity).
// Replaces the chunk gather and the chunk and bucket trees of
// zkecdsa_tpu/ops/msm_bucket.py:123 _bucket_body_jit (:138-143).
//
// bucket_fold: S -> [N, C, 9], per window W_d = sum_b b * S_b, then the
// windows by Horner (w doublings and one add each).  Replaces the masked bit
// fold, its Horner and the window fold of the same routine (:144-171).
//
// No conversions.  Neither kernel converts a coordinate to or from
// Montgomery form: a canonical coordinate x, read as a Montgomery residue,
// stands for x * R^-1, so a point (X:Y:Z) (or (X:Y:T:Z)) read that way is
// the point scaled by R^-1, which is the same projective point, and the
// complete formulas are homogeneous, so sums of such points are the sums
// of the points.  The outputs are written as they are held: canonical
// residues of the same projective points.  (A conversion is a Montgomery
// product a coordinate: 3 or 4 a term and window, against an add of 14 or
// 11 products.)  The kernels' projective coordinates differ from the plain
// versions' (they add in another order as well); the group elements are
// the same, and the callers compare group elements (is_identity, affine).
//
// bucket_sums.  One block per (row, window).  A stable counting sort lists
// the window's terms by bucket in shared memory in O(T): each warp counts
// a contiguous slice of the digit column into its own histogram, a scan
// over the warps and a warp scan over the buckets give each (warp, bucket)
// its offset, and each warp places its slice in term order, ranking equal
// digits with __match_any_sync.  Then one unit a bucket adds the bucket's
// points, starting from its first term (not from the identity): a team
// of four lanes (curve.cuh) a bucket up to 64 buckets, a lane beyond
// (bucket_plan).  A team runs an add in 3 (Tom-256) or 5 (P-256) rounds
// instead of 11 or 14 products, and its loop runs the longest of its
// warp's 8 buckets (the team exchanges name the whole warp) where a lane
// loop's warp waits on the longest of 32: the team form was the faster at
// every shape timed, the card under-filled or not (PERF.md).  The skew: at
// w = 5 the top window holds one real bit (D*w = 260), so its bucket 1
// takes about T/2 terms against T/32 elsewhere.  A block whose largest
// digit is below nb = B/L (L > 1, a power of two) gives each bucket c < nb
// the L units c, c + nb, c + 2nb, ...: each adds every L-th term of the
// bucket's list, and a tree over shared memory (log2 L steps) sums the L
// pieces.  Bound on the H100: 32-bit integer multiply-adds, an add a term
// past each bucket's first; the chains' latency where they are few.
//
// bucket_fold.  Each window's running sums are split over `segs` segments
// of buckets, a team each: segment [lo, hi] gives run = sum S_b and
// acc = sum (b - lo + 1) S_b (2 adds a bucket, from the top down), then
// acc + (lo - 1) * run (a double-and-add of at most w bits), and a tree
// over shared memory sums a window's segments into W_d, which goes to a
// global scratch [N, D].  A block holds 32 teams: 32 / segs windows of one
// row a pass, and `wpt` passes, one after another, where the rows' blocks
// would not fit the card at once (a second wave would wait for the first
// wave's Horner blocks: at P-256 [256, 48] one pass took 4.6 ms, two
// 2.5, on an NVIDIA H100 80GB HBM3 at 700 W).  The row's last block to
// finish (a ticket counter a row, after a __threadfence) runs the Horner
// on its first warp: `groups` teams each fold Lg = ceil(D / groups)
// consecutive windows (w doublings and an add a window; the top group
// padded with identity windows), and one team
// chains the groups (w * Lg doublings and an add a group).  The chain of
// w(D - 1) doublings cannot shrink; the groups cut its adds from D to
// Lg + groups - 1.  bucket_plan takes the most segments with one pass
// where the rows' blocks fit the card at once, else the fewest passes
// that fit.  Bound on the H100: the dependent chain, the Horner's 1,095
// team rounds and 600 of running sums at P-256 [256, 48] (PERF.md).

#include <cuda_runtime.h>

#include "curve.cuh"

namespace {

constexpr int SUMS_MAX_THREADS = 256;  // a team a bucket for B <= 64
constexpr int FOLD_TEAMS = 32;         // teams of a bucket_fold block
constexpr int FOLD_THREADS = FOLD_TEAMS * ZK_TEAM;
constexpr int FOLD_MAX_GROUPS = 8;     // Horner groups: the teams of one warp

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Shared memory of a bucket_sums block: the warps' histograms [warps][B],
// the offsets [B + 1] and the lane split L, then the list [T] (uint16) and
// the digit column [T] (uint8), which the L-split pieces [B] overlay once
// the sums are done.
template <int CID>
size_t sums_smem(long long T, int B, int threads) {
    const size_t head = align16((size_t)((threads / 32) * B + B + 2) * sizeof(int));
    const size_t lists = (size_t)T * (sizeof(uint16_t) + 1);
    const size_t pieces = (size_t)B * sizeof(Pt<CID>);
    return head + align16(lists > pieces ? lists : pieces);
}

int sums_threads(int B, int lanes) { return B * lanes < 32 ? 32 : B * lanes; }

// coordinate q of P (q < C) stored as it is held, by lane q, if `live`
template <int CID>
__device__ __forceinline__ void team_store_raw(uint32_t* g, const Pt<CID>& P, bool live) {
    Fe c;
    team_coord<CID>(c, P);
    if (live && team_lane() < CurveT<CID>::C) fe_store(g + team_lane() * ZK_NL, c);
}

// a point another block wrote during this launch: past L1
template <int CID>
__device__ __forceinline__ void pt_load_cg(Pt<CID>& r, const uint32_t* g) {
#pragma unroll
    for (int k = 0; k < CurveT<CID>::C; ++k)
#pragma unroll
        for (int i = 0; i < ZK_NL; ++i) r.c[k][i] = __ldcg(g + k * ZK_NL + i);
}

template <int CID, int LANES>
__device__ __forceinline__ void unit_add(Pt<CID>& acc, const Pt<CID>& P) {
    if constexpr (LANES == 1) {
        Pt<CID> t;
        pt_add<CID>(t, acc, P);
        acc = t;
    } else {
        team_add<CID>(acc, acc, P);
    }
}

template <int CID, int LANES>
__global__ void __launch_bounds__(SUMS_MAX_THREADS) bucket_sums_kernel(
    long long N, long long T, int D, int B, const uint32_t* __restrict__ points,
    const uint8_t* __restrict__ digits, uint32_t* __restrict__ sums) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int C = CurveT<CID>::C;
    constexpr long long PT = (long long)C * ZK_NL;  // limbs per point
    const int threads = blockDim.x, warps = threads / 32;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    int* hist = (int*)smem;        // [warps][B]: counts, then each warp's offset in a bucket
    int* off = hist + warps * B;   // [B + 1] bucket offsets, then the lane split L
    unsigned char* tail = smem + align16((size_t)(warps * B + B + 2) * sizeof(int));
    uint16_t* list = (uint16_t*)tail;      // [T] term indices by bucket
    uint8_t* dig = (uint8_t*)(list + T);   // [T] the window's digits
    Pt<CID>* piece = (Pt<CID>*)tail;       // [B] L-split pieces, after the sums
    const long long row = blockIdx.x % N;
    const int d = (int)(blockIdx.x / N);
    const uint8_t* g = digits + (row * D + d) * T;
    for (long long t = tid; t < T; t += threads) dig[t] = g[t];
    for (int k = tid; k < warps * B; k += threads) hist[k] = 0;
    __syncthreads();

    // counting sort: warp w counts and later places the terms [t0, t1)
    const long long slice = (T + warps - 1) / warps;
    const long long t0 = warp * slice, t1 = t0 + slice < T ? t0 + slice : T;
    int* h = hist + warp * B;
    for (long long t = t0 + lane; t < t1; t += 32) atomicAdd(&h[dig[t]], 1);
    __syncthreads();
    for (int b = tid; b < B; b += threads) {
        int run = 0;
        for (int w = 0; w < warps; ++w) {
            const int c = hist[w * B + b];
            hist[w * B + b] = run;
            run += c;
        }
        off[b] = run;  // the bucket's count, until the scan below
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the counts; lane k takes `per` buckets
        const int per = (B + 31) / 32;
        int mine = 0, top = -1;
        for (int k = 0; k < per; ++k) {
            const int b = lane * per + k;
            if (b < B) {
                mine += off[b];
                if (off[b]) top = b;
            }
        }
        int incl = mine;
        for (int s = 1; s < 32; s *= 2) {
            const int v = __shfl_up_sync(ZK_WARP_ALL, incl, s);
            if (lane >= s) incl += v;
        }
        int run = incl - mine;
        for (int k = 0; k < per; ++k) {
            const int b = lane * per + k;
            if (b < B) {
                const int c = off[b];
                off[b] = run;
                run += c;
            }
        }
        top = __reduce_max_sync(ZK_WARP_ALL, top);
        if (lane == 31) off[B] = incl;  // = T
        if (lane == 0) {
            int L = 1;  // units a bucket: B/L buckets still hold every digit
            while (L < B && top < B / (2 * L)) L *= 2;
            off[B + 1] = L;
        }
    }
    __syncthreads();
    for (long long base = t0; base < t1; base += 32) {  // place, in term order
        const long long t = base + lane;
        const bool act = t < t1;
        const unsigned mask = __ballot_sync(ZK_WARP_ALL, act);
        int dd = 0, rank = 0;
        unsigned peers = 0;
        if (act) {
            dd = dig[t];
            peers = __match_any_sync(mask, dd);
            rank = __popc(peers & ((1u << lane) - 1u));
            list[off[dd] + h[dd] + rank] = (uint16_t)t;
        }
        __syncwarp();
        if (act && rank == 0) h[dd] += __popc(peers);
        __syncwarp();
    }
    __syncthreads();

    // unit u sums every L-th term of bucket c, from its j-th
    const int L = off[B + 1], nb = B / L;
    const int u = tid / LANES;
    const bool unit = u < B;
    const int c = u % nb, j = u / nb;
    int first = 0, n = 0;
    if (unit && c != 0) {  // bucket 0 contributes nothing: it stays the identity
        const int cnt = off[c + 1] - off[c];
        first = off[c] + j;
        n = cnt > j ? (cnt - j + L - 1) / L : 0;
    }
    const uint32_t* pts = points + row * T * PT;
    Pt<CID> acc, cur;
    if (n > 0) {
        pt_load_raw<CID>(acc, pts + (long long)list[first] * PT);
    } else {
        pt_identity<CID>(acc);
    }
    int steps = n;
    if constexpr (LANES > 1) steps = __reduce_max_sync(ZK_WARP_ALL, n);
#pragma unroll 1
    for (int i = 1; i < steps; ++i) {
        if (i < n) {
            pt_load_raw<CID>(cur, pts + (long long)list[first + i * L] * PT);
        } else {
            pt_identity<CID>(cur);  // a team past its bucket's end
        }
        unit_add<CID, LANES>(acc, cur);
    }
    if (L > 1) {  // the same for the whole block
        const bool writer = unit && (LANES == 1 || team_lane() == 0);
        __syncthreads();  // every unit is done with the list: the pieces overlay it
        if (writer) piece[u] = acc;
        __syncthreads();
        for (int hh = L / 2; hh >= 1; hh /= 2) {
            const bool take = unit && j < hh;
            if (take) {
                cur = piece[u + hh * nb];
            } else {
                pt_identity<CID>(cur);
            }
            if (LANES > 1 || take) unit_add<CID, LANES>(acc, cur);
            __syncthreads();
            if (take && writer) piece[u] = acc;
            __syncthreads();
        }
        if (j != 0) pt_identity<CID>(acc);  // bucket u >= nb is empty
    }
    uint32_t* o = sums + ((row * D + d) * (long long)B + (unit ? u : 0)) * PT;
    if constexpr (LANES == 1) {
        if (unit) pt_store_raw<CID>(o, acc);
    } else {
        team_store_raw<CID>(o, acc, unit);
    }
}

template <int CID>
__global__ void __launch_bounds__(FOLD_THREADS) bucket_fold_kernel(
    long long N, int D, int B, int window, int segs, int wpt, int groups,
    const uint32_t* __restrict__ sums, uint32_t* wsum, unsigned int* ticket,
    uint32_t* __restrict__ out) {
    constexpr int C = CurveT<CID>::C;
    constexpr long long PT = (long long)C * ZK_NL;
    __shared__ Pt<CID> part[FOLD_TEAMS];
    __shared__ int last;
    const int wpp = FOLD_TEAMS / segs;  // windows a pass; a team runs `wpt` passes
    const int bpr = (D + wpp * wpt - 1) / (wpp * wpt);  // blocks a row
    const long long row = blockIdx.x / bpr;
    const int team = threadIdx.x / ZK_TEAM, q = team_lane();
    const int k = team / segs, j = team % segs;
    const bool real = k < wpp;  // a team of one of the pass's windows
    const int lo = 1 + (int)((long long)j * (B - 1) / segs);  // segment j: buckets [lo, hi]
    const int hi = (int)((long long)(j + 1) * (B - 1) / segs);
    const int len = (B - 1 + segs - 1) / segs;  // the longest segment
    const int lo_top = 1 + (int)((long long)(segs - 1) * (B - 1) / segs);
    const int nbits = 32 - __clz(lo_top - 1);  // of the last segment's lo - 1
    Pt<CID> id, run, acc, P, R;
    pt_identity<CID>(id);
#pragma unroll 1
    for (int pass = 0; pass < wpt; ++pass) {
        const int d0 = ((int)(blockIdx.x % bpr) * wpt + pass) * wpp + k;
        const bool live = real && d0 < D;
        const int d = live ? d0 : D - 1;  // idle teams run a clamped window and store nothing
        const uint32_t* s = sums + (row * D + d) * (long long)B * PT;

        // running sums from the top bucket down
        pt_load_raw<CID>(run, s + hi * PT);
        acc = run;
#pragma unroll 1
        for (int i = 1; i < len; ++i) {
            const bool in = hi - i >= lo;
            if (in) {
                pt_load_raw<CID>(P, s + (hi - i) * PT);
            } else {
                P = id;
            }
            team_add<CID>(run, run, P);
            pt_select<CID>(R, in, run, id);
            team_add<CID>(acc, acc, R);
        }
        // acc += (lo - 1) * run, a double-and-add over nbits bits
        if (nbits > 0) {
            const int m = lo - 1;
            Pt<CID> t;
            pt_select<CID>(t, (m >> (nbits - 1)) & 1, run, id);
#pragma unroll 1
            for (int i = nbits - 2; i >= 0; --i) {
                team_dbl<CID>(t, t);
                pt_select<CID>(R, (m >> i) & 1, run, id);
                team_add<CID>(t, t, R);
            }
            team_add<CID>(acc, acc, t);
        }
        // the window's segments by a tree: at step h, segment j (j % 2h ==
        // 0) takes segment j + h's sum
        if (q == 0) part[team] = acc;
        __syncthreads();
#pragma unroll 1
        for (int h = 1; h < segs; h *= 2) {
            const bool take = real && j % (2 * h) == 0 && j + h < segs;
            if (take) {
                P = part[team + h];
            } else {
                P = id;
            }
            team_add<CID>(acc, acc, P);
            __syncthreads();
            if (take && q == 0) part[team] = acc;
            __syncthreads();
        }
        team_store_raw<CID>(wsum + (row * D + d) * PT, acc, live && j == 0);
    }

    // the row's last block folds its D windows
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&ticket[row], 1u) == (unsigned)(bpr - 1);
    __syncthreads();
    if (!last || threadIdx.x >= 32) return;
    __threadfence();
    const int Lg = (D + groups - 1) / groups;
    const int base = D - (groups - team) * Lg;  // team's first window (< 0: identity)
    const bool grp = team < groups;
    const uint32_t* W = wsum + row * D * PT;
    if (grp && base >= 0) {
        pt_load_cg<CID>(acc, W + base * PT);
    } else {
        acc = id;
    }
#pragma unroll 1
    for (int i = 1; i < Lg; ++i) {
#pragma unroll 1
        for (int b = 0; b < window; ++b) team_dbl<CID>(acc, acc);
        if (grp && base + i >= 0) {
            pt_load_cg<CID>(P, W + (base + i) * PT);
        } else {
            P = id;
        }
        team_add<CID>(acc, acc, P);
    }
    if (q == 0) part[team] = acc;
    __syncwarp();
    acc = part[0];
#pragma unroll 1
    for (int gi = 1; gi < groups; ++gi) {
#pragma unroll 1
        for (int b = 0; b < window * Lg; ++b) team_dbl<CID>(acc, acc);
        P = part[gi];
        team_add<CID>(acc, acc, P);
    }
    team_store_raw<CID>(out + row * PT, acc, team == 0);
    if (threadIdx.x == 0) ticket[row] = 0u;
}

}  // namespace

extern "C" int zk_bucket_sums(int curve, int lanes, long long N, long long T, int D, int B,
                              const void* points, const void* digits, void* sums, void* stream) {
    if (N * D == 0) return 0;
    if (B < 2 || B > 256 || (B & (B - 1)) || T >= 65536 || (lanes != 1 && lanes != 4) ||
        B * lanes > SUMS_MAX_THREADS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = sums_threads(B, lanes);
    int err = 0;
    const int bad = zk_dispatch_curve(curve, [&](auto cv) {
        constexpr int CID = decltype(cv)::value;
        const size_t smem = sums_smem<CID>(T, B, threads);
        auto kern = lanes == 1 ? bucket_sums_kernel<CID, 1> : bucket_sums_kernel<CID, 4>;
        if (smem > 48 * 1024)
            err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)smem);
        if (err) return;
        kern<<<(unsigned)(N * D), threads, smem, st>>>(N, T, D, B, (const uint32_t*)points,
                                                      (const uint8_t*)digits, (uint32_t*)sums);
    });
    if (bad) return bad;
    return err ? err : (int)cudaGetLastError();
}

extern "C" int zk_bucket_fold(int curve, long long N, int D, int B, int window, int segs,
                              int wpt, int groups, const void* sums, void* wsum, void* ticket,
                              void* out, void* stream) {
    if (N == 0) return 0;
    if (D < 1 || B < 2 || window < 1 || segs < 1 || segs > FOLD_TEAMS || segs > B - 1 ||
        wpt < 1 || wpt > D || groups < 1 || groups > FOLD_MAX_GROUPS || groups > D)
        return (int)cudaErrorInvalidValue;
    const long long wpb = (long long)(FOLD_TEAMS / segs) * wpt;  // windows a block
    const long long bpr = (D + wpb - 1) / wpb;
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto cv) {
        constexpr int CID = decltype(cv)::value;
        bucket_fold_kernel<CID><<<(unsigned)(N * bpr), FOLD_THREADS, 0, st>>>(
            N, D, B, window, segs, wpt, groups, (const uint32_t*)sums, (uint32_t*)wsum,
            (unsigned int*)ticket, (uint32_t*)out);
    });
    return bad ? bad : (int)cudaGetLastError();
}

// Blocks of bucket_fold_kernel<curve> (four warps each) that one SM of the
// current device holds at once, for bucket_plan's segments.
extern "C" int zk_bucket_fold_resident_warps(int curve, int* warps) {
    *warps = 0;
    cudaError_t err = cudaSuccess;
    const int bad = zk_dispatch_curve(curve, [&](auto cv) {
        constexpr int CID = decltype(cv)::value;
        int blocks = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bucket_fold_kernel<CID>,
                                                            FOLD_THREADS, 0);
        *warps = blocks * (FOLD_THREADS / 32);
    });
    return bad ? bad : (int)err;
}
