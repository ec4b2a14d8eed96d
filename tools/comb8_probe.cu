// The probe's own kernels (tools/torch_comb8_probe.py), built in one
// translation unit after csrc/comb8.cu and tools/comb8_old.cu:
//
// * probe_comb8_entries_form: comb8_entries under the inverse's other
//   forms (InvForm below), a copy of csrc/comb8.cu's kernel built on its
//   phases (entries_rounds, tree_up, tree_down, entries_store) with the
//   inverse switched; the shipped form is zk_comb8_entries itself;
// * product chains, one warp a launch, each product waiting on the one
//   before, for one product's latency in each form:
//     0  CIOS: field.cuh fe_mont_mul by one lane (x = x y, n times);
//     1  a team round: fe_mont_mul on four lanes and the exchange of the
//        four products (curve.cuh team_mul4), lane q going on with lane
//        q + 1's product;
//     2  limb-parallel: one product on a group of 16 lanes (below);
//     3  fe_inv, the Fermat inverse, by one lane (x = 1/x + 1);
//     4  fe_inv_vartime_mont, comb8.cu's variable-time inverse, likewise;
// * probe_dbl_chain: comb8_bases' chain without its stores, n doublings
//   (comb8_dbl: 2 rounds of one product a lane on 16 lanes) from one base,
//   the point stored at the end, for the shipped round's latency.
//
// The limb-parallel product (form 2) holds an element as ten 28-bit limbs,
// limb j on lane j of a 16-lane group (lanes 10..15 hold 0), and computes
// the Montgomery product a b 2^-280 mod p: for each limb b_i (shuffled from
// lane i) every lane adds a_j b_i to its 64-bit accumulator, lane 0's low
// 28 bits give q (shuffled to all), every lane adds q p_j, and the
// accumulators move down a lane (position j + 1 -> j) with lane 0's
// quotient by 2^28 added to the new position 0.  Two carry passes bring the
// limbs below 2^28 + 2^7; the value stays below p + 2^238 for inputs below
// 2^259, so a chain needs no final subtraction.  Ten steps of three
// dependent shuffles, where CIOS runs 81 multiply-adds on one carry chain.

namespace probe_comb8 {

// How the probe's comb8_entries inverts the 256 Z of a window; the last
// two time the phases and write no table (the rounds alone, each entry's
// X stored; everything but the inverse at the tree's root).
enum InvForm { INV_FERMAT = 0, INV_VARTIME = 1, INV_TREE_FERMAT = 2, INV_ROUNDS_ONLY = 4, INV_TREE_NONE = 5 };

template <int CID, int INV>
__global__ void __launch_bounds__(ENTRY_THREADS) entries_form_kernel(
    const uint32_t* __restrict__ bases, uint32_t* __restrict__ canon, uint32_t* __restrict__ mont) {
    constexpr int PT = CurveT<CID>::C * ZK_NL;
    __shared__ uint32_t E[ENTRIES * PT];
    __shared__ uint32_t Mk[(ROUNDS + 1) * PT];
    const ZkModulus& M = curve_mod<CID>();
    const long long w = blockIdx.x;
    const int tid = threadIdx.x;
    entries_rounds<CID>(bases + w * PT, E, Mk);
    if constexpr (INV == INV_ROUNDS_ONLY) {  // X stored: the rounds are not dead code
        if (tid < ENTRIES) fe_store(canon + (w * ENTRIES + tid) * ZK_NL, E + tid * PT);
        return;
    }
    Pt<CID> a;
    Fe z, zi;
    const bool inf = entry_z<CID>(a, z, E, tid < ENTRIES ? tid : 0);
    if constexpr (INV == INV_FERMAT || INV == INV_VARTIME) {
        if (tid >= ENTRIES) return;
        if constexpr (INV == INV_FERMAT) {
            fe_inv(zi, z, M);
        } else {
            fe_inv_vartime_mont(zi, z, M);
        }
    } else {
        tree_up(E, z, M);
        if (tid == 0) {
            fe_load(z, E + ZK_NL);
            if constexpr (INV == INV_TREE_FERMAT) fe_inv(z, z, M);
            fe_store(E + TREE_I + ZK_NL, z);
        }
        __syncthreads();
        tree_down(E, zi, M);
    }
    if (tid < ENTRIES) entries_store<CID>(a, zi, inf, w * ENTRIES + tid, canon, mont);
}

template <int INV>
int launch_entries_form(int curve, long long R, const void* bases, void* canon, void* mont, cudaStream_t st) {
    return zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        entries_form_kernel<CID, INV><<<(unsigned)(R * WINDOWS), ENTRY_THREADS, 0, st>>>(
            (const uint32_t*)bases, (uint32_t*)canon, (uint32_t*)mont);
    });
}

template <int CID>
__global__ void __launch_bounds__(32) dbl_chain_kernel(int n, const uint32_t* __restrict__ P,
                                                       uint32_t* __restrict__ out) {
    Pt<CID> b;
    Fe k;
    team_to_mont<CID>(b, P);
    wide_carry<CID>(k, b);
#pragma unroll 1
    for (int i = 0; i < n; ++i) comb8_dbl<CID>(b, k);
    team_store<CID>(out, b, true);
}

constexpr int LP_W = 16;        // lanes a limb-parallel product
constexpr int LP_LIMBS = 10;    // 28-bit limbs: 280 bits
constexpr uint32_t LP_MASK = (1u << 28) - 1u;

// bits [28 j, 28 j + 28) of a nine-limb 32-bit value (0 for j >= 10)
__device__ __forceinline__ uint32_t lp_limb(const uint32_t* v, int j) {
    if (j >= LP_LIMBS) return 0u;
    const int o = 28 * j, w = o / 32, sh = o % 32;
    uint32_t lo = v[w] >> sh;
    if (sh > 4 && w + 1 < ZK_NL) lo |= v[w + 1] << (32 - sh);
    return lo & LP_MASK;
}

// Montgomery product a b 2^-280 mod p on a 16-lane group; j the lane in
// the group, pj limb j of p, pinv = -p^-1 mod 2^28
__device__ __forceinline__ uint32_t lp_mul(uint32_t a, uint32_t b, uint32_t pj, uint32_t pinv, int j) {
    uint64_t T = 0;
#pragma unroll
    for (int i = 0; i < LP_LIMBS; ++i) {
        const uint32_t bi = __shfl_sync(ZK_WARP_ALL, b, i, LP_W);
        T += (uint64_t)a * bi;
        const uint32_t t0 = __shfl_sync(ZK_WARP_ALL, (uint32_t)T, 0, LP_W);
        const uint32_t q = (t0 * pinv) & LP_MASK;
        T += (uint64_t)q * pj;
        const uint32_t lo = __shfl_down_sync(ZK_WARP_ALL, (uint32_t)T, 1, LP_W);
        const uint32_t hi = __shfl_down_sync(ZK_WARP_ALL, (uint32_t)(T >> 32), 1, LP_W);
        uint64_t next = j == LP_W - 1 ? 0ull : ((uint64_t)hi << 32 | lo);
        if (j == 0) next += T >> 28;
        T = next;
    }
    // carries: T_j < 2^61 -> limbs below 2^28 + 2^34 -> below 2^28 + 2^7
    const uint64_t c = T >> 28;
    uint32_t clo = __shfl_up_sync(ZK_WARP_ALL, (uint32_t)c, 1, LP_W);
    uint32_t chi = __shfl_up_sync(ZK_WARP_ALL, (uint32_t)(c >> 32), 1, LP_W);
    uint64_t L = (T & LP_MASK) + (j == 0 ? 0ull : ((uint64_t)chi << 32 | clo));
    const uint32_t c2 = (uint32_t)(L >> 28);
    const uint32_t in2 = __shfl_up_sync(ZK_WARP_ALL, c2, 1, LP_W);
    return (uint32_t)(L & LP_MASK) + (j == 0 ? 0u : in2);
}

template <int CID>
__global__ void mul_chain_kernel(int form, int n, const uint32_t* __restrict__ xy,
                                 uint32_t* __restrict__ out) {
    const ZkModulus& M = curve_mod<CID>();
    const int lane = threadIdx.x;
    Fe x, y;
    if (form == 0 || form >= 3) {  // one lane
        if (lane != 0) return;
        fe_load(x, xy);
        fe_load(y, xy + ZK_NL);
        if (form == 0) {
#pragma unroll 1
            for (int i = 0; i < n; ++i) fe_mont_mul(x, x, y, M);
        } else {
#pragma unroll 1
            for (int i = 0; i < n; ++i) {
                if (form == 3) {
                    fe_inv(x, x, M);
                } else {
                    fe_inv_vartime_mont(x, x, M);
                }
                fe_add(x, x, M.one, M);
            }
        }
        fe_store(out, x);
    } else if (form == 1) {  // a team: lane q starts from x_q
        const int q = team_lane();
        fe_load(x, xy + (2 + q) * ZK_NL);
        fe_load(y, xy + ZK_NL);
        Fe o0, o1, o2, o3;
#pragma unroll 1
        for (int i = 0; i < n; ++i) {
            team_mul4(o0, o1, o2, o3, x, y, M);
            fe_pick(x, (q + 1) & 3, o0, o1, o2, o3);
        }
        if (lane < ZK_TEAM) fe_store(out + lane * ZK_NL, x);
    } else {  // limb-parallel, lanes 0..15
        const int j = lane % LP_W;
        uint32_t p32[ZK_NL];
#pragma unroll
        for (int i = 0; i < ZK_NL; ++i) p32[i] = M.p[i];
        const uint32_t pj = lp_limb(p32, j);
        const uint32_t pinv = M.pinv & LP_MASK;
        uint32_t a = lp_limb(xy, j), b = lp_limb(xy + ZK_NL, j);
#pragma unroll 1
        for (int i = 0; i < n; ++i) a = lp_mul(a, b, pj, pinv, j);
        if (lane < LP_W) out[lane] = a;
    }
}

}  // namespace probe_comb8

extern "C" int probe_comb8_entries_form(int curve, int form, long long R, const void* bases,
                                        void* canon, void* mont, void* stream) {
    if (R == 0) return 0;
    using namespace probe_comb8;
    cudaStream_t st = (cudaStream_t)stream;
    int bad;
    switch (form) {
        case INV_FERMAT: bad = launch_entries_form<INV_FERMAT>(curve, R, bases, canon, mont, st); break;
        case INV_VARTIME: bad = launch_entries_form<INV_VARTIME>(curve, R, bases, canon, mont, st); break;
        case INV_TREE_FERMAT: bad = launch_entries_form<INV_TREE_FERMAT>(curve, R, bases, canon, mont, st); break;
        case INV_ROUNDS_ONLY: bad = launch_entries_form<INV_ROUNDS_ONLY>(curve, R, bases, canon, mont, st); break;
        case INV_TREE_NONE: bad = launch_entries_form<INV_TREE_NONE>(curve, R, bases, canon, mont, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return bad ? bad : (int)cudaGetLastError();
}

// n doublings of the base P (standard form, [C, 9]) on one 16-lane chain;
// out gets the point as comb8_bases stores it
extern "C" int probe_dbl_chain(int curve, int n, const void* P, void* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        probe_comb8::dbl_chain_kernel<CID><<<1, 32, 0, st>>>(n, (const uint32_t*)P, (uint32_t*)out);
    });
    return bad ? bad : (int)cudaGetLastError();
}

// a chain of n products (or inverses) in `form` on one warp; xy holds x,
// y and the team's four starting values, nine limbs each
extern "C" int probe_mul_chain(int curve, int form, int n, const void* xy, void* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        probe_comb8::mul_chain_kernel<CID><<<1, 32, 0, st>>>(form, n, (const uint32_t*)xy,
                                                              (uint32_t*)out);
    });
    return bad ? bad : (int)cudaGetLastError();
}
