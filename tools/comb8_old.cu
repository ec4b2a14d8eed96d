// The comb8 kernels before their redesign for the H100, kept as
// tools/torch_comb8_probe.py's "old" forms: comb8_bases on curve.cuh's
// team_comb_bases (the P-256 doubling in team_weier_dbl's 4 rounds);
// comb8_entries one block of 256 threads a window, thread s < k doubling
// entry k/2 itself in every index-set round and adding by one lane, then a
// Fermat inverse (field.cuh fe_inv) of its entry's Z.  Built only by the
// probe, in one translation unit with csrc/comb8.cu.

#include <cuda_runtime.h>

#include "curve.cuh"

namespace old_comb8 {

constexpr int WINDOWS = 32;   // 8-bit windows of a 256-bit scalar
constexpr int ENTRIES = 256;  // multiples 0..255 a window
constexpr int MIXED = 5;      // rows of a Tom-256 mixed-add entry
constexpr int BASES = 8;      // bases (teams) per one-warp block of comb8_bases

template <int CID>
__global__ void __launch_bounds__(BASES * ZK_TEAM) comb8_bases_kernel(
    long long R, const uint32_t* __restrict__ P, uint32_t* __restrict__ bases) {
    constexpr int PT = CurveT<CID>::C * ZK_NL;
    const long long r0 = (long long)blockIdx.x * BASES + threadIdx.x / ZK_TEAM;
    // a team past R runs base R-1 and stores nothing
    const bool live = r0 < R;
    const long long r = live ? r0 : R - 1;
    team_comb_bases<CID, 8, false>(bases + r * WINDOWS * PT, P + r * PT, WINDOWS, live);
}

template <int CID>
__global__ void __launch_bounds__(ENTRIES) comb8_entries_kernel(
    const uint32_t* __restrict__ bases, uint32_t* __restrict__ canon, uint32_t* __restrict__ mont) {
    constexpr int C = CurveT<CID>::C;
    constexpr int PT = C * ZK_NL;
    __shared__ uint32_t E[ENTRIES * PT];  // the window's entries, Montgomery form
    const ZkModulus& M = curve_mod<CID>();
    const long long w = blockIdx.x;  // (base, window)
    const int s = threadIdx.x;
    Pt<CID> a, m, r;
    if (s == 0) {
        pt_identity<CID>(a);
        pt_store_raw<CID>(E, a);
        pt_load<CID>(m, bases + w * PT);
        pt_store_raw<CID>(E + PT, m);
    }
    __syncthreads();
#pragma unroll 1
    for (int k = 2; k < ENTRIES; k *= 2) {
        if (s < k) {
            pt_load_raw<CID>(a, E + (k / 2) * PT);
            pt_dbl<CID>(m, a);
            pt_load_raw<CID>(a, E + s * PT);
            pt_add<CID>(r, a, m);
            pt_store_raw<CID>(E + (k + s) * PT, r);
        }
        __syncthreads();
    }
    // entry s to affine: a Fermat inverse of Z (0 -> 0, the P-256 identity)
    pt_load_raw<CID>(a, E + s * PT);
    Fe zi, x, y, t;
    fe_inv(zi, a.c[C - 1], M);
    fe_mont_mul(x, a.c[0], zi, M);
    fe_mont_mul(y, a.c[1], zi, M);
    if constexpr (C == 4) {
        Fe row[MIXED];
        fe_copy(row[0], x);
        fe_copy(row[1], y);
        fe_add(row[2], x, y, M);
        fe_mont_mul(t, x, y, M);
        fe_mont_mul(row[3], ZK_COEF[CurveT<CID>::D], t, M);
        fe_mont_mul(row[4], ZK_COEF[CurveT<CID>::A], x, M);
        uint32_t* oc = canon + (w * ENTRIES + s) * MIXED * ZK_NL;
        uint32_t* om = mont + (w * ENTRIES + s) * MIXED * ZK_NL;
#pragma unroll
        for (int k = 0; k < MIXED; ++k) {
            fe_store(om + k * ZK_NL, row[k]);
            fe_from_mont(t, row[k], M);
            fe_store(oc + k * ZK_NL, t);
        }
    } else {
        const bool inf = fe_is_zero(a.c[C - 1]);
        Fe one, zero;
        fe_set_zero(zero);
        fe_set_zero(one);
        one[0] = 1u;  // standard form
        uint32_t* oc = canon + (w * ENTRIES + s) * PT;
        uint32_t* om = mont + (w * ENTRIES + s) * PT;
        fe_store(om, x);  // 0 for the identity
        fe_select(t, inf, M.one, y);
        fe_store(om + ZK_NL, t);
        fe_select(t, inf, zero, M.one);
        fe_store(om + 2 * ZK_NL, t);
        fe_from_mont(t, x, M);
        fe_store(oc, t);
        fe_from_mont(t, y, M);
        fe_select(t, inf, one, t);
        fe_store(oc + ZK_NL, t);
        fe_select(t, inf, zero, one);
        fe_store(oc + 2 * ZK_NL, t);
    }
}

unsigned grid_for(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

}  // namespace old_comb8

extern "C" int probe_old_comb8_bases(int curve, long long R, const void* P, void* bases, void* stream) {
    if (R == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        old_comb8::comb8_bases_kernel<CID><<<old_comb8::grid_for(R, old_comb8::BASES), old_comb8::BASES * ZK_TEAM, 0, st>>>(
            R, (const uint32_t*)P, (uint32_t*)bases);
    });
    return bad ? bad : (int)cudaGetLastError();
}

// both forms are written: canon (standard form) and mont (Montgomery form)
extern "C" int probe_old_comb8_entries(int curve, long long R, const void* bases, void* canon, void* mont,
                                void* stream) {
    if (R == 0) return 0;
    if (canon == nullptr || mont == nullptr) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        old_comb8::comb8_entries_kernel<CID><<<(unsigned)(R * old_comb8::WINDOWS), old_comb8::ENTRIES, 0, st>>>(
            (const uint32_t*)bases, (uint32_t*)canon, (uint32_t*)mont);
    });
    return bad ? bad : (int)cudaGetLastError();
}
