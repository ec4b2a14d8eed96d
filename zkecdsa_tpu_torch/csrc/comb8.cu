// comb8: the fixed-base comb tables of the Pedersen bases, built on the
// card once per parameter set (protocol/batch.py DeviceParams): entry
// [j][d] = d * 2^(8j) * base, 32 windows of 256 multiples, in affine form.
// Replaces zkecdsa_tpu/ops/curve_ops.py:307 comb_table (P-256, the table
// of h) and :666 comb_table_mixed (Tom-256, the tables of g and h), in
// their order, as two entries; each takes a curve id (csrc/curve.cuh):
//
// zk_comb8_bases: bases [R, C, 9] -> window bases [R, 32, C, 9], LSB-first
// (entry j = 2^(8j) * base): a serial chain of 31 runs of eight
// doublings, a team of four lanes a base (curve.cuh team_comb_bases, as
// comb4_bases), 8 bases to a one-warp block.
//
// zk_comb8_entries: window bases [R, 32, C, 9] -> the table, one block of
// 256 threads a (base, window).  The 256 entries live in shared memory in
// Montgomery form (36 KB for Tom-256, 27 KB for P-256) and are built by
// index-set doubling in the reference's order: entries 0, 1 = identity,
// base; then for k = 2, 4, ..., 128 thread s < k computes m_k = dbl(entry
// k/2) (every such thread the same value, so no thread waits on another)
// and entry k + s = entry s + m_k.  Then thread d converts entry d to
// affine with a Fermat inverse of its Z (field.cuh fe_inv, a 4-bit window:
// 298 products for P-256, 312 for Tom-256; one inverse per thread runs as
// long as one batch inverse would, and the card has spare lanes at 32 or
// 64 blocks) and writes each entry twice, standard form to canon and
// Montgomery form (x * 2^288 mod p) to mont, so the host converts nothing
// and the comb kernels read mont as it stands:
//   * P-256 ([R, 32, 256, 3, 9] each): (x, y, 1), the identity as
//     (0, 1, 0) (Montgomery: (x R, y R, R), (0, R, 0)), the table of
//     comb_weier (WeierComb's two forms);
//   * Tom-256 ([R, 32, 256, 5, 9] each): the mixed-add rows (x, y, x+y,
//     d*x*y, a*x), MixedComb's two forms.
//
// Every point operation is the complete formula the plain version
// (ops/curve_ops.py) takes, in its order, and every field operation
// returns the canonical residue, so the tables are its integers.
//
// Bound on the H100: 32-bit integer multiply-adds, but the call is far
// from it: at R = 1 or 2 the bases are one or two chains of 248
// doublings (latency-bound; the team cuts a doubling to 3-4 rounds of one
// product) and the entries 32 or 64 blocks on 132 SMs, each a chain of 7
// rounds of a doubling and an addition, then one inverse.

#include <cuda_runtime.h>

#include "curve.cuh"

namespace {

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

}  // namespace

extern "C" int zk_comb8_bases(int curve, long long R, const void* P, void* bases, void* stream) {
    if (R == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        comb8_bases_kernel<CID><<<grid_for(R, BASES), BASES * ZK_TEAM, 0, st>>>(
            R, (const uint32_t*)P, (uint32_t*)bases);
    });
    return bad ? bad : (int)cudaGetLastError();
}

// both forms are written: canon (standard form) and mont (Montgomery form)
extern "C" int zk_comb8_entries(int curve, long long R, const void* bases, void* canon, void* mont,
                                void* stream) {
    if (R == 0) return 0;
    if (canon == nullptr || mont == nullptr) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        comb8_entries_kernel<CID><<<(unsigned)(R * WINDOWS), ENTRIES, 0, st>>>(
            (const uint32_t*)bases, (uint32_t*)canon, (uint32_t*)mont);
    });
    return bad ? bad : (int)cudaGetLastError();
}
