// Complete, branch-free point formulas for the three curves, on Montgomery
// field elements (field.cuh).  The same algebra as the reference package's
// zkecdsa_tpu/ops/curve_ops.py, operation for operation, so a kernel and
// the plain PyTorch version (zkecdsa_tpu_torch/ops/curve_ops.py) reach the
// same canonical projective coordinates:
//
//   * P-256 and war256: Renes-Costello-Batina 2015 for a = -3, projective
//     (X:Y:Z), identity (0:1:0) (curve_ops.py WeierOps.add / dbl);
//   * Tom-256: Hisil-Wong-Carter-Dawson 2008, extended (X:Y:T:Z), identity
//     (0:1:0:1) (EdwardsOps.add / dbl), and the mixed add against affine
//     comb-table rows (X2, Y2, X2+Y2, d*T2, a*X2) (EdwardsOps.add_mixed).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "field.cuh"

// Curve ids; the same order as zkecdsa_tpu_torch/ops/curve_ops.py.
#define ZK_CURVE_P256 0
#define ZK_CURVE_WAR 1
#define ZK_CURVE_TOM 2

// Curve coefficients in Montgomery form: b for the Weierstrass curves, a
// and d for Tom-256.  Checked by tests/test_torch_field.py.
static __constant__ uint32_t ZK_COEF[4][ZK_NL] = {
    // p256 b
    {0xdc30061du, 0x29c4bddfu, 0xd89cdf62u, 0x9c542a73u, 0xacf005ccu, 0xf7212ed6u, 0x09721a8eu, 0xe0b74e51u, 0x00000000u},
    // war256 b
    {0x96fcf224u, 0x640337e6u, 0x9de4f0cbu, 0xf325834fu, 0x3b11a06eu, 0x3d75190bu, 0x59cb5468u, 0x0a994682u, 0x00000000u},
    // tomEdwards256 a
    {0xcc44b5e1u, 0xeaa1d5e5u, 0x405c1707u, 0x5d37cba0u, 0x14890a3bu, 0x926142b4u, 0x73a95ad4u, 0x0e3d3b67u, 0x00000003u},
    // tomEdwards256 d
    {0x4ccfe7adu, 0xf12b020eu, 0xc3f5b8eau, 0xa9a1c831u, 0x8ab7f36au, 0x394067bbu, 0xa83ca491u, 0x3b043aa4u, 0x00000002u},
};

template <int CID>
struct CurveT;

template <>
struct CurveT<ZK_CURVE_P256> {
    static constexpr int C = 3;
    static constexpr int MOD = ZK_P256_P;
    static constexpr int B = 0;  // row of ZK_COEF
};

template <>
struct CurveT<ZK_CURVE_WAR> {
    static constexpr int C = 3;
    static constexpr int MOD = ZK_WAR_P;
    static constexpr int B = 1;
};

template <>
struct CurveT<ZK_CURVE_TOM> {
    static constexpr int C = 4;
    static constexpr int MOD = ZK_TOM_P;
    static constexpr int A = 2;
    static constexpr int D = 3;
};

// A point: C coordinates of ZK_NL limbs.
template <int CID>
struct Pt {
    uint32_t c[CurveT<CID>::C][ZK_NL];
};

template <int CID>
__device__ __forceinline__ const ZkModulus& curve_mod() {
    return ZK_MODS[CurveT<CID>::MOD];
}

template <int CID>
__device__ __forceinline__ void pt_identity(Pt<CID>& r) {
    const ZkModulus& M = curve_mod<CID>();
#pragma unroll
    for (int k = 0; k < CurveT<CID>::C; ++k) fe_set_zero(r.c[k]);
    fe_copy(r.c[1], M.one);                                   // Y = 1
    if constexpr (CurveT<CID>::C == 4) fe_copy(r.c[3], M.one);  // Z = 1 (Edwards)
}

// RCB15 complete addition, a = -3 (curve_ops.py WeierOps.add)
template <int CID>
__device__ __forceinline__ void weier_add(Pt<CID>& r, const Pt<CID>& P, const Pt<CID>& Q) {
    const ZkModulus& M = curve_mod<CID>();
    const uint32_t* b = ZK_COEF[CurveT<CID>::B];
    Fe m0, m1, m2, s1, s2, sxy, syz, sxz, t, w, zc, xc, v, u;
    fe_mont_mul(m0, P.c[0], Q.c[0], M);
    fe_mont_mul(m1, P.c[1], Q.c[1], M);
    fe_mont_mul(m2, P.c[2], Q.c[2], M);
    fe_add(s1, P.c[0], P.c[1], M);
    fe_add(s2, Q.c[0], Q.c[1], M);
    fe_mont_mul(sxy, s1, s2, M);
    fe_sub(sxy, sxy, m0, M);
    fe_sub(sxy, sxy, m1, M);
    fe_add(s1, P.c[1], P.c[2], M);
    fe_add(s2, Q.c[1], Q.c[2], M);
    fe_mont_mul(syz, s1, s2, M);
    fe_sub(syz, syz, m1, M);
    fe_sub(syz, syz, m2, M);
    fe_add(s1, P.c[0], P.c[2], M);
    fe_add(s2, Q.c[0], Q.c[2], M);
    fe_mont_mul(sxz, s1, s2, M);
    fe_sub(sxz, sxz, m0, M);
    fe_sub(sxz, sxz, m2, M);
    fe_mont_mul(t, b, m2, M);
    fe_sub(t, sxz, t, M);
    fe_mul_small<3>(w, t, M);           // w = 3 (sxz - b m2)
    fe_sub(zc, m1, w, M);
    fe_add(xc, m1, w, M);
    fe_mont_mul(t, b, sxz, M);
    fe_mul_small<3>(s1, m2, M);
    fe_sub(t, t, s1, M);
    fe_sub(t, t, m0, M);
    fe_mul_small<3>(v, t, M);           // v = 3 (b sxz - 3 m2 - m0)
    fe_sub(t, m0, m2, M);
    fe_mul_small<3>(u, t, M);           // u = 3 (m0 - m2)
    fe_mont_mul(s1, sxy, xc, M);
    fe_mont_mul(s2, syz, v, M);
    fe_sub(r.c[0], s1, s2, M);          // x3 = sxy xc - syz v
    fe_mont_mul(s1, xc, zc, M);
    fe_mont_mul(s2, u, v, M);
    fe_add(r.c[1], s1, s2, M);          // y3 = xc zc + u v
    fe_mont_mul(s1, syz, zc, M);
    fe_mont_mul(s2, sxy, u, M);
    fe_add(r.c[2], s1, s2, M);          // z3 = syz zc + sxy u
}

// RCB15 doubling, a = -3 (curve_ops.py WeierOps.dbl)
template <int CID>
__device__ __forceinline__ void weier_dbl(Pt<CID>& r, const Pt<CID>& P) {
    const ZkModulus& M = curve_mod<CID>();
    const uint32_t* b = ZK_COEF[CurveT<CID>::B];
    Fe xx, yy, zz, xy2, xz2, yz2, t, s, w, zc, xc, v, u;
    fe_mont_mul(xx, P.c[0], P.c[0], M);
    fe_mont_mul(yy, P.c[1], P.c[1], M);
    fe_mont_mul(zz, P.c[2], P.c[2], M);
    fe_mont_mul(t, P.c[0], P.c[1], M);
    fe_add(xy2, t, t, M);
    fe_mont_mul(t, P.c[0], P.c[2], M);
    fe_add(xz2, t, t, M);
    fe_mont_mul(t, P.c[1], P.c[2], M);
    fe_add(yz2, t, t, M);
    fe_mont_mul(t, b, zz, M);
    fe_sub(t, t, xz2, M);
    fe_mul_small<3>(w, t, M);           // w = 3 (b zz - xz2)
    fe_sub(zc, yy, w, M);
    fe_add(xc, yy, w, M);
    fe_mont_mul(t, b, xz2, M);
    fe_mul_small<3>(s, zz, M);
    fe_sub(t, t, s, M);
    fe_sub(t, t, xx, M);
    fe_mul_small<3>(v, t, M);           // v = 3 (b xz2 - 3 zz - xx)
    fe_sub(t, xx, zz, M);
    fe_mul_small<3>(u, t, M);           // u = 3 (xx - zz)
    fe_mont_mul(t, xy2, zc, M);
    fe_mont_mul(s, yz2, v, M);
    fe_sub(r.c[0], t, s, M);            // x3 = xy2 zc - yz2 v
    fe_mont_mul(t, xc, zc, M);
    fe_mont_mul(s, u, v, M);
    fe_add(r.c[1], t, s, M);            // y3 = xc zc + u v
    fe_mont_mul(t, yz2, yy, M);
    fe_mul_small<4>(r.c[2], t, M);      // z3 = 4 yz2 yy
}

// Shared tail of the HWCD08 formulas: (E F, G H, E H, F G)
template <int CID>
__device__ __forceinline__ void edw_finish(Pt<CID>& r, const Fe E, const Fe F, const Fe G,
                                           const Fe H, const ZkModulus& M) {
    fe_mont_mul(r.c[0], E, F, M);
    fe_mont_mul(r.c[1], G, H, M);
    fe_mont_mul(r.c[2], E, H, M);
    fe_mont_mul(r.c[3], F, G, M);
}

// HWCD08 unified addition (curve_ops.py EdwardsOps.add)
template <int CID>
__device__ __forceinline__ void edw_add(Pt<CID>& r, const Pt<CID>& P, const Pt<CID>& Q) {
    const ZkModulus& M = curve_mod<CID>();
    const uint32_t* ca = ZK_COEF[CurveT<CID>::A];
    const uint32_t* cd = ZK_COEF[CurveT<CID>::D];
    Fe A, B, C, D, E, F, G, H, s1, s2;
    fe_mont_mul(A, P.c[0], Q.c[0], M);
    fe_mont_mul(B, P.c[1], Q.c[1], M);
    fe_mont_mul(s1, P.c[2], Q.c[2], M);
    fe_mont_mul(C, cd, s1, M);
    fe_mont_mul(D, P.c[3], Q.c[3], M);
    fe_add(s1, P.c[0], P.c[1], M);
    fe_add(s2, Q.c[0], Q.c[1], M);
    fe_mont_mul(E, s1, s2, M);
    fe_sub(E, E, A, M);
    fe_sub(E, E, B, M);
    fe_sub(F, D, C, M);
    fe_add(G, D, C, M);
    fe_mont_mul(s1, ca, A, M);
    fe_sub(H, B, s1, M);
    edw_finish<CID>(r, E, F, G, H, M);
}

// HWCD08 doubling (curve_ops.py EdwardsOps.dbl)
template <int CID>
__device__ __forceinline__ void edw_dbl(Pt<CID>& r, const Pt<CID>& P) {
    const ZkModulus& M = curve_mod<CID>();
    const uint32_t* ca = ZK_COEF[CurveT<CID>::A];
    Fe A, B, C, D, E, F, G, H, s;
    fe_mont_mul(A, P.c[0], P.c[0], M);
    fe_mont_mul(B, P.c[1], P.c[1], M);
    fe_mont_mul(s, P.c[3], P.c[3], M);
    fe_add(C, s, s, M);
    fe_mont_mul(D, ca, A, M);
    fe_add(s, P.c[0], P.c[1], M);
    fe_mont_mul(E, s, s, M);
    fe_sub(E, E, A, M);
    fe_sub(E, E, B, M);
    fe_add(G, D, B, M);
    fe_sub(F, G, C, M);
    fe_sub(H, D, B, M);
    edw_finish<CID>(r, E, F, G, H, M);
}

// Mixed addition against one affine comb-table entry T = (X2, Y2, X2+Y2,
// d*T2, a*X2), Montgomery form (curve_ops.py EdwardsOps.add_mixed)
__device__ __forceinline__ void edw_add_mixed(Pt<ZK_CURVE_TOM>& r, const Pt<ZK_CURVE_TOM>& P,
                                              const Fe tx, const Fe ty, const Fe txy,
                                              const Fe tdt, const Fe tax) {
    const ZkModulus& M = curve_mod<ZK_CURVE_TOM>();
    Fe A, B, C, E, F, G, H, s;
    fe_mont_mul(A, P.c[0], tx, M);
    fe_mont_mul(B, P.c[1], ty, M);
    fe_mont_mul(C, P.c[2], tdt, M);
    fe_add(s, P.c[0], P.c[1], M);
    fe_mont_mul(E, s, txy, M);
    fe_sub(E, E, A, M);
    fe_sub(E, E, B, M);
    fe_sub(F, P.c[3], C, M);
    fe_add(G, P.c[3], C, M);
    fe_mont_mul(s, P.c[0], tax, M);
    fe_sub(H, B, s, M);
    edw_finish<ZK_CURVE_TOM>(r, E, F, G, H, M);
}

template <int CID>
__device__ __forceinline__ void pt_add(Pt<CID>& r, const Pt<CID>& P, const Pt<CID>& Q) {
    if constexpr (CurveT<CID>::C == 4) {
        edw_add<CID>(r, P, Q);
    } else {
        weier_add<CID>(r, P, Q);
    }
}

template <int CID>
__device__ __forceinline__ void pt_dbl(Pt<CID>& r, const Pt<CID>& P) {
    if constexpr (CurveT<CID>::C == 4) {
        edw_dbl<CID>(r, P);
    } else {
        weier_dbl<CID>(r, P);
    }
}

// ---------------------------------------------------------------------------
// Point operations by a team of four lanes.
//
// Four consecutive lanes of a warp compute one point operation.  Each round
// of a formula puts up to four independent Montgomery products on the four
// lanes (lane q takes product q, its operands chosen without a branch) and
// hands every product to every lane with __shfl_sync (width 4), so each
// lane keeps the whole operands and the whole result, and the additions
// between the rounds run on every lane.  The values are the per-thread
// formulas' (every field operation returns the canonical residue), so a
// team's result is bit for bit the per-thread one's.  Rounds on the chain,
// per-thread products -> team rounds: RCB add 14 -> 5, RCB dbl 13 -> 4,
// HWCD add 11 -> 3, HWCD dbl 9 -> 3, HWCD mixed add 9 -> 3.
//
// The result may alias an operand: the operands are read only before the
// result is written.  Every lane of the warp must call a team routine at
// the same point (the exchange names the full warp): a kernel runs idle
// teams on clamped inputs and masks only their stores.
// ---------------------------------------------------------------------------

#define ZK_TEAM 4
#define ZK_WARP_ALL 0xffffffffu

__device__ __forceinline__ int team_lane() { return (int)(threadIdx.x & (ZK_TEAM - 1)); }

// r = lane src's v, for every lane of the team
__device__ __forceinline__ void fe_from_lane(Fe r, const Fe v, int src) {
#pragma unroll
    for (int i = 0; i < ZK_NL; ++i) r[i] = __shfl_sync(ZK_WARP_ALL, v[i], src, ZK_TEAM);
}

// r = (v0, v1, v2, v3)[q], without a branch
__device__ __forceinline__ void fe_pick(Fe r, int q, const Fe v0, const Fe v1, const Fe v2,
                                        const Fe v3) {
    Fe lo, hi;
    fe_select(lo, q & 1, v1, v0);
    fe_select(hi, q & 1, v3, v2);
    fe_select(r, q & 2, hi, lo);
}

// One round: lane q computes x*y; o_k = lane k's product on every lane
__device__ __forceinline__ void team_mul4(Fe o0, Fe o1, Fe o2, Fe o3, const Fe x, const Fe y,
                                          const ZkModulus& M) {
    Fe p;
    fe_mont_mul(p, x, y, M);
    fe_from_lane(o0, p, 0);
    fe_from_lane(o1, p, 1);
    fe_from_lane(o2, p, 2);
    fe_from_lane(o3, p, 3);
}

__device__ __forceinline__ void team_mul3(Fe o0, Fe o1, Fe o2, const Fe x, const Fe y,
                                          const ZkModulus& M) {
    Fe p;
    fe_mont_mul(p, x, y, M);
    fe_from_lane(o0, p, 0);
    fe_from_lane(o1, p, 1);
    fe_from_lane(o2, p, 2);
}

__device__ __forceinline__ void team_mul2(Fe o0, Fe o1, const Fe x, const Fe y,
                                          const ZkModulus& M) {
    Fe p;
    fe_mont_mul(p, x, y, M);
    fe_from_lane(o0, p, 0);
    fe_from_lane(o1, p, 1);
}

// RCB15 complete addition, a = -3 (weier_add's values in 5 rounds)
template <int CID>
__device__ __forceinline__ void team_weier_add(Pt<CID>& r, const Pt<CID>& P, const Pt<CID>& Q) {
    const ZkModulus& M = curve_mod<CID>();
    const uint32_t* b = ZK_COEF[CurveT<CID>::B];
    const int q = team_lane();
    const bool odd = q & 1;
    Fe x, y, m0, m1, m2, sxy, syz, sxz, bm2, bsxz, u, w, zc, xc, v, a0, a3;
    // X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2)
    fe_add(x, P.c[0], P.c[1], M);
    fe_add(y, Q.c[0], Q.c[1], M);
    fe_pick(x, q, P.c[0], P.c[1], P.c[2], x);
    fe_pick(y, q, Q.c[0], Q.c[1], Q.c[2], y);
    team_mul4(m0, m1, m2, sxy, x, y, M);
    // (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)
    fe_select(x, odd, P.c[0], P.c[1]);
    fe_select(y, odd, Q.c[0], Q.c[1]);
    fe_add(x, x, P.c[2], M);
    fe_add(y, y, Q.c[2], M);
    team_mul2(syz, sxz, x, y, M);
    fe_sub(sxy, sxy, m0, M);
    fe_sub(sxy, sxy, m1, M);
    fe_sub(syz, syz, m1, M);
    fe_sub(syz, syz, m2, M);
    fe_sub(sxz, sxz, m0, M);
    fe_sub(sxz, sxz, m2, M);
    // b m2, b sxz, and sxy u with u = 3 (m0 - m2) known already
    fe_sub(u, m0, m2, M);
    fe_mul_small<3>(u, u, M);
    fe_pick(x, q, m2, sxz, sxy, sxy);
    fe_pick(y, q, b, b, u, u);
    team_mul3(bm2, bsxz, a3, x, y, M);  // a3 = sxy u
    fe_sub(w, sxz, bm2, M);
    fe_mul_small<3>(w, w, M);            // w = 3 (sxz - b m2)
    fe_sub(zc, m1, w, M);
    fe_add(xc, m1, w, M);
    fe_mul_small<3>(v, m2, M);
    fe_sub(v, bsxz, v, M);
    fe_sub(v, v, m0, M);
    fe_mul_small<3>(v, v, M);            // v = 3 (b sxz - 3 m2 - m0)
    // sxy xc, syz v, xc zc, u v
    fe_pick(x, q, sxy, syz, xc, u);
    fe_pick(y, q, xc, v, zc, v);
    Fe p0, p1, p2, p3;
    team_mul4(p0, p1, p2, p3, x, y, M);
    // syz zc, the round's one product: every lane computes it
    fe_mont_mul(a0, syz, zc, M);
    fe_sub(r.c[0], p0, p1, M);           // x3 = sxy xc - syz v
    fe_add(r.c[1], p2, p3, M);           // y3 = xc zc + u v
    fe_add(r.c[2], a0, a3, M);           // z3 = syz zc + sxy u
}

// RCB15 doubling, a = -3 (weier_dbl's values in 4 rounds)
template <int CID>
__device__ __forceinline__ void team_weier_dbl(Pt<CID>& r, const Pt<CID>& P) {
    const ZkModulus& M = curve_mod<CID>();
    const uint32_t* b = ZK_COEF[CurveT<CID>::B];
    const int q = team_lane();
    const bool odd = q & 1;
    Fe x, y, xx, yy, zz, xy2, xz2, yz2, bzz, bxz2, z4, w, zc, xc, v, u;
    // XX, YY, ZZ, XY
    fe_pick(x, q, P.c[0], P.c[1], P.c[2], P.c[0]);
    fe_pick(y, q, P.c[0], P.c[1], P.c[2], P.c[1]);
    team_mul4(xx, yy, zz, xy2, x, y, M);
    // YZ, XZ
    fe_select(x, odd, P.c[0], P.c[1]);
    team_mul2(yz2, xz2, x, P.c[2], M);
    fe_add(xy2, xy2, xy2, M);
    fe_add(xz2, xz2, xz2, M);
    fe_add(yz2, yz2, yz2, M);
    // b zz, b xz2, yz2 yy
    fe_pick(x, q, zz, xz2, yz2, yz2);
    fe_pick(y, q, b, b, yy, yy);
    team_mul3(bzz, bxz2, z4, x, y, M);
    fe_sub(w, bzz, xz2, M);
    fe_mul_small<3>(w, w, M);            // w = 3 (b zz - xz2)
    fe_sub(zc, yy, w, M);
    fe_add(xc, yy, w, M);
    fe_mul_small<3>(v, zz, M);
    fe_sub(v, bxz2, v, M);
    fe_sub(v, v, xx, M);
    fe_mul_small<3>(v, v, M);            // v = 3 (b xz2 - 3 zz - xx)
    fe_sub(u, xx, zz, M);
    fe_mul_small<3>(u, u, M);            // u = 3 (xx - zz)
    // xy2 zc, yz2 v, xc zc, u v
    fe_pick(x, q, xy2, yz2, xc, u);
    fe_pick(y, q, zc, v, zc, v);
    Fe p0, p1, p2, p3;
    team_mul4(p0, p1, p2, p3, x, y, M);
    fe_sub(r.c[0], p0, p1, M);           // x3 = xy2 zc - yz2 v
    fe_add(r.c[1], p2, p3, M);           // y3 = xc zc + u v
    fe_mul_small<4>(r.c[2], z4, M);      // z3 = 4 yz2 yy
}

// HWCD08 unified addition (edw_add's values in 3 rounds)
template <int CID>
__device__ __forceinline__ void team_edw_add(Pt<CID>& r, const Pt<CID>& P, const Pt<CID>& Q) {
    const ZkModulus& M = curve_mod<CID>();
    const uint32_t* ca = ZK_COEF[CurveT<CID>::A];
    const uint32_t* cd = ZK_COEF[CurveT<CID>::D];
    const int q = team_lane();
    Fe x, y, A, B, TT, D, E, C, aA, F, G, H;
    // X1X2, Y1Y2, T1T2, Z1Z2
    fe_pick(x, q, P.c[0], P.c[1], P.c[2], P.c[3]);
    fe_pick(y, q, Q.c[0], Q.c[1], Q.c[2], Q.c[3]);
    team_mul4(A, B, TT, D, x, y, M);
    // (X1+Y1)(X2+Y2), d T1T2, a A
    fe_add(x, P.c[0], P.c[1], M);
    fe_add(y, Q.c[0], Q.c[1], M);
    fe_pick(x, q, x, cd, ca, ca);
    fe_pick(y, q, y, TT, A, A);
    team_mul3(E, C, aA, x, y, M);
    fe_sub(E, E, A, M);
    fe_sub(E, E, B, M);
    fe_sub(F, D, C, M);
    fe_add(G, D, C, M);
    fe_sub(H, B, aA, M);
    // E F, G H, E H, F G
    fe_pick(x, q, E, G, E, F);
    fe_pick(y, q, F, H, H, G);
    team_mul4(r.c[0], r.c[1], r.c[2], r.c[3], x, y, M);
}

// HWCD08 doubling (edw_dbl's values in 3 rounds)
template <int CID>
__device__ __forceinline__ void team_edw_dbl(Pt<CID>& r, const Pt<CID>& P) {
    const ZkModulus& M = curve_mod<CID>();
    const uint32_t* ca = ZK_COEF[CurveT<CID>::A];
    const int q = team_lane();
    Fe x, y, A, B, C, E, D, F, G, H;
    // XX, YY, ZZ, (X+Y)^2
    fe_add(x, P.c[0], P.c[1], M);
    fe_pick(x, q, P.c[0], P.c[1], P.c[3], x);
    team_mul4(A, B, C, E, x, x, M);
    fe_add(C, C, C, M);
    // a A, the round's one product: every lane computes it
    fe_mont_mul(D, ca, A, M);
    fe_sub(E, E, A, M);
    fe_sub(E, E, B, M);
    fe_add(G, D, B, M);
    fe_sub(F, G, C, M);
    fe_sub(H, D, B, M);
    // E F, G H, E H, F G
    fe_pick(x, q, E, G, E, F);
    fe_pick(y, q, F, H, H, G);
    team_mul4(r.c[0], r.c[1], r.c[2], r.c[3], x, y, M);
}

// HWCD08 mixed addition against one comb-table entry (X2, Y2, X2+Y2,
// d*T2, a*X2), Montgomery form (edw_add_mixed's values in 3 rounds; the
// second round's one product runs on every lane and does not wait on the
// first).  Lane q holds row q of the entry in `tq` (q < 4), every lane
// holds a*X2 in `tax`.
__device__ __forceinline__ void team_edw_add_mixed(Pt<ZK_CURVE_TOM>& r,
                                                   const Pt<ZK_CURVE_TOM>& P, const Fe tq,
                                                   const Fe tax) {
    const ZkModulus& M = curve_mod<ZK_CURVE_TOM>();
    const int q = team_lane();
    Fe x, y, A, B, S, C, xa, E, F, G, H;
    // X1 X2, Y1 Y2, (X1+Y1)(X2+Y2), T1 d*T2
    fe_add(x, P.c[0], P.c[1], M);
    fe_pick(x, q, P.c[0], P.c[1], x, P.c[2]);
    team_mul4(A, B, S, C, x, tq, M);
    // X1 a*X2
    fe_mont_mul(xa, P.c[0], tax, M);
    fe_sub(E, S, A, M);
    fe_sub(E, E, B, M);
    fe_sub(F, P.c[3], C, M);
    fe_add(G, P.c[3], C, M);
    fe_sub(H, B, xa, M);
    // E F, G H, E H, F G
    fe_pick(x, q, E, G, E, F);
    fe_pick(y, q, F, H, H, G);
    team_mul4(r.c[0], r.c[1], r.c[2], r.c[3], x, y, M);
}

template <int CID>
__device__ __forceinline__ void team_add(Pt<CID>& r, const Pt<CID>& P, const Pt<CID>& Q) {
    if constexpr (CurveT<CID>::C == 4) {
        team_edw_add<CID>(r, P, Q);
    } else {
        team_weier_add<CID>(r, P, Q);
    }
}

template <int CID>
__device__ __forceinline__ void team_dbl(Pt<CID>& r, const Pt<CID>& P) {
    if constexpr (CurveT<CID>::C == 4) {
        team_edw_dbl<CID>(r, P);
    } else {
        team_weier_dbl<CID>(r, P);
    }
}

// Team conversions at a kernel's boundary: lane q converts coordinate q
// (q < C) and the team shares the results.
template <int CID>
__device__ __forceinline__ void team_to_mont(Pt<CID>& r, const uint32_t* g) {
    const ZkModulus& M = curve_mod<CID>();
    constexpr int C = CurveT<CID>::C;
    const int q = team_lane();
    Fe t, m;
    fe_load(t, g + (q < C ? q : 0) * ZK_NL);
    fe_to_mont(m, t, M);
#pragma unroll
    for (int k = 0; k < C; ++k) fe_from_lane(r.c[k], m, k);
}

// r = coordinate q of P for lane q (the last one for q >= C)
template <int CID>
__device__ __forceinline__ void team_coord(Fe r, const Pt<CID>& P) {
    if constexpr (CurveT<CID>::C == 4) {
        fe_pick(r, team_lane(), P.c[0], P.c[1], P.c[2], P.c[3]);
    } else {
        fe_pick(r, team_lane(), P.c[0], P.c[1], P.c[2], P.c[2]);
    }
}

// Coordinate q of P (q < C) in standard form, stored by lane q if `live`.
template <int CID>
__device__ __forceinline__ void team_store(uint32_t* g, const Pt<CID>& P, bool live) {
    const int q = team_lane();
    Fe c;
    team_coord<CID>(c, P);
    fe_from_mont(c, c, curve_mod<CID>());
    if (live && q < CurveT<CID>::C) fe_store(g + q * ZK_NL, c);
}

// The window bases of a comb by a team of four lanes: base k of n is
// 2^(W k) * P, from n - 1 runs of W doublings on one chain, stored in
// standard form at t + pos * C * ZK_NL with pos = n - 1 - k when
// MSB_FIRST (comb4: the position order of nibble digits), else k (comb8:
// byte-digit windows); stores only if `live`.
template <int CID, int W, bool MSB_FIRST>
__device__ __forceinline__ void team_comb_bases(uint32_t* t, const uint32_t* P, int n, bool live) {
    constexpr int PT = CurveT<CID>::C * ZK_NL;
    Pt<CID> b;
    team_to_mont<CID>(b, P);
    team_store<CID>(t + (MSB_FIRST ? n - 1 : 0) * PT, b, live);
#pragma unroll 1
    for (int k = 1; k < n; ++k) {
#pragma unroll 1
        for (int s = 0; s < W; ++s) team_dbl<CID>(b, b);
        team_store<CID>(t + (MSB_FIRST ? n - 1 - k : k) * PT, b, live);
    }
}

// r = c ? P : Q, without a branch
template <int CID>
__device__ __forceinline__ void pt_select(Pt<CID>& r, bool c, const Pt<CID>& P, const Pt<CID>& Q) {
#pragma unroll
    for (int k = 0; k < CurveT<CID>::C; ++k) fe_select(r.c[k], c, P.c[k], Q.c[k]);
}

// canonical standard-form coordinates in device memory <-> Montgomery
template <int CID>
__device__ __forceinline__ void pt_load(Pt<CID>& r, const uint32_t* g) {
    const ZkModulus& M = curve_mod<CID>();
#pragma unroll
    for (int k = 0; k < CurveT<CID>::C; ++k) {
        Fe t;
        fe_load(t, g + k * ZK_NL);
        fe_to_mont(r.c[k], t, M);
    }
}

template <int CID>
__device__ __forceinline__ void pt_store(uint32_t* g, const Pt<CID>& P) {
    const ZkModulus& M = curve_mod<CID>();
#pragma unroll
    for (int k = 0; k < CurveT<CID>::C; ++k) {
        Fe t;
        fe_from_mont(t, P.c[k], M);
        fe_store(g + k * ZK_NL, t);
    }
}

// Montgomery-form copy of a point (for scratch inside one kernel)
template <int CID>
__device__ __forceinline__ void pt_load_raw(Pt<CID>& r, const uint32_t* g) {
#pragma unroll
    for (int k = 0; k < CurveT<CID>::C; ++k) fe_load(r.c[k], g + k * ZK_NL);
}

template <int CID>
__device__ __forceinline__ void pt_store_raw(uint32_t* g, const Pt<CID>& P) {
#pragma unroll
    for (int k = 0; k < CurveT<CID>::C; ++k) fe_store(g + k * ZK_NL, P.c[k]);
}

// Run f(std::integral_constant<int, CID>) for a run-time curve id; the
// callee launches its kernel template for that CID.
template <typename F>
static int zk_dispatch_curve(int curve, F&& f) {
    switch (curve) {
        case ZK_CURVE_P256: f(std::integral_constant<int, ZK_CURVE_P256>{}); return 0;
        case ZK_CURVE_WAR: f(std::integral_constant<int, ZK_CURVE_WAR>{}); return 0;
        case ZK_CURVE_TOM: f(std::integral_constant<int, ZK_CURVE_TOM>{}); return 0;
        default: return (int)cudaErrorInvalidValue;
    }
}
