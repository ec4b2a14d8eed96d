// comb8: the fixed-base comb tables of the Pedersen bases, built on the
// card once per parameter set (protocol/batch.py DeviceParams): entry
// [j][d] = d * 2^(8j) * base, 32 windows of 256 multiples, in affine form.
// Replaces zkecdsa_tpu/ops/curve_ops.py:307 comb_table (P-256, the table
// of h) and :666 comb_table_mixed (Tom-256, the tables of g and h), in
// their order, as two entries; each takes a curve id (csrc/curve.cuh):
//
// zk_comb8_bases: bases [R, C, 9] -> window bases [R, 32, C, 9], LSB-first
// (entry j = 2^(8j) * base): a serial chain of 31 runs of eight
// doublings, a group of 16 lanes a base (two to a one-warp block), each
// doubling in 2 rounds of one product a lane (wide_weier_dbl,
// wide_edw_dbl below), the points curve.cuh's formulas' projective
// coordinates.
//
// zk_comb8_entries: window bases [R, 32, C, 9] -> the table, one block of
// 288 threads a (base, window).  The 256 entries live in shared memory in
// Montgomery form (36 KB for Tom-256, 27 KB for P-256).  Index-set
// doubling in seven rounds: round r (k = 2^r) adds m_k to entries 0..k-1,
// entry k + s = entry s + m_k, on eight warps of teams (64 teams of four
// lanes, two entries a team in the last round), while a ninth warp doubles
// m_k into m_2k (m_k = 2^r * base, held in shared memory; comb8_bases'
// doubling), so no round waits on a doubling but the first.  Then every
// entry goes affine by one batch inversion a window: Montgomery's trick as
// a tree over the 256 Z in shared memory (8 levels of products up, one
// inverse of the root, 8 levels down; a zero Z, the P-256 identity, enters
// as one and its inverse is set to 0), the root inverted by
// fe_inv_vartime, a binary extended GCD: the tables are built from the
// parameter set's public bases, so a variable-time inverse is admissible
// here, and nowhere else.  Thread d
// then writes entry d twice, standard form to canon and Montgomery form
// (x * 2^288 mod p) to mont, so the host converts nothing and the comb
// kernels read mont as it stands:
//   * P-256 ([R, 32, 256, 3, 9] each): (x, y, 1), the identity as
//     (0, 1, 0) (Montgomery: (x R, y R, R), (0, R, 0)), the table of
//     comb_weier (WeierComb's two forms);
//   * Tom-256 ([R, 32, 256, 5, 9] each): the mixed-add rows (x, y, x+y,
//     d*x*y, a*x), MixedComb's two forms.
//
// Every field operation returns the canonical residue, so an affine entry
// is the same integers whatever projective representative it came from:
// the tables are the plain version's (ops/curve_ops.py), whose entries
// double entry k/2 where this kernel doubles m_k, and invert each Z apart.
//
// Bound on the H100: 32-bit integer multiply-adds, but the call is far
// from it: at R = 1 or 2 the bases are one or two chains of 248 doublings
// (latency-bound: 496 rounds of one product a lane) and the entries 32 or
// 64 blocks on 132 SMs, each a chain of about 40 rounds (P-256; 24 for
// Tom-256), 17 tree products, one inverse and the output's 3-5 products.
// tools/torch_comb8_probe.py times the inverse's other forms (a Fermat or
// a variable-time inverse a thread, the tree with a Fermat root; its own
// kernel, tools/comb8_probe.cu, built on the phases below) beside the
// kernels before this design (tools/comb8_old.cu).

#include <cuda_runtime.h>

#include "curve.cuh"

namespace {

constexpr int WINDOWS = 32;    // 8-bit windows of a 256-bit scalar
constexpr int ENTRIES = 256;   // multiples 0..255 a window
constexpr int ROUNDS = 7;      // index-set rounds: k = 2, 4, ..., 128
constexpr int MIXED = 5;       // rows of a Tom-256 mixed-add entry
constexpr int ADD_TEAMS = 64;  // teams that add, eight warps
constexpr int DBL_WARP = ADD_TEAMS * ZK_TEAM / 32;  // the warp that doubles m_k
constexpr int ENTRY_THREADS = (DBL_WARP + 1) * 32;

// --- additions without reduction ------------------------------------------

// r = a - b over ZK_NL limbs; returns the borrow (0 or all ones).  The
// asm writes a temporary: r may alias a or b.
__device__ __forceinline__ uint32_t raw_sub(Fe r, const Fe a, const Fe b) {
    uint32_t d[ZK_NL], borrow;
    asm("sub.cc.u32 %0, %10, %19;\n\t"
        "subc.cc.u32 %1, %11, %20;\n\t"
        "subc.cc.u32 %2, %12, %21;\n\t"
        "subc.cc.u32 %3, %13, %22;\n\t"
        "subc.cc.u32 %4, %14, %23;\n\t"
        "subc.cc.u32 %5, %15, %24;\n\t"
        "subc.cc.u32 %6, %16, %25;\n\t"
        "subc.cc.u32 %7, %17, %26;\n\t"
        "subc.cc.u32 %8, %18, %27;\n\t"
        "subc.u32 %9, 0, 0;"
        : ZK_O9(d), "=r"(borrow)
        : ZK_L9(a), ZK_L9(b));
    fe_copy(r, d);
    return borrow;
}

// Additions between a doubling's two rounds leave their sums unreduced,
// below 2^8 p: fe_mont_mul's result is canonical for a b < p 2^288 (its
// last subtraction needs a value below 2p), so a product takes them as
// they are, and its result is reduced.  lz_add r = a + b;
// lz_sub r = a + (k - b) for a multiple k of p above b; lz_shl r = a 2^s
// (each may alias its inputs).
__device__ __forceinline__ void lz_add(Fe r, const Fe a, const Fe b) {
    uint32_t t[ZK_NL];
    asm("add.cc.u32 %0, %9, %18;\n\t"
        "addc.cc.u32 %1, %10, %19;\n\t"
        "addc.cc.u32 %2, %11, %20;\n\t"
        "addc.cc.u32 %3, %12, %21;\n\t"
        "addc.cc.u32 %4, %13, %22;\n\t"
        "addc.cc.u32 %5, %14, %23;\n\t"
        "addc.cc.u32 %6, %15, %24;\n\t"
        "addc.cc.u32 %7, %16, %25;\n\t"
        "addc.u32 %8, %17, %26;"
        : ZK_O9(t)
        : ZK_L9(a), ZK_L9(b));
    fe_copy(r, t);
}

__device__ __forceinline__ void lz_shl(Fe r, const Fe a, int s) {
#pragma unroll
    for (int j = ZK_NL - 1; j > 0; --j) r[j] = __funnelshift_l(a[j - 1], a[j], s);
    r[0] = a[0] << s;
}

__device__ __forceinline__ void lz_sub(Fe r, const Fe a, const Fe b, const Fe k) {
    Fe d;
    raw_sub(d, k, b);
    lz_add(r, a, d);
}

// --- doublings on 16 lanes, 2 rounds each ---------------------------------
//
// A chain of comb8_bases (and comb8_entries' m_k) runs alone on its SM, so
// it spends lanes on depth: a group of 16 lanes doubles in 2 rounds of one
// product a lane (curve.cuh's team of four takes 3-4, and a round with two
// products on a lane runs as long as two rounds).  The chain carries one
// product beside the point, k = b Z (P-256) or a X (Tom-256), so that every
// product of the first round reads only the operands: b zz = (b Z) Z, b xz
// = (b Z) X, a A = (a X) X; the second round also makes the next k (b Z3 =
// 2 (b Z Y) 4 Y^2, a X3 = (a E) F with a E = 2 (a X) Y), and folds the
// factor 4 of Z3 into its product.  Between the rounds the sums stay
// unreduced (lz_*).  Every value is the field element curve.cuh's formula
// makes; the products reduce fully, and X3, Y3 of P-256 (below 2p) are
// reduced where they leave the chain, so the points are its projective
// coordinates, bit for bit.

constexpr int WIDE = 16;           // lanes a chain
constexpr int CHAINS = 32 / WIDE;  // chains (bases) a one-warp block of comb8_bases

__device__ __forceinline__ int wide_lane() { return (int)(threadIdx.x & (WIDE - 1)); }

// r = lane src's v, for every lane of the group
__device__ __forceinline__ void fe_from_wide(Fe r, const Fe v, int src) {
#pragma unroll
    for (int i = 0; i < ZK_NL; ++i) r[i] = __shfl_sync(ZK_WARP_ALL, v[i], src, WIDE);
}

// 2-bit field q of a packed operand code (0 past its end)
__device__ __forceinline__ int code_of(uint32_t code, int q) { return (int)((code >> (2 * q)) & 3u); }

__host__ __device__ constexpr uint32_t codes(int c0, int c1, int c2, int c3, int c4, int c5, int c6 = 0,
                                             int c7 = 0, int c8 = 0) {
    return (uint32_t)(c0 | c1 << 2 | c2 << 4 | c3 << 6 | c4 << 8 | c5 << 10 | c6 << 12 | c7 << 14 |
                      c8 << 16);
}

// the chain's carried product k of P, on every lane
template <int CID>
__device__ __forceinline__ void wide_carry(Fe k, const Pt<CID>& P) {
    const ZkModulus& M = curve_mod<CID>();
    if constexpr (CurveT<CID>::C == 4) {
        fe_mont_mul(k, ZK_COEF[CurveT<CID>::A], P.c[0], M);  // a X
    } else {
        fe_mont_mul(k, ZK_COEF[CurveT<CID>::B], P.c[2], M);  // b Z
    }
}

// RCB15 doubling, a = -3 (weier_dbl's values), with bz = b Z carried; X, Y
// in and out below 2p, Z and bz canonical
template <int CID>
__device__ __forceinline__ void wide_weier_dbl(Pt<CID>& P, Fe bz) {
    const ZkModulus& M = curve_mod<CID>();
    const int q = wide_lane();
    Fe x, y, p, xx, yy, zz, xy2, xz2, yz2, bzz, bxz2, bzy2, yy4, w, zc, xc, v, u, kp;
    // lanes 0..8: XX, YY, ZZ, XY, XZ, YZ, (bZ) Z, (bZ) X, (bZ) Y
    constexpr uint32_t XC = codes(0, 1, 2, 0, 0, 1, 3, 3, 3);  // X Y Z bZ
    constexpr uint32_t YC = codes(0, 1, 2, 1, 2, 2, 2, 0, 1);  // X Y Z
    fe_pick(x, code_of(XC, q), P.c[0], P.c[1], P.c[2], bz);
    fe_pick(y, code_of(YC, q), P.c[0], P.c[1], P.c[2], P.c[2]);
    fe_mont_mul(p, x, y, M);
    fe_from_wide(xx, p, 0);
    fe_from_wide(yy, p, 1);
    fe_from_wide(zz, p, 2);
    fe_from_wide(xy2, p, 3);
    fe_from_wide(xz2, p, 4);
    fe_from_wide(yz2, p, 5);
    fe_from_wide(bzz, p, 6);
    fe_from_wide(bxz2, p, 7);
    fe_from_wide(bzy2, p, 8);
    lz_shl(xy2, xy2, 1);                  // < 2p, as the next four
    lz_shl(xz2, xz2, 1);
    lz_shl(yz2, yz2, 1);
    lz_shl(bxz2, bxz2, 1);
    lz_shl(bzy2, bzy2, 1);
    lz_shl(yy4, yy, 2);                   // < 4p
    lz_shl(kp, M.p, 1);
    lz_sub(w, bzz, xz2, kp);              // b zz - xz2 + 2p < 3p
    lz_shl(x, w, 1);
    lz_add(w, x, w);                      // w = 3 (b zz - xz2) (+ 6p) < 9p
    lz_shl(kp, M.p, 4);
    lz_sub(zc, yy, w, kp);                // zc = yy - w (+ 16p) < 17p
    lz_add(xc, yy, w);                    // xc = yy + w < 10p
    lz_shl(x, zz, 1);
    lz_add(x, x, zz);                     // 3 zz < 3p
    lz_shl(kp, M.p, 2);
    lz_sub(v, bxz2, x, kp);               // b xz2 - 3 zz + 4p, in (p, 6p)
    raw_sub(v, v, xx);                     // - xx: in (0, 6p)
    lz_shl(x, v, 1);
    lz_add(v, x, v);                      // v = 3 (b xz2 - 3 zz - xx) (+ 12p) < 18p
    lz_sub(u, xx, zz, M.p);               // xx - zz + p < 2p
    lz_shl(x, u, 1);
    lz_add(u, x, u);                      // u = 3 (xx - zz) (+ 3p) < 6p
    // lanes 0..5: xy2 zc, yz2 v, xc zc, u v, yz2 (4 yy), (2 b Z Y) (4 yy)
    fe_pick(x, q & 3, xy2, yz2, xc, u);
    fe_select(w, q & 1, bzy2, yz2);
    fe_select(x, q >= 4, w, x);
    fe_pick(y, q & 3, zc, v, zc, v);
    fe_select(y, q >= 4, yy4, y);
    fe_mont_mul(p, x, y, M);
    fe_from_wide(x, p, 0);
    fe_from_wide(y, p, 1);
    lz_sub(P.c[0], x, y, M.p);            // x3 = xy2 zc - yz2 v (+ p) < 2p
    fe_from_wide(x, p, 2);
    fe_from_wide(y, p, 3);
    lz_add(P.c[1], x, y);                 // y3 = xc zc + u v < 2p
    fe_from_wide(P.c[2], p, 4);           // z3 = 4 yz2 yy
    fe_from_wide(bz, p, 5);               // b z3
}

// HWCD08 doubling (edw_dbl's values), with ax = a X carried; everything
// canonical in and out
template <int CID>
__device__ __forceinline__ void wide_edw_dbl(Pt<CID>& P, Fe ax) {
    const ZkModulus& M = curve_mod<CID>();
    const int q = wide_lane();
    Fe x, y, p, A, B, C, D, E, aE, F, G, H, kp;
    // lanes 0..5: XX, YY, ZZ, XY, (aX) X, (aX) Y
    constexpr uint32_t XC = codes(0, 1, 2, 0, 3, 3);  // X Y Z aX
    constexpr uint32_t YC = codes(0, 1, 2, 1, 0, 1);  // X Y Z
    fe_pick(x, code_of(XC, q), P.c[0], P.c[1], P.c[3], ax);
    fe_pick(y, code_of(YC, q), P.c[0], P.c[1], P.c[3], P.c[3]);
    fe_mont_mul(p, x, y, M);
    fe_from_wide(A, p, 0);
    fe_from_wide(B, p, 1);
    fe_from_wide(C, p, 2);
    fe_from_wide(E, p, 3);
    fe_from_wide(D, p, 4);                // D = a A
    fe_from_wide(aE, p, 5);
    lz_shl(C, C, 1);                      // C = 2 ZZ < 2p
    lz_shl(E, E, 1);                      // E = (X+Y)^2 - A - B = 2 XY < 2p
    lz_shl(aE, aE, 1);
    lz_add(G, D, B);                      // < 2p
    lz_shl(kp, M.p, 1);
    lz_sub(F, G, C, kp);                  // F = G - C (+ 2p) < 4p
    lz_sub(H, D, B, M.p);                 // H = D - B (+ p) < 2p
    // lanes 0..4: E F, G H, E H, F G, (a E) F
    fe_pick(x, q & 3, E, G, E, F);
    fe_select(x, q >= 4, aE, x);
    fe_pick(y, q & 3, F, H, H, G);
    fe_select(y, q >= 4, F, y);
    fe_mont_mul(p, x, y, M);
    fe_from_wide(P.c[0], p, 0);
    fe_from_wide(P.c[1], p, 1);
    fe_from_wide(P.c[2], p, 2);
    fe_from_wide(P.c[3], p, 3);
    fe_from_wide(ax, p, 4);               // a x3
}

template <int CID>
__device__ __forceinline__ void comb8_dbl(Pt<CID>& P, Fe k) {
    if constexpr (CurveT<CID>::C == 4) {
        wide_edw_dbl<CID>(P, k);
    } else {
        wide_weier_dbl<CID>(P, k);
    }
}

// P's coordinates canonical (wide_weier_dbl leaves X, Y below 2p)
template <int CID>
__device__ __forceinline__ void wide_canon(Pt<CID>& P) {
    if constexpr (CurveT<CID>::C == 3) {
        const ZkModulus& M = curve_mod<CID>();
        fe_reduce_once(P.c[0], P.c[0], 0u, M);
        fe_reduce_once(P.c[1], P.c[1], 0u, M);
    }
}

// --- a variable-time inverse, for public data only -----------------------

// x = x / 2^t mod p for 1 <= t <= 32 (x canonical, standard form): add the
// multiple m p (m < 2^t) that clears the low t bits, then shift; the sum
// is below 2^t p + p, so the quotient is below 2p.
__device__ __forceinline__ void fe_div_2k(Fe x, int t, const ZkModulus& M) {
    const uint32_t m = (x[0] * M.pinv) & (0xffffffffu >> (32 - t));
    uint32_t s[ZK_NL + 1], r[ZK_NL];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < ZK_NL; ++j) {
        c += (uint64_t)m * M.p[j] + x[j];
        s[j] = (uint32_t)c;
        c >>= 32;
    }
    s[ZK_NL] = (uint32_t)c;
#pragma unroll
    for (int j = 0; j < ZK_NL; ++j) r[j] = __funnelshift_rc(s[j], s[j + 1], t);
    fe_reduce_once(x, r, __funnelshift_rc(s[ZK_NL], 0u, t), M);
}

// u = u / 2^t with x = x / 2^t mod p, for the t trailing zeros of u != 0
// (u = 0 ends after ZK_NL limbs, unchanged)
__device__ __forceinline__ void vt_strip(Fe u, Fe x, const ZkModulus& M) {
#pragma unroll 1
    for (int i = 0; i < ZK_NL && u[0] == 0u; ++i) {
#pragma unroll
        for (int j = 0; j < ZK_NL - 1; ++j) u[j] = u[j + 1];
        u[ZK_NL - 1] = 0u;
        fe_div_2k(x, 32, M);
    }
    const int t = __ffs(u[0]) - 1;
    if (t > 0) {
#pragma unroll
        for (int j = 0; j < ZK_NL - 1; ++j) u[j] = __funnelshift_r(u[j], u[j + 1], t);
        u[ZK_NL - 1] >>= t;
        fe_div_2k(x, t, M);
    }
}

// Iteration limit of fe_inv_vartime: each pass drops at least one bit of
// u or v, which start at most 2 * 9 * 32 bits long together.
constexpr int VT_LIMIT = 2 * ZK_NL * 32;

// r = a^-1 mod p in standard form, for a canonical nonzero a in standard
// form.  VARIABLE TIME: the loop's length and branches follow a, so it
// takes public data only (the comb tables of the parameter set's bases);
// every inverse of a value derived from a witness keeps fe_inv.  A binary
// extended GCD, with x1 a = u and x2 a = v (mod p) throughout: from u = a,
// v = p (both odd once u is stripped of its trailing zeros), subtract the
// smaller from the larger and strip the difference, until u = v = 1; then
// x1 = a^-1.  Stops after VT_LIMIT passes (at most 514 are needed for a
// 258-bit p; tests/test_torch_comb8.py checks the count on a model).
__device__ __forceinline__ void fe_inv_vartime(Fe r, const Fe a, const ZkModulus& M) {
    Fe u, v, x1, x2, d;
    fe_copy(u, a);
    fe_copy(v, M.p);
    fe_set_zero(x1);
    x1[0] = 1u;
    fe_set_zero(x2);
    vt_strip(u, x1, M);
#pragma unroll 1
    for (int it = 0; it < VT_LIMIT; ++it) {
        if (raw_sub(d, u, v) == 0u) {  // u >= v
            if (fe_is_zero(d)) break;  // u = v = gcd = 1
            fe_copy(u, d);
            fe_sub(x1, x1, x2, M);
            vt_strip(u, x1, M);
        } else {
            raw_sub(v, v, u);
            fe_sub(x2, x2, x1, M);
            vt_strip(v, x2, M);
        }
    }
    fe_copy(r, x1);
}

// r = a^-1 in Montgomery form (a Montgomery, nonzero), by fe_inv_vartime
__device__ __forceinline__ void fe_inv_vartime_mont(Fe r, const Fe a, const ZkModulus& M) {
    Fe t;
    fe_from_mont(t, a, M);
    fe_inv_vartime(t, t, M);
    fe_to_mont(r, t, M);
}

// --- the kernels -----------------------------------------------------------

template <int CID>
__global__ void __launch_bounds__(32) comb8_bases_kernel(
    long long R, const uint32_t* __restrict__ P, uint32_t* __restrict__ bases) {
    constexpr int PT = CurveT<CID>::C * ZK_NL;
    const long long r0 = (long long)blockIdx.x * CHAINS + threadIdx.x / WIDE;
    // a group past R runs base R-1 and stores nothing
    const bool live = r0 < R;
    const long long r = live ? r0 : R - 1;
    uint32_t* t = bases + r * WINDOWS * PT;
    Pt<CID> b;
    Fe k;
    team_to_mont<CID>(b, P + r * PT);  // every team of the group loads the base
    team_store<CID>(t, b, live);  // each team of the group stores the same
    wide_carry<CID>(k, b);
#pragma unroll 1
    for (int j = 1; j < WINDOWS; ++j) {
#pragma unroll 1
        for (int s = 0; s < 8; ++s) comb8_dbl<CID>(b, k);
        team_store<CID>(t + j * PT, b, live);
    }
}

// Montgomery product of two nodes of the inversion tree in shared memory
__device__ __forceinline__ void node_mul(Fe r, const uint32_t* a, const uint32_t* b,
                                         const ZkModulus& M) {
    Fe x, y;
    fe_load(x, a);
    fe_load(y, b);
    fe_mont_mul(r, x, y, M);
}

// The index-set rounds of one window (base: its window base, standard
// form): entries 0..255 into E, Montgomery form, m_k = 2^r * base into
// Mk[r * PT]; the block is in step when it returns.
template <int CID>
__device__ __forceinline__ void entries_rounds(const uint32_t* base, uint32_t* E, uint32_t* Mk) {
    constexpr int C = CurveT<CID>::C;
    constexpr int PT = C * ZK_NL;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int team = tid / ZK_TEAM;
    Pt<CID> a, m;
    Fe c;
    Fe km;  // the doubling warp's carried product
    if (warp == DBL_WARP) {  // both groups of the warp hold m; lane 0 stores
        team_to_mont<CID>(m, base);
        wide_carry<CID>(km, m);
        if (tid % 32 == 0) {
            pt_identity<CID>(a);
            pt_store_raw<CID>(E, a);
            pt_store_raw<CID>(E + PT, m);
        }
        comb8_dbl<CID>(m, km);
        wide_canon<CID>(m);
        if (tid % 32 == 0) pt_store_raw<CID>(Mk + PT, m);
    }
    __syncthreads();
#pragma unroll 1
    for (int r = 1; r <= ROUNDS; ++r) {
        const int k = 1 << r;
        if (warp < DBL_WARP) {
            // teams s < k add (every team of a warp with a live one runs,
            // a team past k on entry k - 1, storing nothing)
            if (warp * (32 / ZK_TEAM) < k) {
                Pt<CID> mk;
                pt_load_raw<CID>(mk, Mk + r * PT);
                const int passes = (k + ADD_TEAMS - 1) / ADD_TEAMS;
#pragma unroll 1
                for (int j = 0; j < passes; ++j) {
                    const int s = team + j * ADD_TEAMS;
                    const bool live = s < k;
                    pt_load_raw<CID>(a, E + (live ? s : k - 1) * PT);
                    team_add<CID>(a, a, mk);
                    team_coord<CID>(c, a);
                    if (live && team_lane() < C) fe_store(E + (k + s) * PT + team_lane() * ZK_NL, c);
                }
            }
        } else if (r < ROUNDS) {
            comb8_dbl<CID>(m, km);  // m_2k, for the next round
            wide_canon<CID>(m);
            if (tid % 32 == 0) pt_store_raw<CID>(Mk + (r + 1) * PT, m);
        }
        __syncthreads();
    }
}

// Entry s of E (Montgomery form) into a; z its Z, or one for a zero Z (the
// P-256 identity), which is returned as true
template <int CID>
__device__ __forceinline__ bool entry_z(Pt<CID>& a, Fe z, const uint32_t* E, int s) {
    constexpr int C = CurveT<CID>::C;
    pt_load_raw<CID>(a, E + s * C * ZK_NL);
    const bool inf = fe_is_zero(a.c[C - 1]);
    fe_select(z, inf, curve_mod<CID>().one, a.c[C - 1]);
    return inf;
}

// The window's batch inversion, in E once every entry is read: node n's
// children are 2n and 2n + 1, the leaves 256 + s hold the Z; the products
// (nodes 1..511) from E, the inverses (nodes 1..255) from E + TREE_I.
// tree_up enters thread s's z (s < 256) and multiplies up to the root
// (node 1); the caller stores the root's inverse at node 1 of the
// inverses, brings the block in step and calls tree_down, which gives
// thread s the inverse of leaf s.
constexpr int TREE_I = 2 * ENTRIES * ZK_NL;

__device__ __forceinline__ void tree_up(uint32_t* E, const Fe z, const ZkModulus& M) {
    const int tid = threadIdx.x;
    Fe t;
    __syncthreads();
    if (tid < ENTRIES) fe_store(E + (ENTRIES + tid) * ZK_NL, z);
    __syncthreads();
#pragma unroll 1
    for (int n = ENTRIES / 2; n >= 1; n /= 2) {
        if (tid < n) {
            const int v = n + tid;
            node_mul(t, E + 2 * v * ZK_NL, E + (2 * v + 1) * ZK_NL, M);
            fe_store(E + v * ZK_NL, t);
        }
        __syncthreads();
    }
}

__device__ __forceinline__ void tree_down(uint32_t* E, Fe zi, const ZkModulus& M) {
    const int tid = threadIdx.x;
    uint32_t* I = E + TREE_I;
    // the inverse of node v is the parent's times the sibling's product
#pragma unroll 1
    for (int n = 2; n < ENTRIES; n *= 2) {
        if (tid < n) {
            const int v = n + tid;
            node_mul(zi, I + (v / 2) * ZK_NL, E + (v ^ 1) * ZK_NL, M);
            fe_store(I + v * ZK_NL, zi);
        }
        __syncthreads();
    }
    const int v = ENTRIES + (tid < ENTRIES ? tid : 0);
    node_mul(zi, I + (v / 2) * ZK_NL, E + (v ^ 1) * ZK_NL, M);
}

// Entry n of the table (n = window * 256 + s) from its projective a and
// zi = Z^-1 (any value for the identity, inf), in both forms
template <int CID>
__device__ __forceinline__ void entries_store(const Pt<CID>& a, const Fe zi_in, bool inf, long long n,
                                              uint32_t* __restrict__ canon, uint32_t* __restrict__ mont) {
    constexpr int C = CurveT<CID>::C;
    const ZkModulus& M = curve_mod<CID>();
    Fe x, y, t, zi, zero;
    fe_set_zero(zero);
    fe_select(zi, inf, zero, zi_in);
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
        uint32_t* oc = canon + n * MIXED * ZK_NL;
        uint32_t* om = mont + n * MIXED * ZK_NL;
#pragma unroll
        for (int k = 0; k < MIXED; ++k) {
            fe_store(om + k * ZK_NL, row[k]);
            fe_from_mont(t, row[k], M);
            fe_store(oc + k * ZK_NL, t);
        }
    } else {
        constexpr int PT = C * ZK_NL;
        Fe one;
        fe_set_zero(one);
        one[0] = 1u;  // standard form
        uint32_t* oc = canon + n * PT;
        uint32_t* om = mont + n * PT;
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

template <int CID>
__global__ void __launch_bounds__(ENTRY_THREADS) comb8_entries_kernel(
    const uint32_t* __restrict__ bases, uint32_t* __restrict__ canon, uint32_t* __restrict__ mont) {
    constexpr int PT = CurveT<CID>::C * ZK_NL;
    __shared__ uint32_t E[ENTRIES * PT];       // the window's entries, Montgomery form
    __shared__ uint32_t Mk[(ROUNDS + 1) * PT];  // m_k = 2^r * base, k = 2^r
    const ZkModulus& M = curve_mod<CID>();
    const long long w = blockIdx.x;  // (base, window)
    const int tid = threadIdx.x;
    entries_rounds<CID>(bases + w * PT, E, Mk);
    // entry s to affine: zi = Z^-1 by the window's tree, its root by the
    // variable-time inverse
    Pt<CID> a;
    Fe z, zi;
    const bool inf = entry_z<CID>(a, z, E, tid < ENTRIES ? tid : 0);
    tree_up(E, z, M);
    if (tid == 0) {
        fe_load(z, E + ZK_NL);
        fe_inv_vartime_mont(z, z, M);
        fe_store(E + TREE_I + ZK_NL, z);
    }
    __syncthreads();
    tree_down(E, zi, M);
    if (tid < ENTRIES) entries_store<CID>(a, zi, inf, w * ENTRIES + tid, canon, mont);
}

unsigned grid_for(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

}  // namespace

extern "C" int zk_comb8_bases(int curve, long long R, const void* P, void* bases, void* stream) {
    if (R == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        comb8_bases_kernel<CID><<<grid_for(R, CHAINS), 32, 0, st>>>(
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
        comb8_entries_kernel<CID><<<(unsigned)(R * WINDOWS), ENTRY_THREADS, 0, st>>>(
            (const uint32_t*)bases, (uint32_t*)canon, (uint32_t*)mont);
    });
    return bad ? bad : (int)cudaGetLastError();
}
