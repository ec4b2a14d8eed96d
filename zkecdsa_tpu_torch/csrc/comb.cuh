// Shared pieces of the comb kernels (comb.cu, comb4.cu): a row's digits
// read 16 bytes at a time (also ladder.cu's bit bytes), and the P-256 comb
// scan of one row by a team of four lanes or by one lane.
#pragma once

#include <cuda_runtime.h>

#include "curve.cuh"

// Threads of a comb block (ops/curve_ops.py _COMB_THREADS): 32 rows of a
// team of four lanes, or 128 rows of one lane.
constexpr int COMB_THREADS = 128;

// A row's digit bytes, 16 at a time: one 16-byte load every 16 windows;
// each window takes the low byte and shifts the 128-bit queue down by 8
// (no indexing into registers, no unrolled windows).  The row starts on a
// 16-byte boundary and its windows are taken in order from 0.  Byte j is
// window j's digit: an LSB-first byte of the scalar for the 8-bit combs
// (comb_mixed, comb_weier), an MSB-first nibble for comb4, an MSB-first
// bit for msm_ladder.
struct Digits {
    const uint4* src;
    uint32_t w0, w1, w2, w3;

    __device__ __forceinline__ int next(int j) {
        if ((j & 15) == 0) {
            const uint4 v = __ldg(src + (j >> 4));
            w0 = v.x;
            w1 = v.y;
            w2 = v.z;
            w3 = v.w;
        }
        const int d = (int)(w0 & 0xffu);
        w0 = __funnelshift_r(w0, w1, 8);
        w1 = __funnelshift_r(w1, w2, 8);
        w2 = __funnelshift_r(w2, w3, 8);
        w3 >>= 8;
        return d;
    }
};

// One row of a P-256 comb: acc = T[0][d_0] + T[1][d_1] + ... + T[n-1][d_{n-1}]
// from the identity, complete RCB15 adds in window order, stored at `out`
// in standard form (if `live`).  `tab` is the row's table in Montgomery
// form, entry (j, d) at (j * E + d) * 27 limbs, read as it stands;
// `digits` the row's n digit bytes (16-byte aligned).
//   * LANES = 4: the calling team runs each add (team_weier_add: 5 rounds
//     on the chain instead of 14 products).  Every lane loads the whole
//     108-byte entry (27 words; the four lanes of a team read the same
//     addresses, one request), the next window's while the current add
//     runs, so no exchange is spent on the entry.  Measured on the H100
//     (tools/torch_comb_probe.py): lane q loading coordinate q and the
//     team sharing the three by 27 shuffles ran 16-20% slower at both
//     prover calls, and a cap of 128 registers (four blocks an SM, not
//     three) 6-8% slower, with spills.
//   * LANES = 1: one thread, weier_add (14 products), no loads ahead:
//     the rows of other warps hide the latency.
// The caller passes n at run time: with the trip count a compile-time
// constant the same scan ran 8-14% slower (the probe's whole_const).
// A team's result is bit for bit the lane's (curve.cuh).
template <int LANES, int E>
__device__ __forceinline__ void comb_weier_row(uint32_t* out, const uint32_t* __restrict__ tab,
                                               const uint8_t* digits, int n, bool live) {
    constexpr int CID = ZK_CURVE_P256;
    constexpr int PT = 3 * ZK_NL;
    Digits dg{reinterpret_cast<const uint4*>(digits)};
    Pt<CID> acc, e;
    pt_identity<CID>(acc);
    if constexpr (LANES == 1) {
        Pt<CID> t;
        for (int j = 0; j < n; ++j) {
            pt_load_raw<CID>(e, tab + ((long long)j * E + dg.next(j)) * PT);
            weier_add<CID>(t, acc, e);
            acc = t;
        }
        pt_store<CID>(out, acc);
    } else {
        Pt<CID> nx;
        pt_load_raw<CID>(e, tab + (long long)dg.next(0) * PT);
#pragma unroll 1
        for (int j = 0; j < n; ++j) {
            const bool more = j + 1 < n;
            if (more) {  // the next window's entry, loaded ahead
                pt_load_raw<CID>(nx, tab + ((long long)(j + 1) * E + dg.next(j + 1)) * PT);
            }
            team_weier_add<CID>(acc, acc, e);
            if (more) e = nx;
        }
        team_store<CID>(out, acc, live);
    }
}
