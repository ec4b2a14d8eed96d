// chord: the prover's phase-B field pass of the point-add sub-proofs, one
// thread per even-round row, all mod the Tom-256 order (ZK_TOM_N, the
// P-256 base prime).  Rows [K, 15, 9] canonical, in the order of
// zkecdsa_tpu_torch/ops/field.py CHORD_IN:
//   t1x t1y pkx pky txv pky_r txr cb0 cb1 cb2 cb3 kx0 kx1 kx2 kx3
// -> [K, 23, 9] canonical:
//   i7 = pkx - t1x, i8 = i7^-1 (0 -> 0), i9 = pky - t1y, i10 = i8 i9,
//   i11 = i10^2, i12 = t1x - txv, i13 = i10 i12   (pointAdd.ts:119-136);
//   ext_vals   x_j y_j (j = 0..3), then kx_j y_j;
//   ext_blinds x_j rb_j, then kx_j rb_j;
// with y = [i8, i9, i10, i12], x = [i7, i8, i10, i10] and
// rb = [cb2, pky_r - cb1, cb3, cb0 - txr].
//
// Replaces zkecdsa_tpu/ops/f32field.py:441 batch_inv and the field pass of
// zkecdsa_tpu/protocol/batch.py:464-493.  The TPU shared one inversion
// over the batch with prefix/suffix product trees; here each thread takes
// its own Fermat inverse (the inverse is unique, so the integers are the
// same, and the rows stay independent).
//
// Bound on the H100: 32-bit integer multiply-adds; 298 products for the
// inverse (field.cuh fe_inv, a 4-bit window) plus 38 products per row,
// against 60 + 92 bytes moved per row.  The function's least work inverts
// the K rows as one batch (3 products a row and one inverse); the per-row
// inverse here is the larger share of the kernel's work.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int NIN = 15;
constexpr int NOUT = 23;

__global__ void chord_kernel(long long K, const uint32_t* __restrict__ in,
                             uint32_t* __restrict__ out) {
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= K) return;
    const ZkModulus& M = ZK_MODS[ZK_TOM_N];
    Fe v[NIN];
#pragma unroll
    for (int s = 0; s < NIN; ++s) {
        Fe t;
        fe_load(t, in + (k * NIN + s) * ZK_NL);
        fe_to_mont(v[s], t, M);
    }
    const uint32_t *t1x = v[0], *t1y = v[1], *pkx = v[2], *pky = v[3], *txv = v[4];
    const uint32_t *pky_r = v[5], *txr = v[6], *cb0 = v[7], *cb1 = v[8], *cb2 = v[9];
    const uint32_t* cb3 = v[10];
    const uint32_t* kx[4] = {v[11], v[12], v[13], v[14]};

    Fe r[NOUT];
    // the intermediates i7..i13 -> r[0..6]
    fe_sub(r[0], pkx, t1x, M);
    fe_inv(r[1], r[0], M);
    fe_sub(r[2], pky, t1y, M);
    fe_mont_mul(r[3], r[1], r[2], M);
    fe_mont_mul(r[4], r[3], r[3], M);
    fe_sub(r[5], t1x, txv, M);
    fe_mont_mul(r[6], r[3], r[5], M);
    const uint32_t* ys[4] = {r[1], r[2], r[3], r[5]};
    const uint32_t* xs[4] = {r[0], r[1], r[3], r[3]};
    Fe rb1, rb3;
    fe_sub(rb1, pky_r, cb1, M);
    fe_sub(rb3, cb0, txr, M);
    const uint32_t* rb[4] = {cb2, rb1, cb3, rb3};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        fe_mont_mul(r[7 + j], xs[j], ys[j], M);
        fe_mont_mul(r[11 + j], kx[j], ys[j], M);
        fe_mont_mul(r[15 + j], xs[j], rb[j], M);
        fe_mont_mul(r[19 + j], kx[j], rb[j], M);
    }
#pragma unroll
    for (int s = 0; s < NOUT; ++s) {
        Fe t;
        fe_from_mont(t, r[s], M);
        fe_store(out + (k * NOUT + s) * ZK_NL, t);
    }
}

}  // namespace

extern "C" int zk_chord(long long K, const void* in, void* out, void* stream) {
    if (K == 0) return 0;
    const int threads = 128;
    const unsigned blocks = (unsigned)((K + threads - 1) / threads);
    chord_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(K, (const uint32_t*)in,
                                                               (uint32_t*)out);
    return (int)cudaGetLastError();
}
