// Pippenger bucket MSM per row, in two kernels (the caller,
// zkecdsa_tpu_torch/ops/msm_bucket.py, counts them apart):
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
// Design.  bucket_sums runs one block per (row, window) and one thread per
// bucket.  The block copies its digit column to shared memory; each thread
// counts its bucket's terms, thread 0 turns the counts into offsets, and each
// thread writes its terms' indices, in term order, into its slice of a list
// in shared memory.  Thread b then adds the points of its slice, so the
// lanes of a warp run one loop body with different trip counts: a warp costs
// its largest bucket, not the sum of its buckets (as a scan of the digits
// with a branch per term would).  The TPU kernel's host chunk layout, static
// chunk count K and its overflow are gone: a list holds any count.
//
// The skew: at w = 5 the top window holds one real bit (D*w = 260), so its
// bucket 1 takes about T/2 terms against T/32 elsewhere; at w = 6, 15
// buckets of T/16 against T/64, and the lanes of buckets 16..63 idle.  A
// block whose largest digit is below nb = B/L (L > 1, a power of two) gives
// each bucket c < nb the L lanes c, c + nb, c + 2nb, ...: each adds every
// L-th term of the bucket's slice, and a tree over shared memory (log2 L
// steps) sums the L pieces.  So the top window runs a chain of about T/2L
// adds, and every other window, whose digits reach B-1, keeps L = 1.
//
// bucket_fold runs one block per row and one thread per window: running sums
// from the top bucket down (run += S_b; acc += run: 2(B-1) adds) into shared
// memory, then thread 0 folds the D windows.
//
// Bound on the H100: 32-bit integer multiply-adds (a Tom-256 add is 11
// Montgomery products, a P-256 add 14, plus C to-Montgomery products per
// loaded point).  bucket_fold's thread 0 runs a dependent chain of 256
// doublings per row, the same chain a Straus row pays.

#include <cuda_runtime.h>

#include "curve.cuh"

// shared memory of one bucket_sums block: B pieces (when a bucket is split
// over lanes), B+1 list offsets and the lane split, the [T] list and the [T]
// digit column
template <int CID>
static size_t bucket_sums_smem(long long T, int B) {
    return (size_t)B * sizeof(Pt<CID>) + (size_t)(B + 2) * sizeof(int) +
           (size_t)T * (sizeof(uint16_t) + 1);
}

template <int CID>
__global__ void bucket_sums_kernel(long long N, long long T, int D, int B,
                                   const uint32_t* __restrict__ points,
                                   const uint8_t* __restrict__ digits,
                                   uint32_t* __restrict__ sums) {
    extern __shared__ __align__(16) unsigned char smem[];
    Pt<CID>* piece = (Pt<CID>*)smem;             // [B] Montgomery form
    int* offs = (int*)(piece + B);               // [B + 1], then the lane split L
    uint16_t* list = (uint16_t*)(offs + B + 2);  // [T]
    uint8_t* dig = (uint8_t*)(list + T);         // [T]
    constexpr int C = CurveT<CID>::C;
    constexpr long long PT = (long long)C * ZK_NL;  // limbs per point
    const long long row = blockIdx.x % N;
    const int d = (int)(blockIdx.x / N);
    const int b = threadIdx.x;
    const uint8_t* g = digits + (row * D + d) * T;
    for (long long t = b; t < T; t += B) dig[t] = g[t];
    __syncthreads();

    int cnt = 0;
    for (long long t = 0; t < T; ++t) cnt += (dig[t] == b);
    offs[b] = cnt;
    __syncthreads();
    if (b == 0) {
        int run = 0, top = 0;
        for (int k = 0; k < B; ++k) {
            const int c = offs[k];
            offs[k] = run;
            run += c;
            if (c) top = k;
        }
        offs[B] = run;  // = T
        int L = 1;      // lanes per bucket: B/L buckets still hold every digit
        while (L < B && top < B / (2 * L)) L *= 2;
        offs[B + 1] = L;
    }
    __syncthreads();
    if (b != 0) {
        int o = offs[b];
        for (long long t = 0; t < T; ++t)
            if (dig[t] == b) list[o++] = (uint16_t)t;
    }
    __syncthreads();

    const int L = offs[B + 1], nb = B / L;
    const int c = b % nb, j = b / nb;  // lane b adds every L-th term of bucket c
    const uint32_t* pts = points + row * T * PT;
    Pt<CID> acc, P, tmp;
    pt_identity<CID>(acc);
    if (c != 0) {  // bucket 0 contributes nothing: it stays the identity
        for (int k = offs[c] + j; k < offs[c + 1]; k += L) {
            pt_load<CID>(P, pts + (long long)list[k] * PT);
            pt_add<CID>(tmp, acc, P);
            acc = tmp;
        }
    }
    if (L > 1) {  // the same for the whole block
        piece[b] = acc;
        for (int h = L / 2; h >= 1; h /= 2) {
            __syncthreads();
            if (j < h) {
                pt_add<CID>(tmp, piece[b], piece[b + h * nb]);
                piece[b] = tmp;
            }
        }
        if (j == 0) acc = piece[b];
        else pt_identity<CID>(acc);  // bucket b >= nb is empty
    }
    pt_store<CID>(sums + ((row * D + d) * (long long)B + b) * PT, acc);
}

template <int CID>
__global__ void bucket_fold_kernel(long long N, int D, int B, int window,
                                   const uint32_t* __restrict__ sums,
                                   uint32_t* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    Pt<CID>* W = (Pt<CID>*)smem;  // [D] window sums, Montgomery form
    constexpr int C = CurveT<CID>::C;
    constexpr long long PT = (long long)C * ZK_NL;
    const long long row = blockIdx.x;
    const int d = threadIdx.x;
    Pt<CID> run, acc, S, tmp;
    pt_identity<CID>(run);
    pt_identity<CID>(acc);
    const uint32_t* s = sums + (row * D + d) * B * PT;
    for (int b = B - 1; b >= 1; --b) {
        pt_load<CID>(S, s + b * PT);
        pt_add<CID>(tmp, run, S);
        run = tmp;
        pt_add<CID>(tmp, acc, run);
        acc = tmp;
    }
    W[d] = acc;
    __syncthreads();
    if (d != 0) return;
    pt_identity<CID>(acc);
    for (int k = 0; k < D; ++k) {
#pragma unroll 1
        for (int j = 0; j < window; ++j) {
            pt_dbl<CID>(tmp, acc);
            acc = tmp;
        }
        pt_add<CID>(tmp, acc, W[k]);
        acc = tmp;
    }
    pt_store<CID>(out + row * PT, acc);
}

extern "C" int zk_bucket_sums(int curve, long long N, long long T, int D, int B, const void* points,
                              const void* digits, void* sums, void* stream) {
    if (N * D == 0) return 0;
    if (B < 2 || B > 256 || T >= 65536) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    int err = 0;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        const size_t smem = bucket_sums_smem<CID>(T, B);
        if (smem > 48 * 1024)
            err = (int)cudaFuncSetAttribute(bucket_sums_kernel<CID>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err) return;
        bucket_sums_kernel<CID><<<(unsigned)(N * D), B, smem, st>>>(
            N, T, D, B, (const uint32_t*)points, (const uint8_t*)digits, (uint32_t*)sums);
    });
    if (bad) return bad;
    return err ? err : (int)cudaGetLastError();
}

extern "C" int zk_bucket_fold(int curve, long long N, int D, int B, int window, const void* sums,
                              void* out, void* stream) {
    if (N == 0) return 0;
    if (D < 1 || D > 1024 || B < 2) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int bad = zk_dispatch_curve(curve, [&](auto c) {
        constexpr int CID = decltype(c)::value;
        const size_t smem = (size_t)D * sizeof(Pt<CID>);
        bucket_fold_kernel<CID><<<(unsigned)N, D, smem, st>>>(
            N, D, B, window, (const uint32_t*)sums, (uint32_t*)out);
    });
    return bad ? bad : (int)cudaGetLastError();
}
